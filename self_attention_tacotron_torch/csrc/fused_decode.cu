// The whole autoregressive decode loop of the decoders in one launch.
//
// Replaces the Pallas kernel of self_attention_tacotron_tpu/ops/fused_decode.py
// (_make_kernel / _run_fused). Per decoder step t this body computes, for every
// lane of the launch:
//
//   prenet (two dense + ReLU layers, dropout from the masks handed in)
//   attention ZoneoutLSTM on [prenet | speaker | ctx1 | ctx2 | h_att]   (gates i, g, f, o)
//   qp = h_att . Wqp                       (both mechanisms' query projections at once)
//   e  = sum_a tanh(keys_cat + qp) * [v1 | v2], split at A1, + score bias (-1e9 where padded)
//   source 1: y = softmax(e1);  a = ((1 - u) a + u shift(a) + 1e-6) y, renormalised
//             u = sigmoid(Wta . [ctx1, h_att] + b) with the transition agent, else 0.5
//   or, location-sensitive (LS): the first A1 columns of the tanh's argument add
//             loc[s] = sum_k prev[s + k - K/2] . Wls[k] + bls, prev the cumulative
//             alignments (or the previous ones); a = y, cum += a; a starts uniform
//   source 2: a2 = softmax(e2);  contexts ctx_i = a_i . memory_i
//   two ZoneoutLSTMs, feature = h2 + h1
//   self-attention block: in-projection + sinusoid row t, LayerNorm, QKV, K and V
//     appended to the cache, softmax(q / sqrt(HD) . K[0..t]) . V[0..t], output
//     projection, residual, LayerNorm, FFN, residual
//   out = y . Wout + b: r frames and r stop logits; rows of frames, stop
//     probabilities and both alignments written out; per-lane first firing frame,
//     lengths and finished flags; the last frame fed back, its lanes [LF0, M)
//     (the lf0 class logits of the WORLD heads; none where LF0 = 0, the mel head)
//     softmaxed first
//
// and leaves the loop at T steps or, with early_exit, as soon as every lane of
// the launch has fired.
//
// The kernel is compiled for two independent flags and two io types: DUAL (the
// two sources above; without it the baseline's single forward attention, where
// Wqp is the mechanism's own query layer, v has one column, A2 = E2 = 0 and there
// is no second memory or alignment), USE_SA (the self-attention block; without it
// the output projection reads the feature h2 + h1 itself and there is no K/V
// cache), and IO, float or bfloat16. LS (location-sensitive attention on source 1,
// K > 0) is compiled for the two pairs of flags a model class reaches, DUAL with
// USE_SA (the flagship's structure) and neither (the baseline's): the folded
// matrix Wls (K rows, zero-padded to LS_TAPS) lives in shared memory for the whole
// launch, the cumulative alignments in a row per lane beside the alignments, and
// the location features are formed inside the score pass (location.cuh), never
// stored. LF0 (the WORLD heads' lf0 feedback) is compiled with forward attention
// for all four pairs: read from the width at run time inside every instantiation
// instead, the softmax's code cost the flagship's decode 5 % on an H100 (PERF.md,
// PR 9). IO is the type of the weights, keys, memories, speaker embedding, K/V
// cache and every product's input rows. With bfloat16 the kernel rounds the input
// of every product to bfloat16 where the Pallas kernel casts it to its io_dtype
// (the fed-back frame, the prenet's second input, the attention LSTM's input, the
// query, the transition agent's input, both decoder LSTMs' inputs, the feature,
// both LayerNorm outputs, the attention output, the FFN's hidden layer and the
// output projection's input) and keeps everything else in float: the products'
// sums, the LSTM and attention state, the score bias, score vectors, LayerNorm
// parameters, softmaxes, stop logits and the outputs. With LS the taps (the
// alignment values) and Wls are rounded too; the location sum and its bias stay
// float. The fed-back frame is kept as float logits and rounded (after the lf0
// lanes' softmax, in float) where the next step's prenet reads it, as the Pallas
// kernel casts the fed-back frame only at its end; the frames written out stay
// logits.
//
// What bounds it on an H100 is the serial chain of a step's dependent stages (a
// dozen small products and the attention), not bytes or operations: the roofline
// bound of a flagship request at B=32 and 500 steps is 1.8 ms (float32 operations),
// and a step's chain runs 15 stages deep. The design spreads every stage over the
// whole card. One block per SM, all resident at once (a cooperative launch), walks
// all the steps; each block holds, for the whole launch, its slice of every decoder
// matrix in shared memory, with the slice's biases: a contiguous run of a product's
// output columns (of an LSTM's gate product whole units, the four gate columns i, g,
// f, o of a unit side by side, so that the zoneout LSTM's update stays in the
// block). A wide product goes to every block; a narrow one to as few as give each
// eight columns (product_blocks), so that fewer blocks read its input rows. The
// slices are dealt out from the widths and the grid size (the SM count) by
// plan_block; the flagship's 3.5 M weights take at most 110 KB a block in float32
// and 56 KB in bfloat16. A product stage copies the lanes' input rows (written by
// the previous stage, in L2) into shared memory with the Tensor Memory
// Accelerator, one bulk copy a row (16-byte copies by the threads ran at 20–30 GB/s
// a block: PERF.md, PR 10), a block of lanes at a time as its room allows, and
// each warp computes 4-lane x 4-column tiles of the block's columns with float
// FMAs (not TF32: the float32 model stays in float32; bfloat16 inputs and weights
// are exact in float, so the sums are the float32 sums the Pallas kernel
// prescribes). A LayerNorm is computed, redundantly, by every block that reads its
// output, while it copies the rows. The attention takes two stages: the scores,
// a warp per (lane, a run of positions) dealt over the whole grid (the location
// features formed there from the taps), then a block per (lane, CTX_COLS context
// columns), which computes the lane's softmaxes and alignments itself (the first
// of a lane's blocks writes them out) and its columns of the contexts. The decoder
// self-attention over the K/V cache goes to a block per (lane, head), walking the
// cache's prefix in tiles of SA_TILE positions with an online softmax (running
// maximum and sum, the output rescaled from tile to tile; a prefix of one tile,
// every step of a request of up to SA_TILE steps, is normalised before its product
// with V, as a plain softmax is): nothing in shared memory grows with T. Between
// two dependent stages every block meets the others at a grid barrier
// (grid.cuh::grid_barrier); the flagship has 15 a step. After the last one every
// block reads the step's stop probabilities of every lane and keeps its own copy of
// the lanes' lengths and finished flags, so all blocks take the same exit decision
// without a barrier of its own. State lives in global memory (L2): per-lane rows
// written by one stage and read by the next, double-buffered by the step's parity
// where a stage reads a row that it also feeds (the LSTMs' inputs) and where
// several blocks read what one writes (the alignments); an LSTM's cell and hidden
// state are read and written only by the block that owns the unit, and the
// transition factor is recomputed from the previous step's context and query. K is
// cached transposed (position minor), so that both passes of the attention read
// consecutive addresses along the axis they do not reduce.
//
// With stamp_step >= 0 (the STAMPS instantiations, of the flagship's structure
// alone), block 0 writes %globaltimer into P.stamps at the start of that step and,
// for each of its stages, when its input rows are in shared memory (product
// stages), at its arrival at the stage's barrier and at its departure: the time of
// each stage apart, and of its copy and its wait.
//
// Plain C interface at the bottom: the function launches on the given stream,
// allocates nothing, does not synchronise, and returns the CUDA error code.

#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "dense.cuh"
#include "grid.cuh"
#include "location.cuh"

namespace {

constexpr int NT = 512;
constexpr int NWARPS = NT / 32;
// Positions of the decoder self-attention's prefix per tile (a multiple of 4):
// requests of up to this many steps attend in one tile.
constexpr int SA_TILE = 512;
// Most lanes one launch takes (every block keeps every lane's finished flag and length).
constexpr int MAX_LANES = 1024;

// Order of the entries in the flat weight buffers (ops/fused_decode.py::_ENTRIES).
// V_CAT and the LayerNorm parameters are in the float buffer, the rest in the
// buffer of the io type.
enum Entry {
  P1_W, P1_B, P2_W, P2_B, ATTG_W, ATTG_B, QP_W, V_CAT, TA_W, TA_B,
  L1_W, L1_B, L2_W, L2_B, IN_W, IN_B, LN1_S, LN1_B, LN2_S, LN2_B,
  QKV_W, O_W, O_B, F1_W, F1_B, F2_W, F2_B, OUT_W, OUT_B, LS_W, LS_B, NUM_ENTRIES
};

// Sizes, flags and offsets (in values of their buffer), in the order the wrapper
// writes them. The widths name the specialisation: E2 > 0 two sources, SA > 0 the
// self-attention block, K > 0 (the location taps) location-sensitive attention;
// LF0 the first lf0 lane of a frame (0: the mel head, no softmax in the feedback);
// ls_cum: its taps read the cumulative alignments; bf16 the io type; stamp_step the
// step whose stages P.stamps times (-1: none).
struct Dims {
  int B, S, T;
  int M, R, P1, P2, SPK, AU, A1, A2, DU, SA, H, FFN, E1, E2, K, LF0;
  int use_ta, early_exit, use_masks, ls_cum, bf16, stamp_step;
  int off[NUM_ENTRIES];
};

struct Scalars {
  float zc, zo, forget_bias, inv_keep, stop_threshold, ln_eps, sqrt_hd;
};

template <typename IO>
struct Ptrs {
  const IO* w;
  const float* w32;              // score vectors and LayerNorm parameters
  const double* pe_rate;         // (SA,); a placeholder without self-attention
  const IO* keys;                // (B, S, A1 + A2)
  const IO* mem1;                // (B, S, E1)
  const IO* mem2;                // (B, S, E2); a placeholder with one source
  const float* bias;             // (B, S)
  const IO* spk;                 // (B, SPK) or null
  const unsigned char* mask1;    // (T, B, P1) or null
  const unsigned char* mask2;    // (T, B, P2) or null
  IO* kcache;                    // (B, SA, T4) scratch; a placeholder without self-attention
  IO* vcache;                    // (B, T, SA) scratch; likewise
  float* frames;                 // (B, T, R * M)
  float* stops;                  // (B, T, R)
  float* align1;                 // (B, T, S)
  float* align2;                 // (B, T, S); a placeholder with one source
  int* lengths;                  // (B,)
  unsigned char* finished;       // (B,)
  int* info;                     // [0] steps run, [1] the grid barrier's arrival counter
  unsigned char* scratch;        // scratch_layout(d).total bytes, zeroed by the caller
  long long* stamps;             // null, or 1 + 3 x stages values: the step's start, then
                                 // (rows copied, arrival, departure) a stage
};

// ------------------------------ the plan -------------------------------------

__host__ __device__ inline int r8(int n) { return (n + 7) / 8 * 8; }

// The stride (values) of a product's input rows and weight columns in shared
// memory: that of the rows in global memory (r8), so that a block of whole rows
// is one bulk copy.
__host__ __device__ inline int ldk(int K, int) { return r8(K); }

// The products of a step in the order they run; the self-attention block's have
// no columns without it.
enum Product { PR_P1, PR_P2, PR_ATTG, PR_QP, PR_L1, PR_L2, PR_IN, PR_QKV, PR_O, PR_F1, PR_F2,
               PR_OUT, NUM_PRODUCTS };

struct ProductShape {
  int K, items, gates, entry;   // items: output columns, or with gates units of 4 columns
};

__host__ __device__ inline ProductShape product_shape(const Dims& d, int p) {
  const int EW = d.E1 + d.E2;
  const int sa = d.SA > 0 ? 1 : 0;
  ProductShape s;
  s.gates = 0;
  switch (p) {
    case PR_P1: s.K = d.M; s.items = d.P1; s.entry = P1_W; break;
    case PR_P2: s.K = d.P1; s.items = d.P2; s.entry = P2_W; break;
    case PR_ATTG: s.K = d.P2 + d.SPK + EW + d.AU; s.items = d.AU; s.gates = 1; s.entry = ATTG_W; break;
    case PR_QP: s.K = d.AU; s.items = d.A1 + d.A2; s.entry = QP_W; break;
    case PR_L1: s.K = d.AU + EW + d.DU; s.items = d.DU; s.gates = 1; s.entry = L1_W; break;
    case PR_L2: s.K = 2 * d.DU; s.items = d.DU; s.gates = 1; s.entry = L2_W; break;
    case PR_IN: s.K = d.DU; s.items = sa * d.SA; s.entry = IN_W; break;
    case PR_QKV: s.K = d.SA; s.items = 3 * d.SA; s.entry = QKV_W; break;
    case PR_O: s.K = d.SA; s.items = d.SA; s.entry = O_W; break;
    case PR_F1: s.K = d.SA; s.items = sa * d.FFN; s.entry = F1_W; break;
    case PR_F2: s.K = d.FFN; s.items = d.SA; s.entry = F2_W; break;
    default: s.K = sa ? d.SA : d.DU; s.items = d.R * d.M + d.R; s.entry = OUT_W; break;
  }
  return s;
}

struct Slice {
  int first, count, cols, off,   // items [first, first + count), their columns, and where
      boff;                      // the slice starts in the block's weight region (values)
};                               // and its biases in the bias region (floats)

// What a block holds for the launch: weight values (io type) and bias floats.
struct Held {
  int weights, biases;
};

// The blocks a product's items are dealt to: as few as give each at least 8 columns
// (2 units of a gate product), so that few blocks read its input rows, as long as
// one block's slice stays within SLICE_BYTES; a wide product goes to every block.
constexpr int SLICE_BYTES = 8192;
__host__ __device__ inline int product_blocks(const Dims& d, const ProductShape& ps, int G) {
  const int item_bytes = (ps.gates ? 4 : 1) * ldk(ps.K, d.bf16) * (d.bf16 ? 2 : 4);
  const int per = imax(1, imin(ps.gates ? 2 : 8, SLICE_BYTES / imax(item_bytes, 1)));
  return imin(G, imax(1, (ps.items + per - 1) / per));
}

// Block b's slices of a grid of G blocks, and what it holds: weight values of the
// io type (a multiple of 8) and bias floats (each product's a multiple of 4). A slice
// is its columns, each ldk(K) values (k minor, zero beyond K). Product p's items go
// to product_blocks of them, in contiguous runs from block `start` on; the next
// product starts where this one's blocks end (or, on every block, where its
// remainder ends). ops/fused_decode.py::grid_plan is the same formula.
__host__ __device__ inline Held plan_block(const Dims& d, int G, int b, Slice* s) {
  int start = 0;
  Held h = {0, 0};
  for (int p = 0; p < NUM_PRODUCTS; ++p) {
    const ProductShape ps = product_shape(d, p);
    const int Gp = product_blocks(d, ps, G);
    const int r = (b - start + G) % G;
    Share sh = {0, 0};
    if (r < Gp) sh = share_of(ps.items, Gp, 0, r);
    s[p].first = sh.first;
    s[p].count = sh.count;
    s[p].cols = ps.gates ? 4 * sh.count : sh.count;
    s[p].off = h.weights;
    s[p].boff = h.biases;
    h.weights = r8(h.weights + s[p].cols * ldk(ps.K, d.bf16));
    h.biases += r4(s[p].cols);
    start = (start + (Gp < G ? Gp : ps.items % G)) % G;
  }
  return h;
}

// The most any block of the grid holds.
__host__ __device__ inline Held plan_held(const Dims& d, int G) {
  Slice s[NUM_PRODUCTS];
  Held most = {0, 0};
  for (int b = 0; b < G; ++b) {
    const Held h = plan_block(d, G, b, s);
    most.weights = imax(most.weights, h.weights);
    most.biases = imax(most.biases, h.biases);
  }
  return most;
}

__host__ __device__ inline int widest_k(const Dims& d) {
  int k = 0;
  for (int p = 0; p < NUM_PRODUCTS; ++p) {
    const ProductShape ps = product_shape(d, p);
    if (ps.items > 0) k = imax(k, ldk(ps.K, d.bf16));
  }
  return k;
}

// Floats of one lane's row that a LayerNorm or the fed-back frame stages in shared
// memory before it is transformed into a product's input row.
__host__ __device__ inline int stage_floats(const Dims& d) { return r4(imax(d.M, d.SA)); }

// Floats of the work region's layout in the alignment and context stage and in the
// self-attention stage (the region is reused by every stage in turn). A block of the
// former takes CTX_COLS context columns of a lane.
constexpr int CTX_COLS = 128;
struct LaneLayout {
  int e1, e2, alpha, tmp, cum, part, total;
};
__host__ __device__ inline LaneLayout lane_layout(const Dims& d) {
  LaneLayout L;
  int at = 0;
  L.e1 = at; at += r4(d.S);
  L.e2 = at; at += r4(d.S);
  L.alpha = at; at += r4(d.S);
  L.tmp = at; at += r4(d.S);
  L.cum = at; at += r4(d.S);
  L.part = at; at += imax(4 * NT, CTX_COLS);
  L.total = at;
  return L;
}
struct SaLayout {
  int q, acc, logit, part, total;
};
__host__ __device__ inline SaLayout sa_layout(const Dims& d) {
  const int HD = d.SA > 0 ? d.SA / d.H : 0;
  SaLayout L;
  int at = 0;
  L.q = at; at += r4(HD);
  L.acc = at; at += r4(HD);
  L.logit = at; at += SA_TILE;
  L.part = at; at += imax(4 * NT, r4(HD));
  L.total = at;
  return L;
}

// Byte offsets of a block's dynamic shared memory: its weight slices (io type), their
// biases and the LayerNorm parameters (float), the folded location matrix (LS,
// float), every lane's finished flag, length and last valid source position, then
// the work region: the product stages' input rows (and the float rows they are made
// from), or the attention stages' rows.
struct Smem {
  int bias, ln, lsw, fin, len, hi, work, min_work;
};
__host__ __device__ inline Smem smem_layout(const Dims& d, Held held, int lanes) {
  const int io = d.bf16 ? 2 : 4;
  Smem m;
  int at = held.weights * io;
  m.bias = at;
  at += held.biases * 4;
  m.ln = at;
  at += 4 * r4(d.SA) * 4;
  m.lsw = at;
  at += d.K > 0 ? LS_TAPS * r4(d.A1) * 4 : 0;
  m.fin = at;
  at += r4(lanes) * 4;
  m.len = at;
  at += r4(lanes) * 4;
  m.hi = at;
  at += r4(lanes) * 4;
  m.work = at;
  // one group of four lanes of the widest product, and their staged float rows
  const int rows = 4 * (widest_k(d) * io + 4 * stage_floats(d));
  m.min_work = imax(rows, 4 * imax(lane_layout(d).total, d.SA > 0 ? sa_layout(d).total : 0));
  return m;
}

// Dynamic shared memory a block needs at the least with a grid of G blocks, whatever
// the lane count up to MAX_LANES (what ops/fused_decode.py::grid_plan calls smem_bytes).
size_t smem_need(const Dims& d, int G) {
  const Smem m = smem_layout(d, plan_held(d, G), MAX_LANES);
  return (size_t)m.work + m.min_work;
}

// What a block of a launch of d.B lanes can use: input rows of every lane at once.
size_t smem_want(const Dims& d, int G) {
  const Smem m = smem_layout(d, plan_held(d, G), d.B);
  const int io = d.bf16 ? 2 : 4;
  return (size_t)m.work + imax(m.min_work, r4(d.B) * (widest_k(d) * io + 4 * stage_floats(d)));
}

// ------------------------------ global scratch -------------------------------

// Per-lane rows in the scratch buffer (bytes from its start, each 16-byte aligned).
// Rows of the io type have strides of r8 values, float rows of r4. attin, din and
// din2 are double-buffered by the step's parity (a stage reads the row it feeds), and
// so are the alignments and the cumulative ones (every block of a lane reads them).
struct Scratch {
  size_t x1, attin, din, din2, feat, attn, f1, y;          // io type
  size_t feed, qp, xs, q, xs2, catt, hatt, c1, h1, c2, h2, alpha, cum, e;   // float
  size_t total;
};
__host__ __device__ inline Scratch scratch_layout(const Dims& d) {
  const size_t io = d.bf16 ? 2 : 4, B = d.B;
  const int EW = d.E1 + d.E2;
  const int KA = d.P2 + d.SPK + EW + d.AU, KD1 = d.AU + EW + d.DU;
  Scratch s;
  size_t at = 0;
  auto take = [&](size_t& off, size_t bytes) {
    off = at;
    at += (bytes + 15) / 16 * 16;
  };
  take(s.x1, B * r8(d.P1) * io);
  take(s.attin, 2 * B * r8(KA) * io);
  take(s.din, 2 * B * r8(KD1) * io);
  take(s.din2, 2 * B * r8(2 * d.DU) * io);
  take(s.feat, B * r8(d.DU) * io);
  take(s.attn, B * r8(d.SA) * io);
  take(s.f1, B * r8(d.FFN) * io);
  take(s.y, B * r8(d.SA) * io);
  take(s.feed, B * r4(d.M) * 4);
  take(s.qp, B * r4(d.A1 + d.A2) * 4);
  take(s.xs, B * r4(d.SA) * 4);
  take(s.q, B * r4(d.SA) * 4);
  take(s.xs2, B * r4(d.SA) * 4);
  take(s.catt, B * r4(d.AU) * 4);
  take(s.hatt, B * r4(d.AU) * 4);
  take(s.c1, B * r4(d.DU) * 4);
  take(s.h1, B * r4(d.DU) * 4);
  take(s.c2, B * r4(d.DU) * 4);
  take(s.h2, B * r4(d.DU) * 4);
  take(s.alpha, 2 * B * r4(d.S) * 4);
  take(s.cum, d.K > 0 ? 2 * B * r4(d.S) * 4 : 0);
  take(s.e, 2 * B * r4(d.S) * 4);
  s.total = at;
  return s;
}

// ------------------------------ stages ---------------------------------------

// Rows [l0, l0 + lc) of a row-major (lanes, lds) array of T into `dst` (rows of ld
// values, ld <= lds; both strides and the rows' starts whole 16-byte pieces): one
// bulk copy a row, all in flight at once, ld values each (what a row holds past its
// width, zero or a neighbouring row's finite values, meets the zero padding of the
// weights). The rows from lc to r4(lc) are left as they are: no lane reads them.
// Every thread returns once the rows are in; `phase` counts the batches.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, int lds, int l0, int lc,
                                          unsigned long long* bar, unsigned int& phase) {
  if (threadIdx.x == 0) {
    fence_proxy_async();
    mbar_expect(bar, (unsigned int)(lc * ld * sizeof(T)));
    if (ld == lds) {   // whole rows: one copy (the bulk copies of a block run one by one)
      bulk_copy(dst, src + (size_t)l0 * lds, (unsigned int)(lc * ld * sizeof(T)), bar);
    } else {
      for (int r = 0; r < lc; ++r)
        bulk_copy(dst + r * ld, src + (size_t)(l0 + r) * lds, (unsigned int)(ld * sizeof(T)), bar);
    }
  }
  mbar_wait(bar, phase);
  phase ^= 1u;
}

// One product stage of a block: its slice `s` of a product of depth K, for every lane
// of the launch, B lanes in blocks of as many as the work region (`work_bytes`)
// holds. `load(tile, ld, l0, lc, stage)` fills the tile with lanes l0 .. l0 + lc - 1
// (see copy_rows), where the rows are made from float rows of `stage_row` values
// staged at `stage` first (0: copied as they are); `copied`: null, or where block 0
// stamps the time its first rows are in shared memory. A warp computes 4 lanes x 4
// columns, then `epi(lane, item, v0, v1, v2, v3)`: a plain product calls it per
// (lane, column) with the sum in v0, a gate product per (lane, unit) with the sums
// of gates i, g, f, o.
template <typename IO, typename Load, typename Epi>
__device__ __forceinline__ void product(const IO* sw, const Slice& s, int K, bool gates, int B,
                                        IO* tile, int work_bytes, int stage_row, long long* copied,
                                        Load&& load, Epi&& epi) {
  if (s.count == 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = ldk(K, sizeof(IO) == 2), nq = ld >> 2;
  const int cap = imin(r4(B), (work_bytes / (ld * (int)sizeof(IO) + 4 * stage_row)) & ~3);
  float* stage = reinterpret_cast<float*>(tile + cap * ld);
  const int ncg = gates ? s.count : (s.cols + 3) >> 2;
  for (int l0 = 0; l0 < B; l0 += cap) {
    const int lc = imin(cap, B - l0);
    __syncthreads();   // the previous rows have been read
    load(tile, ld, l0, lc, stage);
    __syncthreads();
    if (copied != nullptr && threadIdx.x == 0 && l0 == 0) *copied = global_timer();
    const int nlg = (lc + 3) >> 2;
    for (int item = warp; item < nlg * ncg; item += NWARPS) {
      const int lg = item % nlg, cg = item / nlg;
      const IO* x[4];
      const IO* w[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) x[a] = tile + (4 * lg + a) * ld;
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = sw + imin(4 * cg + c, s.cols - 1) * ld;   // past the slice: unused
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
      warp_tile<IO>(x, w, nq, lane, acc);
      const float v = reduce16(acc, lane);
      const int a = lane >> 3, c = (lane >> 1) & 3;
      if (gates) {
        const int base = lane & ~7;
        const float zg = __shfl_sync(0xffffffffu, v, base | 2);
        const float zf = __shfl_sync(0xffffffffu, v, base | 4);
        const float zo = __shfl_sync(0xffffffffu, v, base | 6);
        if ((lane & 7) == 0 && 4 * lg + a < lc) epi(l0 + 4 * lg + a, s.first + cg, v, zg, zf, zo);
      } else if ((lane & 1) == 0 && 4 * lg + a < lc && 4 * cg + c < s.cols) {
        epi(l0 + 4 * lg + a, s.first + 4 * cg + c, v, 0.0f, 0.0f, 0.0f);
      }
    }
  }
}

// The maximum and the sum of one value a thread over the block; every thread gets
// them. `red`: NWARPS + 1 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < NWARPS ? red[threadIdx.x] : -3.0e38f;
    w = warp_max(w);
    if (threadIdx.x == 0) red[NWARPS] = w;
  }
  __syncthreads();
  return red[NWARPS];
}
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();   // the previous reduction has been read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < NWARPS ? red[threadIdx.x] : 0.0f;
    w = warp_sum(w);
    if (threadIdx.x == 0) red[NWARPS] = w;
  }
  __syncthreads();
  return red[NWARPS];
}

template <bool DUAL, bool USE_SA, bool LS, bool LF0, bool STAMPS, typename IO>
__global__ void __launch_bounds__(NT)
fused_decode_kernel(const Ptrs<IO> P, const Dims d, const Scalars sc, const Held held) {
  using Vec = typename Weights4<IO>::Vec;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __shared__ float s_u;
  __shared__ float s_stat[3];   // the self-attention's running maximum, sum and rescale
  __shared__ float s_red[NWARPS + 1];
  __shared__ unsigned long long s_bar;   // completion of the bulk copies of input rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, blk = blockIdx.x;
  const int B = d.B, S = d.S, T = d.T, T4 = r4(d.T);
  const int M = d.M, R = d.R, P1 = d.P1, P2 = d.P2, AU = d.AU, A1 = d.A1, DU = d.DU;
  const int SA = d.SA, H = d.H, HD = USE_SA ? d.SA / d.H : 1, FFN = d.FFN, E1 = d.E1, E2 = d.E2;
  const int A = d.A1 + d.A2, EW = d.E1 + d.E2, RM = d.R * d.M, OW = d.R * d.M + d.R;
  const int KA = P2 + d.SPK + EW + AU, KD1 = AU + EW + DU;
  const IO* w = P.w;
  const float* w32 = P.w32;

  Slice sl[NUM_PRODUCTS];
  plan_block(d, G, blk, sl);
  const Smem sm = smem_layout(d, held, B);
  unsigned int dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  IO* sw = reinterpret_cast<IO*>(smem);
  float* s_bias = reinterpret_cast<float*>(smem + sm.bias);
  float* s_ln = reinterpret_cast<float*>(smem + sm.ln);     const int ld_ln = r4(d.SA);
  float* s_lsw = reinterpret_cast<float*>(smem + sm.lsw);   const int ld_lsw = r4(A1);
  int* s_fin = reinterpret_cast<int*>(smem + sm.fin);
  int* s_len = reinterpret_cast<int*>(smem + sm.len);
  IO* tile = reinterpret_cast<IO*>(smem + sm.work);
  float* work = reinterpret_cast<float*>(smem + sm.work);
  int* s_hi = reinterpret_cast<int*>(smem + sm.hi);   // positions below this can hold mass
  const int work_bytes = (int)(dyn - (unsigned int)sm.work);

  // the rows in global memory
  const Scratch sg = scratch_layout(d);
  unsigned char* g = P.scratch;
  IO* g_x1 = reinterpret_cast<IO*>(g + sg.x1);          const int ld_x1 = r8(P1);
  IO* g_attin = reinterpret_cast<IO*>(g + sg.attin);    const int ld_attin = r8(KA);
  IO* g_din = reinterpret_cast<IO*>(g + sg.din);        const int ld_din = r8(KD1);
  IO* g_din2 = reinterpret_cast<IO*>(g + sg.din2);      const int ld_din2 = r8(2 * DU);
  IO* g_feat = reinterpret_cast<IO*>(g + sg.feat);      const int ld_feat = r8(DU);
  IO* g_attn = reinterpret_cast<IO*>(g + sg.attn);      const int ld_sa8 = r8(SA);
  IO* g_f1 = reinterpret_cast<IO*>(g + sg.f1);          const int ld_f1 = r8(FFN);
  IO* g_y = reinterpret_cast<IO*>(g + sg.y);
  float* g_feed = reinterpret_cast<float*>(g + sg.feed); const int ld_feed = r4(M);
  float* g_qp = reinterpret_cast<float*>(g + sg.qp);     const int ld_qp = r4(A);
  float* g_xs = reinterpret_cast<float*>(g + sg.xs);     const int ld_sa4 = r4(SA);
  float* g_q = reinterpret_cast<float*>(g + sg.q);
  float* g_xs2 = reinterpret_cast<float*>(g + sg.xs2);
  float* g_catt = reinterpret_cast<float*>(g + sg.catt); const int ld_au = r4(AU);
  float* g_hatt = reinterpret_cast<float*>(g + sg.hatt);
  float* g_c1 = reinterpret_cast<float*>(g + sg.c1);     const int ld_du = r4(DU);
  float* g_h1 = reinterpret_cast<float*>(g + sg.h1);
  float* g_c2 = reinterpret_cast<float*>(g + sg.c2);
  float* g_h2 = reinterpret_cast<float*>(g + sg.h2);
  // the alignments (and cumulative ones) by the step's parity; the scores
  float* g_alpha = reinterpret_cast<float*>(g + sg.alpha); const int ld_s = r4(S);
  float* g_cum = reinterpret_cast<float*>(g + sg.cum);
  float* g_e1 = reinterpret_cast<float*>(g + sg.e);
  float* g_e2 = g_e1 + (size_t)B * ld_s;
  const size_t lane_half = (size_t)B * ld_s;
  const size_t attin_half = (size_t)B * ld_attin, din_half = (size_t)B * ld_din,
               din2_half = (size_t)B * ld_din2;

  unsigned int* counter = reinterpret_cast<unsigned int*>(P.info) + 1;
  unsigned int goal = 0;
  long long* stamp = nullptr;
  int stage = 0;
  auto copied = [&]() { return stamp != nullptr ? stamp + 1 + 3 * stage : nullptr; };
  auto sync = [&]() {
    grid_barrier(counter, goal, stamp != nullptr ? stamp + 2 + 3 * stage : nullptr);
    ++stage;
  };

  unsigned int bar_phase = 0;
  if (tid == 0) mbar_init(&s_bar);

  // ------------------------------ the launch's set-up ------------------------
  // this block's weight slices, for the whole launch
  for (int p = 0; p < NUM_PRODUCTS; ++p) {
    const Slice s = sl[p];
    if (s.count == 0) continue;
    const ProductShape ps = product_shape(d, p);
    const int ld = ldk(ps.K, d.bf16), N = ps.gates ? 4 * ps.items : ps.items;
    const IO* W = w + d.off[ps.entry];
    for (int i = tid; i < s.cols * ld; i += NT) {
      const int k = i / s.cols, c = i - k * s.cols;
      const int col = ps.gates ? (c & 3) * ps.items + s.first + (c >> 2) : s.first + c;
      sw[s.off + c * ld + k] = k < ps.K ? W[(size_t)k * r4(N) + col] : Io<IO>::from(0.0f);
    }
    // the bias of each column (the query projection and QKV have none), float
    for (int c = tid; c < s.cols; c += NT) {
      const int col = ps.gates ? (c & 3) * ps.items + s.first + (c >> 2) : s.first + c;
      s_bias[s.boff + c] =
          (p == PR_QP || p == PR_QKV) ? 0.0f : Io<IO>::load(w + d.off[ps.entry + 1] + col);
    }
  }
  if (USE_SA)
    for (int i = tid; i < SA; i += NT) {
      s_ln[i] = __ldg(w32 + d.off[LN1_S] + i);
      s_ln[ld_ln + i] = __ldg(w32 + d.off[LN1_B] + i);
      s_ln[2 * ld_ln + i] = __ldg(w32 + d.off[LN2_S] + i);
      s_ln[3 * ld_ln + i] = __ldg(w32 + d.off[LN2_B] + i);
    }
  if (LS)
    for (int i = tid; i < LS_TAPS * A1; i += NT) {
      const int k = i / A1, a = i - k * A1;
      s_lsw[k * ld_lsw + a] = Io<IO>::load(w + d.off[LS_W] + k * ld_lsw + a);
    }
  for (int l = tid; l < B; l += NT) {
    s_fin[l] = 0;
    s_len[l] = 0;
  }
  // every lane's end of the valid source, a warp per lane
  for (int l = warp; l < B; l += NWARPS) {
    int hi = 0;
    for (int s = lane; s < S; s += 32)
      if (__ldg(P.bias + (size_t)l * S + s) > -1e8f) hi = s + 1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) hi = imax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    if (lane == 0) s_hi[l] = hi > 0 ? hi : S;   // nothing valid: the softmax is uniform
  }
  // lanes blk, blk + G, ...: their first alignments and the speaker embedding in
  // both parities of the attention LSTM's input
  for (int l = blk; l < B; l += G) {
    if (LS) {
      for (int s = tid; s < S; s += NT) g_alpha[(size_t)l * ld_s + s] = 1.0f / (float)S;
    } else if (tid == 0) {
      g_alpha[(size_t)l * ld_s] = 1.0f;   // forward attention: all mass at position 0
    }
    if (P.spk != nullptr)
      for (int j = tid; j < d.SPK; j += NT) {
        const IO v = P.spk[(size_t)l * d.SPK + j];
        g_attin[(size_t)l * ld_attin + P2 + j] = v;
        g_attin[attin_half + (size_t)l * ld_attin + P2 + j] = v;
      }
  }
  sync();

  int steps = 0;
  for (int t = 0; t < T; ++t) {
    stage = 0;
    stamp = (STAMPS && P.stamps != nullptr && t == d.stamp_step && blk == 0) ? P.stamps : nullptr;
    if (stamp != nullptr && tid == 0) stamp[0] = global_timer();
    const int par = t & 1;
    IO* attin_p = g_attin + par * attin_half;          // the attention LSTM's input of step t
    IO* attin_n = g_attin + (par ^ 1) * attin_half;    // ... and of step t + 1
    IO* din_p = g_din + par * din_half;
    IO* din_n = g_din + (par ^ 1) * din_half;
    IO* din2_p = g_din2 + par * din2_half;
    IO* din2_n = g_din2 + (par ^ 1) * din2_half;
    auto rows_of = [&](const IO* src, int lds) {
      return [&, src, lds](IO* tl, int ld, int l0, int lc, float*) {
        copy_rows<IO>(tl, ld, src, lds, l0, lc, &s_bar, bar_phase);
      };
    };
    // the bias of an item of product p held by this block
    auto bias_of = [&](int p, int j) { return s_bias[sl[p].boff + (j - sl[p].first)]; };
    auto lstm = [&](float* c_state, float* h_state, int ldc, int p, int l, int u,
                    float zi, float zg, float zf, float zo) {
      const float* b = s_bias + sl[p].boff + 4 * (u - sl[p].first);   // i, g, f, o
      zi += b[0];
      zg += b[1];
      zf += b[2];
      zo += b[3];
      const float c = __ldcg(c_state + (size_t)l * ldc + u);
      const float h = __ldcg(h_state + (size_t)l * ldc + u);
      const float new_c = sigmoidf_(zf + sc.forget_bias) * c + sigmoidf_(zi) * tanhf(zg);
      const float new_h = sigmoidf_(zo) * tanhf(new_c);
      const float out_h = sc.zo * h + (1.0f - sc.zo) * new_h;
      c_state[(size_t)l * ldc + u] = sc.zc * c + (1.0f - sc.zc) * new_c;
      h_state[(size_t)l * ldc + u] = out_h;
      return out_h;
    };

    // ------------------------------ prenet ------------------------------------
    // the fed-back frame (float logits, staged in shared memory), rounded to the io
    // type as the prenet reads it; from step 1 on its lf0 lanes softmaxed first (in
    // float), a warp per lane. Step 0 reads the zero frame as it is.
    const bool softmax_lf0 = LF0 && t > 0;
    product(sw + sl[PR_P1].off, sl[PR_P1], M, false, B, tile, work_bytes, ld_feed, copied(),
            [&](IO* tl, int ld, int l0, int lc, float* stage) {
              copy_rows<float>(stage, ld_feed, g_feed, ld_feed, l0, lc, &s_bar, bar_phase);
              for (int r = warp; r < lc; r += NWARPS) {
                IO* row = tl + r * ld;
                const float* f = stage + r * ld_feed;
                float m = -3.0e38f, sum = 1.0f;
                if (softmax_lf0) {
                  for (int k = d.LF0 + lane; k < M; k += 32) m = fmaxf(m, f[k]);
                  m = warp_max(m);
                  sum = 0.0f;
                  for (int k = d.LF0 + lane; k < M; k += 32) sum += expf(f[k] - m);
                  sum = warp_sum(sum);
                }
                for (int k = lane; k < ld; k += 32) {
                  float v = k < M ? f[k] : 0.0f;
                  if (softmax_lf0 && k >= d.LF0 && k < M) v = expf(v - m) / sum;
                  row[k] = Io<IO>::from(v);
                }
              }
            },
            [&](int l, int j, float v, float, float, float) {
              v = fmaxf(v + bias_of(PR_P1, j), 0.0f);
              if (d.use_masks) v = P.mask1[((size_t)t * B + l) * P1 + j] ? v * sc.inv_keep : 0.0f;
              g_x1[(size_t)l * ld_x1 + j] = Io<IO>::from(v);
            });
    sync();
    product(sw + sl[PR_P2].off, sl[PR_P2], P1, false, B, tile, work_bytes, 0, copied(), rows_of(g_x1, ld_x1),
            [&](int l, int j, float v, float, float, float) {
              v = fmaxf(v + bias_of(PR_P2, j), 0.0f);
              if (d.use_masks) v = P.mask2[((size_t)t * B + l) * P2 + j] ? v * sc.inv_keep : 0.0f;
              attin_p[(size_t)l * ld_attin + j] = Io<IO>::from(v);
            });
    sync();

    // ------------------------------ attention LSTM -----------------------------
    // input [prenet | speaker | ctx1 | ctx2 | h_att]; the new h_att is the query
    product(sw + sl[PR_ATTG].off, sl[PR_ATTG], KA, true, B, tile, work_bytes, 0, copied(),
            rows_of(attin_p, ld_attin),
            [&](int l, int u, float zi, float zg, float zf, float zo) {
              const IO h = Io<IO>::from(lstm(g_catt, g_hatt, ld_au, PR_ATTG, l, u,
                                             zi, zg, zf, zo));
              din_p[(size_t)l * ld_din + u] = h;
              attin_n[(size_t)l * ld_attin + (KA - AU) + u] = h;
            });
    sync();
    product(sw + sl[PR_QP].off, sl[PR_QP], AU, false, B, tile, work_bytes, 0, copied(),
            rows_of(din_p, ld_din),
            [&](int l, int j, float v, float, float, float) { g_qp[(size_t)l * ld_qp + j] = v; });
    sync();

    // ------------------------------ scores, a warp per RUN positions ---------
    // e = sum_a tanh(keys_cat + qp [+ loc]) * [v1 | v2] + bias for every lane and
    // position, a warp per (lane, RUN neighbouring positions) dealt over the whole
    // grid, the keys of all of them in flight at once; location-sensitive: the taps
    // of LS_RUN positions in registers, source 1's columns adding the location
    // features. Without them two positions a warp: a warp's tanh chain is the stage.
    {
      constexpr int RUN = LS ? LS_RUN : 2;
      const int nrun = (S + RUN - 1) / RUN;
      const float* prev_rows = (d.ls_cum ? g_cum : g_alpha) + par * lane_half;
      for (int task = blk + G * warp; task < B * nrun; task += G * NWARPS) {
        const int l = task / nrun, s0 = (task - l * nrun) * RUN;
        const float* qp = g_qp + (size_t)l * ld_qp;
        const IO* keys = P.keys + (size_t)l * S * A;
        float win[LS_WIN];
        if (LS) {
          const float* prev = prev_rows + (size_t)l * ld_s;
#pragma unroll
          for (int i = 0; i < LS_WIN; ++i) {   // the taps (a product's input): rounded
            const int p = s0 - (d.K >> 1) + i;
            win[i] = (p >= 0 && p < S) ? Io<IO>::round(__ldcg(prev + p)) : 0.0f;
          }
        }
        float acc1[RUN], acc2[RUN];
#pragma unroll
        for (int j = 0; j < RUN; ++j) acc1[j] = acc2[j] = 0.0f;
        if (!LS && (A & 3) == 0) {
          // four neighbouring columns a lane: groups of four keys, all in flight
          for (int aq = lane; aq < (A >> 2); aq += 32) {
            const int a = 4 * aq;
            const float4 q4 = __ldcg(reinterpret_cast<const float4*>(qp + a));
            const float4 v4 = __ldg(reinterpret_cast<const float4*>(w32 + d.off[V_CAT] + a));
            const float q[4] = {q4.x, q4.y, q4.z, q4.w}, v[4] = {v4.x, v4.y, v4.z, v4.w};
            float4 key[RUN];
#pragma unroll
            for (int j = 0; j < RUN; ++j)   // past the source: computed, never written
              key[j] = Weights4<IO>::values(__ldg(reinterpret_cast<const Vec*>(
                  keys + (size_t)imin(s0 + j, S - 1) * A + a)));
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
              const float k[4] = {key[j].x, key[j].y, key[j].z, key[j].w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float th = tanhf(k[e] + q[e]) * v[e];
                if (!DUAL || a + e < A1) acc1[j] += th; else acc2[j] += th;
              }
            }
          }
        } else {
          for (int a = lane; a < A; a += 32) {
            const float q = __ldcg(qp + a);
            const float v = __ldg(w32 + d.off[V_CAT] + a);
            const bool first = !DUAL || a < A1;
            float key[RUN];
#pragma unroll
            for (int j = 0; j < RUN; ++j)   // past the source: computed, never written
              key[j] = Io<IO>::load(keys + (size_t)imin(s0 + j, S - 1) * A + a);
            float loc[LS_RUN];
#pragma unroll
            for (int j = 0; j < LS_RUN; ++j) loc[j] = 0.0f;
            if (LS && first) {
              ls_dot(win, s_lsw, ld_lsw, a, loc);
              const float b = __ldg(w32 + d.off[LS_B] + a);
#pragma unroll
              for (int j = 0; j < LS_RUN; ++j) loc[j] += b;
            }
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
              const float th = (LS ? tanhf((key[j] + q) + loc[j]) : tanhf(key[j] + q)) * v;
              if (first) acc1[j] += th; else acc2[j] += th;
            }
          }
        }
        const float* bias = P.bias + (size_t)l * S;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          const float e1 = warp_sum(acc1[j]);
          const float e2 = DUAL ? warp_sum(acc2[j]) : 0.0f;
          const int s = s0 + j;
          if (lane == 0 && s < S) {
            // a padded position keeps -1e9: its probability is exactly 0
            const float b = __ldg(bias + s);
            g_e1[(size_t)l * ld_s + s] = b > -1e8f ? e1 + b : b;
            if (DUAL) g_e2[(size_t)l * ld_s + s] = b > -1e8f ? e2 + b : b;
          }
        }
      }
    }
    sync();

    // ------------------------------ alignments and contexts -------------------
    // a block per (lane, CTX_COLS context columns): each computes the lane's
    // softmaxes and alignments itself (the first of a lane's blocks writes them out)
    // and its columns of ctx[col] = sum_s alpha[s] * memory[s][col], both sources
    // side by side
    {
      const LaneLayout L = lane_layout(d);
      float* s_e1 = work + L.e1;
      float* s_e2 = work + L.e2;
      float* s_alpha = work + L.alpha;
      float* s_tmp = work + L.tmp;
      float* s_cum = work + L.cum;
      float* s_part = work + L.part;
      const int nchunk = (EW + CTX_COLS - 1) / CTX_COLS;
      for (int unit = blk; unit < B * nchunk; unit += G) {
        const int l = unit / nchunk, c0 = (unit - l * nchunk) * CTX_COLS;
        const bool lead = c0 == 0;
        const size_t row = (size_t)l * ld_s;
        for (int s = tid; s < S; s += NT) {
          s_e1[s] = __ldcg(g_e1 + row + s);
          if (DUAL) s_e2[s] = __ldcg(g_e2 + row + s);
          s_alpha[s] = __ldcg(g_alpha + par * lane_half + row + s);
          if (LS && d.ls_cum) s_cum[s] = __ldcg(g_cum + par * lane_half + row + s);
        }
        // forward attention's transition factor, from the previous step's ctx1 and
        // query (0.5 at the first step, or without the agent)
        if (!LS && d.use_ta && t > 0) {
          if (warp == 0) {
            const IO* wt = w + d.off[TA_W];
            const IO* ctx = attin_p + (size_t)l * ld_attin + P2 + d.SPK;
            const IO* query = din_n + (size_t)l * ld_din;
            float acc = 0.0f;
            for (int i = lane; i < E1 + AU; i += 32)
              acc += Io<IO>::load(wt + i) * (i < E1 ? ldcg_f(ctx + i) : ldcg_f(query + (i - E1)));
            acc = warp_sum(acc);
            if (lane == 0) s_u = sigmoidf_(acc + Io<IO>::load(w + d.off[TA_B]));
          }
        } else if (tid == 0) {
          s_u = 0.5f;
        }
        __syncthreads();

        // source 1: y = softmax(e1)
        float m = -3.0e38f;
        for (int s = tid; s < S; s += NT) m = fmaxf(m, s_e1[s]);
        m = block_max(m, s_red);
        float sum = 0.0f;
        for (int s = tid; s < S; s += NT) {
          const float v = expf(s_e1[s] - m);
          s_e1[s] = v;
          sum += v;
        }
        sum = block_sum(sum, s_red);
        float* row1 = P.align1 + ((size_t)l * T + t) * S;
        if (LS) {
          // location-sensitive: the alignments are the softmax, the taps' next input
          for (int s = tid; s < S; s += NT) {
            const float v = s_e1[s] / sum;
            s_alpha[s] = v;
            if (lead) {
              g_alpha[(par ^ 1) * lane_half + row + s] = v;
              if (d.ls_cum) g_cum[(par ^ 1) * lane_half + row + s] = s_cum[s] + v;
              row1[s] = v;
            }
          }
        } else {
          // a_i(n) = ((1 - u) a_i(n-1) + u a_{i-1}(n-1) + 1e-6) y_i(n), renormalised
          const float u = s_u;
          float total = 0.0f;
          for (int s = tid; s < S; s += NT) {
            const float y = s_e1[s] / sum;
            const float shifted = s > 0 ? s_alpha[s - 1] : 0.0f;
            const float v = ((1.0f - u) * s_alpha[s] + u * shifted + 1e-6f) * y;
            s_tmp[s] = v;
            total += v;
          }
          total = block_sum(total, s_red);
          for (int s = tid; s < S; s += NT) {
            const float v = s_tmp[s] / total;
            s_alpha[s] = v;
            if (lead) {
              g_alpha[(par ^ 1) * lane_half + row + s] = v;
              row1[s] = v;
            }
          }
        }
        // source 2: a2 = softmax(e2)
        if (DUAL) {
          float m2 = -3.0e38f;
          for (int s = tid; s < S; s += NT) m2 = fmaxf(m2, s_e2[s]);
          m2 = block_max(m2, s_red);
          float sum2 = 0.0f;
          for (int s = tid; s < S; s += NT) {
            const float v = expf(s_e2[s] - m2);
            s_e2[s] = v;
            sum2 += v;
          }
          sum2 = block_sum(sum2, s_red);
          float* row2 = P.align2 + ((size_t)l * T + t) * S;
          for (int s = tid; s < S; s += NT) {
            const float v = s_e2[s] / sum2;
            s_e2[s] = v;
            if (lead) row2[s] = v;
          }
        }
        __syncthreads();

        // this block's context columns [c0, c0 + cw)
        const int cw = imin(CTX_COLS, EW - c0), nc4 = cw >> 2;
        int cparts = imax(1, imin(NT / nc4, (S + 7) / 8));
        const int span = (S + cparts - 1) / cparts;
        cparts = (S + span - 1) / span;
        for (int idx = tid; idx < cparts * nc4; idx += NT) {
          const int p = idx / nc4, c = idx - p * nc4;
          const int col = c0 + 4 * c;
          const bool second = DUAL && col >= E1;
          const int width = second ? E2 : E1;
          const IO* mem = second ? P.mem2 + (size_t)l * S * E2 + (col - E1)
                                 : P.mem1 + (size_t)l * S * E1 + col;
          const float* alpha = second ? s_e2 : s_alpha;
          const int s0 = p * span;
          const int s1 = imin(imin(s0 + span, S), s_hi[l]);
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          int s = s0;
          for (; s + 8 <= s1; s += 8) {
            float4 mv[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              mv[u] = Weights4<IO>::values(
                  __ldg(reinterpret_cast<const Vec*>(mem + (size_t)(s + u) * width)));
#pragma unroll
            for (int u = 0; u < 8; ++u) fma4(acc, alpha[s + u], mv[u]);
          }
          for (; s < s1; ++s)
            fma4(acc, alpha[s],
                 Weights4<IO>::values(__ldg(reinterpret_cast<const Vec*>(mem + (size_t)s * width))));
          *reinterpret_cast<float4*>(s_part + (size_t)p * cw + 4 * c) = acc;
        }
        __syncthreads();
        for (int j = tid; j < cw; j += NT) {
          float acc = 0.0f;
          for (int p = 0; p < cparts; ++p) acc += s_part[p * cw + j];
          const IO v = Io<IO>::from(acc);
          attin_n[(size_t)l * ld_attin + P2 + d.SPK + c0 + j] = v;   // next step's attention LSTM
          din_p[(size_t)l * ld_din + AU + c0 + j] = v;               // [query | ctx1 | ctx2 | h1]
        }
        __syncthreads();
      }
    }
    sync();

    // ------------------------------ decoder LSTMs ------------------------------
    product(sw + sl[PR_L1].off, sl[PR_L1], KD1, true, B, tile, work_bytes, 0, copied(),
            rows_of(din_p, ld_din),
            [&](int l, int u, float zi, float zg, float zf, float zo) {
              const IO h = Io<IO>::from(lstm(g_c1, g_h1, ld_du, PR_L1, l, u,
                                             zi, zg, zf, zo));
              din2_p[(size_t)l * ld_din2 + u] = h;
              din_n[(size_t)l * ld_din + (KD1 - DU) + u] = h;
            });
    sync();
    // feature = h2 + h1
    product(sw + sl[PR_L2].off, sl[PR_L2], 2 * DU, true, B, tile, work_bytes, 0, copied(),
            rows_of(din2_p, ld_din2),
            [&](int l, int u, float zi, float zg, float zf, float zo) {
              const float h = lstm(g_c2, g_h2, ld_du, PR_L2, l, u, zi, zg, zf, zo);
              din2_n[(size_t)l * ld_din2 + DU + u] = Io<IO>::from(h);
              g_feat[(size_t)l * ld_feat + u] = Io<IO>::from(h + __ldcg(g_h1 + (size_t)l * ld_du + u));
            });
    sync();

    // ------------------------------ self-attention block -----------------------
    if (USE_SA) {
      product(sw + sl[PR_IN].off, sl[PR_IN], DU, false, B, tile, work_bytes, 0, copied(),
              rows_of(g_feat, ld_feat),
              [&](int l, int j, float v, float, float, float) {
                const double angle = (double)t * P.pe_rate[j];
                const float pe = (float)((j & 1) ? cos(angle) : sin(angle));
                g_xs[(size_t)l * ld_sa4 + j] = v + bias_of(PR_IN, j) + pe;
              });
      sync();
      // LayerNorm of a lane's row (float, staged in shared memory), a warp per lane,
      // rounded to the io type
      auto layer_norm_rows = [&](const float* src, const float* scale, const float* shift) {
        return [&, src, scale, shift](IO* tl, int ld, int l0, int lc, float* stage) {
          copy_rows<float>(stage, ld_sa4, src, ld_sa4, l0, lc, &s_bar, bar_phase);
          for (int r = warp; r < lc; r += NWARPS) {
            IO* row = tl + r * ld;
            const float* x = stage + r * ld_sa4;
            // eight values a lane in flight at a time, in both passes
            float sum = 0.0f;
            for (int j0 = 0; j0 < SA; j0 += 256) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int j = j0 + lane + 32 * i;
                sum += j < SA ? x[j] : 0.0f;
              }
            }
            const float mean = warp_sum(sum) / (float)SA;
            float sq = 0.0f;
            for (int j0 = 0; j0 < SA; j0 += 256) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int j = j0 + lane + 32 * i;
                const float c = j < SA ? x[j] - mean : 0.0f;
                sq += c * c;
              }
            }
            const float sd = sqrtf(warp_sum(sq) / (float)SA + sc.ln_eps);
            for (int j = lane; j < ld; j += 32)
              row[j] = Io<IO>::from(j < SA ? (x[j] - mean) / sd * scale[j] + shift[j] : 0.0f);
          }
        };
      };
      product(sw + sl[PR_QKV].off, sl[PR_QKV], SA, false, B, tile, work_bytes, ld_sa4, copied(),
              layer_norm_rows(g_xs, s_ln, s_ln + ld_ln),
              [&](int l, int j, float v, float, float, float) {
                if (j < SA) g_q[(size_t)l * ld_sa4 + j] = v / sc.sqrt_hd;
                else if (j < 2 * SA) P.kcache[((size_t)l * SA + (j - SA)) * T4 + t] = Io<IO>::from(v);
                else P.vcache[((size_t)l * T + t) * SA + (j - 2 * SA)] = Io<IO>::from(v);
              });
      sync();

      // attention over the prefix 0..t, a block per (lane, head), SA_TILE positions at a time
      {
        const SaLayout L = sa_layout(d);
        float* s_q = work + L.q;
        float* s_acc = work + L.acc;
        float* s_logit = work + L.logit;
        float* s_part = work + L.part;
        const int n_all = t + 1;
        const int ntiles = (n_all + SA_TILE - 1) / SA_TILE;
        for (int unit = blk; unit < B * H; unit += G) {
          const int l = unit / H, h = unit - l * H;
          for (int i = tid; i < HD; i += NT) s_q[i] = __ldcg(g_q + (size_t)l * ld_sa4 + h * HD + i);
          __syncthreads();
          for (int tile_i = 0; tile_i < ntiles; ++tile_i) {
            const int p0 = tile_i * SA_TILE;
            const int np = imin(SA_TILE, n_all - p0);
            // logits[p] = sum_d q[d] * K[l][h][d][p0 + p], four positions a thread
            {
              const int n4 = (np + 3) >> 2;
              int lparts = imax(1, imin(NT / n4, (HD + 7) / 8));
              const int chunk = (HD + lparts - 1) / lparts;
              lparts = (HD + chunk - 1) / chunk;
              const int t4 = T4 >> 2;
              for (int idx = tid; idx < lparts * n4; idx += NT) {
                const int p = idx / n4, p4 = idx - p * n4;
                const int d0 = p * chunk, d1 = imin(d0 + chunk, HD);
                const Vec* kp = reinterpret_cast<const Vec*>(
                                    P.kcache + ((size_t)l * SA + h * HD + d0) * T4 + p0) + p4;
                float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
                int dd = d0;
                for (; dd + 8 <= d1; dd += 8) {
                  float4 k[8];
#pragma unroll
                  for (int u = 0; u < 8; ++u) k[u] = Weights4<IO>::values(__ldcg(kp + (size_t)u * t4));
                  kp += (size_t)8 * t4;
#pragma unroll
                  for (int u = 0; u < 8; ++u) fma4(acc, s_q[dd + u], k[u]);
                }
                for (; dd < d1; ++dd) {
                  fma4(acc, s_q[dd], Weights4<IO>::values(__ldcg(kp)));
                  kp += t4;
                }
                *reinterpret_cast<float4*>(s_part + (size_t)p * n4 * 4 + p4 * 4) = acc;
              }
              __syncthreads();
              // the softmax over the tile, every thread taking positions of its own
              float m = -3.0e38f;
              for (int p = tid; p < np; p += NT) {
                float v = 0.0f;
                for (int pp = 0; pp < lparts; ++pp) v += s_part[(size_t)pp * n4 * 4 + p];
                s_logit[p] = v;
                m = fmaxf(m, v);
              }
              m = block_max(m, s_red);
              // one tile: the plain softmax; more: online, rescaling what the earlier
              // tiles summed
              const float m_old = ntiles == 1 || tile_i == 0 ? -3.0e38f : s_stat[0];
              const float m_new = fmaxf(m_old, m);
              float sum = 0.0f;
              for (int p = tid; p < np; p += NT) {
                const float v = expf(s_logit[p] - m_new);
                s_logit[p] = v;
                sum += v;
              }
              sum = block_sum(sum, s_red);
              if (ntiles == 1) {
                for (int p = tid; p < np; p += NT) s_logit[p] = s_logit[p] / sum;
              } else if (tid == 0) {
                const float scale = tile_i == 0 ? 0.0f : expf(m_old - m_new);
                s_stat[1] = (tile_i == 0 ? 0.0f : s_stat[1] * scale) + sum;
                s_stat[0] = m_new;
                s_stat[2] = scale;
              }
              __syncthreads();
            }
            // attn[d] (+)= sum_{p < np} probs[p] * V[l][p0 + p][h * HD + d]
            {
              const int nc4 = HD >> 2;
              int vparts = imax(1, imin(NT / nc4, (np + 7) / 8));
              const int chunk = (np + vparts - 1) / vparts;
              vparts = (np + chunk - 1) / chunk;
              for (int idx = tid; idx < vparts * nc4; idx += NT) {
                const int p = idx / nc4, c = idx - p * nc4;
                const int q0 = p * chunk, q1 = imin(q0 + chunk, np);
                const Vec* vp = reinterpret_cast<const Vec*>(
                                    P.vcache + ((size_t)l * T + p0 + q0) * SA + h * HD) + c;
                const int stride = SA >> 2;
                float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
                int pos = q0;
                for (; pos + 8 <= q1; pos += 8) {
                  float4 v[8];
#pragma unroll
                  for (int u = 0; u < 8; ++u) v[u] = Weights4<IO>::values(__ldcg(vp + (size_t)u * stride));
                  vp += (size_t)8 * stride;
#pragma unroll
                  for (int u = 0; u < 8; ++u) fma4(acc, s_logit[pos + u], v[u]);
                }
                for (; pos < q1; ++pos) {
                  fma4(acc, s_logit[pos], Weights4<IO>::values(__ldcg(vp)));
                  vp += stride;
                }
                *reinterpret_cast<float4*>(s_part + (size_t)p * HD + 4 * c) = acc;
              }
              __syncthreads();
              const bool last = tile_i == ntiles - 1;
              for (int j = tid; j < HD; j += NT) {
                float v = 0.0f;
                for (int p = 0; p < vparts; ++p) v += s_part[p * HD + j];
                if (ntiles > 1) {
                  if (tile_i > 0) v += s_acc[j] * s_stat[2];
                  if (last) v /= s_stat[1];
                }
                if (last) g_attn[(size_t)l * ld_sa8 + h * HD + j] = Io<IO>::from(v);
                else s_acc[j] = v;
              }
              __syncthreads();
            }
          }
        }
      }
      sync();

      product(sw + sl[PR_O].off, sl[PR_O], SA, false, B, tile, work_bytes, 0, copied(),
              rows_of(g_attn, ld_sa8),
              [&](int l, int j, float v, float, float, float) {
                g_xs2[(size_t)l * ld_sa4 + j] =
                    __ldcg(g_xs + (size_t)l * ld_sa4 + j) + (v + bias_of(PR_O, j));
              });
      sync();
      product(sw + sl[PR_F1].off, sl[PR_F1], SA, false, B, tile, work_bytes, ld_sa4, copied(),
              layer_norm_rows(g_xs2, s_ln + 2 * ld_ln, s_ln + 3 * ld_ln),
              [&](int l, int j, float v, float, float, float) {
                g_f1[(size_t)l * ld_f1 + j] =
                    Io<IO>::from(fmaxf(v + bias_of(PR_F1, j), 0.0f));
              });
      sync();
      product(sw + sl[PR_F2].off, sl[PR_F2], FFN, false, B, tile, work_bytes, 0, copied(),
              rows_of(g_f1, ld_f1),
              [&](int l, int j, float v, float, float, float) {
                g_y[(size_t)l * ld_sa8 + j] = Io<IO>::from(
                    __ldcg(g_xs2 + (size_t)l * ld_sa4 + j) + v + bias_of(PR_F2, j));
              });
      sync();
    }  // USE_SA

    // ------------------------------ output rows --------------------------------
    // from the block's output, or without self-attention from the feature itself
    product(sw + sl[PR_OUT].off, sl[PR_OUT], USE_SA ? SA : DU, false, B, tile, work_bytes, 0, copied(),
            USE_SA ? rows_of(g_y, ld_sa8) : rows_of(g_feat, ld_feat),
            [&](int l, int j, float v, float, float, float) {
              v += bias_of(PR_OUT, j);
              const size_t row = (size_t)l * T + t;
              if (j < RM) {
                P.frames[row * RM + j] = v;
                if (j >= RM - M) g_feed[(size_t)l * ld_feed + (j - (RM - M))] = v;   // fed back
              } else {
                P.stops[row * R + (j - RM)] = sigmoidf_(v);
              }
            });
    sync();

    // ------------------------------ stop tracking and exit ---------------------
    // every block keeps every lane's state, from the same stop probabilities
    steps = t + 1;
    int done = 1;
    for (int l = tid; l < B; l += NT) {
      if (!s_fin[l]) {
        int first = -1;
        for (int r = R - 1; r >= 0; --r)
          if (__ldcg(P.stops + ((size_t)l * T + t) * R + r) > sc.stop_threshold) first = r;
        if (first >= 0) {
          s_len[l] = t * R + first + 1;
          s_fin[l] = 1;
        } else {
          done = 0;
        }
      }
    }
    if (__syncthreads_and(done) && d.early_exit) break;
  }

  if (blk == 0) {
    for (int l = tid; l < B; l += NT) {
      P.lengths[l] = s_fin[l] ? s_len[l] : steps * R;   // never fired: to the last step
      P.finished[l] = (unsigned char)s_fin[l];
    }
    if (tid == 0) P.info[0] = steps;
  }
}

bool sizes_ok(const Dims& d) {
  if (d.B <= 0 || d.B > MAX_LANES || d.S <= 0 || d.T <= 0 || d.M <= 0 || d.R <= 0 || d.P1 <= 0 ||
      d.P2 <= 0 || d.SPK < 0 || d.AU <= 0 || d.A1 <= 0 || d.DU <= 0 || d.E1 <= 0 ||
      d.E1 % 4 != 0)
    return false;
  // two sources (E2 > 0): a second mechanism and memory; one source: neither
  const bool sources = (d.A2 > 0) == (d.E2 > 0) && d.E2 % 4 == 0;
  const bool block = d.SA == 0 ||
                     (d.SA > 0 && d.H > 0 && d.FFN > 0 && d.SA % d.H == 0 && (d.SA / d.H) % 4 == 0);
  // location-sensitive: an odd number of taps up to LS_TAPS, no transition agent,
  // and one of the two pairs of flags it is compiled for
  const bool ls = d.K == 0 || (d.K > 0 && d.K <= LS_TAPS && d.K % 2 == 1 && d.use_ta == 0 &&
                               (d.E2 > 0) == (d.SA > 0));
  // the lf0 lanes of a frame: none (the mel head) or a tail of at least one lane,
  // with forward attention
  const bool lf0 = d.LF0 == 0 || (d.LF0 > 0 && d.LF0 < d.M && d.K == 0);
  return sources && block && ls && lf0;
}

template <typename IO>
using Kernel = void (*)(const Ptrs<IO>, const Dims, const Scalars, const Held);

template <bool LF0, typename IO>
Kernel<IO> forward_kernel(bool dual, bool use_sa) {
  if (dual) {
    return use_sa ? fused_decode_kernel<true, true, false, LF0, false, IO>
                  : fused_decode_kernel<true, false, false, LF0, false, IO>;
  }
  return use_sa ? fused_decode_kernel<false, true, false, LF0, false, IO>
                : fused_decode_kernel<false, false, false, LF0, false, IO>;
}

// The kernel compiled for the specialisation of `d`'s widths, with io type IO; null
// for location-sensitive attention on a pair of flags it is not compiled for, or
// with the lf0 feedback. The stamps of a step (stamp_step >= 0) are compiled into
// the flagship's structure alone (two sources, self-attention, forward attention,
// the mel head): every instantiation a request runs has no stamp code, which
// cost 2-5 % even with a null pointer (PERF.md, PR 10).
template <typename IO>
Kernel<IO> kernel_for(const Dims& d) {
  const bool dual = d.E2 > 0, use_sa = d.SA > 0;
  if (d.stamp_step >= 0)
    return dual && use_sa && d.K == 0 && d.LF0 == 0
               ? fused_decode_kernel<true, true, false, false, true, IO> : nullptr;
  if (d.K > 0) {
    if (d.LF0 > 0) return nullptr;
    if (dual && use_sa) return fused_decode_kernel<true, true, true, false, false, IO>;
    if (!dual && !use_sa) return fused_decode_kernel<false, false, true, false, false, IO>;
    return nullptr;
  }
  return d.LF0 > 0 ? forward_kernel<true, IO>(dual, use_sa) : forward_kernel<false, IO>(dual, use_sa);
}

const void* kernel_address(const Dims& d) {
  return d.bf16 ? (const void*)kernel_for<__nv_bfloat16>(d) : (const void*)kernel_for<float>(d);
}

// Dynamic shared memory one block may have on the current device (what a block can
// opt in to, less what the kernel declares statically) and the device's SM count;
// a CUDA error code, or 0.
int device_limits(const Dims& d, long long* have, int* sms) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  cudaFuncAttributes attr;
  const void* kernel = kernel_address(d);
  if (err == cudaSuccess && kernel == nullptr) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *have = (long long)optin - (long long)attr.sharedSizeBytes;
  return 0;
}

template <typename IO>
int launch(const Ptrs<IO>& P, const Dims& d, const Scalars& sc, cudaStream_t stream) {
  const Kernel<IO> kernel = kernel_for<IO>(d);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  long long have = 0;
  int sms = 0;
  int err = device_limits(d, &have, &sms);
  if (err != 0) return err;
  const Held held = plan_held(d, sms);
  const Smem sm = smem_layout(d, held, d.B);
  if ((long long)sm.work + sm.min_work > have) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)imin((int)smem_want(d, sms), (int)have);
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // the grid barriers need every block resident: a launch that cannot have that
  // is refused here instead of waiting forever
  Ptrs<IO> p = P;
  Dims dd = d;
  Scalars s = sc;
  Held h = held;
  void* args[] = {(void*)&p, (void*)&dd, (void*)&s, (void*)&h};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms), dim3(NT), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename IO>
Ptrs<IO> pointers(const void* const* ptr) {
  Ptrs<IO> P;
  P.w = (const IO*)ptr[0];
  P.w32 = (const float*)ptr[1];
  P.pe_rate = (const double*)ptr[2];
  P.keys = (const IO*)ptr[3];
  P.mem1 = (const IO*)ptr[4];
  P.mem2 = (const IO*)ptr[5];
  P.bias = (const float*)ptr[6];
  P.spk = (const IO*)ptr[7];
  P.mask1 = (const unsigned char*)ptr[8];
  P.mask2 = (const unsigned char*)ptr[9];
  P.kcache = (IO*)ptr[10];
  P.vcache = (IO*)ptr[11];
  P.frames = (float*)ptr[12];
  P.stops = (float*)ptr[13];
  P.align1 = (float*)ptr[14];
  P.align2 = (float*)ptr[15];
  P.lengths = (int*)ptr[16];
  P.finished = (unsigned char*)ptr[17];
  P.info = (int*)ptr[18];
  P.scratch = (unsigned char*)ptr[19];
  P.stamps = (long long*)ptr[20];
  return P;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at the least, in bytes, for these sizes and
// io type on a grid of `grid` blocks, whatever the lane count (up to the most lanes
// a launch takes); it does not grow with T.
long long fused_decode_smem_bytes(const int* dims, int grid) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  return (long long)smem_need(d, grid);
}

// Dynamic shared memory one block of the kernel (of the specialisation and io
// type `dims` names) may have on the current device, in bytes: what a block can
// opt in to, less what the kernel declares statically. Negative: minus the CUDA
// error code.
long long fused_decode_smem_limit(const int* dims) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  long long have = 0;
  int sms = 0;
  const int err = device_limits(d, &have, &sms);
  return err != 0 ? -(long long)err : have;
}

// Bytes of the scratch buffer a launch of these sizes reads and writes (zeroed by
// the caller).
long long fused_decode_scratch_bytes(const int* dims) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  return (long long)scratch_layout(d).total;
}

// One launch. `ptrs` holds the 21 device pointers in the order of the Ptrs struct
// (w, w32, pe_rate, keys, mem1, mem2, bias, spk, mask1, mask2, kcache, vcache,
// frames, stops, align1, align2, lengths, finished, info, scratch, stamps); the io
// type is dims' bf16 flag.
int fused_decode_launch(const void* const* ptrs, const int* dims, const float* scalars,
                        void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  Scalars sc;
  std::memcpy(&sc, scalars, sizeof(Scalars));
  if (!sizes_ok(d)) return (int)cudaErrorInvalidValue;
  if (d.use_masks && (ptrs[8] == nullptr || ptrs[9] == nullptr)) return (int)cudaErrorInvalidValue;
  if (d.SPK > 0 && ptrs[7] == nullptr) return (int)cudaErrorInvalidValue;
  if (d.E2 > 0 && (ptrs[5] == nullptr || ptrs[15] == nullptr)) return (int)cudaErrorInvalidValue;
  if (d.SA > 0 && (ptrs[2] == nullptr || ptrs[10] == nullptr || ptrs[11] == nullptr))
    return (int)cudaErrorInvalidValue;
  if (d.SPK == 0 && ptrs[7] != nullptr) return (int)cudaErrorInvalidValue;
  if (ptrs[19] == nullptr) return (int)cudaErrorInvalidValue;
  if (d.bf16) return launch(pointers<__nv_bfloat16>(ptrs), d, sc, (cudaStream_t)stream);
  return launch(pointers<float>(ptrs), d, sc, (cudaStream_t)stream);
}

}  // extern "C"
