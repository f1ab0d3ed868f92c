// The teacher-forced decoder scan of the flagship, forward and backward, one
// launch each.
//
// Replaces the two Pallas kernels of self_attention_tacotron_tpu/ops/fused_teacher.py
// (_run_fwd with _make_fwd_kernel, _run_bwd with _make_bwd_kernel).
//
// Forward, per decoder step t and lane, from the prenet's output row x2[t]
// (the prenet is outside: its inputs are the known teacher frames):
//
//   attention ZoneoutLSTM on [x2 | speaker | ctx1 | ctx2 | h_att]      (gates i, g, f, o)
//   qp = h_att . Wqp                    (both mechanisms' query projections at once)
//   e_i = sum_a tanh(keys_cat + qp) * vblk[i], + score bias (-1e9 where padded)
//   source 1: y = softmax(e1);  a = ((1 - u) a + u shift(a) + 1e-6) y, renormalised
//             u = sigmoid(Wta . [ctx1, h_att] + b) with the transition agent, else 0.5
//   source 2: a2 = softmax(e2);  contexts ctx_i = a_i . memory_i
//   two ZoneoutLSTMs, feature = h1 + h2
//
// Both kernels are compiled for DUAL (the two sources above) and for one source,
// the baseline's single forward attention: there Wqp is the mechanism's own query
// layer, vblk has one column, and there is no second key, memory, context or
// alignment (E2 = A2 = 0, alignment rows of S instead of 2S); each of those for
// location-sensitive attention on source 1 (LS, K > 0) as well: the first A1
// columns of the tanh's argument add loc[s] = sum_k prev[s + k - K/2] . Wls[k] + bls,
// prev the cumulative alignments before the step (kept in the carry row, so that
// the backward need not subtract) or the previous alignments, a = y = softmax(e1)
// starting uniform, Wls (K rows zero-padded to LS_TAPS) in shared memory and the
// features formed inside the score pass (location.cuh), never stored; and each of
// those for two io types, float and bfloat16 (IO). IO is the type of the weights, the
// feeds, keys, memories and speaker embedding, and of the gradient rows. With
// bfloat16 the kernels round where the Pallas kernels cast to their io_dtype:
// forward, the input of every product (the attention LSTM's input, the query,
// the transition agent's input, both decoder LSTMs' inputs); backward, the
// cotangent entering every product with a transposed weight (the three gate
// pre-activations', the transition agent's, g_qp), and the gradient row as it is
// stored. The LSTM states live in float beside their rounded copies; everything
// else stays float: the products' sums, states, scores, softmaxes, the recursion,
// contexts, the carry and activation rows, the running sum the bias gradients
// come from, d_keys, d_vblk and d_spk. The forward's scores use vblk rounded in
// the io buffer, the backward's the float score vectors (v32), as the Pallas
// kernels read vblk and vcol1 / vcol2.
//
// Zoneout keeps the previous state where a keep mask says so. In training the
// mask of (step, draw, lane, unit) is a counter-based hash (murmur3 finalizer)
// of the seed, so that the backward regenerates it and nothing random is stored;
// in evaluation it is the constant zoneout factor. Every step writes its feature
// and alignment rows, one carry row (states, contexts, alignment, u) and one
// activation row (the three gate pre-activations, qp, y, a2) to global memory.
//
// Backward: the adjoint chain t = N-1 .. 0. It reads carry rows t-1 and t and the
// activation row in place, regenerates the masks, and recomputes one tensor, the
// (S, A) score tanh, in the same pass that adds its cotangent to d_keys, reduces
// it over s into g_qp and reduces g_e . tanh into this lane's d_vblk partial: the
// tensor is never held. It exports one gradient row per step (the cotangents of
// the three gate pre-activations, of x2, qp, both contexts and the transition
// agent's pre-activation), from which the wrapper forms every weight gradient as
// one batched product, and adds each row to a per-lane float32 running sum that
// gives the bias gradients. Every value that is summed over the steps (d_keys,
// d_spk, the running sum, the per-lane partials of d_vblk and d_Wls) has one owner
// thread for the whole launch, which adds its step's share in a fixed order, so
// nothing is atomic and two launches on the same inputs give the same bits; the
// wrapper sums the per-lane partials. LS: the score pass also recomputes the
// location features from the carried alignments and stores the step's rounded
// cotangent of source 1's columns before the tanh, g (S, A1), in a scratch row per
// lane; then d_Wls[k][a] += sum_s taps[s][k] g[s][a] into a float partial per lane,
// G = g . Wls^T (S, LS_TAPS) into a second scratch, and the taps' adjoint g_prev[p]
// = sum_k G[p - k + K/2][k] onto the carried alignment's cotangent (cumulative: on
// top of it, the identity path; previous alignments: instead of it). bls's gradient
// is g_qp's first A1 columns, summed by the wrapper.
//
// What bounds both on an H100 is the serial chain of a step's dependent stages,
// not bytes or operations: at the flagship's widths a step needs about 2 * 2.5 M
// * B operations and the weights are 10 MB in float32. The design is that of
// fused_decode.cu (grid.cuh): one block per SM, all resident at once (a
// cooperative launch), walks all the steps; each block holds, for the whole
// launch, its slice of every matrix of its direction in shared memory (whole
// output columns; of an LSTM's gate product whole units, the four gate columns of
// a unit side by side; the backward's slices come from the transposed copies), so
// that no weight is read from L2 after the launch's start; a narrow product goes
// to as few blocks as give each eight columns. A product stage copies the lanes'
// input rows into shared memory with the Tensor Memory Accelerator, as many lanes
// at a time as the block's room holds, and every block computes its columns for
// every lane (grid.cuh::product). Between two dependent stages the blocks meet at
// a grid barrier. Per-lane rows and states live in a scratch buffer in global
// memory (L2); a row that a stage both reads and feeds is double-buffered by the
// step's parity. Forward, five barriers a step: the attention LSTM (its
// pointwise update in the product's epilogue), qp, the scores (a warp per lane and
// run of positions over the whole grid, the location features formed there), the
// alignments and contexts (a block per lane and CTX_COLS context columns, the
// source in tiles of ATT_TILE positions), the first decoder LSTM (with the
// transition factor for the next step), the second. Backward, five (six with LS):
// L2^T, whose epilogue runs the first decoder LSTM's pointwise adjoint of step t
// and the second's of step t-1 (the only cotangent either still needs is that
// column of the product), L1^T (with the transition agent's adjoint), the
// alignments' cotangents g_ctx . memory (a warp per lane and two positions), the
// score adjoint (a block per lane and run of columns, which computes the lane's
// softmax and recursion adjoints itself, tile by tile), with LS the two tap passes,
// qp^T (with the attention LSTM's pointwise adjoint), then ATTG^T. The last stage of
// a step needs no barrier: nothing the next step's first stage reads comes from it.
//
// With stamp_step >= 0 (the STAMPS instantiations, of the flagship's structure in
// float alone), block 0 writes %globaltimer into P.stamps at the start of that step
// and, for each stage, when its input rows are in shared memory (product stages),
// at its arrival at the stage's barrier and at its departure.
//
// Plain C interface at the bottom: the functions launch on the given stream,
// allocate nothing, do not synchronise, and return the CUDA error code.

#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "dense.cuh"
#include "grid.cuh"
#include "location.cuh"
#include "parts.cuh"

// the entry of instantiation `variant` (its flags as bits, `variant_of`) in the table
extern "C" SATT_HIDDEN void fused_teacher_enrol(int variant, const void* kernel);

namespace {

constexpr int NT = GRID_NT;
constexpr int NWARPS = GRID_NWARPS;
// Source positions of the attention stages' tiles: the rows of a source of up to
// this many positions stay in shared memory for the whole stage.
constexpr int ATT_TILE = 512;
// Context columns one block of the forward's alignment stage takes.
constexpr int CTX_COLS = 128;

// Order of the entries in the flat weight buffer (ops/fused_teacher.py::_ENTRIES).
enum Entry {
  ATTG_W, ATTG_B, QP_W, VBLK, TA_W, TA_B, L1_W, L1_B, L2_W, L2_B,
  ATTG_WT, QP_WT, L1_WT, L2_WT, LS_W, NUM_ENTRIES
};
// Fields of the three per-step rows (ops/fused_teacher.py::_CARRY, _ACTS, _STACK).
enum Carry {
  C_CATT, C_HATT, C_C1, C_H1, C_C2, C_H2, C_CTX1, C_CTX2, C_ALPHA, C_CUM, C_U, NUM_CARRY
};
enum Acts { A_ZATT, A_Z1, A_Z2, A_QP, A_Y1, A_ALPHA2, NUM_ACTS };
enum Stack { G_ZATT, G_Z1, G_Z2, G_FEED, G_QP, G_CTX1, G_CTX2, G_UPRE, NUM_STACK };

// Sizes, flags, row widths and offsets (in values), in the order the wrapper writes
// them; K > 0: location-sensitive attention with K taps, ls_cum over the cumulative
// alignments; bf16: the io type; stamp_step: the step whose stages P.stamps times
// (-1: none).
struct Dims {
  int B, S, N;
  int P2, SPK, AU, A1, A2, DU, E1, E2, K;
  int use_ta, train_masks, ls_cum, bf16, stamp_step;
  int CW, AW, SW;
  int carry[NUM_CARRY], acts[NUM_ACTS], stack[NUM_STACK];
  int off[NUM_ENTRIES];
};

struct Scalars {
  float zc, zo, forget_bias;
};

// Keep thresholds of the mask hash, the seed, the draw number of every (cell, c
// or h) mask within a step (c then h per cell, kinds at factor 0 skipped), and the
// global index of lane 0 (a data-parallel rank's first row; 0 on one device).
struct Bits {
  unsigned thr_c, thr_h, seed;
  unsigned draw[6];
  unsigned lane0;
};

template <typename IO>
struct Ptrs {
  const IO* w;
  const IO* feeds;        // (B, N, P2) the prenet's output
  const IO* keys;         // (B, S, A1 + A2)
  const IO* mem1;         // (B, S, E1)
  const IO* mem2;         // (B, S, E2)
  const float* bias;      // (B, S)
  const IO* spk;          // (B, SPK) or null
  float* features;        // (B, N, DU)
  float* aligns;          // (B, N, 2S), (B, N, S) with one source
  float* carry;           // (B, N, CW)
  float* acts;            // (B, N, AW)
  // backward only
  const float* g_feat;    // (B, N, DU)
  const float* g_align;   // as aligns, or null
  IO* stack;              // (B, N, SW)
  float* d_keys;          // (B, S, A1 + A2), zero on entry
  float* d_vblk;          // (B, 2 or 1, A1 + A2) one partial per lane, zero on entry
  float* d_spk;           // (B, SPK), zero on entry
  float* d_brow;          // (B, SW), zero on entry
  const float* v32;       // (2 or 1, A1 + A2 padded to 4) the score vectors, float
  // location-sensitive only (placeholders otherwise); the last three backward only
  const float* ls_b;      // (A1,) the location bias, float
  float* d_lsw;           // (B, LS_TAPS, A1 padded to 4) per-lane partials, zero on entry
  float* ls_g;            // (B, S, A1 padded to 4) scratch, zero on entry
  float* ls_gk;           // (B, S, LS_TAPS) scratch
  // both
  unsigned char* scratch; // scratch_layout(d, backward).total bytes, zero on entry
  long long* stamps;      // null, or 1 + 3 x stages values: the step's start, then
                          // (rows copied, arrival, departure) a stage
};

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// How much of the previous state unit (row, col) of a (., width) state keeps; row
// is the global lane.
__device__ __forceinline__ float keep_old(int train, unsigned step_seed, unsigned draw,
                                          unsigned threshold, float factor, unsigned row,
                                          int col, int width) {
  if (!train || factor <= 0.0f) return factor;
  const unsigned base = step_seed * 0x9E3779B9u + draw * 0x85EBCA6Bu;
  const unsigned idx = row * (unsigned)width + (unsigned)col;
  return mix32(base + idx * 0xC2B2AE35u) < threshold ? 1.0f : 0.0f;
}

// ------------------------------ the plan -------------------------------------

// The products of a step in the order they run: the forward's, and the backward's
// with the transposed weights.
enum FwdProduct { FP_ATTG, FP_QP, FP_L1, FP_L2 };
enum BwdProduct { BP_L2T, BP_L1T, BP_QPT, BP_ATTGT };
constexpr int NUM_PRODUCTS = 4;

struct ProductShape {
  int K, items, gates, entry;   // items: output columns, or with gates units of 4 columns
};

__host__ __device__ inline ProductShape product_shape(const Dims& d, bool backward, int p) {
  const int A = d.A1 + d.A2, EW = d.E1 + d.E2;
  const int KA = d.P2 + d.SPK + EW + d.AU, KD1 = d.AU + EW + d.DU;
  ProductShape s;
  s.gates = 0;
  if (!backward) {
    switch (p) {
      case FP_ATTG: s.K = KA; s.items = d.AU; s.gates = 1; s.entry = ATTG_W; break;
      case FP_QP: s.K = d.AU; s.items = A; s.entry = QP_W; break;
      case FP_L1: s.K = KD1; s.items = d.DU; s.gates = 1; s.entry = L1_W; break;
      default: s.K = 2 * d.DU; s.items = d.DU; s.gates = 1; s.entry = L2_W; break;
    }
  } else {
    switch (p) {
      case BP_L2T: s.K = 4 * d.DU; s.items = 2 * d.DU; s.entry = L2_WT; break;
      case BP_L1T: s.K = 4 * d.DU; s.items = KD1; s.entry = L1_WT; break;
      case BP_QPT: s.K = A; s.items = d.AU; s.entry = QP_WT; break;
      default: s.K = 4 * d.AU; s.items = KA; s.entry = ATTG_WT; break;
    }
  }
  return s;
}

// What a block holds for the launch: weight values (io type) and bias floats.
struct Held {
  int weights, biases;
};

// The blocks a product's items are dealt to: as few as give each at least 8 columns
// (2 units of a gate product), as long as one block's slice stays within SLICE_BYTES;
// a wide product goes to every block (fused_decode.cu::product_blocks).
constexpr int SLICE_BYTES = 8192;
__host__ __device__ inline int product_blocks(const Dims& d, const ProductShape& ps, int G) {
  const int item_bytes = (ps.gates ? 4 : 1) * r8(ps.K) * (d.bf16 ? 2 : 4);
  const int per = imax(1, imin(ps.gates ? 2 : 8, SLICE_BYTES / imax(item_bytes, 1)));
  return imin(G, imax(1, (ps.items + per - 1) / per));
}

// Block b's slices of a grid of G blocks, and what it holds: weight values of the
// io type (a multiple of 8) and, forward, bias floats (each product's a multiple of
// 4; the query projection's are 0). A slice is its columns, each r8(K) values (k
// minor, zero beyond K). Product p's items go to product_blocks of them, in
// contiguous runs from block `start` on; the next product starts where this one's
// blocks end (or, on every block, where its remainder ends).
// ops/fused_teacher.py::teacher_grid_plan is the same formula.
__host__ __device__ inline Held plan_block(const Dims& d, bool backward, int G, int b, Slice* s) {
  int start = 0;
  Held h = {0, 0};
  for (int p = 0; p < NUM_PRODUCTS; ++p) {
    const ProductShape ps = product_shape(d, backward, p);
    const int Gp = product_blocks(d, ps, G);
    const int r = (b - start + G) % G;
    Share sh = {0, 0};
    if (r < Gp) sh = share_of(ps.items, Gp, 0, r);
    s[p].first = sh.first;
    s[p].count = sh.count;
    s[p].cols = ps.gates ? 4 * sh.count : sh.count;
    s[p].off = h.weights;
    s[p].boff = h.biases;
    h.weights = r8(h.weights + s[p].cols * r8(ps.K));
    if (!backward) h.biases += r4(s[p].cols);
    start = (start + (Gp < G ? Gp : ps.items % G)) % G;
  }
  return h;
}

// The most any block of the grid holds.
__host__ __device__ inline Held plan_held(const Dims& d, bool backward, int G) {
  Slice s[NUM_PRODUCTS];
  Held most = {0, 0};
  for (int b = 0; b < G; ++b) {
    const Held h = plan_block(d, backward, G, b, s);
    most.weights = imax(most.weights, h.weights);
    most.biases = imax(most.biases, h.biases);
  }
  return most;
}

__host__ __device__ inline int widest_k(const Dims& d, bool backward) {
  int k = 0;
  for (int p = 0; p < NUM_PRODUCTS; ++p) k = imax(k, r8(product_shape(d, backward, p).K));
  return k;
}

// Floats of the work region in the attention stages (the region is reused by every
// stage in turn). Forward, a block of the alignment stage holds the first ATT_TILE
// positions of its lane's scores, previous and cumulative alignments, one tile of
// each source's new alignments and the context sums; backward, a block of the score
// adjoint holds the first ATT_TILE positions of its lane's alignment cotangents,
// softmaxes, alignments and previous alignments, one tile of each source's score
// cotangents, and the partial sums of its columns.
__host__ __device__ inline int lane_floats(bool backward) {
  return backward ? 8 * ATT_TILE + 3 * NT : 6 * ATT_TILE + imax(4 * NT, CTX_COLS);
}

// Byte offsets of a block's dynamic shared memory: its weight slices (io type),
// their biases (float), the folded location matrix (LS, float), then the work
// region: the product stages' input rows or the attention stages' rows.
struct Smem {
  int bias, lsw, work, min_work;
};
__host__ __device__ inline Smem smem_layout(const Dims& d, bool backward, Held held) {
  const int io = d.bf16 ? 2 : 4;
  Smem m;
  int at = held.weights * io;
  m.bias = at;
  at += held.biases * 4;
  m.lsw = at;
  at += d.K > 0 ? LS_TAPS * r4(d.A1) * 4 : 0;
  m.work = at;
  // one group of four lanes of the widest product, or the attention stages' rows
  m.min_work = imax(4 * widest_k(d, backward) * io, 4 * lane_floats(backward));
  return m;
}

// Dynamic shared memory a block needs at the least with a grid of G blocks, whatever
// the lane count (what ops/fused_teacher.py::teacher_grid_plan calls smem_bytes).
size_t smem_need(const Dims& d, bool backward, int G) {
  const Smem m = smem_layout(d, backward, plan_held(d, backward, G));
  return (size_t)m.work + m.min_work;
}

// What a block of a launch of d.B lanes can use: input rows of every lane at once.
size_t smem_want(const Dims& d, bool backward, int G) {
  const Smem m = smem_layout(d, backward, plan_held(d, backward, G));
  const int io = d.bf16 ? 2 : 4;
  return (size_t)m.work + imax(m.min_work, r4(d.B) * widest_k(d, backward) * io);
}

// ------------------------------ global scratch -------------------------------

// The grid barrier's counter and the per-lane rows in the scratch buffer (bytes
// from its start, each 16-byte aligned); a direction's buffer holds its own rows
// (the other's take no room). Rows of the io type (a product's input) have strides
// of r8 values, float rows of r4. Forward: attin, din and din2 by the step's parity
// (a stage reads the row it feeds), and so are the alignments and the cumulative
// ones (every block of a lane reads them). Backward: the second LSTM's gate
// cotangents by parity (the stage that reads them makes the next step's).
struct Scratch {
  size_t counter, hi;
  size_t attin, din, din2, qp, catt, hatt, c1, h1, c2, h2, alpha, cum, e, u;   // forward
  size_t gz2, gz1, gzatt, gqp, gcatt, ghatt, gq, gc1, gh1, gc2, gh2, gctx, galpha, ga,
      gupre;                                                                  // backward
  size_t total;
};
__host__ __device__ inline Scratch scratch_layout(const Dims& d, bool backward) {
  const size_t io = d.bf16 ? 2 : 4, B = d.B;
  const int EW = d.E1 + d.E2, A = d.A1 + d.A2;
  const int KA = d.P2 + d.SPK + EW + d.AU, KD1 = d.AU + EW + d.DU;
  const size_t fw = backward ? 0 : 1, bw = backward ? 1 : 0;
  Scratch s;
  size_t at = 0;
  auto take = [&](size_t& off, size_t bytes) {
    off = at;
    at += (bytes + 15) / 16 * 16;
  };
  take(s.counter, 16);
  take(s.hi, B * 4);
  take(s.attin, fw * 2 * B * r8(KA) * io);
  take(s.din, fw * 2 * B * r8(KD1) * io);
  take(s.din2, fw * 2 * B * r8(2 * d.DU) * io);
  take(s.qp, fw * B * r4(A) * 4);
  take(s.catt, fw * B * r4(d.AU) * 4);
  take(s.hatt, fw * B * r4(d.AU) * 4);
  take(s.c1, fw * B * r4(d.DU) * 4);
  take(s.h1, fw * B * r4(d.DU) * 4);
  take(s.c2, fw * B * r4(d.DU) * 4);
  take(s.h2, fw * B * r4(d.DU) * 4);
  take(s.alpha, fw * 2 * B * r4(d.S) * 4);
  take(s.cum, fw * (d.K > 0 ? 2 * B * r4(d.S) * 4 : 0));
  take(s.e, fw * 2 * B * r4(d.S) * 4);
  take(s.u, fw * B * 4);
  take(s.gz2, bw * 2 * B * r8(4 * d.DU) * io);
  take(s.gz1, bw * B * r8(4 * d.DU) * io);
  take(s.gzatt, bw * B * r8(4 * d.AU) * io);
  take(s.gqp, bw * B * r8(A) * io);
  take(s.gcatt, bw * B * r4(d.AU) * 4);
  take(s.ghatt, bw * B * r4(d.AU) * 4);
  take(s.gq, bw * B * r4(d.AU) * 4);
  take(s.gc1, bw * B * r4(d.DU) * 4);
  take(s.gh1, bw * B * r4(d.DU) * 4);
  take(s.gc2, bw * B * r4(d.DU) * 4);
  take(s.gh2, bw * B * r4(d.DU) * 4);
  take(s.gctx, bw * B * r4(EW) * 4);
  take(s.galpha, bw * B * r4(d.S) * 4);
  take(s.ga, bw * 2 * B * r4(d.S) * 4);
  take(s.gupre, bw * B * 4);
  s.total = at;
  return s;
}

// ------------------------------ common stages --------------------------------

// This block's slice of every product of its direction, for the whole launch, with
// the forward's biases (float); the folded location matrix (LS).
template <typename IO>
__device__ __forceinline__ void load_slices(const Dims& d, bool backward, const IO* w,
                                            const Slice* sl, IO* sw, float* s_bias,
                                            float* s_lsw) {
  const int tid = threadIdx.x;
  for (int p = 0; p < NUM_PRODUCTS; ++p) {
    const Slice s = sl[p];
    if (s.count == 0) continue;
    const ProductShape ps = product_shape(d, backward, p);
    const int ld = r8(ps.K), N = ps.gates ? 4 * ps.items : ps.items;
    const IO* W = w + d.off[ps.entry];
    for (int i = tid; i < s.cols * ld; i += NT) {
      const int k = i / s.cols, c = i - k * s.cols;
      const int col = ps.gates ? (c & 3) * ps.items + s.first + (c >> 2) : s.first + c;
      sw[s.off + c * ld + k] = k < ps.K ? W[(size_t)k * r4(N) + col] : Io<IO>::from(0.0f);
    }
    if (!backward)
      for (int c = tid; c < s.cols; c += NT) {
        const int col = ps.gates ? (c & 3) * ps.items + s.first + (c >> 2) : s.first + c;
        s_bias[s.boff + c] = p == FP_QP ? 0.0f : Io<IO>::load(w + d.off[ps.entry + 1] + col);
      }
  }
  if (d.K > 0)
    for (int i = tid; i < LS_TAPS * d.A1; i += NT) {
      const int k = i / d.A1, a = i - k * d.A1;
      s_lsw[k * r4(d.A1) + a] = Io<IO>::load(w + d.off[LS_W] + k * r4(d.A1) + a);
    }
}

// value += v of a float summed over the steps by its one owner thread
__device__ __forceinline__ void add_to(float* p, float v) { *p = __ldcg(p) + v; }

// The sums of K values a thread over the block, in place, in the order block_sum
// takes; every thread gets them. `red`: K * (NWARPS + 1) floats of shared memory.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  __syncthreads();   // the previous reduction has been read
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * NWARPS + warp] = v[k];
  __syncthreads();
  if (threadIdx.x < 32)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float w = warp_sum(lane < NWARPS ? red[k * NWARPS + lane] : 0.0f);
      if (lane == 0) red[K * NWARPS + k] = w;
    }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = red[K * NWARPS + k];
}

// Sums each of 32 values over the warp; lane q returns the sum of value q. Each
// halving step keeps the half of the values that its bit of q selects and adds the
// partner's copy of it (grid.cuh::reduce16 for 32 values).
__device__ __forceinline__ float reduce32(float (&v)[32], int lane) {
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const bool hi = lane & width;
#pragma unroll
    for (int i = 0; i < width; ++i) {
      const float send = hi ? v[i] : v[i + width];
      v[i] = (hi ? v[i + width] : v[i]) + __shfl_xor_sync(0xffffffffu, send, width);
    }
  }
  return v[0];
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Lane l's end of the valid source (positions below it can hold attention mass;
// nothing valid: S, the softmax is uniform), by warp 0.
__device__ __forceinline__ void lane_end(const float* bias, int S, int l, int* g_hi) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int hi = 0;
  for (int s = lane; s < S; s += 32)
    if (__ldg(bias + (size_t)l * S + s) > -1e8f) hi = s + 1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hi = imax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  if (lane == 0) g_hi[l] = hi > 0 ? hi : S;
}

// ------------------------------------------------------------------------------------
// Forward
// ------------------------------------------------------------------------------------

template <bool DUAL, bool LS, bool STAMPS, typename IO>
__global__ void __launch_bounds__(NT)
teacher_fwd_kernel(const Ptrs<IO> P, const Dims d, const Scalars sc, const Bits bits,
                   const Held held) {
  using Vec = typename Weights4<IO>::Vec;
  constexpr int NSRC = DUAL ? 2 : 1;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __shared__ float s_red[NWARPS + 1];
  __shared__ unsigned long long s_bar;   // completion of the bulk copies of input rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, blk = blockIdx.x;
  const int B = d.B, S = d.S, N = d.N;
  const int P2 = d.P2, AU = d.AU, A1 = d.A1, DU = d.DU, E1 = d.E1, E2 = d.E2;
  const int A = A1 + d.A2, EW = E1 + E2;
  const int KA = P2 + d.SPK + EW + AU, KD1 = AU + EW + DU;
  const IO* w = P.w;

  Slice sl[NUM_PRODUCTS];
  plan_block(d, false, G, blk, sl);
  const Smem sm = smem_layout(d, false, held);
  unsigned int dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  IO* sw = reinterpret_cast<IO*>(smem);
  float* s_bias = reinterpret_cast<float*>(smem + sm.bias);
  float* s_lsw = reinterpret_cast<float*>(smem + sm.lsw);   const int ld_lsw = r4(A1);
  IO* tile = reinterpret_cast<IO*>(smem + sm.work);
  float* work = reinterpret_cast<float*>(smem + sm.work);
  const int work_bytes = (int)(dyn - (unsigned int)sm.work);

  // the rows in global memory
  const Scratch sg = scratch_layout(d, false);
  unsigned char* g = P.scratch;
  int* g_hi = reinterpret_cast<int*>(g + sg.hi);
  IO* g_attin = reinterpret_cast<IO*>(g + sg.attin);    const int ld_attin = r8(KA);
  IO* g_din = reinterpret_cast<IO*>(g + sg.din);        const int ld_din = r8(KD1);
  IO* g_din2 = reinterpret_cast<IO*>(g + sg.din2);      const int ld_din2 = r8(2 * DU);
  float* g_qp = reinterpret_cast<float*>(g + sg.qp);     const int ld_qp = r4(A);
  float* g_catt = reinterpret_cast<float*>(g + sg.catt); const int ld_au = r4(AU);
  float* g_hatt = reinterpret_cast<float*>(g + sg.hatt);
  float* g_c1 = reinterpret_cast<float*>(g + sg.c1);     const int ld_du = r4(DU);
  float* g_h1 = reinterpret_cast<float*>(g + sg.h1);
  float* g_c2 = reinterpret_cast<float*>(g + sg.c2);
  float* g_h2 = reinterpret_cast<float*>(g + sg.h2);
  float* g_alpha = reinterpret_cast<float*>(g + sg.alpha); const int ld_s = r4(S);
  float* g_cum = reinterpret_cast<float*>(g + sg.cum);
  float* g_e1 = reinterpret_cast<float*>(g + sg.e);
  float* g_e2 = g_e1 + (size_t)B * ld_s;
  float* g_u = reinterpret_cast<float*>(g + sg.u);
  const size_t lane_half = (size_t)B * ld_s;
  const size_t attin_half = (size_t)B * ld_attin, din_half = (size_t)B * ld_din,
               din2_half = (size_t)B * ld_din2;

  unsigned int* counter = reinterpret_cast<unsigned int*>(g + sg.counter);
  unsigned int goal = 0;
  long long* stamp = nullptr;
  int stage = 0;
  auto copied = [&]() { return STAMPS && stamp != nullptr ? stamp + 1 + 3 * stage : nullptr; };
  auto sync = [&]() {
    grid_barrier(counter, goal, STAMPS && stamp != nullptr ? stamp + 2 + 3 * stage : nullptr);
    ++stage;
  };

  unsigned int bar_phase = 0;
  if (tid == 0) mbar_init(&s_bar);

  // ------------------------------ the launch's set-up ------------------------
  load_slices<IO>(d, false, w, sl, sw, s_bias, s_lsw);
  // lanes blk, blk + G, ...: the end of the valid source, the first alignments, the
  // speaker embedding in both parities of the attention LSTM's input and step 0's
  // feed in the first, the transition factor 0.5
  for (int l = blk; l < B; l += G) {
    lane_end(P.bias, S, l, g_hi);
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
    for (int j = tid; j < P2; j += NT) g_attin[(size_t)l * ld_attin + j] = P.feeds[(size_t)l * N * P2 + j];
    if (tid == 0) g_u[l] = 0.5f;
  }
  sync();

  for (int t = 0; t < N; ++t) {
    stage = 0;
    if (STAMPS) {
      stamp = (P.stamps != nullptr && t == d.stamp_step && blk == 0) ? P.stamps : nullptr;
      if (stamp != nullptr && tid == 0) stamp[0] = global_timer();
    }
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
    const unsigned step_seed = bits.seed + (unsigned)t;
    // one unit of the ZoneoutLSTM `cell` (product p) from its gate sums; its state in
    // global memory, its pre-activations and new state to the step's rows; the new h
    auto lstm = [&](int p, int cell, int U, float* c_state, float* h_state, int ldc, int z_off,
                    int c_off, int h_off, int l, int u, float zi, float zg, float zf, float zo) {
      const float* b = s_bias + sl[p].boff + 4 * (u - sl[p].first);   // i, g, f, o
      zi += b[0];
      zg += b[1];
      zf += b[2];
      zo += b[3];
      const float c = __ldcg(c_state + (size_t)l * ldc + u);
      const float h = __ldcg(h_state + (size_t)l * ldc + u);
      const float new_c = sigmoidf_(zf + sc.forget_bias) * c + sigmoidf_(zi) * tanhf(zg);
      const float new_h = sigmoidf_(zo) * tanhf(new_c);
      const float mc = keep_old(d.train_masks, step_seed, bits.draw[2 * cell], bits.thr_c, sc.zc,
                                bits.lane0 + (unsigned)l, u, U);
      const float mh = keep_old(d.train_masks, step_seed, bits.draw[2 * cell + 1], bits.thr_h,
                                sc.zo, bits.lane0 + (unsigned)l, u, U);
      const float out_c = c * mc + new_c * (1.0f - mc);
      const float out_h = h * mh + new_h * (1.0f - mh);
      c_state[(size_t)l * ldc + u] = out_c;
      h_state[(size_t)l * ldc + u] = out_h;
      const size_t row = (size_t)l * N + t;
      float* z = P.acts + row * d.AW + z_off;
      z[u] = zi;
      z[U + u] = zg;
      z[2 * U + u] = zf;
      z[3 * U + u] = zo;
      P.carry[row * d.CW + c_off + u] = out_c;
      P.carry[row * d.CW + h_off + u] = out_h;
      return out_h;
    };

    // ------------------------------ attention LSTM -----------------------------
    // input [x2 | speaker | ctx1 | ctx2 | h_att]; the new h_att is the query
    product(sw + sl[FP_ATTG].off, sl[FP_ATTG], KA, true, B, tile, work_bytes, 0, copied(),
            rows_of(attin_p, ld_attin),
            [&](int l, int u, float zi, float zg, float zf, float zo) {
              const IO h = Io<IO>::from(lstm(FP_ATTG, 0, AU, g_catt, g_hatt, ld_au,
                                             d.acts[A_ZATT], d.carry[C_CATT], d.carry[C_HATT],
                                             l, u, zi, zg, zf, zo));
              din_p[(size_t)l * ld_din + u] = h;
              attin_n[(size_t)l * ld_attin + (KA - AU) + u] = h;
            });
    sync();

    // ------------------------------ query projection ---------------------------
    // and the next step's feed into its attention LSTM input
    if (t + 1 < N)
      for (int l = blk; l < B; l += G)
        for (int j = tid; j < P2; j += NT)
          attin_n[(size_t)l * ld_attin + j] = P.feeds[((size_t)l * N + t + 1) * P2 + j];
    product(sw + sl[FP_QP].off, sl[FP_QP], AU, false, B, tile, work_bytes, 0, copied(),
            rows_of(din_p, ld_din),
            [&](int l, int j, float v, float, float, float) {
              g_qp[(size_t)l * ld_qp + j] = v;
              P.acts[((size_t)l * N + t) * d.AW + d.acts[A_QP] + j] = v;
            });
    sync();

    // ------------------------------ scores, a warp per RUN positions ---------
    // e_i = sum_a tanh(keys_cat + qp [+ loc]) * vblk[i] + bias for every lane and
    // position, a warp per (lane, RUN neighbouring positions) dealt over the whole
    // grid, the keys of all of them in flight at once; location-sensitive: the taps
    // of LS_RUN positions in registers, source 1's columns adding the location
    // features.
    {
      constexpr int RUN = LS ? LS_RUN : 2;
      const int nrun = (S + RUN - 1) / RUN;
      const float* prev_rows = (d.ls_cum ? g_cum : g_alpha) + par * lane_half;
      const IO* v1 = w + d.off[VBLK];
      const IO* v2 = v1 + r4(A);   // read only with DUAL
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
            const float4 va4 = Weights4<IO>::values(__ldg(reinterpret_cast<const Vec*>(v1 + a)));
            const float4 vb4 = DUAL ? Weights4<IO>::values(__ldg(reinterpret_cast<const Vec*>(v2 + a)))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
            const float q[4] = {q4.x, q4.y, q4.z, q4.w};
            const float va[4] = {va4.x, va4.y, va4.z, va4.w}, vb[4] = {vb4.x, vb4.y, vb4.z, vb4.w};
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
                const float th = tanhf(k[e] + q[e]);
                acc1[j] = fmaf(th, va[e], acc1[j]);
                if (DUAL) acc2[j] = fmaf(th, vb[e], acc2[j]);
              }
            }
          }
        } else {
          for (int a = lane; a < A; a += 32) {
            const float q = __ldcg(qp + a);
            const float va = Io<IO>::load(v1 + a), vb = DUAL ? Io<IO>::load(v2 + a) : 0.0f;
            float key[RUN];
#pragma unroll
            for (int j = 0; j < RUN; ++j)   // past the source: computed, never written
              key[j] = Io<IO>::load(keys + (size_t)imin(s0 + j, S - 1) * A + a);
            float loc[LS_RUN];
#pragma unroll
            for (int j = 0; j < LS_RUN; ++j) loc[j] = 0.0f;
            if (LS && a < A1) {
              ls_dot(win, s_lsw, ld_lsw, a, loc);
              const float b = __ldg(P.ls_b + a);
#pragma unroll
              for (int j = 0; j < LS_RUN; ++j) loc[j] += b;
            }
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
              const float th = LS ? tanhf((key[j] + q) + loc[j]) : tanhf(key[j] + q);
              acc1[j] = fmaf(th, va, acc1[j]);
              if (DUAL) acc2[j] = fmaf(th, vb, acc2[j]);
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
    // side by side. The maxima and sums run over the whole source, the rows' first
    // ATT_TILE positions kept in shared memory and the rest read from L2; then the
    // alignments and the contexts ATT_TILE positions at a time.
    {
      float* s_e1 = work;
      float* s_e2 = work + ATT_TILE;
      float* s_prev = work + 2 * ATT_TILE;
      float* s_cum = work + 3 * ATT_TILE;
      float* s_a1 = work + 4 * ATT_TILE;
      float* s_a2 = work + 5 * ATT_TILE;
      float* s_part = work + 6 * ATT_TILE;
      const int nchunk = (EW + CTX_COLS - 1) / CTX_COLS;
      for (int unit = blk; unit < B * nchunk; unit += G) {
        const int l = unit / nchunk, c0 = (unit - l * nchunk) * CTX_COLS;
        const bool lead = c0 == 0;
        const size_t row = (size_t)l * ld_s, trow = (size_t)l * N + t;
        const float* e1_row = g_e1 + row;
        const float* e2_row = g_e2 + row;
        const float* prev_row = g_alpha + par * lane_half + row;
        const float* cum_row = g_cum + par * lane_half + row;
        // a row's value at s: the first ATT_TILE positions from shared memory
        auto at = [&](const float* s_row, const float* g_row, int s) {
          return s < ATT_TILE ? s_row[s] : __ldcg(g_row + s);
        };
        float m1 = -3.0e38f, m2 = -3.0e38f;
        for (int s = tid; s < S; s += NT) {
          const float v1 = __ldcg(e1_row + s);
          const float v2 = DUAL ? __ldcg(e2_row + s) : 0.0f;
          m1 = fmaxf(m1, v1);
          m2 = fmaxf(m2, v2);
          if (s < ATT_TILE) {
            s_e1[s] = v1;
            if (DUAL) s_e2[s] = v2;
            if (!LS) s_prev[s] = __ldcg(prev_row + s);
            if (LS && d.ls_cum) s_cum[s] = __ldcg(cum_row + s);
          }
        }
        // forward attention's transition factor of the previous step
        const float u = LS ? 0.5f : __ldcg(g_u + l);
        __syncthreads();
        m1 = block_max(m1, s_red);
        if (DUAL) m2 = block_max(m2, s_red);

        // source 1's alignment at s before its normalisation, from x = exp(e1[s] - m1):
        // location-sensitive x itself (a = softmax(e1)); forward attention
        // ((1 - u) a[s] + u a[s - 1] + 1e-6) x, as a = ((1 - u) a + u shift(a) + 1e-6) y
        // renormalised, where y = softmax(e1)'s own sum cancels
        auto unnormed1 = [&](int s, float x) {
          if (LS) return x;
          const float shifted = s > 0 ? at(s_prev, prev_row, s - 1) : 0.0f;
          return ((1.0f - u) * at(s_prev, prev_row, s) + u * shifted + 1e-6f) * x;
        };
        float z1 = 0.0f, n1 = 0.0f, n2 = 0.0f;
        for (int s = tid; s < S; s += NT) {
          const float x = expf(at(s_e1, e1_row, s) - m1);
          z1 += x;
          if (!LS) n1 += unnormed1(s, x);
          if (DUAL) n2 += expf(at(s_e2, e2_row, s) - m2);
        }
        z1 = block_sum(z1, s_red);
        n1 = LS ? z1 : block_sum(n1, s_red);
        if (DUAL) n2 = block_sum(n2, s_red);

        // a tile's alignments (source 2's: a2 = softmax(e2)), then this block's
        // context columns [c0, c0 + cw) over it: a thread takes four neighbouring
        // columns over a run of the tile's positions, the same in every tile, and
        // adds its sums to those of the earlier tiles
        const int cw = imin(CTX_COLS, EW - c0), nc4 = cw >> 2;
        const int n = imin(S, ATT_TILE);
        int cparts = imax(1, imin(NT / nc4, (n + 7) / 8));
        const int span = (n + cparts - 1) / cparts;
        cparts = (n + span - 1) / span;
        float* arow = P.aligns + trow * NSRC * S;
        float* acts = P.acts + trow * d.AW;
        float* carry = P.carry + trow * d.CW;
        const int hi = __ldcg(g_hi + l);
        for (int t0 = 0; t0 < S; t0 += ATT_TILE) {
          const int t1 = imin(t0 + ATT_TILE, S);
          for (int s = t0 + tid; s < t1; s += NT) {
            const float x = expf(at(s_e1, e1_row, s) - m1);
            const float v = unnormed1(s, x) / n1;
            s_a1[s - t0] = v;
            if (lead) {
              g_alpha[(par ^ 1) * lane_half + row + s] = v;
              arow[s] = v;
              carry[d.carry[C_ALPHA] + s] = v;
              acts[d.acts[A_Y1] + s] = x / z1;
              if (LS && d.ls_cum) {
                const float c = at(s_cum, cum_row, s) + v;
                g_cum[(par ^ 1) * lane_half + row + s] = c;
                carry[d.carry[C_CUM] + s] = c;
              }
            }
            if (DUAL) {
              const float v2 = expf(at(s_e2, e2_row, s) - m2) / n2;
              s_a2[s - t0] = v2;
              if (lead) {
                arow[S + s] = v2;
                acts[d.acts[A_ALPHA2] + s] = v2;
              }
            }
          }
          __syncthreads();
          for (int idx = tid; idx < cparts * nc4; idx += NT) {
            const int p = idx / nc4, c = idx - p * nc4;
            const int col = c0 + 4 * c;
            const bool second = DUAL && col >= E1;
            const int width = second ? E2 : E1;
            const IO* mem = second ? P.mem2 + (size_t)l * S * E2 + (col - E1)
                                   : P.mem1 + (size_t)l * S * E1 + col;
            const float* alpha = second ? s_a2 : s_a1;
            const int s0 = t0 + p * span;
            const int s1 = imin(imin(s0 + span, t1), hi);
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
            int s = s0;
            for (; s + 8 <= s1; s += 8) {
              float4 mv[8];
#pragma unroll
              for (int k = 0; k < 8; ++k)
                mv[k] = Weights4<IO>::values(
                    __ldg(reinterpret_cast<const Vec*>(mem + (size_t)(s + k) * width)));
#pragma unroll
              for (int k = 0; k < 8; ++k) fma4(acc, alpha[s - t0 + k], mv[k]);
            }
            for (; s < s1; ++s)
              fma4(acc, alpha[s - t0],
                   Weights4<IO>::values(__ldg(reinterpret_cast<const Vec*>(mem + (size_t)s * width))));
            float4* sums = reinterpret_cast<float4*>(s_part + (size_t)p * cw + 4 * c);
            if (t0 > 0) {
              const float4 earlier = *sums;
              acc.x += earlier.x;
              acc.y += earlier.y;
              acc.z += earlier.z;
              acc.w += earlier.w;
            }
            *sums = acc;
          }
          __syncthreads();   // the tile's alignments have been read, its sums written
        }
        for (int j = tid; j < cw; j += NT) {
          float sum = 0.0f;
          for (int p = 0; p < cparts; ++p) sum += s_part[p * cw + j];
          const IO v = Io<IO>::from(sum);
          const int col = c0 + j;
          attin_n[(size_t)l * ld_attin + P2 + d.SPK + col] = v;   // next step's attention LSTM
          din_p[(size_t)l * ld_din + AU + col] = v;               // [query | ctx1 | ctx2 | h1]
          carry[col < E1 ? d.carry[C_CTX1] + col : d.carry[C_CTX2] + (col - E1)] = sum;
        }
        __syncthreads();
      }
    }
    sync();

    // ------------------------------ decoder LSTM 1 -----------------------------
    // beside it, lanes blk, blk + G, ...: the transition factor u of this step (read
    // by the next step's alignments) from the rounded [ctx1 | query]
    for (int l = blk; l < B; l += G) {
      if (warp == 0) {
        float u = 0.5f;
        if (d.use_ta) {
          const IO* wt = w + d.off[TA_W];
          const IO* in = din_p + (size_t)l * ld_din;
          float acc = 0.0f;
          for (int i = lane; i < E1 + AU; i += 32)
            acc += Io<IO>::load(wt + i) * (i < E1 ? ldcg_f(in + AU + i) : ldcg_f(in + (i - E1)));
          acc = warp_sum(acc);
          u = sigmoidf_(acc + Io<IO>::load(w + d.off[TA_B]));
        }
        if (lane == 0) {
          g_u[l] = u;
          P.carry[((size_t)l * N + t) * d.CW + d.carry[C_U]] = u;
        }
      }
    }
    product(sw + sl[FP_L1].off, sl[FP_L1], KD1, true, B, tile, work_bytes, 0, copied(),
            rows_of(din_p, ld_din),
            [&](int l, int u, float zi, float zg, float zf, float zo) {
              const IO h = Io<IO>::from(lstm(FP_L1, 1, DU, g_c1, g_h1, ld_du, d.acts[A_Z1],
                                             d.carry[C_C1], d.carry[C_H1], l, u, zi, zg, zf, zo));
              din2_p[(size_t)l * ld_din2 + u] = h;
              din_n[(size_t)l * ld_din + (KD1 - DU) + u] = h;
            });
    sync();

    // ------------------------------ decoder LSTM 2 -----------------------------
    // feature = h2 + h1. No barrier after it: the next step's first stage reads
    // nothing this stage writes
    product(sw + sl[FP_L2].off, sl[FP_L2], 2 * DU, true, B, tile, work_bytes, 0, copied(),
            rows_of(din2_p, ld_din2),
            [&](int l, int u, float zi, float zg, float zf, float zo) {
              const float h = lstm(FP_L2, 2, DU, g_c2, g_h2, ld_du, d.acts[A_Z2], d.carry[C_C2],
                                   d.carry[C_H2], l, u, zi, zg, zf, zo);
              din2_n[(size_t)l * ld_din2 + DU + u] = Io<IO>::from(h);
              P.features[((size_t)l * N + t) * DU + u] = h + __ldcg(g_h1 + (size_t)l * ld_du + u);
            });
    if (STAMPS && stamp != nullptr) {
      __syncthreads();
      if (tid == 0) stamp[2 + 3 * stage] = stamp[3 + 3 * stage] = global_timer();
    }
  }
}

// ------------------------------------------------------------------------------------
// Backward
// ------------------------------------------------------------------------------------

// The adjoint of one unit's ZoneoutLSTM update at step t, lane l: `g_h_out` is the
// whole cotangent of its h output, gc[l][j] that of its c output; on exit gc and gh
// hold those of the step's c and h inputs as far as this update gives them. The
// cotangents of the gate pre-activations go to `gz` (lane l's row of 4U in the io
// type, the next product's input), to the gradient row and to the float running sum.
template <typename IO>
__device__ __forceinline__ void lstm_backward(const Ptrs<IO>& P, const Dims& d,
                                              const Scalars& sc, const Bits& bits, int cell,
                                              int U, int z_off, int c_off, int g_off, int t,
                                              int l, int j, float* gc, float* gh, int ldg,
                                              float g_h_out, IO* gz) {
  const size_t row = (size_t)l * d.N + t;
  const float* z = P.acts + row * d.AW + z_off;
  const float c_prev = t > 0 ? __ldg(P.carry + (row - 1) * d.CW + c_off + j) : 0.0f;
  const float si = sigmoidf_(__ldg(z + j));
  const float tg = tanhf(__ldg(z + U + j));
  const float sf = sigmoidf_(__ldg(z + 2 * U + j) + sc.forget_bias);
  const float so = sigmoidf_(__ldg(z + 3 * U + j));
  const float tc = tanhf(sf * c_prev + si * tg);
  const unsigned step_seed = bits.seed + (unsigned)t;
  const float mc = keep_old(d.train_masks, step_seed, bits.draw[2 * cell], bits.thr_c, sc.zc,
                            bits.lane0 + (unsigned)l, j, U);
  const float mh = keep_old(d.train_masks, step_seed, bits.draw[2 * cell + 1], bits.thr_h,
                            sc.zo, bits.lane0 + (unsigned)l, j, U);
  const float g_c_out = __ldcg(gc + (size_t)l * ldg + j);
  const float g_h_new = g_h_out * (1.0f - mh);
  const float g_c_new = g_c_out * (1.0f - mc) + g_h_new * so * (1.0f - tc * tc);
  const float g_i = g_c_new * tg * si * (1.0f - si);
  const float g_g = g_c_new * si * (1.0f - tg * tg);
  const float g_f = g_c_new * c_prev * sf * (1.0f - sf);
  const float g_o = g_h_new * tc * so * (1.0f - so);
  gc[(size_t)l * ldg + j] = g_c_out * mc + g_c_new * sf;
  gh[(size_t)l * ldg + j] = g_h_out * mh;
  const IO vi = Io<IO>::from(g_i), vg = Io<IO>::from(g_g), vf = Io<IO>::from(g_f),
           vo = Io<IO>::from(g_o);
  gz[j] = vi;
  gz[U + j] = vg;
  gz[2 * U + j] = vf;
  gz[3 * U + j] = vo;
  IO* out = P.stack + row * d.SW + g_off;
  out[j] = vi;
  out[U + j] = vg;
  out[2 * U + j] = vf;
  out[3 * U + j] = vo;
  float* sum = P.d_brow + (size_t)l * d.SW + g_off;
  sum[j] = __ldcg(sum + j) + g_i;
  sum[U + j] = __ldcg(sum + U + j) + g_g;
  sum[2 * U + j] = __ldcg(sum + 2 * U + j) + g_f;
  sum[3 * U + j] = __ldcg(sum + 3 * U + j) + g_o;
}

// The number of (lane, column run) blocks of the score adjoint per lane: enough to
// spread B lanes over G blocks, runs of at least 32 columns, at most NT columns.
__host__ __device__ inline int score_chunks(int A, int B, int G) {
  return imax((A + NT - 1) / NT, imin((A + 31) / 32, imax(1, G / B)));
}

template <bool DUAL, bool LS, bool STAMPS, typename IO>
__global__ void __launch_bounds__(NT)
teacher_bwd_kernel(const Ptrs<IO> P, const Dims d, const Scalars sc, const Bits bits,
                   const Held held) {
  constexpr int NSRC = DUAL ? 2 : 1;
  extern __shared__ float4 smem4[];
  __shared__ float s_red[3 * (NWARPS + 1)];
  __shared__ unsigned long long s_bar;
  // the dynamic region from its first 128-byte boundary (launch_io adds the 128 bytes
  // that may take): where this kernel's static scalars left it at 16 bytes, its bulk
  // copies were slower and the flagship's backward 8 % so at B=32 on an H100. An
  // __align__(128) on the array would move the forward's region too (every kernel of
  // the file), and the forward ran 4-5 % slower there (PERF.md §6, PR 12)
  const unsigned int skew = (128u - (smem_addr(smem4) & 127u)) & 127u;
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4) + skew;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, blk = blockIdx.x;
  const int B = d.B, S = d.S, N = d.N;
  const int P2 = d.P2, SPK = d.SPK, AU = d.AU, A1 = d.A1, DU = d.DU, E1 = d.E1, E2 = d.E2;
  const int A = A1 + d.A2, EW = E1 + E2;
  const int KA = P2 + SPK + EW + AU;

  Slice sl[NUM_PRODUCTS];
  plan_block(d, true, G, blk, sl);
  const Smem sm = smem_layout(d, true, held);
  unsigned int dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  IO* sw = reinterpret_cast<IO*>(smem);
  float* s_lsw = reinterpret_cast<float*>(smem + sm.lsw);   const int ld_lsw = r4(A1);
  IO* tile = reinterpret_cast<IO*>(smem + sm.work);
  float* work = reinterpret_cast<float*>(smem + sm.work);
  const int work_bytes = (int)(dyn - skew - (unsigned int)sm.work);

  const Scratch sg = scratch_layout(d, true);
  unsigned char* g = P.scratch;
  int* g_hi = reinterpret_cast<int*>(g + sg.hi);
  IO* g_gz2 = reinterpret_cast<IO*>(g + sg.gz2);         const int ld_gz = r8(4 * DU);
  IO* g_gz1 = reinterpret_cast<IO*>(g + sg.gz1);
  IO* g_gzatt = reinterpret_cast<IO*>(g + sg.gzatt);     const int ld_gza = r8(4 * AU);
  IO* g_gqp = reinterpret_cast<IO*>(g + sg.gqp);         const int ld_gqp = r8(A);
  float* g_gcatt = reinterpret_cast<float*>(g + sg.gcatt); const int ld_au = r4(AU);
  float* g_ghatt = reinterpret_cast<float*>(g + sg.ghatt);
  float* g_gq = reinterpret_cast<float*>(g + sg.gq);
  float* g_gc1 = reinterpret_cast<float*>(g + sg.gc1);   const int ld_du = r4(DU);
  float* g_gh1 = reinterpret_cast<float*>(g + sg.gh1);
  float* g_gc2 = reinterpret_cast<float*>(g + sg.gc2);
  float* g_gh2 = reinterpret_cast<float*>(g + sg.gh2);
  float* g_gctx = reinterpret_cast<float*>(g + sg.gctx); const int ld_ew = r4(EW);
  float* g_galpha = reinterpret_cast<float*>(g + sg.galpha); const int ld_s = r4(S);
  float* g_ga1 = reinterpret_cast<float*>(g + sg.ga);
  float* g_ga2 = g_ga1 + (size_t)B * ld_s;
  float* g_gupre = reinterpret_cast<float*>(g + sg.gupre);
  const size_t gz2_half = (size_t)B * ld_gz;

  unsigned int* counter = reinterpret_cast<unsigned int*>(g + sg.counter);
  unsigned int goal = 0;
  long long* stamp = nullptr;
  int stage = 0;
  auto copied = [&]() { return STAMPS && stamp != nullptr ? stamp + 1 + 3 * stage : nullptr; };
  auto sync = [&]() {
    grid_barrier(counter, goal, STAMPS && stamp != nullptr ? stamp + 2 + 3 * stage : nullptr);
    ++stage;
  };

  unsigned int bar_phase = 0;
  if (tid == 0) mbar_init(&s_bar);
  auto rows_of = [&](const IO* src, int lds) {
    return [&, src, lds](IO* tl, int ld, int l0, int lc, float*) {
      copy_rows<IO>(tl, ld, src, lds, l0, lc, &s_bar, bar_phase);
    };
  };

  // ------------------------------ the launch's set-up ------------------------
  load_slices<IO>(d, true, P.w, sl, sw, nullptr, s_lsw);
  for (int l = blk; l < B; l += G) {
    lane_end(P.bias, S, l, g_hi);
    // the last step's u feeds no step: its pre-activation's cotangent is 0
    if (tid == 0) P.stack[((size_t)l * N + N - 1) * d.SW + d.stack[G_UPRE]] = Io<IO>::from(0.0f);
  }
  // the second decoder LSTM's adjoint of the last step: the feature's cotangent alone
  for (int i = blk * NT + tid; i < B * DU; i += G * NT) {
    const int l = i / DU, u = i - l * DU;
    lstm_backward<IO>(P, d, sc, bits, 2, DU, d.acts[A_Z2], d.carry[C_C2], d.stack[G_Z2], N - 1,
                      l, u, g_gc2, g_gh2, ld_du,
                      __ldg(P.g_feat + ((size_t)l * N + N - 1) * DU + u),
                      g_gz2 + ((N - 1) & 1) * gz2_half + (size_t)l * ld_gz);
  }
  sync();

  for (int t = N - 1; t >= 0; --t) {
    stage = 0;
    if (STAMPS) {
      stamp = (P.stamps != nullptr && t == d.stamp_step && blk == 0) ? P.stamps : nullptr;
      if (stamp != nullptr && tid == 0) stamp[0] = global_timer();
    }
    const int par = t & 1;
    // the rows the next step reads into L2, a line a thread over the grid, while this
    // step runs: its activation rows and the one before, the carry rows of the three
    // steps to it, the features' cotangents of it and the step before, the
    // alignments' of it
    if (t > 0) {
      const int tn = t - 1, ta = imax(tn - 1, 0), tc = imax(tn - 2, 0);
      const int la = ((tn + 1 - ta) * d.AW * 4 + 127) >> 7;
      const int lc = ((tn + 1 - tc) * d.CW * 4 + 127) >> 7;
      const int lf = ((tn + 1 - ta) * DU * 4 + 127) >> 7;
      const int lg = P.g_align != nullptr ? (NSRC * S * 4 + 127) >> 7 : 0;
      const int per_lane = la + lc + lf + lg;
      for (int i = blk * NT + tid; i < B * per_lane; i += G * NT) {
        const int l = i / per_lane;
        int k = i - l * per_lane;
        const size_t row = (size_t)l * N;
        const char* p;
        if (k < la) {
          p = reinterpret_cast<const char*>(P.acts + (row + ta) * d.AW);
        } else if ((k -= la) < lc) {
          p = reinterpret_cast<const char*>(P.carry + (row + tc) * d.CW);
        } else if ((k -= lc) < lf) {
          p = reinterpret_cast<const char*>(P.g_feat + (row + ta) * DU);
        } else {
          k -= lf;
          p = reinterpret_cast<const char*>(P.g_align + (row + tn) * NSRC * S);
        }
        prefetch_l2(p + ((size_t)k << 7));
      }
    }
    // the alignments that step t's taps (LS) or recursion read: before the step
    auto aprev = [&](int l, int p) -> float {
      if (t == 0) return LS ? (d.ls_cum ? 0.0f : 1.0f / (float)S) : (p == 0 ? 1.0f : 0.0f);
      const float* c = P.carry + ((size_t)l * N + t - 1) * d.CW;
      return __ldg(c + ((LS && d.ls_cum) ? d.carry[C_CUM] : d.carry[C_ALPHA]) + p);
    };

    // ------------------------------ L2^T ---------------------------------------
    // input the second LSTM's gate cotangents of step t; output [h1 | h2 of step
    // t-1]. A column's cotangent completes that of h1 (step t) or h2 (step t-1):
    // the epilogue runs that unit's pointwise adjoint
    product(sw + sl[BP_L2T].off, sl[BP_L2T], 4 * DU, false, B, tile, work_bytes, 0, copied(),
            rows_of(g_gz2 + par * gz2_half, ld_gz),
            [&](int l, int j, float v, float, float, float) {
              if (j < DU) {
                const float g_h = __ldcg(g_gh1 + (size_t)l * ld_du + j) + v +
                                  __ldg(P.g_feat + ((size_t)l * N + t) * DU + j);
                lstm_backward<IO>(P, d, sc, bits, 1, DU, d.acts[A_Z1], d.carry[C_C1],
                                  d.stack[G_Z1], t, l, j, g_gc1, g_gh1, ld_du, g_h,
                                  g_gz1 + (size_t)l * ld_gz);
              } else if (t > 0) {
                const int u = j - DU;
                const float g_h = __ldcg(g_gh2 + (size_t)l * ld_du + u) + v +
                                  __ldg(P.g_feat + ((size_t)l * N + t - 1) * DU + u);
                lstm_backward<IO>(P, d, sc, bits, 2, DU, d.acts[A_Z2], d.carry[C_C2],
                                  d.stack[G_Z2], t - 1, l, u, g_gc2, g_gh2, ld_du, g_h,
                                  g_gz2 + (par ^ 1) * gz2_half + (size_t)l * ld_gz);
              }
            });
    sync();

    // ------------------------------ L1^T ---------------------------------------
    // output [query | ctx1 | ctx2 | h1 of step t-1]; the transition agent's adjoint
    // (u of step t was consumed by step t+1, whose score adjoint left the
    // cotangent of its pre-activation) adds to the query and ctx1
    {
      const IO* wt = P.w + d.off[TA_W];
      product(sw + sl[BP_L1T].off, sl[BP_L1T], 4 * DU, false, B, tile, work_bytes, 0, copied(),
              rows_of(g_gz1, ld_gz),
              [&](int l, int j, float v, float, float, float) {
                const float g_u = d.use_ta ? Io<IO>::round(__ldcg(g_gupre + l)) : 0.0f;
                if (j < AU) {
                  g_gq[(size_t)l * ld_au + j] = d.use_ta ? v + g_u * Io<IO>::load(wt + E1 + j) : v;
                } else if (j < AU + EW) {
                  const int i = j - AU;
                  float total = __ldcg(g_gctx + (size_t)l * ld_ew + i) + v;   // + step t+1's share
                  if (d.use_ta && i < E1) total += g_u * Io<IO>::load(wt + i);
                  g_gctx[(size_t)l * ld_ew + i] = total;
                  const int at = i < E1 ? d.stack[G_CTX1] + i : d.stack[G_CTX2] + (i - E1);
                  P.stack[((size_t)l * N + t) * d.SW + at] = Io<IO>::from(total);
                  add_to(P.d_brow + (size_t)l * d.SW + at, total);
                } else {
                  add_to(g_gh1 + (size_t)l * ld_du + (j - AU - EW), v);
                }
              });
    }
    sync();

    // ------------------------------ contexts -> alignments ---------------------
    // g_a_i[s] = g_ctx_i . memory_i[s], plus what arrives for the alignment itself,
    // a warp per (lane, two positions) over the whole grid
    {
      using Vec = typename Weights4<IO>::Vec;
      const int nrun = (S + 1) >> 1;
      for (int task = blk + G * warp; task < B * nrun; task += G * NWARPS) {
        const int l = task / nrun, s0 = (task - l * nrun) * 2;
        const int hi = __ldcg(g_hi + l);
        const float* gc = g_gctx + (size_t)l * ld_ew;
        const size_t trow = (size_t)l * N + t;
        for (int s = s0; s < imin(s0 + 2, S); ++s) {
          float acc1 = 0.0f, acc2 = 0.0f;
          if (s < hi) {
            const Vec* m1 = reinterpret_cast<const Vec*>(P.mem1 + ((size_t)l * S + s) * E1);
            for (int q = lane; q < (E1 >> 2); q += 32) {
              const float4 gv = __ldcg(reinterpret_cast<const float4*>(gc) + q);
              const float4 mv = Weights4<IO>::values(__ldg(m1 + q));
              acc1 = fmaf(gv.x, mv.x, fmaf(gv.y, mv.y, fmaf(gv.z, mv.z, fmaf(gv.w, mv.w, acc1))));
            }
            if (DUAL) {
              const Vec* m2 = reinterpret_cast<const Vec*>(P.mem2 + ((size_t)l * S + s) * E2);
              for (int q = lane; q < (E2 >> 2); q += 32) {
                const float4 gv = __ldcg(reinterpret_cast<const float4*>(gc + E1) + q);
                const float4 mv = Weights4<IO>::values(__ldg(m2 + q));
                acc2 = fmaf(gv.x, mv.x, fmaf(gv.y, mv.y, fmaf(gv.z, mv.z, fmaf(gv.w, mv.w, acc2))));
              }
            }
          }
          acc1 = warp_sum(acc1);
          if (DUAL) acc2 = warp_sum(acc2);
          if (lane == 0) {
            if (s < hi) {
              if (P.g_align != nullptr) {
                const float* ga = P.g_align + trow * NSRC * S;
                acc1 += __ldg(ga + s);
                if (DUAL) acc2 += __ldg(ga + S + s);
              }
              acc1 += __ldcg(g_galpha + (size_t)l * ld_s + s);
            }
            g_ga1[(size_t)l * ld_s + s] = acc1;
            if (DUAL) g_ga2[(size_t)l * ld_s + s] = acc2;
          }
        }
      }
    }
    sync();

    // ------------------------------ recursion, softmaxes and scores ------------
    // a block per (lane, run of columns). Each computes the lane's softmax (and
    // forward attention's recursion) adjoints itself; the first of a lane's blocks
    // writes the carried alignment's cotangent and the transition agent's. Then one
    // pass over (s, a) of its columns: the tanh again, its cotangent into d_keys,
    // summed over s into g_qp, and g_e . tanh into this lane's d_vblk partial;
    // location-sensitive, the tanh's argument with the location features of the
    // carried alignments, and source 1's columns of its rounded cotangent into the
    // lane's scratch row. A thread takes one column over a run of each tile's
    // positions; the runs' sums are added in order.
    {
      float* s_ga1 = work;
      float* s_ga2 = work + ATT_TILE;
      float* s_y1 = work + 2 * ATT_TILE;
      float* s_a1 = work + 3 * ATT_TILE;
      float* s_prev = work + 4 * ATT_TILE;
      float* s_a2 = work + 5 * ATT_TILE;
      float* s_ge1 = work + 6 * ATT_TILE;
      float* s_ge2 = work + 7 * ATT_TILE;
      float* s_sum = work + 8 * ATT_TILE;
      const int nchunk = score_chunks(A, B, G);
      const int cwf = (A + nchunk - 1) / nchunk;
      const int ldg = r4(A1);
      for (int unit = blk; unit < B * nchunk; unit += G) {
        const int l = unit / nchunk, a0 = (unit - l * nchunk) * cwf;
        const int cw = imin(cwf, A - a0);
        if (cw <= 0) continue;
        const bool lead = a0 == 0;
        const int hi = __ldcg(g_hi + l);
        const size_t row = (size_t)l * N + t;
        const float* acts = P.acts + row * d.AW;
        const float* ga1 = g_ga1 + (size_t)l * ld_s;
        const float* ga2 = g_ga2 + (size_t)l * ld_s;
        const float* y1 = acts + d.acts[A_Y1];
        const float* a1 = P.carry + row * d.CW + d.carry[C_ALPHA];
        const float* a2 = acts + d.acts[A_ALPHA2];
        const float u = t > 0 ? __ldg(P.carry + (row - 1) * d.CW + d.carry[C_U]) : 0.5f;
        for (int s = tid; s < imin(S, ATT_TILE); s += NT) {
          s_ga1[s] = __ldcg(ga1 + s);
          s_y1[s] = __ldg(y1 + s);
          if (!LS) s_a1[s] = __ldg(a1 + s);
          s_prev[s] = aprev(l, s);
          if (DUAL) {
            s_ga2[s] = __ldcg(ga2 + s);
            s_a2[s] = __ldg(a2 + s);
          }
        }
        __syncthreads();
        // a row's value at s: the first ATT_TILE positions from shared memory
        auto at = [&](const float* s_row, const float* g_row, int s) {
          return s < ATT_TILE ? s_row[s] : __ldcg(g_row + s);
        };
        auto prev_at = [&](int s) {
          return s < 0 ? 0.0f : (s < ATT_TILE ? s_prev[s] : aprev(l, s));
        };
        auto w_rec = [&](int s) {   // what y multiplies in forward attention's recursion
          return (1.0f - u) * prev_at(s) + u * prev_at(s - 1) + 1e-6f;
        };
        // the softmaxes' and the recursion's sums over the source, three at once
        float r[3] = {0.0f, 0.0f, 0.0f};
        for (int s = tid; s < S; s += NT) {
          const float ga = at(s_ga1, ga1, s), y = at(s_y1, y1, s);
          if (LS) {
            r[0] += ga * y;
          } else {
            r[0] += ga * at(s_a1, a1, s);
            r[1] += w_rec(s) * y;
          }
          if (DUAL) r[2] += at(s_ga2, ga2, s) * at(s_a2, a2, s);
        }
        block_sums<3>(r, s_red);
        const float dot = r[0], s_hat = LS ? 1.0f : r[1], dot2 = r[2];
        // forward attention: g_hat = (g_a - dot) / s_hat, g_y = g_hat w_rec, g_w = g_hat y
        auto g_w = [&](int s) { return (at(s_ga1, ga1, s) - dot) / s_hat * at(s_y1, y1, s); };
        float dot_y = 0.0f, g_u_rec = 0.0f;
        if (!LS) {
          float q2[2] = {0.0f, 0.0f};
          for (int s = tid; s < S; s += NT) {
            const float g_hat = (at(s_ga1, ga1, s) - dot) / s_hat, y = at(s_y1, y1, s);
            q2[0] += g_hat * w_rec(s) * y;
            q2[1] += g_hat * y * (prev_at(s - 1) - prev_at(s));
          }
          block_sums<2>(q2, s_red);
          dot_y = q2[0];
          g_u_rec = q2[1];
        }
        if (lead) {
          // the carried alignment's cotangent for step t-1: forward attention the
          // adjoint of the shift (a zero-filled left shift), location-sensitive over
          // the cumulative alignments the identity path (kept), over the previous
          // ones nothing before the taps' adjoint
          float* galpha = g_galpha + (size_t)l * ld_s;
          if (!LS) {
            for (int s = tid; s < S; s += NT)
              galpha[s] = g_w(s) * (1.0f - u) + (s + 1 < S ? g_w(s + 1) * u : 0.0f);
          } else if (!d.ls_cum) {
            for (int s = tid; s < S; s += NT) galpha[s] = 0.0f;
          }
          if (tid == 0 && t > 0) {
            const float g_u_pre = d.use_ta ? g_u_rec * u * (1.0f - u) : 0.0f;
            g_gupre[l] = g_u_pre;
            P.stack[(row - 1) * d.SW + d.stack[G_UPRE]] = Io<IO>::from(g_u_pre);
            add_to(P.d_brow + (size_t)l * d.SW + d.stack[G_UPRE], g_u_pre);
          }
        }
        auto ge1_at = [&](int s) {
          const float ga = at(s_ga1, ga1, s), y = at(s_y1, y1, s);
          return LS ? y * (ga - dot) : y * ((ga - dot) / s_hat * w_rec(s) - dot_y);
        };

        const int parts = imax(1, NT / cw);
        const int c = tid % cw, part = tid / cw;
        const bool active = part < parts;
        const int a = a0 + c;
        const float q = __ldg(acts + d.acts[A_QP] + a);
        const float va = __ldg(P.v32 + a), vb = DUAL ? __ldg(P.v32 + r4(A) + a) : 0.0f;
        const IO* key = P.keys + (size_t)l * S * A + a;
        float* dk = P.d_keys + (size_t)l * S * A + a;
        const float* bias = P.bias + (size_t)l * S;
        const bool first = LS && a < A1;
        const float lb = first ? __ldg(P.ls_b + a) : 0.0f;
        float* gl = P.ls_g + (size_t)l * S * ldg + a;
        float g_q = 0.0f, d1 = 0.0f, d2 = 0.0f;
        for (int t0 = 0; t0 < hi; t0 += ATT_TILE) {
          const int t1 = imin(t0 + ATT_TILE, hi);
          __syncthreads();   // the previous tile's cotangents have been read
          for (int s = t0 + tid; s < t1; s += NT) {
            s_ge1[s - t0] = ge1_at(s);
            if (DUAL) s_ge2[s - t0] = at(s_a2, a2, s) * (at(s_ga2, ga2, s) - dot2);
          }
          __syncthreads();
          if (!active) continue;
          const int span = (t1 - t0 + parts - 1) / parts;
          const int sa = t0 + part * span, sb = imin(sa + span, t1);
          if (LS) {
            const int half = d.K >> 1;
            for (int s0 = sa; s0 < sb; s0 += LS_RUN) {
              float loc[LS_RUN];
              if (first) {
                float win[LS_WIN];
#pragma unroll
                for (int i = 0; i < LS_WIN; ++i) {   // the taps (a product's input): rounded
                  const int p = s0 - half + i;
                  win[i] = (p >= 0 && p < S) ? Io<IO>::round(prev_at(p)) : 0.0f;
                }
                ls_dot(win, s_lsw, ld_lsw, a, loc);
              } else {
#pragma unroll
                for (int j = 0; j < LS_RUN; ++j) loc[j] = 0.0f;
              }
              // the run's keys and d_keys in flight at once
              float kv[LS_RUN], dv[LS_RUN];
#pragma unroll
              for (int j = 0; j < LS_RUN; ++j) {
                const size_t at_s = (size_t)imin(s0 + j, sb - 1) * A;
                kv[j] = Io<IO>::load(key + at_s);
                dv[j] = __ldcg(dk + at_s);
              }
#pragma unroll
              for (int j = 0; j < LS_RUN; ++j) {
                const int s = s0 + j;
                if (s >= sb) break;
                float g_pre = 0.0f;
                if (__ldg(bias + s) > -1e8f) {
                  const float tq = tanhf((kv[j] + q) + (loc[j] + lb));
                  const float g1 = s_ge1[s - t0], g2 = DUAL ? s_ge2[s - t0] : 0.0f;
                  g_pre = (g1 * va + g2 * vb) * (1.0f - tq * tq);
                  dk[(size_t)s * A] = dv[j] + g_pre;
                  g_q += g_pre;
                  d1 = fmaf(g1, tq, d1);
                  d2 = fmaf(g2, tq, d2);
                }
                if (first) gl[(size_t)s * ldg] = Io<IO>::round(g_pre);
              }
            }
          } else {
            constexpr int RUN = 8;
            for (int s0 = sa; s0 < sb; s0 += RUN) {
              // eight positions' keys and d_keys in flight at once
              float kv[RUN], dv[RUN];
#pragma unroll
              for (int j = 0; j < RUN; ++j) {
                const size_t at_s = (size_t)imin(s0 + j, sb - 1) * A;
                kv[j] = Io<IO>::load(key + at_s);
                dv[j] = __ldcg(dk + at_s);
              }
#pragma unroll
              for (int j = 0; j < RUN; ++j) {
                const int s = s0 + j;
                if (s >= sb || __ldg(bias + s) <= -1e8f) continue;
                const float tq = tanhf(kv[j] + q);
                const float g1 = s_ge1[s - t0], g2 = DUAL ? s_ge2[s - t0] : 0.0f;
                const float g_pre = (g1 * va + g2 * vb) * (1.0f - tq * tq);
                dk[(size_t)s * A] = dv[j] + g_pre;
                g_q += g_pre;
                d1 = fmaf(g1, tq, d1);
                d2 = fmaf(g2, tq, d2);
              }
            }
          }
        }
        __syncthreads();
        if (active) {
          s_sum[part * cw + c] = g_q;
          s_sum[NT + part * cw + c] = d1;
          s_sum[2 * NT + part * cw + c] = d2;
        }
        __syncthreads();
        if (tid < cw) {
          float gq = 0.0f, v1 = 0.0f, v2 = 0.0f;
          for (int p = 0; p < parts; ++p) {
            gq += s_sum[p * cw + tid];
            v1 += s_sum[NT + p * cw + tid];
            v2 += s_sum[2 * NT + p * cw + tid];
          }
          const int col = a0 + tid;
          g_gqp[(size_t)l * ld_gqp + col] = Io<IO>::from(gq);   // what enters Wqp^T's product
          P.stack[row * d.SW + d.stack[G_QP] + col] = Io<IO>::from(gq);
          add_to(P.d_brow + (size_t)l * d.SW + d.stack[G_QP] + col, gq);
          float* dv = P.d_vblk + (size_t)l * NSRC * A + col;
          add_to(dv, v1);
          if (DUAL) add_to(dv + A, v2);
        }
        __syncthreads();   // the region is free for the next unit
      }
    }
    sync();

    // ------------------------------ location taps (LS) -------------------------
    // Two kinds of unit over the grid, from the step's rounded cotangents g (S, A1)
    // in the lane's scratch rows. (lane, 32 columns): those columns' share of
    // d_Wls[k][a] += sum_{s < hi} taps[s][k] g[s][a] into the lane's partial, a thread
    // per column and two taps, the source TAP_TILE positions at a time through shared
    // memory with the taps (rounded as the forward rounds them). (lane, 32
    // positions): G[s][k] = sum_a g[s][a] Wls[k][a], a warp per position, the columns
    // dealt over its threads and the 32 taps summed over the warp at once.
    if (LS) {
      constexpr int TAP_TILE = 128;
      static_assert(LS_TAPS == 32 && NT == 16 * 32, "a warp per 32 taps, a thread per two");
      static_assert(TAP_TILE * 33 + TAP_TILE + LS_TAPS - 1 <= 8 * ATT_TILE + 3 * NT,
                    "a tile and its taps fit the work region");
      const int half = d.K >> 1, ldg = r4(A1);
      const int ncol = (A1 + 31) >> 5, npos = (S + 31) >> 5;
      float* s_g = work;                        // TAP_TILE positions x 32 columns (+1)
      float* s_tap = work + TAP_TILE * 33;      // the taps those positions read
      for (int unit = blk; unit < B * (ncol + npos); unit += G) {
        const int l = unit / (ncol + npos), r = unit - l * (ncol + npos);
        const int hi = __ldcg(g_hi + l);
        const float* g_l = P.ls_g + (size_t)l * S * ldg;
        if (r < ncol) {
          const int a0 = r << 5, c = tid & 31, k0 = tid >> 5;   // taps k0 and k0 + 16
          float acc0 = 0.0f, acc1 = 0.0f;
          for (int s0 = 0; s0 < hi; s0 += TAP_TILE) {
            const int n = imin(TAP_TILE, hi - s0);
            __syncthreads();   // the previous tile has been read
            for (int i = tid; i < n * 32; i += NT) {
              const int si = i >> 5, a = a0 + (i & 31);
              s_g[si * 33 + (i & 31)] = a < A1 ? __ldcg(g_l + (size_t)(s0 + si) * ldg + a) : 0.0f;
            }
            for (int i = tid; i < n + LS_TAPS - 1; i += NT) {
              const int p = s0 - half + i;
              s_tap[i] = (p >= 0 && p < S) ? Io<IO>::round(aprev(l, p)) : 0.0f;
            }
            __syncthreads();
#pragma unroll 4
            for (int si = 0; si < n; ++si) {
              const float gv = s_g[si * 33 + c];
              acc0 = fmaf(s_tap[si + k0], gv, acc0);
              acc1 = fmaf(s_tap[si + k0 + 16], gv, acc1);
            }
          }
          if (a0 + c < ldg) {
            float* dst = P.d_lsw + (size_t)l * LS_TAPS * ldg + a0 + c;
            add_to(dst + (size_t)k0 * ldg, acc0);
            add_to(dst + (size_t)(k0 + 16) * ldg, acc1);
          }
        } else {
          const int s0 = (r - ncol) << 5;
          for (int s = s0 + warp; s < imin(s0 + 32, hi); s += NWARPS) {
            float acc[LS_TAPS];
#pragma unroll
            for (int k = 0; k < LS_TAPS; ++k) acc[k] = 0.0f;
            for (int a = lane; a < A1; a += 32) {
              const float gv = __ldcg(g_l + (size_t)s * ldg + a);
#pragma unroll
              for (int k = 0; k < LS_TAPS; ++k) acc[k] = fmaf(gv, s_lsw[k * ld_lsw + a], acc[k]);
            }
            P.ls_gk[((size_t)l * S + s) * LS_TAPS + lane] = reduce32(acc, lane);
          }
        }
      }
      sync();
    }

    // ------------------------------ qp^T ---------------------------------------
    // (LS: first the taps' adjoint onto the carried alignment's cotangent,
    // g_prev[p] += sum_k G[p - k + K/2][k] over the positions s < hi.) The product's
    // column j completes the cotangent of h_att[j]: the epilogue runs the attention
    // LSTM's pointwise adjoint
    if (LS) {
      const int half = d.K >> 1;
      for (int i = blk * NT + tid; i < B * S; i += G * NT) {
        const int l = i / S, p = i - l * S;
        const float* Gk = P.ls_gk + (size_t)l * S * LS_TAPS;
        const int hi = __ldcg(g_hi + l);
        float v = 0.0f;
#pragma unroll
        for (int k = 0; k < LS_TAPS; ++k) {   // unrolled: the loads in flight at once
          const int s = p - k + half;
          if (k < d.K && s >= 0 && s < hi) v += __ldcg(Gk + (size_t)s * LS_TAPS + k);
        }
        add_to(g_galpha + (size_t)l * ld_s + p, v);
      }
    }
    product(sw + sl[BP_QPT].off, sl[BP_QPT], A, false, B, tile, work_bytes, 0, copied(),
            rows_of(g_gqp, ld_gqp),
            [&](int l, int j, float v, float, float, float) {
              const float g_h = __ldcg(g_ghatt + (size_t)l * ld_au + j) +
                                __ldcg(g_gq + (size_t)l * ld_au + j) + v;
              lstm_backward<IO>(P, d, sc, bits, 0, AU, d.acts[A_ZATT], d.carry[C_CATT],
                                d.stack[G_ZATT], t, l, j, g_gcatt, g_ghatt, ld_au, g_h,
                                g_gzatt + (size_t)l * ld_gza);
            });
    sync();

    // ------------------------------ ATTG^T -------------------------------------
    // output [x2 | speaker | ctx1 | ctx2 | h_att of step t-1]. No barrier after it:
    // the next step's first stage reads nothing this stage writes
    product(sw + sl[BP_ATTGT].off, sl[BP_ATTGT], 4 * AU, false, B, tile, work_bytes, 0, copied(),
            rows_of(g_gzatt, ld_gza),
            [&](int l, int j, float v, float, float, float) {
              if (j < P2) {
                P.stack[((size_t)l * N + t) * d.SW + d.stack[G_FEED] + j] = Io<IO>::from(v);
                add_to(P.d_brow + (size_t)l * d.SW + d.stack[G_FEED] + j, v);
              } else if (j < P2 + SPK) {
                add_to(P.d_spk + (size_t)l * SPK + (j - P2), v);
              } else if (j < P2 + SPK + EW) {
                g_gctx[(size_t)l * ld_ew + (j - P2 - SPK)] = v;   // the contexts of step t-1
              } else {
                add_to(g_ghatt + (size_t)l * ld_au + (j - (KA - AU)), v);
              }
            });
    if (STAMPS && stamp != nullptr) {
      __syncthreads();
      if (tid == 0) stamp[2 + 3 * stage] = stamp[3 + 3 * stage] = global_timer();
    }
  }
}

bool sizes_ok(const Dims& d) {
  if (d.B <= 0 || d.S <= 0 || d.N <= 0 || d.P2 <= 0 || d.AU <= 0 || d.A1 <= 0 || d.DU <= 0 ||
      d.E1 <= 0 || d.SPK < 0 || d.E1 % 4 != 0)
    return false;
  // two sources (E2 > 0): a second mechanism and memory; one source: neither;
  // location-sensitive: an odd number of taps up to LS_TAPS and no transition agent
  const bool ls = d.K == 0 || (d.K > 0 && d.K <= LS_TAPS && d.K % 2 == 1 && d.use_ta == 0);
  return (d.A2 > 0) == (d.E2 > 0) && d.E2 % 4 == 0 && ls;
}

template <typename IO>
Ptrs<IO> make_ptrs(const void* const* p, const Dims& d) {
  Ptrs<IO> P;
  P.w = (const IO*)p[0];
  P.feeds = (const IO*)p[1];
  P.keys = (const IO*)p[2];
  P.mem1 = (const IO*)p[3];
  P.mem2 = (const IO*)p[4];
  P.bias = (const float*)p[5];
  P.spk = d.SPK > 0 ? (const IO*)p[6] : nullptr;
  P.features = (float*)p[7];
  P.aligns = (float*)p[8];
  P.carry = (float*)p[9];
  P.acts = (float*)p[10];
  P.g_feat = (const float*)p[11];
  P.g_align = (const float*)p[12];
  P.stack = (IO*)p[13];
  P.d_keys = (float*)p[14];
  P.d_vblk = (float*)p[15];
  P.d_spk = (float*)p[16];
  P.d_brow = (float*)p[17];
  P.v32 = (const float*)p[18];
  P.ls_b = (const float*)p[19];
  P.d_lsw = (float*)p[20];
  P.ls_g = (float*)p[21];
  P.ls_gk = (float*)p[22];
  P.scratch = (unsigned char*)p[23];
  P.stamps = (long long*)p[24];
  return P;
}

// An instantiation's index in the table: its direction and flags as bits.
constexpr int variant_of(bool backward, bool dual, bool ls, bool stamps, bool bf16) {
  return (int)backward | (int)dual << 1 | (int)ls << 2 | (int)stamps << 3 | (int)bf16 << 4;
}
constexpr int VARIANTS = 32;

// The instantiation's address in the table, where it belongs to this part (parts.cuh):
// the parts take every pair (direction, dual) alike, the costly ones spread.
template <bool BACKWARD, bool DUAL, bool LS, bool STAMPS, typename IO>
void enrol() {
  constexpr bool bf16 = std::is_same<IO, __nv_bfloat16>::value;
  if constexpr (in_this_part((int)BACKWARD + 2 * (int)DUAL + (int)LS + 2 * (int)bf16 +
                             (int)STAMPS)) {
    // one direction's kernel alone is instantiated here
    if constexpr (BACKWARD)
      fused_teacher_enrol(variant_of(true, DUAL, LS, STAMPS, bf16),
                          (const void*)teacher_bwd_kernel<DUAL, LS, STAMPS, IO>);
    else
      fused_teacher_enrol(variant_of(false, DUAL, LS, STAMPS, bf16),
                          (const void*)teacher_fwd_kernel<DUAL, LS, STAMPS, IO>);
  }
}

// Both directions of one specialisation.
template <bool DUAL, bool LS, bool STAMPS, typename IO>
void enrol_directions() {
  enrol<false, DUAL, LS, STAMPS, IO>();
  enrol<true, DUAL, LS, STAMPS, IO>();
}

// Every instantiation: two sources or one, forward or location-sensitive attention,
// each io type, and the stamps compiled into the flagship's structure in float
// alone: every instantiation training runs has no stamp code.
struct Enrolment {
  Enrolment() {
    enrol_directions<true, false, false, float>();
    enrol_directions<false, false, false, float>();
    enrol_directions<true, true, false, float>();
    enrol_directions<false, true, false, float>();
    enrol_directions<true, false, false, __nv_bfloat16>();
    enrol_directions<false, false, false, __nv_bfloat16>();
    enrol_directions<true, true, false, __nv_bfloat16>();
    enrol_directions<false, true, false, __nv_bfloat16>();
    enrol_directions<true, false, true, float>();
  }
} enrolment;

#if SATT_PART == 0

// every part's kernels, by variant_of (null where no instantiation is compiled)
const void* kernels[VARIANTS] = {};

// The kernel of one direction compiled for the specialisation of `d`'s widths (a
// second memory, E2 > 0, means two sources; K > 0 location-sensitive attention),
// with io type `d.bf16`; null for stamps on any structure but the flagship's in float.
const void* kernel_address(const Dims& d, bool backward) {
  const bool dual = d.E2 > 0, ls = d.K > 0, stamps = d.stamp_step >= 0;
  if (stamps && !(dual && !ls && !d.bf16)) return nullptr;
  return kernels[variant_of(backward, dual, ls, stamps, d.bf16 != 0)];
}

// Dynamic shared memory one block may have on the current device (what a block can
// opt in to, less what the kernel declares statically and the alignment of the
// dynamic region) and the device's SM count; a CUDA error code, or 0.
int device_limits(const Dims& d, bool backward, long long* have, int* sms) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  cudaFuncAttributes attr;
  const void* kernel = kernel_address(d, backward);
  if (err == cudaSuccess && kernel == nullptr) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  // less the 128 bytes the backward takes to align its dynamic region
  *have = (long long)optin - (long long)attr.sharedSizeBytes - 128;
  return 0;
}

template <typename IO>
int launch_io(bool backward, const void* const* pointers, const Dims& d, const Scalars& sc,
              const Bits& bt, cudaStream_t stream) {
  const void* kernel = kernel_address(d, backward);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  long long have = 0;
  int sms = 0;
  const int err = device_limits(d, backward, &have, &sms);
  if (err != 0) return err;
  const Held held = plan_held(d, backward, sms);
  if ((long long)smem_need(d, backward, sms) > have) return (int)cudaErrorInvalidValue;
  // the backward aligns its dynamic region itself (teacher_bwd_kernel): 128 bytes more
  const size_t smem = (size_t)imin((int)smem_want(d, backward, sms), (int)have) +
                      (backward ? 128 : 0);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  // the grid barriers need every block resident: a launch that cannot have that
  // is refused here instead of waiting forever
  Ptrs<IO> p = make_ptrs<IO>(pointers, d);
  Dims dd = d;
  Scalars s = sc;
  Bits b = bt;
  Held h = held;
  void* args[] = {(void*)&p, (void*)&dd, (void*)&s, (void*)&b, (void*)&h};
  e = cudaLaunchCooperativeKernel(kernel, dim3(sms), dim3(NT), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch(bool backward, const void* const* pointers, const int* dims, const float* scalars,
           const unsigned* bits, void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  Scalars sc;
  std::memcpy(&sc, scalars, sizeof(Scalars));
  Bits bt;
  std::memcpy(&bt, bits, sizeof(Bits));
  if (!sizes_ok(d)) return (int)cudaErrorInvalidValue;
  if (d.SPK > 0 && pointers[6] == nullptr) return (int)cudaErrorInvalidValue;
  if (d.E2 > 0 && pointers[4] == nullptr) return (int)cudaErrorInvalidValue;
  if (backward && pointers[18] == nullptr) return (int)cudaErrorInvalidValue;
  if (d.K > 0 && (pointers[19] == nullptr ||
                  (backward && (pointers[20] == nullptr || pointers[21] == nullptr ||
                                pointers[22] == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (pointers[23] == nullptr || (d.stamp_step >= 0 && pointers[24] == nullptr))
    return (int)cudaErrorInvalidValue;
  if (d.bf16) return launch_io<__nv_bfloat16>(backward, pointers, d, sc, bt, (cudaStream_t)stream);
  return launch_io<float>(backward, pointers, d, sc, bt, (cudaStream_t)stream);
}

#endif  // SATT_PART == 0

}  // namespace

#if SATT_PART == 0

void fused_teacher_enrol(int variant, const void* kernel) { kernels[variant] = kernel; }

extern "C" {

// Dynamic shared memory one block needs at the least, in bytes, for these sizes and
// io type on a grid of `grid` blocks (backward != 0: of the backward kernel),
// whatever the lane count; it does not grow with the source length or the steps.
long long fused_teacher_smem_bytes(const int* dims, int backward, int grid) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  return (long long)smem_need(d, backward != 0, grid);
}

// Dynamic shared memory one block of the kernel (of the specialisation and io type
// `dims` names) may have on the current device, in bytes: what a block can opt in to,
// less what the kernel declares statically. Negative: minus the CUDA error code.
long long fused_teacher_smem_limit(const int* dims, int backward) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  long long have = 0;
  int sms = 0;
  const int err = device_limits(d, backward != 0, &have, &sms);
  return err != 0 ? -(long long)err : have;
}

// Bytes of the scratch buffer a launch of these sizes reads and writes (zeroed by
// the caller).
long long fused_teacher_scratch_bytes(const int* dims, int backward) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  return (long long)scratch_layout(d, backward != 0).total;
}

// `pointers`: 25 device pointers in the order of make_ptrs (host array); the
// forward reads the first 11, 18..19 and 23..24, the backward all but 7..8. With one
// source pointers[4] (the second memory) is a placeholder that is never read, and
// so are 19..22 without location-sensitive attention; 24 (the stamps) is null
// unless dims' stamp_step >= 0. The io type is dims' bf16 flag: pointers 0..4, 6
// and 13 are of it.
int fused_teacher_fwd(const void* const* pointers, const int* dims, const float* scalars,
                      const unsigned* bits, void* stream) {
  return launch(false, pointers, dims, scalars, bits, stream);
}

int fused_teacher_bwd(const void* const* pointers, const int* dims, const float* scalars,
                      const unsigned* bits, void* stream) {
  return launch(true, pointers, dims, scalars, bits, stream);
}

}  // extern "C"

#endif  // SATT_PART == 0
