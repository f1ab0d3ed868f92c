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
// matrix Wls (K rows, zero-padded to LS_TAPS, in the io type) lives in shared
// memory from the first step on, the cumulative alignments in a row per lane beside
// the alignments, and the location features are formed inside the score pass
// (location.cuh), never stored; without LS none of that takes room or code. LF0
// (the WORLD heads' lf0 feedback, below) is compiled with forward attention for all
// four pairs. IO is
// the type of the weights, keys, memories, speaker embedding and K/V cache in
// global memory. With bfloat16 the
// kernel rounds the input of every product to bfloat16 where the Pallas kernel
// casts it to its io_dtype (the fed-back frame, the prenet's second input, the
// attention LSTM's input, the query, the transition agent's input, both decoder
// LSTMs' inputs, the feature, both LayerNorm outputs, the attention output, the
// FFN's hidden layer and the output projection's input) and keeps everything else
// in float: the products' sums, the LSTM and attention state, the score bias,
// score vectors, LayerNorm parameters, softmaxes, stop logits and the outputs.
// The LSTMs' hidden states then live apart from their rounded copies. With LS the
// taps (the alignment values) and Wls are rounded too; the location sum and its
// bias stay float.
//
// The frame is one M-wide row whatever the heads. With the WORLD heads (mgc, then
// lf0) the fed-back frame's lanes from LF0 = num_mgcs on are class logits that
// training never feeds (it feeds one-hot rows), so they are softmaxed before the
// next prenet reads them: from the unrounded float logits (summed again from the
// output product's partial sums), in float, a warp per lane, rounded to the io type
// once after the softmax, as the Pallas kernel casts the fed-back frame only at its
// end. The frames written out stay logits. This is the template flag LF0, compiled
// with forward attention for all four pairs of DUAL / USE_SA and both io types:
// read from the width at run time inside every instantiation instead, the
// softmax's code moved the flagship's register allocation and cost its decode 5 %
// on an H100 (PERF.md, PR 9).
//
// The decoder self-attention walks the cache's prefix in tiles of SA_TILE
// positions with an online softmax (running maximum and sum per lane and head,
// the output accumulator rescaled from tile to tile): nothing in shared memory
// grows with T. A prefix of one tile (every step of a request of up to SA_TILE
// steps) is normalised before its product with V, as a plain softmax is.
//
// What bounds it on an H100 is the serial chain of steps, not bytes or
// operations: a step is a dozen dependent small products. The design is one
// block per LANES lanes that walks all the steps on its own. State lives in
// shared memory; the weights (one flat buffer of the io type, every matrix (in,
// out) with rows padded to four values, and a small float buffer of the score
// vectors and LayerNorm parameters) are streamed through L2 every step, four
// values per thread and eight loads in flight, each weight read serving LANES
// lanes; a product's reduction is split over the threads and the partial sums are
// added in shared memory. Conditioning and the K/V cache stay in global memory; K
// is cached transposed (position minor), so that both passes of the attention
// read consecutive addresses along the axis they do not reduce. Blocks share
// nothing but the exit decision: each step every block adds (1, done?) to that
// step's counter in global memory and waits until all have arrived. That needs
// all blocks resident at once, so such a launch is cooperative.
//
// Plain C interface at the bottom: the function launches on the given stream,
// allocates nothing, does not synchronise, and returns the CUDA error code.

#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "dense.cuh"
#include "location.cuh"

namespace {

constexpr int LANES = 4;
constexpr int NT = 512;
constexpr int NWARPS = NT / 32;
static_assert(NWARPS >= 2 * LANES, "a warp per (lane, source) in the softmax stage");
// Positions of the decoder self-attention's prefix per tile (a multiple of 4):
// requests of up to this many steps attend in one tile.
constexpr int SA_TILE = 512;

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
// ls_cum: its taps read the cumulative alignments; bf16 the io type.
struct Dims {
  int B, S, T;
  int M, R, P1, P2, SPK, AU, A1, A2, DU, SA, H, FFN, E1, E2, K, LF0;
  int use_ta, early_exit, use_masks, ls_cum, bf16;
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
  int* info;                     // [0] steps run, [1 + t] arrival counter of step t
};

// Offsets (in floats) of the arrays in dynamic shared memory. Every per-lane
// array is LANES rows of r4(width) floats; those of a stage a specialisation
// does not have take no room. The wrapper asks for this sum through
// fused_decode_smem_bytes below and keeps no copy of it.
struct Layout {
  int part, feed, x1, attin, catt, f1, qp, e1, e2, alpha1, tmp, din, c1, din2, c2, feat;
  int xs, xn, q, attn, y, logit, stat, out, hatt, h1, h2, cum, lsw, total;
};

// The kernel passes its compile-time flags; the host passes what the widths and
// the io flag say (E2 > 0, SA > 0, bf16). Read from the widths inside the kernel
// as well, the flagship's instantiation ran 9 % slower on an H100, with the same
// registers and spills. `split`: the LSTMs' hidden states live apart from the
// rounded copies that the products read (bfloat16 only).
// `ls`: the cumulative alignments and the folded location matrix (appended, so that
// the other specialisations keep their layout).
__host__ __device__ inline Layout make_layout(const Dims& d, bool dual, bool use_sa, bool ls,
                                              bool split) {
  const int A = d.A1 + d.A2, OW = d.R * d.M + d.R;
  const int KA = d.P2 + d.SPK + d.E1 + d.E2 + d.AU;
  const int KD1 = d.AU + d.E1 + d.E2 + d.DU;
  const int sa = use_sa ? 1 : 0;   // without self-attention its arrays take no room
  const int st = split ? 1 : 0;
  int widest = imax(r4(d.P1), r4(d.P2));
  widest = imax(widest, imax(4 * d.AU, 4 * d.DU));
  widest = imax(widest, imax(r4(A), sa * 3 * d.SA));
  widest = imax(widest, imax(sa * r4(d.FFN), r4(OW)));
  widest = imax(widest, imax(d.E1 + d.E2, sa * d.H * SA_TILE));
  widest = r4(widest);
  Layout L;
  int at = 0;
  L.part = at;   at += LANES * imax(4 * NT, widest);
  L.feed = at;   at += LANES * r4(d.M);
  L.x1 = at;     at += LANES * r4(d.P1);
  L.attin = at;  at += LANES * r4(KA);
  L.catt = at;   at += LANES * r4(d.AU);
  L.f1 = at;     at += sa * LANES * r4(d.FFN);
  L.qp = at;     at += LANES * r4(A);
  L.e1 = at;     at += LANES * r4(d.S);
  L.e2 = at;     at += (dual ? 1 : 0) * LANES * r4(d.S);
  L.alpha1 = at; at += LANES * r4(d.S);
  L.tmp = at;    at += LANES * r4(d.S);
  L.din = at;    at += LANES * r4(KD1);
  L.c1 = at;     at += LANES * r4(d.DU);
  L.din2 = at;   at += LANES * r4(2 * d.DU);
  L.c2 = at;     at += LANES * r4(d.DU);
  L.feat = at;   at += LANES * r4(d.DU);
  L.xs = at;     at += sa * LANES * r4(d.SA);
  L.xn = at;     at += sa * LANES * r4(d.SA);
  L.q = at;      at += sa * LANES * r4(d.SA);
  L.attn = at;   at += sa * LANES * r4(d.SA);
  L.y = at;      at += sa * LANES * r4(d.SA);
  L.logit = at;  at += sa * LANES * r4(d.H * SA_TILE);
  L.stat = at;   at += sa * 3 * r4(LANES * d.H);   // running max, sum and rescale per (lane, head)
  L.out = at;    at += LANES * r4(OW);
  L.hatt = at;   at += st * LANES * r4(d.AU);
  L.h1 = at;     at += st * LANES * r4(d.DU);
  L.h2 = at;     at += st * LANES * r4(d.DU);
  L.cum = at;    at += (ls ? 1 : 0) * LANES * r4(d.S);
  L.lsw = at;    at += (ls ? 1 : 0) * LS_TAPS * r4(d.A1);
  L.total = at;
  return L;
}

// Eval-mode ZoneoutLSTM from the partial sums of its gate product (4U columns,
// i, g, f, o). c is s_c[l * ldc + j] and the hidden state s_h[l * ldh + j], both
// float and overwritten. The new h, rounded to the io type, also goes to s_in,
// the cell's own input slot that the next step's product reads (with float io
// s_in is s_h itself); and then either to s_cp (the next product's input) or,
// where s_sum is given, h + s_res[...] rounded to s_sum.
template <typename IO>
__device__ __forceinline__ void lstm_pointwise(const float* s_part, int parts, int U,
                                               const IO* __restrict__ b, float* s_c, int ldc,
                                               float* s_h, int ldh, float* s_in, int ldin,
                                               float* s_cp, int ldcp, float* s_sum,
                                               const float* s_res, int ldres, const Scalars& sc,
                                               int tid) {
  const int ld = 4 * U;
  for (int i = tid; i < LANES * U; i += NT) {
    const int l = i / U;
    const int j = i - l * U;
    const float zi = gather<LANES>(s_part, parts, ld, l, j) + Io<IO>::load(b + j);
    const float zg = gather<LANES>(s_part, parts, ld, l, U + j) + Io<IO>::load(b + U + j);
    const float zf = gather<LANES>(s_part, parts, ld, l, 2 * U + j) + Io<IO>::load(b + 2 * U + j);
    const float zo = gather<LANES>(s_part, parts, ld, l, 3 * U + j) + Io<IO>::load(b + 3 * U + j);
    const float c = s_c[l * ldc + j];
    const float h = s_h[l * ldh + j];
    const float new_c = sigmoidf_(zf + sc.forget_bias) * c + sigmoidf_(zi) * tanhf(zg);
    const float new_h = sigmoidf_(zo) * tanhf(new_c);
    const float out_c = sc.zc * c + (1.0f - sc.zc) * new_c;
    const float out_h = sc.zo * h + (1.0f - sc.zo) * new_h;
    s_c[l * ldc + j] = out_c;
    s_h[l * ldh + j] = out_h;
    const float rounded = Io<IO>::round(out_h);
    if (!std::is_same<IO, float>::value) s_in[l * ldin + j] = rounded;
    if (s_sum != nullptr) s_sum[l * ldcp + j] = Io<IO>::round(out_h + s_res[l * ldres + j]);
    else s_cp[l * ldcp + j] = rounded;
  }
}

// LayerNorm of LANES rows of n values, a warp per row; the output rounded to IO.
template <typename IO>
__device__ __forceinline__ void layer_norm(const float* s_x, float* s_y, int ldx, int n,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, float eps, int warp,
                                           int lane) {
  if (warp < LANES) {
    const float* x = s_x + warp * ldx;
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) sum += x[j];
    const float mean = warp_sum(sum) / (float)n;
    float sq = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float c = x[j] - mean;
      sq += c * c;
    }
    const float sd = sqrtf(warp_sum(sq) / (float)n + eps);
    for (int j = lane; j < n; j += 32)
      s_y[warp * ldx + j] =
          Io<IO>::round((x[j] - mean) / sd * __ldg(scale + j) + __ldg(bias + j));
  }
}

template <bool DUAL, bool USE_SA, bool LS, bool LF0, typename IO>
__global__ void __launch_bounds__(NT)
fused_decode_kernel(const Ptrs<IO> P, const Dims d, const Scalars sc) {
  using Vec = typename Weights4<IO>::Vec;
  constexpr bool SPLIT = !std::is_same<IO, float>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_b[LANES];       // global lane, clamped into the batch
  __shared__ int s_valid[LANES];
  __shared__ int s_hi[LANES];      // positions below this can hold attention mass
  __shared__ int s_fin[LANES];
  __shared__ int s_len[LANES];
  __shared__ float s_u[LANES];
  __shared__ int s_all_done;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int B = d.B, S = d.S, T = d.T, T4 = r4(d.T);
  const int M = d.M, R = d.R, P1 = d.P1, P2 = d.P2, AU = d.AU, A1 = d.A1, DU = d.DU;
  const int SA = d.SA, H = d.H, HD = USE_SA ? d.SA / d.H : 1, FFN = d.FFN, E1 = d.E1, E2 = d.E2;
  const int A = d.A1 + d.A2, EW = d.E1 + d.E2, RM = d.R * d.M, OW = d.R * d.M + d.R;
  const int KA = P2 + d.SPK + EW + AU, KD1 = AU + EW + DU;
  const int nblocks = gridDim.x;

  const Layout L = make_layout(d, DUAL, USE_SA, LS, SPLIT);
  float* s_part = smem + L.part;
  float* s_feed = smem + L.feed;     const int ld_feed = r4(M);
  float* s_x1 = smem + L.x1;         const int ld_x1 = r4(P1);
  float* s_attin = smem + L.attin;   const int ld_attin = r4(KA);
  float* s_catt = smem + L.catt;     const int ld_au = r4(AU);
  float* s_f1 = smem + L.f1;         const int ld_f1 = r4(FFN);
  float* s_qp = smem + L.qp;         const int ld_a = r4(A);
  float* s_e1 = smem + L.e1;         const int ld_s = r4(S);
  float* s_e2 = smem + L.e2;
  float* s_alpha1 = smem + L.alpha1;
  float* s_tmp = smem + L.tmp;
  float* s_din = smem + L.din;       const int ld_din = r4(KD1);
  float* s_c1 = smem + L.c1;         const int ld_du = r4(DU);
  float* s_din2 = smem + L.din2;     const int ld_din2 = r4(2 * DU);
  float* s_c2 = smem + L.c2;
  float* s_feat = smem + L.feat;
  float* s_xs = smem + L.xs;         const int ld_sa = r4(SA);
  float* s_xn = smem + L.xn;
  float* s_q = smem + L.q;
  float* s_attn = smem + L.attn;
  float* s_y = smem + L.y;
  float* s_logit = smem + L.logit;   const int ld_logit = r4(H * SA_TILE);
  float* s_mrun = smem + L.stat;     const int ld_stat = r4(LANES * H);
  float* s_lsum = s_mrun + ld_stat;
  float* s_scale = s_lsum + ld_stat;
  float* s_out = smem + L.out;       const int ld_out = r4(OW);
  float* s_cum = smem + L.cum;       // LS only
  float* s_lsw = smem + L.lsw;       const int ld_lsw = r4(A1);
  // the LSTMs' hidden states: beside their rounded input copies, or (float io) those slots
  float* st_att = SPLIT ? smem + L.hatt : s_attin + (KA - AU);
  const int ld_st_att = SPLIT ? ld_au : ld_attin;
  float* st_h1 = SPLIT ? smem + L.h1 : s_din + (KD1 - DU);
  const int ld_st_h1 = SPLIT ? ld_du : ld_din;
  float* st_h2 = SPLIT ? smem + L.h2 : s_din2 + DU;
  const int ld_st_h2 = SPLIT ? ld_du : ld_din2;
  // what the second LSTM's residual reads: h1's state (float io: its copy in s_din2)
  const float* res_h1 = SPLIT ? st_h1 : s_din2;
  const int ld_res_h1 = SPLIT ? ld_st_h1 : ld_din2;

  const IO* w = P.w;
  const float* w32 = P.w32;

  // ------------------------------ initial state ------------------------------
  for (int i = tid; i < L.total; i += NT) smem[i] = 0.0f;
  if (tid < LANES) {
    const int b = blockIdx.x * LANES + tid;
    s_valid[tid] = b < B;
    s_b[tid] = b < B ? b : B - 1;
    s_fin[tid] = b < B ? 0 : 1;      // a padded lane never holds the exit open
    s_len[tid] = 0;
    s_u[tid] = 0.5f;
  }
  __syncthreads();
  if (LS) {
    // the additive family starts uniform over the source; the folded matrix, once
    for (int i = tid; i < LANES * S; i += NT) {
      const int l = i / S;
      s_alpha1[l * ld_s + (i - l * S)] = 1.0f / (float)S;
    }
    for (int i = tid; i < LS_TAPS * A1; i += NT) {
      const int k = i / A1, a = i - k * A1;
      s_lsw[k * ld_lsw + a] = Io<IO>::load(w + d.off[LS_W] + k * ld_lsw + a);
    }
  } else if (tid < LANES) {
    s_alpha1[tid * ld_s] = 1.0f;   // forward attention: all mass at position 0
  }
  if (P.spk != nullptr)
    for (int i = tid; i < LANES * d.SPK; i += NT) {
      const int l = i / d.SPK, j = i - l * d.SPK;
      s_attin[l * ld_attin + P2 + j] = Io<IO>::load(P.spk + (size_t)s_b[l] * d.SPK + j);
    }
  if (warp < LANES) {
    int hi = 0;
    for (int s = lane; s < S; s += 32)
      if (__ldg(P.bias + (size_t)s_b[warp] * S + s) > -1e8f) hi = s + 1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) hi = imax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    if (lane == 0) s_hi[warp] = hi > 0 ? hi : S;   // nothing valid: the softmax is uniform
  }
  __syncthreads();

  int steps = 0;
  for (int t = 0; t < T; ++t) {
    // ------------------------------ prenet ------------------------------------
    int parts = dense_partial<LANES, NT>(w + d.off[P1_W], r4(P1), M, s_feed, ld_feed, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * P1; i += NT) {
      const int l = i / P1, j = i - l * P1;
      float v = fmaxf(gather<LANES>(s_part, parts, r4(P1), l, j) + Io<IO>::load(w + d.off[P1_B] + j), 0.0f);
      if (d.use_masks) v = P.mask1[((size_t)t * B + s_b[l]) * P1 + j] ? v * sc.inv_keep : 0.0f;
      s_x1[l * ld_x1 + j] = Io<IO>::round(v);
    }
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[P2_W], r4(P2), P1, s_x1, ld_x1, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * P2; i += NT) {
      const int l = i / P2, j = i - l * P2;
      float v = fmaxf(gather<LANES>(s_part, parts, r4(P2), l, j) + Io<IO>::load(w + d.off[P2_B] + j), 0.0f);
      if (d.use_masks) v = P.mask2[((size_t)t * B + s_b[l]) * P2 + j] ? v * sc.inv_keep : 0.0f;
      s_attin[l * ld_attin + j] = Io<IO>::round(v);
    }
    __syncthreads();

    // ------------------------------ attention LSTM -----------------------------
    // input [prenet | speaker | ctx1 | ctx2 | h_att]; the new h_att is the query
    parts = dense_partial<LANES, NT>(w + d.off[ATTG_W], 4 * AU, KA, s_attin, ld_attin, s_part, tid);
    __syncthreads();
    lstm_pointwise<IO>(s_part, parts, AU, w + d.off[ATTG_B], s_catt, ld_au, st_att, ld_st_att,
                       s_attin + (KA - AU), ld_attin, s_din, ld_din, nullptr, nullptr, 0, sc, tid);
    __syncthreads();

    // ------------------------------ both sources' scores -----------------------
    parts = dense_partial<LANES, NT>(w + d.off[QP_W], r4(A), AU, s_din, ld_din, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * A; i += NT) {
      const int l = i / A, j = i - l * A;
      s_qp[l * ld_a + j] = gather<LANES>(s_part, parts, r4(A), l, j);
    }
    __syncthreads();
    if (LS) {
      // a warp per (lane, LS_RUN neighbouring positions): the taps of those
      // positions in registers, source 1's columns adding the location features
      const int nrun = (S + LS_RUN - 1) / LS_RUN;
      const float* prev_rows = d.ls_cum ? s_cum : s_alpha1;
      for (int task = warp; task < LANES * nrun; task += NWARPS) {
        const int l = task / nrun, s0 = (task - l * nrun) * LS_RUN;
        float win[LS_WIN];
        ls_window<IO>(prev_rows + l * ld_s, S, s0 - (d.K >> 1), win);
        float acc1[LS_RUN], acc2[LS_RUN];
#pragma unroll
        for (int j = 0; j < LS_RUN; ++j) acc1[j] = acc2[j] = 0.0f;
        const IO* keys = P.keys + (size_t)s_b[l] * S * A;
        for (int a = lane; a < A; a += 32) {
          const float q = s_qp[l * ld_a + a];
          const float v = __ldg(w32 + d.off[V_CAT] + a);
          const bool first = !DUAL || a < A1;
          float loc[LS_RUN];
          if (first) {
            ls_dot(win, s_lsw, ld_lsw, a, loc);
            const float b = __ldg(w32 + d.off[LS_B] + a);
#pragma unroll
            for (int j = 0; j < LS_RUN; ++j) loc[j] += b;
          } else {
#pragma unroll
            for (int j = 0; j < LS_RUN; ++j) loc[j] = 0.0f;
          }
#pragma unroll
          for (int j = 0; j < LS_RUN; ++j) {
            const int s = imin(s0 + j, S - 1);   // past the source: computed, never written
            const float th = tanhf((Io<IO>::load(keys + (size_t)s * A + a) + q) + loc[j]) * v;
            if (first) acc1[j] += th; else acc2[j] += th;
          }
        }
#pragma unroll
        for (int j = 0; j < LS_RUN; ++j) {
          const float e1 = warp_sum(acc1[j]);
          const float e2 = DUAL ? warp_sum(acc2[j]) : 0.0f;
          const int s = s0 + j;
          if (lane == 0 && s < S) {
            // a padded position keeps -1e9: its probability is exactly 0
            const float bias = __ldg(P.bias + (size_t)s_b[l] * S + s);
            s_e1[l * ld_s + s] = bias > -1e8f ? e1 + bias : bias;
            if (DUAL) s_e2[l * ld_s + s] = bias > -1e8f ? e2 + bias : bias;
          }
        }
      }
    } else {
      for (int pair = warp; pair < LANES * S; pair += NWARPS) {
        const int l = pair / S, s = pair - l * S;
        const float bias = __ldg(P.bias + (size_t)s_b[l] * S + s);
        float e1 = bias, e2 = bias;
        if (bias > -1e8f) {   // a padded position keeps -1e9: its probability is exactly 0
          const IO* key = P.keys + ((size_t)s_b[l] * S + s) * A;
          float acc1 = 0.0f, acc2 = 0.0f;
          for (int a = lane; a < A; a += 32) {
            const float v = tanhf(Io<IO>::load(key + a) + s_qp[l * ld_a + a]) *
                            __ldg(w32 + d.off[V_CAT] + a);
            if (!DUAL || a < A1) acc1 += v; else acc2 += v;
          }
          e1 = warp_sum(acc1) + bias;
          if (DUAL) e2 = warp_sum(acc2) + bias;
        }
        if (lane == 0) {
          s_e1[l * ld_s + s] = e1;
          if (DUAL) s_e2[l * ld_s + s] = e2;
        }
      }
    }
    __syncthreads();

    // ------------------------------ alignments ---------------------------------
    if (warp < (DUAL ? 2 : 1) * LANES) {
      const int l = warp < LANES ? warp : warp - LANES;
      float* e = (warp < LANES ? s_e1 : s_e2) + l * ld_s;
      float m = -3.0e38f;
      for (int s = lane; s < S; s += 32) m = fmaxf(m, e[s]);
      m = warp_max(m);
      float sum = 0.0f;
      for (int s = lane; s < S; s += 32) {
        const float v = expf(e[s] - m);
        e[s] = v;
        sum += v;
      }
      sum = warp_sum(sum);
      if (LS && warp < LANES) {
        // location-sensitive: the alignments are the softmax, the taps' next input
        float* alpha = s_alpha1 + l * ld_s;
        float* cum = s_cum + l * ld_s;
        float* row = P.align1 + ((size_t)s_b[l] * T + t) * S;
        for (int s = lane; s < S; s += 32) {
          const float v = e[s] / sum;
          alpha[s] = v;
          if (d.ls_cum) cum[s] += v;
          if (s_valid[l]) row[s] = v;
        }
      } else if (warp < LANES) {
        // a_i(n) = ((1 - u) a_i(n-1) + u a_{i-1}(n-1) + 1e-6) y_i(n), renormalised
        const float u = s_u[l];
        float* prev = s_alpha1 + l * ld_s;
        float* hat = s_tmp + l * ld_s;
        float total = 0.0f;
        for (int s = lane; s < S; s += 32) {
          const float y = e[s] / sum;
          const float shifted = s > 0 ? prev[s - 1] : 0.0f;
          const float v = ((1.0f - u) * prev[s] + u * shifted + 1e-6f) * y;
          hat[s] = v;
          total += v;
        }
        total = warp_sum(total);
        __syncwarp();
        float* row = P.align1 + ((size_t)s_b[l] * T + t) * S;
        for (int s = lane; s < S; s += 32) {
          const float v = hat[s] / total;
          prev[s] = v;
          if (s_valid[l]) row[s] = v;
        }
      } else {
        float* row = P.align2 + ((size_t)s_b[l] * T + t) * S;
        for (int s = lane; s < S; s += 32) {
          const float v = e[s] / sum;
          e[s] = v;
          if (s_valid[l]) row[s] = v;
        }
      }
    }
    __syncthreads();

    // ------------------------------ contexts -----------------------------------
    // ctx[l][col] = sum_s alpha[l][s] * memory[b][s][col], both sources side by side
    {
      const int nc4 = EW >> 2, G = LANES * nc4;
      int cparts = imax(1, imin(NT / G, (S + 7) / 8));
      const int chunk = (S + cparts - 1) / cparts;
      cparts = (S + chunk - 1) / chunk;
      for (int idx = tid; idx < cparts * G; idx += NT) {
        const int p = idx / G, g = idx - p * G;
        const int l = g / nc4, c = g - l * nc4;
        const int col = 4 * c;
        const bool second = DUAL && col >= E1;
        const int width = second ? E2 : E1;
        const IO* mem = second ? P.mem2 + (size_t)s_b[l] * S * E2 + (col - E1)
                               : P.mem1 + (size_t)s_b[l] * S * E1 + col;
        const float* alpha = (second ? s_e2 : s_alpha1) + l * ld_s;
        const int s0 = p * chunk;
        const int s1 = imin(imin(s0 + chunk, S), s_hi[l]);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        int s = s0;
        for (; s + 8 <= s1; s += 8) {
          float4 m[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            m[u] = Weights4<IO>::values(
                __ldg(reinterpret_cast<const Vec*>(mem + (size_t)(s + u) * width)));
#pragma unroll
          for (int u = 0; u < 8; ++u) fma4(acc, alpha[s + u], m[u]);
        }
        for (; s < s1; ++s)
          fma4(acc, alpha[s],
               Weights4<IO>::values(__ldg(reinterpret_cast<const Vec*>(mem + (size_t)s * width))));
        *reinterpret_cast<float4*>(s_part + (size_t)(p * LANES + l) * EW + col) = acc;
      }
      __syncthreads();
      for (int i = tid; i < LANES * EW; i += NT) {
        const int l = i / EW, j = i - l * EW;
        const float v = Io<IO>::round(gather<LANES>(s_part, cparts, EW, l, j));
        s_attin[l * ld_attin + P2 + d.SPK + j] = v;   // next step's attention LSTM input
        s_din[l * ld_din + AU + j] = v;               // [query | ctx1 | ctx2 | h1]
      }
      __syncthreads();
    }

    // ------------------------------ transition agent ---------------------------
    if (d.use_ta && warp < LANES) {
      const IO* wt = w + d.off[TA_W];
      const float* row = s_din + warp * ld_din;
      float acc = 0.0f;
      for (int i = lane; i < E1 + AU; i += 32)
        acc += Io<IO>::load(wt + i) * (i < E1 ? row[AU + i] : row[i - E1]);   // [ctx1 | query]
      acc = warp_sum(acc);
      if (lane == 0) s_u[warp] = sigmoidf_(acc + Io<IO>::load(w + d.off[TA_B]));
    }

    // ------------------------------ decoder LSTMs ------------------------------
    parts = dense_partial<LANES, NT>(w + d.off[L1_W], 4 * DU, KD1, s_din, ld_din, s_part, tid);
    __syncthreads();
    lstm_pointwise<IO>(s_part, parts, DU, w + d.off[L1_B], s_c1, ld_du, st_h1, ld_st_h1,
                       s_din + (KD1 - DU), ld_din, s_din2, ld_din2, nullptr, nullptr, 0, sc, tid);
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[L2_W], 4 * DU, 2 * DU, s_din2, ld_din2, s_part, tid);
    __syncthreads();
    // feature = h2 + h1
    lstm_pointwise<IO>(s_part, parts, DU, w + d.off[L2_B], s_c2, ld_du, st_h2, ld_st_h2,
                       s_din2 + DU, ld_din2, nullptr, ld_du, s_feat, res_h1, ld_res_h1, sc, tid);
    __syncthreads();

    // ------------------------------ self-attention block -----------------------
    if (USE_SA) {
      parts = dense_partial<LANES, NT>(w + d.off[IN_W], r4(SA), DU, s_feat, ld_du, s_part, tid);
      __syncthreads();
      for (int i = tid; i < LANES * SA; i += NT) {
        const int l = i / SA, j = i - l * SA;
        const double angle = (double)t * P.pe_rate[j];
        const float pe = (float)((j & 1) ? cos(angle) : sin(angle));
        s_xs[l * ld_sa + j] =
            gather<LANES>(s_part, parts, r4(SA), l, j) + Io<IO>::load(w + d.off[IN_B] + j) + pe;
      }
      __syncthreads();
      layer_norm<IO>(s_xs, s_xn, ld_sa, SA, w32 + d.off[LN1_S], w32 + d.off[LN1_B], sc.ln_eps,
                     warp, lane);
      __syncthreads();
      parts = dense_partial<LANES, NT>(w + d.off[QKV_W], r4(3 * SA), SA, s_xn, ld_sa, s_part, tid);
      __syncthreads();
      for (int i = tid; i < LANES * 3 * SA; i += NT) {
        const int l = i / (3 * SA), j = i - l * 3 * SA;
        const float v = gather<LANES>(s_part, parts, r4(3 * SA), l, j);
        if (j < SA) {
          s_q[l * ld_sa + j] = v / sc.sqrt_hd;
        } else if (s_valid[l]) {
          if (j < 2 * SA) P.kcache[((size_t)s_b[l] * SA + (j - SA)) * T4 + t] = Io<IO>::from(v);
          else P.vcache[((size_t)s_b[l] * T + t) * SA + (j - 2 * SA)] = Io<IO>::from(v);
        }
      }
      __syncthreads();
      // attention over the prefix 0..t, SA_TILE positions at a time
      const int n_all = t + 1;
      const int ntiles = (n_all + SA_TILE - 1) / SA_TILE;
      for (int tile = 0; tile < ntiles; ++tile) {
        const int p0 = tile * SA_TILE;
        const int np = imin(SA_TILE, n_all - p0);
        // logits[l][h][p] = sum_d q[l][h][d] * K[b][h][d][p0 + p], four positions a thread
        {
          const int n4 = (np + 3) >> 2, G = LANES * H * n4;
          int lparts = imax(1, imin(NT / G, (HD + 7) / 8));
          const int chunk = (HD + lparts - 1) / lparts;
          lparts = (HD + chunk - 1) / chunk;
          const int t4 = T4 >> 2;
          for (int idx = tid; idx < lparts * G; idx += NT) {
            const int p = idx / G, g = idx - p * G;
            const int lh = g / n4, p4 = g - lh * n4;
            const int l = lh / H, h = lh - l * H;
            const int d0 = p * chunk, d1 = imin(d0 + chunk, HD);
            const Vec* kp = reinterpret_cast<const Vec*>(
                                P.kcache + ((size_t)s_b[l] * SA + h * HD + d0) * T4 + p0) + p4;
            const float* q = s_q + l * ld_sa + h * HD;
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
            int dd = d0;
            for (; dd + 8 <= d1; dd += 8) {
              float4 k[8];
#pragma unroll
              for (int u = 0; u < 8; ++u) k[u] = Weights4<IO>::values(__ldcg(kp + (size_t)u * t4));
              kp += (size_t)8 * t4;
#pragma unroll
              for (int u = 0; u < 8; ++u) fma4(acc, q[dd + u], k[u]);
            }
            for (; dd < d1; ++dd) {
              fma4(acc, q[dd], Weights4<IO>::values(__ldcg(kp)));
              kp += t4;
            }
            *reinterpret_cast<float4*>(s_part + (size_t)p * G * 4 + g * 4) = acc;
          }
          __syncthreads();
          for (int pair = warp; pair < LANES * H; pair += NWARPS) {
            float* row = s_logit + (pair / H) * ld_logit + (pair % H) * SA_TILE;
            float m = -3.0e38f;
            for (int p = lane; p < np; p += 32) {
              float v = 0.0f;
              for (int pp = 0; pp < lparts; ++pp) v += s_part[(size_t)pp * G * 4 + pair * n4 * 4 + p];
              row[p] = v;
              m = fmaxf(m, v);
            }
            m = warp_max(m);
            if (ntiles == 1) {   // one tile: the plain softmax
              float sum = 0.0f;
              for (int p = lane; p < np; p += 32) {
                const float v = expf(row[p] - m);
                row[p] = v;
                sum += v;
              }
              sum = warp_sum(sum);
              for (int p = lane; p < np; p += 32) row[p] = row[p] / sum;
            } else {             // online: rescale what the earlier tiles summed
              const float m_old = tile == 0 ? -3.0e38f : s_mrun[pair];
              const float m_new = fmaxf(m_old, m);
              const float scale = tile == 0 ? 0.0f : expf(m_old - m_new);
              float sum = 0.0f;
              for (int p = lane; p < np; p += 32) {
                const float v = expf(row[p] - m_new);
                row[p] = v;
                sum += v;
              }
              sum = warp_sum(sum);
              if (lane == 0) {
                s_lsum[pair] = (tile == 0 ? 0.0f : s_lsum[pair] * scale) + sum;
                s_mrun[pair] = m_new;
                s_scale[pair] = scale;
              }
            }
          }
          __syncthreads();
        }
        // attn[l][col] (+)= sum_{p < np} probs[l][head(col)][p] * V[b][p0 + p][col]
        {
          const int nc4 = SA >> 2, G = LANES * nc4;
          int vparts = imax(1, imin(NT / G, (np + 7) / 8));
          const int chunk = (np + vparts - 1) / vparts;
          vparts = (np + chunk - 1) / chunk;
          for (int idx = tid; idx < vparts * G; idx += NT) {
            const int p = idx / G, g = idx - p * G;
            const int l = g / nc4, c = g - l * nc4;
            const int h = (4 * c) / HD;
            const int q0 = p * chunk, q1 = imin(q0 + chunk, np);
            const Vec* vp =
                reinterpret_cast<const Vec*>(P.vcache + ((size_t)s_b[l] * T + p0 + q0) * SA) + c;
            const float* pr = s_logit + l * ld_logit + h * SA_TILE;
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
            int pos = q0;
            for (; pos + 8 <= q1; pos += 8) {
              float4 v[8];
#pragma unroll
              for (int u = 0; u < 8; ++u) v[u] = Weights4<IO>::values(__ldcg(vp + (size_t)u * nc4));
              vp += (size_t)8 * nc4;
#pragma unroll
              for (int u = 0; u < 8; ++u) fma4(acc, pr[pos + u], v[u]);
            }
            for (; pos < q1; ++pos) {
              fma4(acc, pr[pos], Weights4<IO>::values(__ldcg(vp)));
              vp += nc4;
            }
            *reinterpret_cast<float4*>(s_part + (size_t)(p * LANES + l) * SA + 4 * c) = acc;
          }
          __syncthreads();
          const bool last = tile == ntiles - 1;
          for (int i = tid; i < LANES * SA; i += NT) {
            const int l = i / SA, j = i - l * SA;
            float v = gather<LANES>(s_part, vparts, SA, l, j);
            if (ntiles > 1) {
              const int lh = l * H + j / HD;
              if (tile > 0) v += s_attn[l * ld_sa + j] * s_scale[lh];
              if (last) v /= s_lsum[lh];
            }
            s_attn[l * ld_sa + j] = last ? Io<IO>::round(v) : v;
          }
          __syncthreads();
        }
      }
      parts = dense_partial<LANES, NT>(w + d.off[O_W], r4(SA), SA, s_attn, ld_sa, s_part, tid);
      __syncthreads();
      for (int i = tid; i < LANES * SA; i += NT) {
        const int l = i / SA, j = i - l * SA;
        s_xs[l * ld_sa + j] +=
            gather<LANES>(s_part, parts, r4(SA), l, j) + Io<IO>::load(w + d.off[O_B] + j);
      }
      __syncthreads();
      layer_norm<IO>(s_xs, s_xn, ld_sa, SA, w32 + d.off[LN2_S], w32 + d.off[LN2_B], sc.ln_eps,
                     warp, lane);
      __syncthreads();
      parts = dense_partial<LANES, NT>(w + d.off[F1_W], r4(FFN), SA, s_xn, ld_sa, s_part, tid);
      __syncthreads();
      for (int i = tid; i < LANES * FFN; i += NT) {
        const int l = i / FFN, j = i - l * FFN;
        s_f1[l * ld_f1 + j] = Io<IO>::round(fmaxf(
            gather<LANES>(s_part, parts, r4(FFN), l, j) + Io<IO>::load(w + d.off[F1_B] + j), 0.0f));
      }
      __syncthreads();
      parts = dense_partial<LANES, NT>(w + d.off[F2_W], r4(SA), FFN, s_f1, ld_f1, s_part, tid);
      __syncthreads();
      for (int i = tid; i < LANES * SA; i += NT) {
        const int l = i / SA, j = i - l * SA;
        s_y[l * ld_sa + j] = Io<IO>::round(
            s_xs[l * ld_sa + j] + gather<LANES>(s_part, parts, r4(SA), l, j) +
            Io<IO>::load(w + d.off[F2_B] + j));
      }
      __syncthreads();

    }  // USE_SA

    // ------------------------------ output rows --------------------------------
    // from the block's output, or without self-attention from the feature itself
    parts = USE_SA
        ? dense_partial<LANES, NT>(w + d.off[OUT_W], r4(OW), SA, s_y, ld_sa, s_part, tid)
        : dense_partial<LANES, NT>(w + d.off[OUT_W], r4(OW), DU, s_feat, ld_du, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * OW; i += NT) {
      const int l = i / OW, j = i - l * OW;
      const float v = gather<LANES>(s_part, parts, r4(OW), l, j) + Io<IO>::load(w + d.off[OUT_B] + j);
      const size_t row = (size_t)s_b[l] * T + t;
      if (j < RM) {
        if (s_valid[l]) P.frames[row * RM + j] = v;
        // feed back the last frame, rounded to the io type as the next prenet reads it
        if (j >= RM - M) s_feed[l * ld_feed + (j - (RM - M))] = Io<IO>::round(v);
      } else {
        const float prob = sigmoidf_(v);
        s_out[l * ld_out + j] = prob;
        if (s_valid[l]) P.stops[row * R + (j - RM)] = prob;
      }
    }
    __syncthreads();

    // ------------------------------ lf0 feedback -------------------------------
    // softmax over the fed-back frame's lanes [LF0, M), a warp per lane of the
    // block (the last LANES warps, so that warp 0 goes on to the exit agreement),
    // from the unrounded logits, summed again from the output product's partial
    // sums (the loop above rounded what it fed back, as for the mel head)
    if (LF0 && warp >= NWARPS - LANES) {
      const int l = warp - (NWARPS - LANES);
      const int first = RM - M;   // the last frame's first column of the output row
      float* f = s_feed + l * ld_feed;
      float m = -3.0e38f;
      for (int k = d.LF0 + lane; k < M; k += 32) {
        const float v = gather<LANES>(s_part, parts, r4(OW), l, first + k) +
                        Io<IO>::load(w + d.off[OUT_B] + first + k);
        f[k] = v;
        m = fmaxf(m, v);
      }
      m = warp_max(m);
      float sum = 0.0f;
      for (int k = d.LF0 + lane; k < M; k += 32) {
        const float e = expf(f[k] - m);
        f[k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int k = d.LF0 + lane; k < M; k += 32) f[k] = Io<IO>::round(f[k] / sum);
    }

    // ------------------------------ stop tracking and exit ---------------------
    steps = t + 1;
    if (tid == 0) {
      int block_done = 1;
      for (int l = 0; l < LANES; ++l) {
        if (s_valid[l]) {
          int first = -1;
          for (int r = R - 1; r >= 0; --r)
            if (s_out[l * ld_out + RM + r] > sc.stop_threshold) first = r;
          if (first >= 0 && !s_fin[l]) {
            s_len[l] = t * R + first + 1;
            s_fin[l] = 1;
          }
        }
        block_done &= s_fin[l];
      }
      int all_done = block_done;
      if (d.early_exit && nblocks > 1) {
        // every block adds (1, done?) to this step's counter and waits for the rest
        unsigned int* counter = reinterpret_cast<unsigned int*>(P.info) + 1 + t;
        atomicAdd(counter, 1u | (block_done ? 0x10000u : 0u));
        unsigned int seen;
        const long long start = clock64();
        while (((seen = *reinterpret_cast<volatile unsigned int*>(counter)) & 0xffffu) <
               (unsigned int)nblocks) {
          if (clock64() - start > 20000000000LL) __trap();   // a block is missing: fail, never hang
        }
        all_done = (int)(seen >> 16) == nblocks;
      }
      s_all_done = d.early_exit && all_done;
    }
    __syncthreads();
    if (s_all_done) break;
  }

  if (tid < LANES && s_valid[tid]) {
    P.lengths[s_b[tid]] = s_fin[tid] ? s_len[tid] : steps * R;   // never fired: to the last step
    P.finished[s_b[tid]] = (unsigned char)s_fin[tid];
  }
  if (blockIdx.x == 0 && tid == 0) P.info[0] = steps;
}

bool sizes_ok(const Dims& d) {
  if (d.B <= 0 || d.S <= 0 || d.T <= 0 || d.M <= 0 || d.R <= 0 || d.P1 <= 0 || d.P2 <= 0 ||
      d.SPK < 0 || d.AU <= 0 || d.A1 <= 0 || d.DU <= 0 || d.E1 <= 0 || d.E1 % 4 != 0 ||
      (d.B + LANES - 1) / LANES > 0xffff)
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
using Kernel = void (*)(const Ptrs<IO>, const Dims, const Scalars);

template <bool LF0, typename IO>
Kernel<IO> forward_kernel(bool dual, bool use_sa) {
  if (dual) {
    return use_sa ? fused_decode_kernel<true, true, false, LF0, IO>
                  : fused_decode_kernel<true, false, false, LF0, IO>;
  }
  return use_sa ? fused_decode_kernel<false, true, false, LF0, IO>
                : fused_decode_kernel<false, false, false, LF0, IO>;
}

// The kernel compiled for the specialisation of `d`'s widths, with io type IO; null
// for location-sensitive attention on a pair of flags it is not compiled for, or
// with the lf0 feedback.
template <typename IO>
Kernel<IO> kernel_for(const Dims& d) {
  const bool dual = d.E2 > 0, use_sa = d.SA > 0;
  if (d.K > 0) {
    if (d.LF0 > 0) return nullptr;
    if (dual && use_sa) return fused_decode_kernel<true, true, true, false, IO>;
    if (!dual && !use_sa) return fused_decode_kernel<false, false, true, false, IO>;
    return nullptr;
  }
  return d.LF0 > 0 ? forward_kernel<true, IO>(dual, use_sa) : forward_kernel<false, IO>(dual, use_sa);
}

const void* kernel_address(const Dims& d) {
  return d.bf16 ? (const void*)kernel_for<__nv_bfloat16>(d) : (const void*)kernel_for<float>(d);
}

size_t smem_bytes(const Dims& d) {
  return (size_t)make_layout(d, d.E2 > 0, d.SA > 0, d.K > 0, d.bf16 != 0).total * sizeof(float);
}

template <typename IO>
int launch(const Ptrs<IO>& P, const Dims& d, const Scalars& sc, cudaStream_t stream) {
  const Kernel<IO> kernel = kernel_for<IO>(d);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.B + LANES - 1) / LANES);
  if (d.early_exit && grid.x > 1) {
    // the per-step exit agreement needs every block resident: a launch that
    // cannot have that is refused here instead of waiting forever
    Ptrs<IO> p = P;
    Dims dd = d;
    Scalars s = sc;
    void* args[] = {(void*)&p, (void*)&dd, (void*)&s};
    err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(NT), args, smem, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<grid, NT, smem, stream>>>(P, d, sc);
  }
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
  return P;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes, for these sizes and io type.
long long fused_decode_smem_bytes(const int* dims) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  return (long long)smem_bytes(d);
}

// Dynamic shared memory one block of the kernel (of the specialisation and io
// type `dims` names) may have on the current device, in bytes: what a block can
// opt in to, less what the kernel declares statically. Negative: minus the CUDA
// error code.
long long fused_decode_smem_limit(const int* dims) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  const void* kernel = kernel_address(d);
  if (err == cudaSuccess && kernel == nullptr) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)optin - (long long)attr.sharedSizeBytes;
}

// One launch. `ptrs` holds the 19 device pointers in the order of the Ptrs struct
// (w, w32, pe_rate, keys, mem1, mem2, bias, spk, mask1, mask2, kcache, vcache,
// frames, stops, align1, align2, lengths, finished, info); the io type is dims'
// bf16 flag.
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
  if (d.bf16) return launch(pointers<__nv_bfloat16>(ptrs), d, sc, (cudaStream_t)stream);
  return launch(pointers<float>(ptrs), d, sc, (cudaStream_t)stream);
}

}  // extern "C"
