// The whole autoregressive decode loop of the flagship in one launch.
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
//   source 2: a2 = softmax(e2);  contexts ctx_i = a_i . memory_i
//   two ZoneoutLSTMs, feature = h2 + h1
//   self-attention block: in-projection + sinusoid row t, LayerNorm, QKV, K and V
//     appended to the cache, softmax(q / sqrt(HD) . K[0..t]) . V[0..t], output
//     projection, residual, LayerNorm, FFN, residual
//   out = y . Wout + b: r frames and r stop logits; rows of frames, stop
//     probabilities and both alignments written out; per-lane first firing frame,
//     lengths and finished flags; the last frame fed back
//
// and leaves the loop at T steps or, with early_exit, as soon as every lane of
// the launch has fired.
//
// What bounds it on an H100 is the serial chain of steps, not bytes or
// operations: a step is a dozen dependent small products. The design is one
// block per LANES lanes that walks all the steps on its own. State lives in
// shared memory; the weights (one flat buffer, every matrix (in, out) with rows
// padded to 16 bytes) are streamed through L2 every step, 16 bytes per thread and
// eight loads in flight, each weight read serving LANES lanes; a product's
// reduction is split over the threads and the partial sums are added in shared
// memory. Conditioning and the K/V cache stay in global memory; K is cached
// transposed (position minor), so that both passes of the attention read
// consecutive addresses along the axis they do not reduce. Blocks share nothing
// but the exit decision: each step every block adds (1, done?) to that step's
// counter in global memory and waits until all have arrived. That needs all
// blocks resident at once, so such a launch is cooperative.
//
// Plain C interface at the bottom: the function launches on the given stream,
// allocates nothing, does not synchronise, and returns the CUDA error code.

#include <cuda_runtime.h>

#include <cstring>

#include "dense.cuh"

namespace {

constexpr int LANES = 4;
constexpr int NT = 512;
constexpr int NWARPS = NT / 32;
static_assert(NWARPS >= 2 * LANES, "a warp per (lane, source) in the softmax stage");

// Order of the entries in the flat weight buffer (ops/fused_decode.py::_ENTRIES).
enum Entry {
  P1_W, P1_B, P2_W, P2_B, ATTG_W, ATTG_B, QP_W, V_CAT, TA_W, TA_B,
  L1_W, L1_B, L2_W, L2_B, IN_W, IN_B, LN1_S, LN1_B, LN2_S, LN2_B,
  QKV_W, O_W, O_B, F1_W, F1_B, F2_W, F2_B, OUT_W, OUT_B, NUM_ENTRIES
};

// Sizes, flags and offsets (in floats), in the order the wrapper writes them.
struct Dims {
  int B, S, T;
  int M, R, P1, P2, SPK, AU, A1, A2, DU, SA, H, FFN, E1, E2;
  int use_ta, early_exit, use_masks;
  int off[NUM_ENTRIES];
};

struct Scalars {
  float zc, zo, forget_bias, inv_keep, stop_threshold, ln_eps, sqrt_hd;
};

struct Ptrs {
  const float* w;
  const double* pe_rate;
  const float* keys;             // (B, S, A1 + A2)
  const float* mem1;             // (B, S, E1)
  const float* mem2;             // (B, S, E2)
  const float* bias;             // (B, S)
  const float* spk;              // (B, SPK) or null
  const unsigned char* mask1;    // (T, B, P1) or null
  const unsigned char* mask2;    // (T, B, P2) or null
  float* kcache;                 // (B, SA, T4) scratch
  float* vcache;                 // (B, T, SA) scratch
  float* frames;                 // (B, T, R * M)
  float* stops;                  // (B, T, R)
  float* align1;                 // (B, T, S)
  float* align2;                 // (B, T, S)
  int* lengths;                  // (B,)
  unsigned char* finished;       // (B,)
  int* info;                     // [0] steps run, [1 + t] arrival counter of step t
};

// Offsets (in floats) of the arrays in dynamic shared memory. Every per-lane
// array is LANES rows of r4(width) floats. The wrapper asks for this sum through
// fused_decode_smem_bytes below and keeps no copy of it.
struct Layout {
  int part, feed, x1, attin, catt, f1, qp, e1, e2, alpha1, tmp, din, c1, din2, c2, feat;
  int xs, xn, q, attn, y, logit, out, total;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  const int A = d.A1 + d.A2, OW = d.R * d.M + d.R, T4 = r4(d.T);
  const int KA = d.P2 + d.SPK + d.E1 + d.E2 + d.AU;
  const int KD1 = d.AU + d.E1 + d.E2 + d.DU;
  int widest = imax(r4(d.P1), r4(d.P2));
  widest = imax(widest, imax(4 * d.AU, 4 * d.DU));
  widest = imax(widest, imax(r4(A), 3 * d.SA));
  widest = imax(widest, imax(r4(d.FFN), r4(OW)));
  widest = imax(widest, imax(d.E1 + d.E2, d.H * T4));
  widest = r4(widest);
  Layout L;
  int at = 0;
  L.part = at;   at += LANES * imax(4 * NT, widest);
  L.feed = at;   at += LANES * r4(d.M);
  L.x1 = at;     at += LANES * r4(d.P1);
  L.attin = at;  at += LANES * r4(KA);
  L.catt = at;   at += LANES * r4(d.AU);
  L.f1 = at;     at += LANES * r4(d.FFN);
  L.qp = at;     at += LANES * r4(A);
  L.e1 = at;     at += LANES * r4(d.S);
  L.e2 = at;     at += LANES * r4(d.S);
  L.alpha1 = at; at += LANES * r4(d.S);
  L.tmp = at;    at += LANES * r4(d.S);
  L.din = at;    at += LANES * r4(KD1);
  L.c1 = at;     at += LANES * r4(d.DU);
  L.din2 = at;   at += LANES * r4(2 * d.DU);
  L.c2 = at;     at += LANES * r4(d.DU);
  L.feat = at;   at += LANES * r4(d.DU);
  L.xs = at;     at += LANES * r4(d.SA);
  L.xn = at;     at += LANES * r4(d.SA);
  L.q = at;      at += LANES * r4(d.SA);
  L.attn = at;   at += LANES * r4(d.SA);
  L.y = at;      at += LANES * r4(d.SA);
  L.logit = at;  at += LANES * r4(d.H * T4);
  L.out = at;    at += LANES * r4(OW);
  L.total = at;
  return L;
}

// Eval-mode ZoneoutLSTM from the partial sums of its gate product (4U columns,
// i, g, f, o). c is s_c[l * ldc + j]; the previous h is s_h[l * ldh + j] and is
// overwritten; the new h also goes to s_h2[l * ldh2 + j], and h + s_res[...] to
// s_sum where those are given.
__device__ __forceinline__ void lstm_pointwise(const float* s_part, int parts, int U,
                                               const float* __restrict__ b, float* s_c, int ldc,
                                               float* s_h, int ldh, float* s_h2, int ldh2,
                                               float* s_sum, int ldsum, const Scalars& sc,
                                               int tid) {
  const int ld = 4 * U;
  for (int i = tid; i < LANES * U; i += NT) {
    const int l = i / U;
    const int j = i - l * U;
    const float zi = gather<LANES>(s_part, parts, ld, l, j) + __ldg(b + j);
    const float zg = gather<LANES>(s_part, parts, ld, l, U + j) + __ldg(b + U + j);
    const float zf = gather<LANES>(s_part, parts, ld, l, 2 * U + j) + __ldg(b + 2 * U + j);
    const float zo = gather<LANES>(s_part, parts, ld, l, 3 * U + j) + __ldg(b + 3 * U + j);
    const float c = s_c[l * ldc + j];
    const float h = s_h[l * ldh + j];
    const float new_c = sigmoidf_(zf + sc.forget_bias) * c + sigmoidf_(zi) * tanhf(zg);
    const float new_h = sigmoidf_(zo) * tanhf(new_c);
    const float out_c = sc.zc * c + (1.0f - sc.zc) * new_c;
    const float out_h = sc.zo * h + (1.0f - sc.zo) * new_h;
    s_c[l * ldc + j] = out_c;
    s_h[l * ldh + j] = out_h;
    if (s_sum != nullptr) s_sum[l * ldsum + j] = out_h + s_h2[l * ldh2 + j];
    else s_h2[l * ldh2 + j] = out_h;
  }
}

// LayerNorm of LANES rows of n values, a warp per row.
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
      s_y[warp * ldx + j] = (x[j] - mean) / sd * __ldg(scale + j) + __ldg(bias + j);
  }
}

__global__ void __launch_bounds__(NT)
fused_decode_kernel(const Ptrs P, const Dims d, const Scalars sc) {
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
  const int SA = d.SA, H = d.H, HD = d.SA / d.H, FFN = d.FFN, E1 = d.E1, E2 = d.E2;
  const int A = d.A1 + d.A2, EW = d.E1 + d.E2, RM = d.R * d.M, OW = d.R * d.M + d.R;
  const int KA = P2 + d.SPK + EW + AU, KD1 = AU + EW + DU;
  const int nblocks = gridDim.x;

  const Layout L = make_layout(d);
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
  float* s_logit = smem + L.logit;   const int ld_logit = r4(H * T4);
  float* s_out = smem + L.out;       const int ld_out = r4(OW);

  const float* w = P.w;

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
  if (tid < LANES) s_alpha1[tid * ld_s] = 1.0f;   // forward attention: all mass at position 0
  if (P.spk != nullptr)
    for (int i = tid; i < LANES * d.SPK; i += NT) {
      const int l = i / d.SPK, j = i - l * d.SPK;
      s_attin[l * ld_attin + P2 + j] = __ldg(P.spk + (size_t)s_b[l] * d.SPK + j);
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
      float v = fmaxf(gather<LANES>(s_part, parts, r4(P1), l, j) + __ldg(w + d.off[P1_B] + j), 0.0f);
      if (d.use_masks) v = P.mask1[((size_t)t * B + s_b[l]) * P1 + j] ? v * sc.inv_keep : 0.0f;
      s_x1[l * ld_x1 + j] = v;
    }
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[P2_W], r4(P2), P1, s_x1, ld_x1, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * P2; i += NT) {
      const int l = i / P2, j = i - l * P2;
      float v = fmaxf(gather<LANES>(s_part, parts, r4(P2), l, j) + __ldg(w + d.off[P2_B] + j), 0.0f);
      if (d.use_masks) v = P.mask2[((size_t)t * B + s_b[l]) * P2 + j] ? v * sc.inv_keep : 0.0f;
      s_attin[l * ld_attin + j] = v;
    }
    __syncthreads();

    // ------------------------------ attention LSTM -----------------------------
    // input [prenet | speaker | ctx1 | ctx2 | h_att]; the new h_att is the query
    parts = dense_partial<LANES, NT>(w + d.off[ATTG_W], 4 * AU, KA, s_attin, ld_attin, s_part, tid);
    __syncthreads();
    lstm_pointwise(s_part, parts, AU, w + d.off[ATTG_B], s_catt, ld_au, s_attin + (KA - AU),
                   ld_attin, s_din, ld_din, nullptr, 0, sc, tid);
    __syncthreads();

    // ------------------------------ both sources' scores -----------------------
    parts = dense_partial<LANES, NT>(w + d.off[QP_W], r4(A), AU, s_din, ld_din, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * A; i += NT) {
      const int l = i / A, j = i - l * A;
      s_qp[l * ld_a + j] = gather<LANES>(s_part, parts, r4(A), l, j);
    }
    __syncthreads();
    for (int pair = warp; pair < LANES * S; pair += NWARPS) {
      const int l = pair / S, s = pair - l * S;
      const float bias = __ldg(P.bias + (size_t)s_b[l] * S + s);
      float e1 = bias, e2 = bias;
      if (bias > -1e8f) {   // a padded position keeps -1e9: its probability is exactly 0
        const float* key = P.keys + ((size_t)s_b[l] * S + s) * A;
        float acc1 = 0.0f, acc2 = 0.0f;
        for (int a = lane; a < A; a += 32) {
          const float v = tanhf(__ldg(key + a) + s_qp[l * ld_a + a]) * __ldg(w + d.off[V_CAT] + a);
          if (a < A1) acc1 += v; else acc2 += v;
        }
        e1 = warp_sum(acc1) + bias;
        e2 = warp_sum(acc2) + bias;
      }
      if (lane == 0) {
        s_e1[l * ld_s + s] = e1;
        s_e2[l * ld_s + s] = e2;
      }
    }
    __syncthreads();

    // ------------------------------ alignments ---------------------------------
    if (warp < 2 * LANES) {
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
      if (warp < LANES) {
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
        const bool second = col >= E1;
        const int width = second ? E2 : E1;
        const float* mem = second ? P.mem2 + (size_t)s_b[l] * S * E2 + (col - E1)
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
            m[u] = __ldg(reinterpret_cast<const float4*>(mem + (size_t)(s + u) * width));
#pragma unroll
          for (int u = 0; u < 8; ++u) fma4(acc, alpha[s + u], m[u]);
        }
        for (; s < s1; ++s)
          fma4(acc, alpha[s], __ldg(reinterpret_cast<const float4*>(mem + (size_t)s * width)));
        *reinterpret_cast<float4*>(s_part + (size_t)(p * LANES + l) * EW + col) = acc;
      }
      __syncthreads();
      for (int i = tid; i < LANES * EW; i += NT) {
        const int l = i / EW, j = i - l * EW;
        const float v = gather<LANES>(s_part, cparts, EW, l, j);
        s_attin[l * ld_attin + P2 + d.SPK + j] = v;   // next step's attention LSTM input
        s_din[l * ld_din + AU + j] = v;               // [query | ctx1 | ctx2 | h1]
      }
      __syncthreads();
    }

    // ------------------------------ transition agent ---------------------------
    if (d.use_ta && warp < LANES) {
      const float* wt = w + d.off[TA_W];
      const float* row = s_din + warp * ld_din;
      float acc = 0.0f;
      for (int i = lane; i < E1 + AU; i += 32)
        acc += __ldg(wt + i) * (i < E1 ? row[AU + i] : row[i - E1]);   // [ctx1 | query]
      acc = warp_sum(acc);
      if (lane == 0) s_u[warp] = sigmoidf_(acc + __ldg(w + d.off[TA_B]));
    }

    // ------------------------------ decoder LSTMs ------------------------------
    parts = dense_partial<LANES, NT>(w + d.off[L1_W], 4 * DU, KD1, s_din, ld_din, s_part, tid);
    __syncthreads();
    lstm_pointwise(s_part, parts, DU, w + d.off[L1_B], s_c1, ld_du, s_din + (KD1 - DU), ld_din,
                   s_din2, ld_din2, nullptr, 0, sc, tid);
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[L2_W], 4 * DU, 2 * DU, s_din2, ld_din2, s_part, tid);
    __syncthreads();
    // feature = h2 + h1
    lstm_pointwise(s_part, parts, DU, w + d.off[L2_B], s_c2, ld_du, s_din2 + DU, ld_din2,
                   s_din2, ld_din2, s_feat, ld_du, sc, tid);
    __syncthreads();

    // ------------------------------ self-attention block -----------------------
    parts = dense_partial<LANES, NT>(w + d.off[IN_W], r4(SA), DU, s_feat, ld_du, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * SA; i += NT) {
      const int l = i / SA, j = i - l * SA;
      const double angle = (double)t * P.pe_rate[j];
      const float pe = (float)((j & 1) ? cos(angle) : sin(angle));
      s_xs[l * ld_sa + j] = gather<LANES>(s_part, parts, r4(SA), l, j) + __ldg(w + d.off[IN_B] + j) + pe;
    }
    __syncthreads();
    layer_norm(s_xs, s_xn, ld_sa, SA, w + d.off[LN1_S], w + d.off[LN1_B], sc.ln_eps, warp, lane);
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[QKV_W], r4(3 * SA), SA, s_xn, ld_sa, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * 3 * SA; i += NT) {
      const int l = i / (3 * SA), j = i - l * 3 * SA;
      const float v = gather<LANES>(s_part, parts, r4(3 * SA), l, j);
      if (j < SA) {
        s_q[l * ld_sa + j] = v / sc.sqrt_hd;
      } else if (s_valid[l]) {
        if (j < 2 * SA) P.kcache[((size_t)s_b[l] * SA + (j - SA)) * T4 + t] = v;
        else P.vcache[((size_t)s_b[l] * T + t) * SA + (j - 2 * SA)] = v;
      }
    }
    __syncthreads();
    // logits[l][h][p] = sum_d q[l][h][d] * K[b][h][d][p] for p <= t, four positions a thread
    {
      const int n4 = (t + 4) >> 2, G = LANES * H * n4;
      int lparts = imax(1, imin(NT / G, (HD + 7) / 8));
      const int chunk = (HD + lparts - 1) / lparts;
      lparts = (HD + chunk - 1) / chunk;
      const int t4 = T4 >> 2;
      for (int idx = tid; idx < lparts * G; idx += NT) {
        const int p = idx / G, g = idx - p * G;
        const int lh = g / n4, p4 = g - lh * n4;
        const int l = lh / H, h = lh - l * H;
        const int d0 = p * chunk, d1 = imin(d0 + chunk, HD);
        const float4* kp =
            reinterpret_cast<const float4*>(P.kcache + ((size_t)s_b[l] * SA + h * HD + d0) * T4) + p4;
        const float* q = s_q + l * ld_sa + h * HD;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        int dd = d0;
        for (; dd + 8 <= d1; dd += 8) {
          float4 k[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) k[u] = __ldcg(kp + (size_t)u * t4);
          kp += (size_t)8 * t4;
#pragma unroll
          for (int u = 0; u < 8; ++u) fma4(acc, q[dd + u], k[u]);
        }
        for (; dd < d1; ++dd) {
          fma4(acc, q[dd], __ldcg(kp));
          kp += t4;
        }
        *reinterpret_cast<float4*>(s_part + (size_t)p * G * 4 + g * 4) = acc;
      }
      __syncthreads();
      for (int pair = warp; pair < LANES * H; pair += NWARPS) {
        float* row = s_logit + (pair / H) * ld_logit + (pair % H) * T4;
        float m = -3.0e38f;
        for (int p = lane; p <= t; p += 32) {
          float v = 0.0f;
          for (int pp = 0; pp < lparts; ++pp) v += s_part[(size_t)pp * G * 4 + pair * n4 * 4 + p];
          row[p] = v;
          m = fmaxf(m, v);
        }
        m = warp_max(m);
        float sum = 0.0f;
        for (int p = lane; p <= t; p += 32) {
          const float v = expf(row[p] - m);
          row[p] = v;
          sum += v;
        }
        sum = warp_sum(sum);
        for (int p = lane; p <= t; p += 32) row[p] = row[p] / sum;
      }
      __syncthreads();
    }
    // attn[l][col] = sum_{p <= t} probs[l][head(col)][p] * V[b][p][col]
    {
      const int nc4 = SA >> 2, G = LANES * nc4, n = t + 1;
      int vparts = imax(1, imin(NT / G, (n + 7) / 8));
      const int chunk = (n + vparts - 1) / vparts;
      vparts = (n + chunk - 1) / chunk;
      for (int idx = tid; idx < vparts * G; idx += NT) {
        const int p = idx / G, g = idx - p * G;
        const int l = g / nc4, c = g - l * nc4;
        const int h = (4 * c) / HD;
        const int p0 = p * chunk, p1 = imin(p0 + chunk, n);
        const float4* vp =
            reinterpret_cast<const float4*>(P.vcache + ((size_t)s_b[l] * T + p0) * SA) + c;
        const float* pr = s_logit + l * ld_logit + h * T4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        int pos = p0;
        for (; pos + 8 <= p1; pos += 8) {
          float4 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = __ldcg(vp + (size_t)u * nc4);
          vp += (size_t)8 * nc4;
#pragma unroll
          for (int u = 0; u < 8; ++u) fma4(acc, pr[pos + u], v[u]);
        }
        for (; pos < p1; ++pos) {
          fma4(acc, pr[pos], __ldcg(vp));
          vp += nc4;
        }
        *reinterpret_cast<float4*>(s_part + (size_t)(p * LANES + l) * SA + 4 * c) = acc;
      }
      __syncthreads();
      for (int i = tid; i < LANES * SA; i += NT) {
        const int l = i / SA, j = i - l * SA;
        s_attn[l * ld_sa + j] = gather<LANES>(s_part, vparts, SA, l, j);
      }
      __syncthreads();
    }
    parts = dense_partial<LANES, NT>(w + d.off[O_W], r4(SA), SA, s_attn, ld_sa, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * SA; i += NT) {
      const int l = i / SA, j = i - l * SA;
      s_xs[l * ld_sa + j] += gather<LANES>(s_part, parts, r4(SA), l, j) + __ldg(w + d.off[O_B] + j);
    }
    __syncthreads();
    layer_norm(s_xs, s_xn, ld_sa, SA, w + d.off[LN2_S], w + d.off[LN2_B], sc.ln_eps, warp, lane);
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[F1_W], r4(FFN), SA, s_xn, ld_sa, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * FFN; i += NT) {
      const int l = i / FFN, j = i - l * FFN;
      s_f1[l * ld_f1 + j] =
          fmaxf(gather<LANES>(s_part, parts, r4(FFN), l, j) + __ldg(w + d.off[F1_B] + j), 0.0f);
    }
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[F2_W], r4(SA), FFN, s_f1, ld_f1, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * SA; i += NT) {
      const int l = i / SA, j = i - l * SA;
      s_y[l * ld_sa + j] =
          s_xs[l * ld_sa + j] + gather<LANES>(s_part, parts, r4(SA), l, j) + __ldg(w + d.off[F2_B] + j);
    }
    __syncthreads();

    // ------------------------------ output rows --------------------------------
    parts = dense_partial<LANES, NT>(w + d.off[OUT_W], r4(OW), SA, s_y, ld_sa, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * OW; i += NT) {
      const int l = i / OW, j = i - l * OW;
      const float v = gather<LANES>(s_part, parts, r4(OW), l, j) + __ldg(w + d.off[OUT_B] + j);
      const size_t row = (size_t)s_b[l] * T + t;
      if (j < RM) {
        if (s_valid[l]) P.frames[row * RM + j] = v;
        if (j >= RM - M) s_feed[l * ld_feed + (j - (RM - M))] = v;   // feed back the last frame
      } else {
        const float prob = sigmoidf_(v);
        s_out[l * ld_out + j] = prob;
        if (s_valid[l]) P.stops[row * R + (j - RM)] = prob;
      }
    }
    __syncthreads();

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
  const int* v = &d.B;
  for (int i = 0; i < 17; ++i)
    if (v[i] <= 0 && i != 7) return false;   // every size but SPK is positive
  return d.SPK >= 0 && d.E1 % 4 == 0 && d.E2 % 4 == 0 && d.SA % d.H == 0 &&
         (d.SA / d.H) % 4 == 0 && (d.B + LANES - 1) / LANES <= 0xffff;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes, for these sizes.
long long fused_decode_smem_bytes(const int* dims) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  return (long long)make_layout(d).total * (long long)sizeof(float);
}

// Dynamic shared memory one block of this kernel may have on the current device,
// in bytes: what a block can opt in to, less what the kernel declares statically.
// Negative: minus the CUDA error code.
long long fused_decode_smem_limit() {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fused_decode_kernel);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)optin - (long long)attr.sharedSizeBytes;
}

int fused_decode_f32(const void* w, const void* pe_rate, const void* keys, const void* mem1,
                     const void* mem2, const void* bias, const void* spk, const void* mask1,
                     const void* mask2, void* kcache, void* vcache, void* frames, void* stops,
                     void* align1, void* align2, void* lengths, void* finished, void* info,
                     const int* dims, const float* scalars, void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  Scalars sc;
  std::memcpy(&sc, scalars, sizeof(Scalars));
  if (!sizes_ok(d)) return (int)cudaErrorInvalidValue;
  if (d.use_masks && (mask1 == nullptr || mask2 == nullptr)) return (int)cudaErrorInvalidValue;
  if (d.SPK > 0 && spk == nullptr) return (int)cudaErrorInvalidValue;
  Ptrs P;
  P.w = (const float*)w;
  P.pe_rate = (const double*)pe_rate;
  P.keys = (const float*)keys;
  P.mem1 = (const float*)mem1;
  P.mem2 = (const float*)mem2;
  P.bias = (const float*)bias;
  P.spk = d.SPK > 0 ? (const float*)spk : nullptr;
  P.mask1 = (const unsigned char*)mask1;
  P.mask2 = (const unsigned char*)mask2;
  P.kcache = (float*)kcache;
  P.vcache = (float*)vcache;
  P.frames = (float*)frames;
  P.stops = (float*)stops;
  P.align1 = (float*)align1;
  P.align2 = (float*)align2;
  P.lengths = (int*)lengths;
  P.finished = (unsigned char*)finished;
  P.info = (int*)info;

  const size_t smem = (size_t)make_layout(d).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.B + LANES - 1) / LANES);
  if (d.early_exit && grid.x > 1) {
    // the per-step exit agreement needs every block resident: a launch that
    // cannot have that is refused here instead of waiting forever
    void* args[] = {(void*)&P, (void*)&d, (void*)&sc};
    err = cudaLaunchCooperativeKernel((const void*)fused_decode_kernel, grid, dim3(NT), args, smem,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    fused_decode_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(P, d, sc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
