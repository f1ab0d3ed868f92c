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
// gives the bias gradients. d_keys, d_spk and the running sum are per lane and a
// block owns its lanes, so nothing is atomic; d_vblk is written as one partial
// per lane and summed by the wrapper, so the result is the same from run to run.
//
// What bounds both on an H100 is the serial chain of steps: per step a handful of
// dependent small products. One block per LANES lanes walks all the steps on its
// own, state in shared memory, the weights (one flat buffer, (in, out), rows
// padded to 16 bytes; the backward reads transposed copies) streamed through L2
// at every step with the product routine of dense.cuh, rows read and written in
// global memory in place.
//
// Plain C interface at the bottom: the functions launch on the given stream,
// allocate nothing, do not synchronise, and return the CUDA error code.

#include <cuda_runtime.h>

#include <cstring>

#include "dense.cuh"

namespace {

constexpr int LANES = 4;
constexpr int NT = 512;
constexpr int NWARPS = NT / 32;
static_assert(NWARPS >= 2 * LANES, "a warp per (lane, source) in the softmax stages");

// Order of the entries in the flat weight buffer (ops/fused_teacher.py::_ENTRIES).
enum Entry {
  ATTG_W, ATTG_B, QP_W, VBLK, TA_W, TA_B, L1_W, L1_B, L2_W, L2_B,
  ATTG_WT, QP_WT, L1_WT, L2_WT, NUM_ENTRIES
};
// Fields of the three per-step rows (ops/fused_teacher.py::_CARRY, _ACTS, _STACK).
enum Carry { C_CATT, C_HATT, C_C1, C_H1, C_C2, C_H2, C_CTX1, C_CTX2, C_ALPHA, C_U, NUM_CARRY };
enum Acts { A_ZATT, A_Z1, A_Z2, A_QP, A_Y1, A_ALPHA2, NUM_ACTS };
enum Stack { G_ZATT, G_Z1, G_Z2, G_FEED, G_QP, G_CTX1, G_CTX2, G_UPRE, NUM_STACK };

// Sizes, flags, row widths and offsets (in floats), in the order the wrapper writes them.
struct Dims {
  int B, S, N;
  int P2, SPK, AU, A1, A2, DU, E1, E2;
  int use_ta, train_masks;
  int CW, AW, SW;
  int carry[NUM_CARRY], acts[NUM_ACTS], stack[NUM_STACK];
  int off[NUM_ENTRIES];
};

struct Scalars {
  float zc, zo, forget_bias;
};

// Keep thresholds of the mask hash, the seed, and the draw number of every
// (cell, c or h) mask within a step: c then h per cell, kinds at factor 0 skipped.
struct Bits {
  unsigned thr_c, thr_h, seed;
  unsigned draw[6];
};

struct Ptrs {
  const float* w;
  const float* feeds;     // (B, N, P2) the prenet's output
  const float* keys;      // (B, S, A1 + A2)
  const float* mem1;      // (B, S, E1)
  const float* mem2;      // (B, S, E2)
  const float* bias;      // (B, S)
  const float* spk;       // (B, SPK) or null
  float* features;        // (B, N, DU)
  float* aligns;          // (B, N, 2S)
  float* carry;           // (B, N, CW)
  float* acts;            // (B, N, AW)
  // backward only
  const float* g_feat;    // (B, N, DU)
  const float* g_align;   // (B, N, 2S) or null
  float* stack;           // (B, N, SW)
  float* d_keys;          // (B, S, A1 + A2), zero on entry
  float* d_vblk;          // (B, 2, A1 + A2) one partial per lane
  float* d_spk;           // (B, SPK), zero on entry
  float* d_brow;          // (B, SW), zero on entry
};

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// How much of the previous state unit (row, col) of a (., width) state keeps.
__device__ __forceinline__ float keep_old(int train, unsigned step_seed, unsigned draw,
                                          unsigned threshold, float factor, int row, int col,
                                          int width) {
  if (!train || factor <= 0.0f) return factor;
  const unsigned base = step_seed * 0x9E3779B9u + draw * 0x85EBCA6Bu;
  const unsigned idx = (unsigned)row * (unsigned)width + (unsigned)col;
  return mix32(base + idx * 0xC2B2AE35u) < threshold ? 1.0f : 0.0f;
}

// ------------------------------------------------------------------------------------
// Forward
// ------------------------------------------------------------------------------------

struct FwdLayout {
  int part, attin, catt, qp, e1, e2, alpha1, tmp, din, c1, din2, c2, total;
};

__host__ __device__ inline int widest_product(const Dims& d) {
  int widest = imax(4 * d.AU, 4 * d.DU);
  widest = imax(widest, r4(d.A1 + d.A2));
  widest = imax(widest, d.E1 + d.E2);
  widest = imax(widest, r4(d.P2 + d.SPK + d.E1 + d.E2 + d.AU));
  widest = imax(widest, r4(d.AU + d.E1 + d.E2 + d.DU));
  return r4(widest);
}

__host__ __device__ inline FwdLayout make_fwd_layout(const Dims& d) {
  const int A = d.A1 + d.A2;
  const int KA = d.P2 + d.SPK + d.E1 + d.E2 + d.AU;
  const int KD1 = d.AU + d.E1 + d.E2 + d.DU;
  FwdLayout L;
  int at = 0;
  L.part = at;   at += LANES * imax(4 * NT, widest_product(d));
  L.attin = at;  at += LANES * r4(KA);
  L.catt = at;   at += LANES * r4(d.AU);
  L.qp = at;     at += LANES * r4(A);
  L.e1 = at;     at += LANES * r4(d.S);
  L.e2 = at;     at += LANES * r4(d.S);
  L.alpha1 = at; at += LANES * r4(d.S);
  L.tmp = at;    at += LANES * r4(d.S);
  L.din = at;    at += LANES * r4(KD1);
  L.c1 = at;     at += LANES * r4(d.DU);
  L.din2 = at;   at += LANES * r4(2 * d.DU);
  L.c2 = at;     at += LANES * r4(d.DU);
  L.total = at;
  return L;
}

// ZoneoutLSTM from the partial sums of its gate product (4U columns i, g, f, o).
// c is s_c[l * ldc + j]; the previous h is s_h[l * ldh + j] and is overwritten.
// The new h also goes to s_h2[l * ldh2 + j], or, where `features` is given,
// h + s_h2[...] goes to the feature row instead. Pre-activations go to the
// activation row, the new c and h to the carry row.
__device__ __forceinline__ void lstm_forward(const float* s_part, int parts, int U,
                                             const float* __restrict__ b, float* s_c, int ldc,
                                             float* s_h, int ldh, float* s_h2, int ldh2,
                                             float* features, const Ptrs& P, const Dims& d,
                                             const Scalars& sc, const Bits& bits, int cell,
                                             int z_off, int c_off, int h_off, const int* s_b,
                                             const int* s_valid, int t, int tid) {
  const int ld = 4 * U;
  const unsigned step_seed = bits.seed + (unsigned)t;
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
    const float mc = keep_old(d.train_masks, step_seed, bits.draw[2 * cell], bits.thr_c, sc.zc,
                              s_b[l], j, U);
    const float mh = keep_old(d.train_masks, step_seed, bits.draw[2 * cell + 1], bits.thr_h,
                              sc.zo, s_b[l], j, U);
    const float out_c = c * mc + new_c * (1.0f - mc);
    const float out_h = h * mh + new_h * (1.0f - mh);
    s_c[l * ldc + j] = out_c;
    s_h[l * ldh + j] = out_h;
    if (features == nullptr) s_h2[l * ldh2 + j] = out_h;
    if (s_valid[l]) {
      const size_t row = (size_t)s_b[l] * d.N + t;
      float* z = P.acts + row * d.AW + z_off;
      z[j] = zi;
      z[U + j] = zg;
      z[2 * U + j] = zf;
      z[3 * U + j] = zo;
      P.carry[row * d.CW + c_off + j] = out_c;
      P.carry[row * d.CW + h_off + j] = out_h;
      if (features != nullptr) features[row * U + j] = out_h + s_h2[l * ldh2 + j];
    }
  }
}

__global__ void __launch_bounds__(NT)
teacher_fwd_kernel(const Ptrs P, const Dims d, const Scalars sc, const Bits bits) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_b[LANES];       // global lane, clamped into the batch
  __shared__ int s_valid[LANES];
  __shared__ int s_hi[LANES];      // positions below this can hold attention mass
  __shared__ float s_u[LANES];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int B = d.B, S = d.S, N = d.N;
  const int P2 = d.P2, AU = d.AU, DU = d.DU, E1 = d.E1, E2 = d.E2;
  const int A = d.A1 + d.A2, EW = d.E1 + d.E2;
  const int KA = P2 + d.SPK + EW + AU, KD1 = AU + EW + DU;

  const FwdLayout L = make_fwd_layout(d);
  float* s_part = smem + L.part;
  float* s_attin = smem + L.attin;   const int ld_attin = r4(KA);
  float* s_catt = smem + L.catt;     const int ld_au = r4(AU);
  float* s_qp = smem + L.qp;         const int ld_a = r4(A);
  float* s_e1 = smem + L.e1;         const int ld_s = r4(S);
  float* s_e2 = smem + L.e2;
  float* s_alpha1 = smem + L.alpha1;
  float* s_tmp = smem + L.tmp;
  float* s_din = smem + L.din;       const int ld_din = r4(KD1);
  float* s_c1 = smem + L.c1;         const int ld_du = r4(DU);
  float* s_din2 = smem + L.din2;     const int ld_din2 = r4(2 * DU);
  float* s_c2 = smem + L.c2;

  const float* w = P.w;
  const float* v1 = w + d.off[VBLK];
  const float* v2 = v1 + r4(A);

  // ------------------------------ initial state ------------------------------
  for (int i = tid; i < L.total; i += NT) smem[i] = 0.0f;
  if (tid < LANES) {
    const int b = blockIdx.x * LANES + tid;
    s_valid[tid] = b < B;
    s_b[tid] = b < B ? b : B - 1;
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

  for (int t = 0; t < N; ++t) {
    // ------------------------------ the step's input ---------------------------
    for (int i = tid; i < LANES * P2; i += NT) {
      const int l = i / P2, j = i - l * P2;
      s_attin[l * ld_attin + j] = __ldg(P.feeds + ((size_t)s_b[l] * N + t) * P2 + j);
    }
    __syncthreads();

    // ------------------------------ attention LSTM -----------------------------
    // input [x2 | speaker | ctx1 | ctx2 | h_att]; the new h_att is the query
    int parts = dense_partial<LANES, NT>(w + d.off[ATTG_W], 4 * AU, KA, s_attin, ld_attin,
                                         s_part, tid);
    __syncthreads();
    lstm_forward(s_part, parts, AU, w + d.off[ATTG_B], s_catt, ld_au, s_attin + (KA - AU),
                 ld_attin, s_din, ld_din, nullptr, P, d, sc, bits, 0, d.acts[A_ZATT],
                 d.carry[C_CATT], d.carry[C_HATT], s_b, s_valid, t, tid);
    __syncthreads();

    // ------------------------------ both sources' scores -----------------------
    parts = dense_partial<LANES, NT>(w + d.off[QP_W], r4(A), AU, s_din, ld_din, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * A; i += NT) {
      const int l = i / A, j = i - l * A;
      const float v = gather<LANES>(s_part, parts, r4(A), l, j);
      s_qp[l * ld_a + j] = v;
      if (s_valid[l]) P.acts[((size_t)s_b[l] * N + t) * d.AW + d.acts[A_QP] + j] = v;
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
          const float tq = tanhf(__ldg(key + a) + s_qp[l * ld_a + a]);
          acc1 = fmaf(tq, __ldg(v1 + a), acc1);
          acc2 = fmaf(tq, __ldg(v2 + a), acc2);
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
      const size_t row = (size_t)s_b[l] * N + t;
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
          if (s_valid[l]) P.acts[row * d.AW + d.acts[A_Y1] + s] = y;
        }
        total = warp_sum(total);
        __syncwarp();
        for (int s = lane; s < S; s += 32) {
          const float v = hat[s] / total;
          prev[s] = v;
          if (s_valid[l]) {
            P.aligns[row * 2 * S + s] = v;
            P.carry[row * d.CW + d.carry[C_ALPHA] + s] = v;
          }
        }
      } else {
        for (int s = lane; s < S; s += 32) {
          const float v = e[s] / sum;
          e[s] = v;
          if (s_valid[l]) {
            P.aligns[row * 2 * S + S + s] = v;
            P.acts[row * d.AW + d.acts[A_ALPHA2] + s] = v;
          }
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
        if (s_valid[l]) {
          const size_t row = (size_t)s_b[l] * N + t;
          if (j < E1) P.carry[row * d.CW + d.carry[C_CTX1] + j] = v;
          else P.carry[row * d.CW + d.carry[C_CTX2] + (j - E1)] = v;
        }
      }
      __syncthreads();
    }

    // ------------------------------ transition agent ---------------------------
    if (warp < LANES) {
      if (d.use_ta) {
        const float* wt = w + d.off[TA_W];
        const float* row = s_din + warp * ld_din;
        float acc = 0.0f;
        for (int i = lane; i < E1 + AU; i += 32)
          acc += __ldg(wt + i) * (i < E1 ? row[AU + i] : row[i - E1]);   // [ctx1 | query]
        acc = warp_sum(acc);
        if (lane == 0) s_u[warp] = sigmoidf_(acc + __ldg(w + d.off[TA_B]));
      }
      __syncwarp();
      if (lane == 0 && s_valid[warp])
        P.carry[((size_t)s_b[warp] * N + t) * d.CW + d.carry[C_U]] = s_u[warp];
    }

    // ------------------------------ decoder LSTMs ------------------------------
    parts = dense_partial<LANES, NT>(w + d.off[L1_W], 4 * DU, KD1, s_din, ld_din, s_part, tid);
    __syncthreads();
    lstm_forward(s_part, parts, DU, w + d.off[L1_B], s_c1, ld_du, s_din + (KD1 - DU), ld_din,
                 s_din2, ld_din2, nullptr, P, d, sc, bits, 1, d.acts[A_Z1], d.carry[C_C1],
                 d.carry[C_H1], s_b, s_valid, t, tid);
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[L2_W], 4 * DU, 2 * DU, s_din2, ld_din2, s_part,
                                     tid);
    __syncthreads();
    // feature = h2 + h1
    lstm_forward(s_part, parts, DU, w + d.off[L2_B], s_c2, ld_du, s_din2 + DU, ld_din2, s_din2,
                 ld_din2, P.features, P, d, sc, bits, 2, d.acts[A_Z2], d.carry[C_C2],
                 d.carry[C_H2], s_b, s_valid, t, tid);
    __syncthreads();
  }
}

// ------------------------------------------------------------------------------------
// Backward
// ------------------------------------------------------------------------------------

struct BwdLayout {
  int part, gcatt, ghatt, gc1, gh1, gc2, gh2, gctx, galpha, gz, gq, qp, gqp;
  int y1, a1, aprev, a2, ga1, ga2, ge1, ge2, dv, total;
};

__host__ __device__ inline BwdLayout make_bwd_layout(const Dims& d) {
  const int A = d.A1 + d.A2;
  BwdLayout L;
  int at = 0;
  L.part = at;    at += LANES * imax(4 * NT, widest_product(d));
  L.gcatt = at;   at += LANES * r4(d.AU);
  L.ghatt = at;   at += LANES * r4(d.AU);
  L.gc1 = at;     at += LANES * r4(d.DU);
  L.gh1 = at;     at += LANES * r4(d.DU);
  L.gc2 = at;     at += LANES * r4(d.DU);
  L.gh2 = at;     at += LANES * r4(d.DU);
  L.gctx = at;    at += LANES * r4(d.E1 + d.E2);
  L.galpha = at;  at += LANES * r4(d.S);
  L.gz = at;      at += LANES * 4 * imax(d.AU, d.DU);
  L.gq = at;      at += LANES * r4(d.AU);
  L.qp = at;      at += LANES * r4(A);
  L.gqp = at;     at += LANES * r4(A);
  L.y1 = at;      at += LANES * r4(d.S);
  L.a1 = at;      at += LANES * r4(d.S);
  L.aprev = at;   at += LANES * r4(d.S);
  L.a2 = at;      at += LANES * r4(d.S);
  L.ga1 = at;     at += LANES * r4(d.S);
  L.ga2 = at;     at += LANES * r4(d.S);
  L.ge1 = at;     at += LANES * r4(d.S);
  L.ge2 = at;     at += LANES * r4(d.S);
  L.dv = at;      at += LANES * 2 * r4(A);
  L.total = at;
  return L;
}

// Adjoint of one ZoneoutLSTM's pointwise stage. On entry s_gc and s_gh hold the
// cotangents of the step's c and h outputs (s_add, where given, is added to the
// latter); on exit they hold those of the previous c and h as far as this stage
// gives them. The cotangents of the gate pre-activations go to s_gz (4U a lane,
// for the product with the transposed weights), to the gradient row and to the
// running sum.
__device__ __forceinline__ void lstm_backward(int U, float* s_gc, float* s_gh, int ldu,
                                              const float* s_add, float* s_gz, const Ptrs& P,
                                              const Dims& d, const Scalars& sc, const Bits& bits,
                                              int cell, int z_off, int c_off, int g_off,
                                              const int* s_b, const int* s_valid, int t,
                                              int tid) {
  const unsigned step_seed = bits.seed + (unsigned)t;
  for (int i = tid; i < LANES * U; i += NT) {
    const int l = i / U;
    const int j = i - l * U;
    const size_t row = (size_t)s_b[l] * d.N + t;
    const float* z = P.acts + row * d.AW + z_off;
    const float c_prev = t > 0 ? P.carry[(row - 1) * d.CW + c_off + j] : 0.0f;
    const float si = sigmoidf_(z[j]);
    const float tg = tanhf(z[U + j]);
    const float sf = sigmoidf_(z[2 * U + j] + sc.forget_bias);
    const float so = sigmoidf_(z[3 * U + j]);
    const float tc = tanhf(sf * c_prev + si * tg);
    const float mc = keep_old(d.train_masks, step_seed, bits.draw[2 * cell], bits.thr_c, sc.zc,
                              s_b[l], j, U);
    const float mh = keep_old(d.train_masks, step_seed, bits.draw[2 * cell + 1], bits.thr_h,
                              sc.zo, s_b[l], j, U);
    const float g_c_out = s_gc[l * ldu + j];
    const float g_h_out = s_gh[l * ldu + j] + (s_add != nullptr ? s_add[l * ldu + j] : 0.0f);
    const float g_h_new = g_h_out * (1.0f - mh);
    const float g_c_new = g_c_out * (1.0f - mc) + g_h_new * so * (1.0f - tc * tc);
    const float g_i = g_c_new * tg * si * (1.0f - si);
    const float g_g = g_c_new * si * (1.0f - tg * tg);
    const float g_f = g_c_new * c_prev * sf * (1.0f - sf);
    const float g_o = g_h_new * tc * so * (1.0f - so);
    s_gc[l * ldu + j] = g_c_out * mc + g_c_new * sf;
    s_gh[l * ldu + j] = g_h_out * mh;
    float* gz = s_gz + l * 4 * U;
    gz[j] = g_i;
    gz[U + j] = g_g;
    gz[2 * U + j] = g_f;
    gz[3 * U + j] = g_o;
    if (s_valid[l]) {
      float* out = P.stack + row * d.SW + g_off;
      float* sum = P.d_brow + (size_t)s_b[l] * d.SW + g_off;
      out[j] = g_i;            sum[j] += g_i;
      out[U + j] = g_g;        sum[U + j] += g_g;
      out[2 * U + j] = g_f;    sum[2 * U + j] += g_f;
      out[3 * U + j] = g_o;    sum[3 * U + j] += g_o;
    }
  }
}

__global__ void __launch_bounds__(NT)
teacher_bwd_kernel(const Ptrs P, const Dims d, const Scalars sc, const Bits bits) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_b[LANES];
  __shared__ int s_valid[LANES];
  __shared__ int s_hi[LANES];
  __shared__ float s_gu[LANES];      // cotangent of u as the next step consumed it
  __shared__ float s_gupass[LANES];
  __shared__ float s_uprev[LANES];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int B = d.B, S = d.S, N = d.N;
  const int P2 = d.P2, SPK = d.SPK, AU = d.AU, DU = d.DU, E1 = d.E1, E2 = d.E2;
  const int A = d.A1 + d.A2, EW = d.E1 + d.E2;
  const int KA = P2 + SPK + EW + AU, KD1 = AU + EW + DU;

  const BwdLayout L = make_bwd_layout(d);
  float* s_part = smem + L.part;
  float* s_gcatt = smem + L.gcatt;   const int ld_au = r4(AU);
  float* s_ghatt = smem + L.ghatt;
  float* s_gc1 = smem + L.gc1;       const int ld_du = r4(DU);
  float* s_gh1 = smem + L.gh1;
  float* s_gc2 = smem + L.gc2;
  float* s_gh2 = smem + L.gh2;
  float* s_gctx = smem + L.gctx;     const int ld_ew = r4(EW);
  float* s_galpha = smem + L.galpha; const int ld_s = r4(S);
  float* s_gz = smem + L.gz;
  float* s_gq = smem + L.gq;
  float* s_qp = smem + L.qp;         const int ld_a = r4(A);
  float* s_gqp = smem + L.gqp;
  float* s_y1 = smem + L.y1;
  float* s_a1 = smem + L.a1;
  float* s_aprev = smem + L.aprev;
  float* s_a2 = smem + L.a2;
  float* s_ga1 = smem + L.ga1;
  float* s_ga2 = smem + L.ga2;
  float* s_ge1 = smem + L.ge1;
  float* s_ge2 = smem + L.ge2;
  float* s_dv = smem + L.dv;

  const float* w = P.w;
  const float* v1 = w + d.off[VBLK];
  const float* v2 = v1 + r4(A);

  for (int i = tid; i < L.total; i += NT) smem[i] = 0.0f;
  if (tid < LANES) {
    const int b = blockIdx.x * LANES + tid;
    s_valid[tid] = b < B;
    s_b[tid] = b < B ? b : B - 1;
    s_gu[tid] = 0.0f;
  }
  __syncthreads();
  if (warp < LANES) {
    int hi = 0;
    for (int s = lane; s < S; s += 32)
      if (__ldg(P.bias + (size_t)s_b[warp] * S + s) > -1e8f) hi = s + 1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) hi = imax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    if (lane == 0) s_hi[warp] = hi > 0 ? hi : S;
  }
  __syncthreads();

  for (int t = N - 1; t >= 0; --t) {
    // ------------------------------ the step's rows ----------------------------
    // alignments and u of steps t-1 (the initial state at t = 0) and t, the
    // activation row's y, a2 and qp; the features' cotangent enters h1 and h2
    for (int i = tid; i < LANES * S; i += NT) {
      const int l = i / S, s = i - l * S;
      const size_t row = (size_t)s_b[l] * N + t;
      const float* acts = P.acts + row * d.AW;
      s_y1[l * ld_s + s] = acts[d.acts[A_Y1] + s];
      s_a2[l * ld_s + s] = acts[d.acts[A_ALPHA2] + s];
      s_a1[l * ld_s + s] = P.carry[row * d.CW + d.carry[C_ALPHA] + s];
      s_aprev[l * ld_s + s] =
          t > 0 ? P.carry[(row - 1) * d.CW + d.carry[C_ALPHA] + s] : (s == 0 ? 1.0f : 0.0f);
    }
    for (int i = tid; i < LANES * A; i += NT) {
      const int l = i / A, j = i - l * A;
      s_qp[l * ld_a + j] = P.acts[((size_t)s_b[l] * N + t) * d.AW + d.acts[A_QP] + j];
    }
    for (int i = tid; i < LANES * DU; i += NT) {
      const int l = i / DU, j = i - l * DU;
      const float gf = P.g_feat[((size_t)s_b[l] * N + t) * DU + j];
      s_gh1[l * ld_du + j] += gf;
      s_gh2[l * ld_du + j] += gf;
    }
    if (tid < LANES)
      s_uprev[tid] =
          t > 0 ? P.carry[((size_t)s_b[tid] * N + t - 1) * d.CW + d.carry[C_U]] : 0.5f;
    __syncthreads();

    // ------------------------------ decoder LSTM 2 -----------------------------
    lstm_backward(DU, s_gc2, s_gh2, ld_du, nullptr, s_gz, P, d, sc, bits, 2, d.acts[A_Z2],
                  d.carry[C_C2], d.stack[G_Z2], s_b, s_valid, t, tid);
    __syncthreads();
    int parts = dense_partial<LANES, NT>(w + d.off[L2_WT], r4(2 * DU), 4 * DU, s_gz, 4 * DU,
                                         s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * 2 * DU; i += NT) {      // input [h1 | h2 of step t-1]
      const int l = i / (2 * DU), j = i - l * 2 * DU;
      const float v = gather<LANES>(s_part, parts, r4(2 * DU), l, j);
      if (j < DU) s_gh1[l * ld_du + j] += v;
      else s_gh2[l * ld_du + (j - DU)] += v;
    }
    __syncthreads();

    // ------------------------------ decoder LSTM 1 -----------------------------
    lstm_backward(DU, s_gc1, s_gh1, ld_du, nullptr, s_gz, P, d, sc, bits, 1, d.acts[A_Z1],
                  d.carry[C_C1], d.stack[G_Z1], s_b, s_valid, t, tid);
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[L1_WT], r4(KD1), 4 * DU, s_gz, 4 * DU, s_part,
                                     tid);
    __syncthreads();
    for (int i = tid; i < LANES * KD1; i += NT) {         // input [query | ctx1 | ctx2 | h1]
      const int l = i / KD1, j = i - l * KD1;
      const float v = gather<LANES>(s_part, parts, r4(KD1), l, j);
      if (j < AU) s_gq[l * ld_au + j] = v;
      else if (j < AU + EW) s_gctx[l * ld_ew + (j - AU)] += v;   // on top of step t+1's share
      else s_gh1[l * ld_du + (j - AU - EW)] += v;
    }
    __syncthreads();

    // ------------------------------ transition agent ---------------------------
    // u of step t was consumed by step t+1: its cotangent arrived through the carry
    if (warp < LANES) {
      float g_u_pre = 0.0f;
      if (d.use_ta) {
        const float u_new = P.carry[((size_t)s_b[warp] * N + t) * d.CW + d.carry[C_U]];
        g_u_pre = s_gu[warp] * u_new * (1.0f - u_new);
        const float* wt = w + d.off[TA_W];
        for (int i = lane; i < E1 + AU; i += 32) {           // [ctx1 | query]
          const float g = g_u_pre * __ldg(wt + i);
          if (i < E1) s_gctx[warp * ld_ew + i] += g;
          else s_gq[warp * ld_au + (i - E1)] += g;
        }
      }
      __syncwarp();
      if (lane == 0) {
        s_gupass[warp] = d.use_ta ? 0.0f : s_gu[warp];
        if (s_valid[warp]) {
          P.stack[((size_t)s_b[warp] * N + t) * d.SW + d.stack[G_UPRE]] = g_u_pre;
          P.d_brow[(size_t)s_b[warp] * d.SW + d.stack[G_UPRE]] += g_u_pre;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < LANES * EW; i += NT) {
      const int l = i / EW, j = i - l * EW;
      if (s_valid[l]) {
        const int at = j < E1 ? d.stack[G_CTX1] + j : d.stack[G_CTX2] + (j - E1);
        const float v = s_gctx[l * ld_ew + j];
        P.stack[((size_t)s_b[l] * N + t) * d.SW + at] = v;
        P.d_brow[(size_t)s_b[l] * d.SW + at] += v;
      }
    }

    // ------------------------------ contexts -> alignments ---------------------
    // g_a_i[s] = g_ctx_i . memory_i[s], plus what arrives for the alignment itself
    for (int pair = warp; pair < LANES * S; pair += NWARPS) {
      const int l = pair / S, s = pair - l * S;
      float acc1 = 0.0f, acc2 = 0.0f;
      if (s < s_hi[l]) {
        const float* m1 = P.mem1 + ((size_t)s_b[l] * S + s) * E1;
        const float* m2 = P.mem2 + ((size_t)s_b[l] * S + s) * E2;
        const float* g = s_gctx + l * ld_ew;
        for (int e = lane; e < E1; e += 32) acc1 = fmaf(g[e], __ldg(m1 + e), acc1);
        for (int e = lane; e < E2; e += 32) acc2 = fmaf(g[E1 + e], __ldg(m2 + e), acc2);
        acc1 = warp_sum(acc1);
        acc2 = warp_sum(acc2);
        if (P.g_align != nullptr) {
          const float* ga = P.g_align + ((size_t)s_b[l] * N + t) * 2 * S;
          acc1 += ga[s];
          acc2 += ga[S + s];
        }
        acc1 += s_galpha[l * ld_s + s];
      }
      if (lane == 0) {
        s_ga1[l * ld_s + s] = acc1;
        s_ga2[l * ld_s + s] = acc2;
      }
    }
    __syncthreads();

    // ------------------------------ recursion and softmax adjoints -------------
    if (warp < 2 * LANES) {
      const int l = warp < LANES ? warp : warp - LANES;
      if (warp < LANES) {
        const float u = s_uprev[l];
        const float* y = s_y1 + l * ld_s;
        const float* a1 = s_a1 + l * ld_s;
        const float* prev = s_aprev + l * ld_s;
        float* ga = s_ga1 + l * ld_s;      // becomes g_w
        float* ge = s_ge1 + l * ld_s;      // holds g_y on the way
        float dot = 0.0f, s_hat = 0.0f;
        for (int s = lane; s < S; s += 32) {
          const float shifted = s > 0 ? prev[s - 1] : 0.0f;
          dot += ga[s] * a1[s];
          s_hat += ((1.0f - u) * prev[s] + u * shifted + 1e-6f) * y[s];
        }
        dot = warp_sum(dot);
        s_hat = warp_sum(s_hat);
        float g_u_rec = 0.0f, dot_y = 0.0f;
        for (int s = lane; s < S; s += 32) {
          const float shifted = s > 0 ? prev[s - 1] : 0.0f;
          const float w_rec = (1.0f - u) * prev[s] + u * shifted + 1e-6f;
          const float g_hat = (ga[s] - dot) / s_hat;
          const float g_y = g_hat * w_rec;
          const float g_w = g_hat * y[s];
          g_u_rec += g_w * (shifted - prev[s]);
          dot_y += g_y * y[s];
          ga[s] = g_w;
          ge[s] = g_y;
        }
        g_u_rec = warp_sum(g_u_rec);
        dot_y = warp_sum(dot_y);
        __syncwarp();
        for (int s = lane; s < S; s += 32) {
          // the zero-filled right shift's adjoint is a zero-filled left shift
          const float from_next = s + 1 < S ? ga[s + 1] * u : 0.0f;
          s_galpha[l * ld_s + s] = ga[s] * (1.0f - u) + from_next;
          ge[s] = y[s] * (ge[s] - dot_y);
        }
        if (lane == 0) s_gu[l] = s_gupass[l] + g_u_rec;
      } else {
        const float* a2 = s_a2 + l * ld_s;
        const float* ga = s_ga2 + l * ld_s;
        float dot = 0.0f;
        for (int s = lane; s < S; s += 32) dot += ga[s] * a2[s];
        dot = warp_sum(dot);
        for (int s = lane; s < S; s += 32) s_ge2[l * ld_s + s] = a2[s] * (ga[s] - dot);
      }
    }
    __syncthreads();

    // ------------------------------ scores -------------------------------------
    // one pass over (s, a): the tanh again, its cotangent into d_keys, summed over
    // s into g_qp, and g_e . tanh into this lane's d_vblk partial
    for (int pair = tid; pair < LANES * A; pair += NT) {
      const int l = pair / A, a = pair - l * A;
      const size_t b = (size_t)s_b[l];
      const float q = s_qp[l * ld_a + a];
      const float va = __ldg(v1 + a), vb = __ldg(v2 + a);
      const float* bias = P.bias + b * S;
      const float* key = P.keys + b * S * A + a;
      float* dk = P.d_keys + b * S * A + a;
      const float* ge1 = s_ge1 + l * ld_s;
      const float* ge2 = s_ge2 + l * ld_s;
      const bool valid = s_valid[l] != 0;
      float g_q = 0.0f, d1 = 0.0f, d2 = 0.0f;
      const int hi = s_hi[l];
#pragma unroll 4
      for (int s = 0; s < hi; ++s) {
        if (__ldg(bias + s) <= -1e8f) continue;
        const float tq = tanhf(__ldg(key + (size_t)s * A) + q);
        const float g1 = ge1[s], g2 = ge2[s];
        const float g_pre = (g1 * va + g2 * vb) * (1.0f - tq * tq);
        if (valid) dk[(size_t)s * A] += g_pre;
        g_q += g_pre;
        d1 = fmaf(g1, tq, d1);
        d2 = fmaf(g2, tq, d2);
      }
      s_gqp[l * ld_a + a] = g_q;
      s_dv[(l * 2) * ld_a + a] += d1;
      s_dv[(l * 2 + 1) * ld_a + a] += d2;
      if (valid) {
        const size_t at = (b * N + t) * d.SW + d.stack[G_QP] + a;
        P.stack[at] = g_q;
        P.d_brow[b * d.SW + d.stack[G_QP] + a] += g_q;
      }
    }
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[QP_WT], r4(AU), A, s_gqp, ld_a, s_part, tid);
    __syncthreads();
    for (int i = tid; i < LANES * AU; i += NT) {
      const int l = i / AU, j = i - l * AU;
      s_gq[l * ld_au + j] += gather<LANES>(s_part, parts, r4(AU), l, j);
    }
    __syncthreads();

    // ------------------------------ attention LSTM -----------------------------
    lstm_backward(AU, s_gcatt, s_ghatt, ld_au, s_gq, s_gz, P, d, sc, bits, 0, d.acts[A_ZATT],
                  d.carry[C_CATT], d.stack[G_ZATT], s_b, s_valid, t, tid);
    __syncthreads();
    parts = dense_partial<LANES, NT>(w + d.off[ATTG_WT], r4(KA), 4 * AU, s_gz, 4 * AU, s_part,
                                     tid);
    __syncthreads();
    for (int i = tid; i < LANES * KA; i += NT) {   // input [x2 | speaker | ctx1 | ctx2 | h_att]
      const int l = i / KA, j = i - l * KA;
      const float v = gather<LANES>(s_part, parts, r4(KA), l, j);
      if (j < P2) {
        if (s_valid[l]) {
          P.stack[((size_t)s_b[l] * N + t) * d.SW + d.stack[G_FEED] + j] = v;
          P.d_brow[(size_t)s_b[l] * d.SW + d.stack[G_FEED] + j] += v;
        }
      } else if (j < P2 + SPK) {
        if (s_valid[l]) P.d_spk[(size_t)s_b[l] * SPK + (j - P2)] += v;
      } else if (j < P2 + SPK + EW) {
        s_gctx[l * ld_ew + (j - P2 - SPK)] = v;    // the contexts of step t-1
      } else {
        s_ghatt[l * ld_au + (j - (KA - AU))] += v;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < LANES * 2 * A; i += NT) {
    const int l = i / (2 * A), j = i - l * 2 * A;
    if (s_valid[l])
      P.d_vblk[(size_t)s_b[l] * 2 * A + j] = s_dv[(l * 2 + j / A) * ld_a + (j % A)];
  }
}

bool sizes_ok(const Dims& d) {
  const int* v = &d.B;
  for (int i = 0; i < 11; ++i)
    if (v[i] <= 0 && i != 4) return false;   // every size but SPK is positive
  return d.SPK >= 0 && d.E1 % 4 == 0 && d.E2 % 4 == 0;
}

Ptrs make_ptrs(const void* const* p, const Dims& d) {
  Ptrs P;
  P.w = (const float*)p[0];
  P.feeds = (const float*)p[1];
  P.keys = (const float*)p[2];
  P.mem1 = (const float*)p[3];
  P.mem2 = (const float*)p[4];
  P.bias = (const float*)p[5];
  P.spk = d.SPK > 0 ? (const float*)p[6] : nullptr;
  P.features = (float*)p[7];
  P.aligns = (float*)p[8];
  P.carry = (float*)p[9];
  P.acts = (float*)p[10];
  P.g_feat = (const float*)p[11];
  P.g_align = (const float*)p[12];
  P.stack = (float*)p[13];
  P.d_keys = (float*)p[14];
  P.d_vblk = (float*)p[15];
  P.d_spk = (float*)p[16];
  P.d_brow = (float*)p[17];
  return P;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const void* const* pointers, const int* dims,
           const float* scalars, const unsigned* bits, void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  Scalars sc;
  std::memcpy(&sc, scalars, sizeof(Scalars));
  Bits bt;
  std::memcpy(&bt, bits, sizeof(Bits));
  if (!sizes_ok(d)) return (int)cudaErrorInvalidValue;
  if (d.SPK > 0 && pointers[6] == nullptr) return (int)cudaErrorInvalidValue;
  const Ptrs P = make_ptrs(pointers, d);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.B + LANES - 1) / LANES);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(P, d, sc, bt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes, for these sizes (backward != 0:
// of the backward kernel).
long long fused_teacher_smem_bytes(const int* dims, int backward) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  const int total = backward ? make_bwd_layout(d).total : make_fwd_layout(d).total;
  return (long long)total * (long long)sizeof(float);
}

// Dynamic shared memory one block of the kernel may have on the current device,
// in bytes: what a block can opt in to, less what the kernel declares statically.
// Negative: minus the CUDA error code.
long long fused_teacher_smem_limit(int backward) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = backward ? cudaFuncGetAttributes(&attr, teacher_bwd_kernel)
                   : cudaFuncGetAttributes(&attr, teacher_fwd_kernel);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)optin - (long long)attr.sharedSizeBytes;
}

// `pointers`: 18 device pointers in the order of make_ptrs (host array); the
// forward reads the first 11, null for the rest.
int fused_teacher_fwd_f32(const void* const* pointers, const int* dims, const float* scalars,
                          const unsigned* bits, void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  return launch(teacher_fwd_kernel, (size_t)make_fwd_layout(d).total * sizeof(float), pointers,
                dims, scalars, bits, stream);
}

int fused_teacher_bwd_f32(const void* const* pointers, const int* dims, const float* scalars,
                          const unsigned* bits, void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  return launch(teacher_bwd_kernel, (size_t)make_bwd_layout(d).total * sizeof(float), pointers,
                dims, scalars, bits, stream);
}

}  // extern "C"
