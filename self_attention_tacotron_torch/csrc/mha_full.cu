// Full-sequence (non-causal) multi-head self-attention on packed qkv.
//
// Replaces the Pallas kernel of self_attention_tacotron_tpu/ops/fused_attention.py
// (mha_full_pallas, _make_kernel). For each batch row b, head h and query row i
// it computes, in this body,
//
//   logits[i, j] = (q_i . k_j) / sqrt(HD) + bias[j]     bias = 0 (valid key) or -1e9, added
//   probs[i, :]  = softmax(logits[i, :])                 float32, expf
//   ctx[i, :]    = sum_j io(probs[i, j]) * v_j           float32 sum, stored in the io type
//
// with q, k, v the slices [h*HD, (h+1)*HD) of the three thirds of qkv (B, T, 3D).
// It writes probs (B, H, T, T) float32 and ctx (B, T, D) in the io type.
//
// What bounds it on an H100: the function must move qkv, ctx and the (B, H, T, T)
// float32 probabilities, and do 4 * B * H * T^2 * HD operations. At the flagship
// shape (B = 32, T = 128, D = 256, HD = 128) that is 21 MB and 0.54 GFLOP: in float32,
// outside the tensor cores, the operations bound it (8 us at 67 TFLOP/s); in bfloat16,
// in the tensor cores, the bytes do (4 us). The design:
//
// * One block of 256 threads per (lane, head, tile of ROWS = 64 query rows): 128
//   blocks at the flagship shape, one wave. The block's q rows stay in shared memory;
//   K, then V, come in tiles of KEYS = 64 rows, double-buffered with cp.async, HD
//   padded with zeros to the products' tile.
// * The products run on register tiles: in bfloat16 on the tensor cores (mma.sync
//   m16n8k16, bf16 x bf16 -> f32, fragments by ldmatrix; a warp takes 16 rows x 32 keys
//   of q.k^T and 16 rows x half the head of probs.v), in float32 as FFMA with every
//   thread holding 4 x 4 logits or 4 rows x 16 columns of the context, operands in
//   registers (no TF32: it keeps about three decimal digits).
// * Two passes over the keys, so that q.k^T runs once and the rounding points stay
//   where the Pallas kernel has them: (1) the logits of every key tile into the
//   block's logits rows; each row's max, then exp(l - max) in place and its sum; (2)
//   per key tile, p = e / sum written to probs once, io(p) into a shared tile, and
//   ctx += io(p) . V. The logits rows live in shared memory where T <= LK keys fit
//   beside the tiles (LK up to 512, from HD and the io type), else in the block's own
//   rows of probs (L2): one generic pointer, so shared memory does not grow with T
//   and every T launches.
//
// The plan (mha_plan: tiles, strides, LK, the shared memory) is mirrored by
// ops/fused_attention.py::mha_full_plan; HD above MHA_HD_MAX is refused (MHA_TOO_WIDE).
//
// Plain C interface at the bottom: the functions launch on the given stream,
// allocate nothing, do not synchronise, and return cudaGetLastError() (or
// MHA_TOO_WIDE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "dense.cuh"
#include "grid.cuh"
#include "tensor.cuh"

namespace {

constexpr int ROWS = 64;          // query rows a block
constexpr int KEYS = 64;          // keys a tile
constexpr int THREADS = 256;
constexpr int LK_MAX = 512;       // most keys of the logits rows kept in shared memory
constexpr int MHA_HD_MAX = 256;
constexpr int MHA_TOO_WIDE = -3;
constexpr float NEG_INF = -1e9f;

__host__ __device__ inline long long r16b(long long n) { return (n + 15) / 16 * 16; }

// The block's plan: the padded head width (bfloat16: a multiple of 32, the tensor
// cores' k and two n tiles a half-warp; float32: of 8), the row strides of the q and
// K/V tiles (padded so that the rows of a warp's loads fall on different banks), of
// the P tile, the keys LK of the logits rows in shared memory, and the byte offsets.
struct MhaPlan {
  int rows, keys, threads, hd, hd_padded, ld, pld, lk, on_chip;
  int grid_x, grid_y, grid_z;
  long long off_kv, off_p, off_sum, off_l, smem_bytes, smem_limit;
};

inline int mha_plan(int B, int Tn, int D, int H, int io_bytes, long long limit, MhaPlan* p) {
  const int HD = D / H;
  if (HD > MHA_HD_MAX) return MHA_TOO_WIDE;
  p->rows = ROWS;
  p->keys = KEYS;
  p->threads = THREADS;
  p->hd = HD;
  p->hd_padded = io_bytes == 2 ? (HD + 31) / 32 * 32 : (HD + 7) / 8 * 8;
  p->ld = p->hd_padded + (io_bytes == 2 ? 8 : 4);
  p->pld = KEYS + (io_bytes == 2 ? 8 : 4);
  p->off_kv = r16b((long long)ROWS * p->ld * io_bytes);
  p->off_p = p->off_kv + r16b(2LL * KEYS * p->ld * io_bytes);
  p->off_sum = p->off_p + r16b((long long)ROWS * p->pld * io_bytes);
  p->off_l = p->off_sum + 8 * ROWS;
  const long long room = (limit - p->off_l) / (4LL * ROWS) - 16;
  p->lk = room < 0 ? 0 : (int)(room >= LK_MAX ? LK_MAX : room / KEYS * KEYS);
  p->on_chip = Tn <= p->lk;
  p->grid_x = (Tn + ROWS - 1) / ROWS;
  p->grid_y = H;
  p->grid_z = B;
  p->smem_bytes = p->off_l + (p->lk > 0 ? 4LL * ROWS * (p->lk + 16) : 0);
  p->smem_limit = limit;
  return 0;
}

// The logits of one key tile: epi(slot, row, key of the tile, q_row . k_key), every
// (row, key) of the 64 x 64 tile once; `slot` numbers the thread's rows (SLOTS of them:
// float32 rows rg + 16 slot, bfloat16 rows r + 8 slot). q and k rows in shared memory,
// stride ld, HDp values (zero-padded).
template <typename T>
struct Scores;

template <>
struct Scores<float> {
  static constexpr int SLOTS = 4;
  // the threads of a row: the 16 of a half-warp
  static constexpr int SHARE_LO = 1, SHARE_HI = 8;
  template <typename Epi>
  static __device__ __forceinline__ void run(const float* s_q, const float* s_k, int ld, int HDp,
                                             Epi&& epi) {
    // rows rg + 16 i, keys kg + 16 j: a warp's 16 keys fall on different banks, its two
    // q rows are broadcast, and its logits go out as two runs of 16 keys
    const int rg = threadIdx.x >> 4, kg = threadIdx.x & 15;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int d = 0; d < HDp; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(s_q + (rg + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(s_k + (kg + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[i][j];
          s = fmaf(qv[i].x, kv[j].x, s);
          s = fmaf(qv[i].y, kv[j].y, s);
          s = fmaf(qv[i].z, kv[j].z, s);
          s = fmaf(qv[i].w, kv[j].w, s);
          acc[i][j] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(i, rg + 16 * i, kg + 16 * j, acc[i][j]);
  }
  static __device__ __forceinline__ int row(int slot) { return (threadIdx.x >> 4) + 16 * slot; }
};

template <>
struct Scores<__nv_bfloat16> {
  static constexpr int SLOTS = 2;
  // the threads of a row: the 4 lanes of a quad, in the two warps of its rows
  static constexpr int SHARE_LO = 1, SHARE_HI = 2;
  template <typename Epi>
  static __device__ __forceinline__ void run(const __nv_bfloat16* s_q, const __nv_bfloat16* s_k,
                                             int ld, int HDp, Epi&& epi) {
    // warp w: rows 16 (w & 3) .. + 15, keys 32 (w >> 2) .. + 31 of the tile
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    const __nv_bfloat16* qa = s_q + (r0 + (lane & 15)) * ld + (lane >> 4) * 8;
    const __nv_bfloat16* kb = s_k + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
    for (int k0 = 0; k0 < HDp; k0 += 16) {
      unsigned a[4], b0[4], b1[4];
      ldsm_x4(a, qa + k0);
      ldsm_x4(b0, kb + k0);
      ldsm_x4(b1, kb + 16 * ld + k0);
      mma_bf16(acc[0], a, b0[0], b0[1]);
      mma_bf16(acc[1], a, b0[2], b0[3]);
      mma_bf16(acc[2], a, b1[0], b1[1]);
      mma_bf16(acc[3], a, b1[2], b1[3]);
    }
    const int r = r0 + (lane >> 2), c = n0 + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      epi(0, r, c + 8 * n, acc[n][0]);
      epi(0, r, c + 8 * n + 1, acc[n][1]);
      epi(1, r + 8, c + 8 * n, acc[n][2]);
      epi(1, r + 8, c + 8 * n + 1, acc[n][3]);
    }
  }
  static __device__ __forceinline__ int row(int slot) {
    return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * slot;
  }
};

// The running maximum and sum of exp(l - max) of a row's logits as a thread sees them,
// and two of them joined.
struct Softmax {
  float m, s;
  __device__ __forceinline__ void add(float v) {
    if (v > m) {
      s = s * expf(m - v) + 1.0f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
  __device__ __forceinline__ void join(float om, float os) {
    const float M = fmaxf(m, om);
    if (M == -INFINITY) return;   // neither has seen a logit of the row
    s = s * expf(m - M) + os * expf(om - M);
    m = M;
  }
};

// The context's register tile of a thread: ctx += io(p) . V over one key tile, and its
// store. float32: rows rg + 16 i, columns 64 c + 4 cg + (0..3), c < HDp / 64 rounded
// up; bfloat16: warp w's rows 16 (w & 3) .. + 15 and its half (w >> 2) of the padded
// head, in n-tiles of 8 columns.
template <typename T>
struct Context;

template <>
struct Context<float> {
  float acc[4][4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }
  __device__ __forceinline__ void add(const float* s_p, int pld, const float* s_v, int ld, int HDp) {
    const int rg = threadIdx.x & 15, cg = threadIdx.x >> 4;
    for (int k = 0; k < KEYS; k += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(s_p + (rg + 16 * i) * pld + k);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * c + 4 * cg;
        if (col < HDp) {
          float4 v[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) v[kk] = *reinterpret_cast<const float4*>(s_v + (k + kk) * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pk[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
            float4 a = make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              a.x = fmaf(pk[kk], v[kk].x, a.x);
              a.y = fmaf(pk[kk], v[kk].y, a.y);
              a.z = fmaf(pk[kk], v[kk].z, a.z);
              a.w = fmaf(pk[kk], v[kk].w, a.w);
            }
            acc[i][c][0] = a.x;
            acc[i][c][1] = a.y;
            acc[i][c][2] = a.z;
            acc[i][c][3] = a.w;
          }
        }
      }
    }
  }
  // out(row, column, value) for every row and column < HD of the thread's tile
  template <typename Out>
  __device__ __forceinline__ void store(int HD, Out&& out) const {
    const int rg = threadIdx.x & 15, cg = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 64 * c + 4 * cg + e;
          if (col < HD) out(rg + 16 * i, col, acc[i][c][e]);
        }
  }
};

template <>
struct Context<__nv_bfloat16> {
  float acc[16][4];   // up to 16 n-tiles: half of a head of 256
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  __device__ __forceinline__ void add(const __nv_bfloat16* s_p, int pld, const __nv_bfloat16* s_v,
                                      int ld, int HDp) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = 16 * (warp & 3), half = HDp / 2, c0 = half * (warp >> 2);
    const __nv_bfloat16* pa = s_p + (r0 + (lane & 15)) * pld + (lane >> 4) * 8;
    const __nv_bfloat16* vb = s_v + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 + (lane >> 4) * 8;
#pragma unroll
    for (int k0 = 0; k0 < KEYS; k0 += 16) {
      unsigned a[4];
      ldsm_x4(a, pa + k0);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        if (16 * np < half) {
          unsigned b[4];
          ldsm_x4_trans(b, vb + k0 * ld + 16 * np);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
  template <typename Out>
  __device__ __forceinline__ void store(int HD, int HDp, Out&& out) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int half = HDp / 2;
    const int r = 16 * (warp & 3) + (lane >> 2), c0 = half * (warp >> 2) + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = c0 + 8 * n;
      if (8 * n < half) {
        if (c < HD) {
          out(r, c, acc[n][0]);
          out(r + 8, c, acc[n][2]);
        }
        if (c + 1 < HD) {
          out(r, c + 1, acc[n][1]);
          out(r + 8, c + 1, acc[n][3]);
        }
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
mha_full_kernel(const T* __restrict__ qkv,               // (B, Tn, 3D)
                const unsigned char* __restrict__ mask,  // (B, Tn) or null
                T* __restrict__ ctx,                     // (B, Tn, D)
                float* __restrict__ probs,               // (B, H, Tn, Tn)
                int B, int Tn, int D, int H, MhaPlan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HD = plan.hd, HDp = plan.hd_padded, ld = plan.ld, pld = plan.pld;
  T* s_q = reinterpret_cast<T*>(smem);                        // [ROWS][ld]
  T* s_kv = reinterpret_cast<T*>(smem + plan.off_kv);         // [2][KEYS][ld] K, then V
  T* s_p = reinterpret_cast<T*>(smem + plan.off_p);           // [ROWS][pld] io(p) of a tile
  float* s_max = reinterpret_cast<float*>(smem + plan.off_sum);   // [ROWS] each row's max
  float* s_sum = s_max + ROWS;                                    // [ROWS] and sum of exp
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int rows = imin(ROWS, Tn - q0);
  const size_t rs = (size_t)3 * D;
  const T* base = qkv + (size_t)b * Tn * rs + h * HD;
  float* prow = probs + (((size_t)b * H + h) * Tn + q0) * Tn;   // the block's rows of probs
  // the logits rows: in shared memory where they fit, else the block's rows of probs
  float* L = plan.on_chip ? reinterpret_cast<float*>(smem + plan.off_l) : prow;
  const size_t ldl = plan.on_chip ? (size_t)(plan.lk + 16) : (size_t)Tn;
  const float scale = sqrtf((float)HD);
  const int nt = (Tn + KEYS - 1) / KEYS;
  constexpr int PER16 = 16 / (int)sizeof(T);
  const bool vec = (HD % PER16) == 0 && (D % PER16) == 0 &&
                   (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;

  // zero q, the K/V tiles and the P tile: the padded columns and the rows past T stay zero
  {
    const long long n4 = plan.off_sum / 16;
    for (long long i = tid; i < n4; i += THREADS) reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  // rows [j0, j0 + n) of third `sec` (0 q, 1 k, 2 v) of the head into dst, one commit group
  auto load = [&](T* dst, int j0, int n, int sec) {
    const T* src = base + (size_t)j0 * rs + (size_t)sec * D;
    if (vec) {
      const int cpr = HD / PER16;
      for (int i = tid; i < n * cpr; i += THREADS) {
        const int r = i / cpr, c = (i - r * cpr) * PER16;
        cp_async16(dst + r * ld + c, src + (size_t)r * rs + c);
      }
    } else {
      for (int i = tid; i < n * HD; i += THREADS) {
        const int r = i / HD, d = i - r * HD;
        dst[r * ld + d] = src[(size_t)r * rs + d];
      }
    }
    cp_async_commit();
  };
  auto tile = [&](int kt) { return s_kv + (size_t)(kt & 1) * KEYS * ld; };

  // pass 1: logits = q . k^T / sqrt(HD) + bias, one key tile at a time; each thread
  // keeps the running max and sum of exp(l - max) of the logits it computes
  using Sc = Scores<T>;
  Softmax sm[Sc::SLOTS];
#pragma unroll
  for (int i = 0; i < Sc::SLOTS; ++i) sm[i] = Softmax{-INFINITY, 0.0f};
  load(s_q, q0, rows, 0);
  load(tile(0), 0, imin(KEYS, Tn), 1);
  for (int kt = 0; kt < nt; ++kt) {
    const int j0 = kt * KEYS;
    if (kt + 1 < nt) {
      load(tile(kt + 1), j0 + KEYS, imin(KEYS, Tn - j0 - KEYS), 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    Sc::run(s_q, tile(kt), ld, HDp, [&](int slot, int r, int jj, float acc) {
      const int j = j0 + jj;
      if (r < rows && j < Tn) {
        const float bias = (mask != nullptr && __ldg(mask + (size_t)b * Tn + j) == 0) ? NEG_INF : 0.0f;
        const float l = acc / scale + bias;
        L[r * ldl + j] = l;
#pragma unroll
        for (int i = 0; i < Sc::SLOTS; ++i)
          if (i == slot) sm[i].add(l);
      }
    });
    __syncthreads();   // the tile is read before the next prefetch overwrites it
  }
  // V's first tile, while the rows' statistics are joined
  load(tile(0), 0, imin(KEYS, Tn), 2);
  // join the threads of a row: by shuffles within a warp, then the warps of the row
  // (bfloat16: two) through shared memory (the P tile's room, free until pass 2)
  float* s_red = reinterpret_cast<float*>(s_p);   // [ROWS][2] max, [ROWS][2] sum
#pragma unroll
  for (int i = 0; i < Sc::SLOTS; ++i) {
    for (int o = Sc::SHARE_LO; o <= Sc::SHARE_HI; o <<= 1)
      sm[i].join(__shfl_xor_sync(0xffffffffu, sm[i].m, o), __shfl_xor_sync(0xffffffffu, sm[i].s, o));
  }
  if (sizeof(T) == 4) {
    if ((tid & 15) == 0) {
#pragma unroll
      for (int i = 0; i < Sc::SLOTS; ++i) {
        const int r = Sc::row(i);
        s_red[2 * r] = sm[i].m;
        s_red[2 * ROWS + 2 * r] = sm[i].s;
        s_red[2 * r + 1] = -INFINITY;
        s_red[2 * ROWS + 2 * r + 1] = 0.0f;
      }
    }
  } else if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < Sc::SLOTS; ++i) {
      const int r = Sc::row(i), part = warp >> 2;
      s_red[2 * r + part] = sm[i].m;
      s_red[2 * ROWS + 2 * r + part] = sm[i].s;
    }
  }
  __syncthreads();
  if (tid < ROWS) {
    Softmax row{s_red[2 * tid], s_red[2 * ROWS + 2 * tid]};
    row.join(s_red[2 * tid + 1], s_red[2 * ROWS + 2 * tid + 1]);
    s_max[tid] = row.m;
    s_sum[tid] = row.s;
  }
  __syncthreads();

  // pass 2: p = e / sum written to probs once, ctx += io(p) . V, one key tile at a time
  Context<T> acc;
  acc.zero();
  for (int kt = 0; kt < nt; ++kt) {
    const int j0 = kt * KEYS;
    if (kt + 1 < nt) load(tile(kt + 1), j0 + KEYS, imin(KEYS, Tn - j0 - KEYS), 2);
    for (int i = tid; i < ROWS * KEYS; i += THREADS) {
      const int r = i / KEYS, jj = i - r * KEYS, j = j0 + jj;
      float p = 0.0f;
      if (r < rows && j < Tn) {
        p = expf(L[r * ldl + j] - s_max[r]) / s_sum[r];
        prow[(size_t)r * Tn + j] = p;
      }
      s_p[r * pld + jj] = Io<T>::from(p);
    }
    if (kt + 1 < nt) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    acc.add(s_p, pld, tile(kt), ld, HDp);
    __syncthreads();   // the P tile and the V tile are read before they are overwritten
  }
  T* out = ctx + ((size_t)b * Tn + q0) * D + h * HD;
  auto put = [&](int r, int c, float v) {
    if (r < rows) out[(size_t)r * D + c] = Io<T>::from(v);
  };
  if constexpr (sizeof(T) == 4) {
    acc.store(HD, put);
  } else {
    acc.store(HD, HDp, put);
  }
}

// The card's opt-in shared memory per block, read and set as the kernel's attribute
// once per (instantiation, device).
template <typename T>
int card_limit(int* limit) {
  struct Card {
    int dev, limit;
  };
  static std::mutex mutex;
  static Card cards[64];
  static int n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < n; ++i)
    if (cards[i].dev == dev) {
      *limit = cards[i].limit;
      return 0;
    }
  int lim = 0;
  err = cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mha_full_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
  if (err != cudaSuccess) return (int)err;
  if (n < 64) cards[n++] = Card{dev, lim};
  *limit = lim;
  return 0;
}

template <typename T>
int plan_of(int B, int Tn, int D, int H, MhaPlan* p) {
  if (B <= 0 || Tn <= 0 || D <= 0 || H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  int limit = 0;
  const int code = card_limit<T>(&limit);
  if (code != 0) return code;
  return mha_plan(B, Tn, D, H, (int)sizeof(T), limit, p);
}

template <typename T>
int launch_mha_full(const void* qkv, const void* mask, void* ctx, void* probs, int B, int Tn,
                    int D, int H, void* stream) {
  MhaPlan p;
  const int code = plan_of<T>(B, Tn, D, H, &p);
  if (code != 0) return code;
  dim3 grid(p.grid_x, p.grid_y, p.grid_z);
  mha_full_kernel<T><<<grid, THREADS, (size_t)p.smem_bytes, (cudaStream_t)stream>>>(
      (const T*)qkv, (const unsigned char*)mask, (T*)ctx, (float*)probs, B, Tn, D, H, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mha_full_f32(const void* qkv, const void* mask, void* ctx, void* probs, int B, int Tn, int D,
                 int H, void* stream) {
  return launch_mha_full<float>(qkv, mask, ctx, probs, B, Tn, D, H, stream);
}

int mha_full_bf16(const void* qkv, const void* mask, void* ctx, void* probs, int B, int Tn, int D,
                  int H, void* stream) {
  return launch_mha_full<__nv_bfloat16>(qkv, mask, ctx, probs, B, Tn, D, H, stream);
}

// The plan the kernel launches with on the current device, in the order of
// ops/fused_attention.py::MhaPlan: rows, keys, threads, hd, hd_padded, ld, pld, lk,
// on_chip, grid_x, grid_y, grid_z, smem_bytes, smem_limit.
int mha_full_plan_query(int B, int Tn, int D, int H, int bf16, long long* out) {
  MhaPlan p;
  const int code = bf16 ? plan_of<__nv_bfloat16>(B, Tn, D, H, &p) : plan_of<float>(B, Tn, D, H, &p);
  if (code != 0) return code;
  const long long v[] = {p.rows, p.keys, p.threads, p.hd, p.hd_padded, p.ld, p.pld, p.lk,
                         p.on_chip, p.grid_x, p.grid_y, p.grid_z, p.smem_bytes, p.smem_limit};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
