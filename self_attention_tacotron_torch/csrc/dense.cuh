// Small products of a block that walks a decoder's steps on its own, shared by
// fused_decode.cu and fused_teacher.cu.
//
// A block owns LANES lanes and has NT threads. Every weight matrix is (in, out)
// with its rows padded to 16 bytes, and is streamed through L2 at every step:
// 16 bytes per thread and eight loads in flight, each weight read serving all
// lanes. A product's reduction is split over the threads; the partial sums are
// added in shared memory by gather().

#pragma once

#include <cuda_runtime.h>

__host__ __device__ inline int r4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

// Partial sums of s_in (LANES rows of K values, row stride ldi, a multiple of 4)
// times W (K rows of ld floats, ld a multiple of 4). The K rows are cut into
// `parts` slices of a multiple of 8 rows; a thread owns four neighbouring columns
// of one slice for all lanes:
//   s_part[(p * LANES + l) * ld + j] = sum over slice p of s_in[l][k] * W[k][j].
// Returns `parts`. The caller synchronises, then adds the slices with gather().
template <int LANES, int NT>
__device__ __forceinline__ int dense_partial(const float* __restrict__ W, int ld, int K,
                                             const float* s_in, int ldi, float* s_part,
                                             int tid) {
  const int nc4 = ld >> 2;
  int parts = NT / nc4;
  parts = imax(1, imin(parts, (K + 7) / 8));
  const int chunk = ((K + parts - 1) / parts + 7) / 8 * 8;
  parts = (K + chunk - 1) / chunk;
  for (int idx = tid; idx < parts * nc4; idx += NT) {
    const int p = idx / nc4;
    const int c = idx - p * nc4;
    const int k0 = p * chunk;
    const int k1 = imin(k0 + chunk, K);
    float4 acc[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l) acc[l] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* w4 = reinterpret_cast<const float4*>(W) + (size_t)k0 * nc4 + c;
    int k = k0;
    for (; k + 8 <= k1; k += 8) {
      float4 w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = __ldg(w4 + (size_t)u * nc4);
      w4 += (size_t)8 * nc4;
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        const float4 a0 = *reinterpret_cast<const float4*>(s_in + l * ldi + k);
        const float4 a1 = *reinterpret_cast<const float4*>(s_in + l * ldi + k + 4);
        fma4(acc[l], a0.x, w[0]);
        fma4(acc[l], a0.y, w[1]);
        fma4(acc[l], a0.z, w[2]);
        fma4(acc[l], a0.w, w[3]);
        fma4(acc[l], a1.x, w[4]);
        fma4(acc[l], a1.y, w[5]);
        fma4(acc[l], a1.z, w[6]);
        fma4(acc[l], a1.w, w[7]);
      }
    }
    for (; k < k1; ++k) {
      const float4 w = __ldg(w4);
      w4 += nc4;
#pragma unroll
      for (int l = 0; l < LANES; ++l) fma4(acc[l], s_in[l * ldi + k], w);
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      *reinterpret_cast<float4*>(s_part + (size_t)(p * LANES + l) * ld + 4 * c) = acc[l];
  }
  return parts;
}

template <int LANES>
__device__ __forceinline__ float gather(const float* s_part, int parts, int ld, int l, int j) {
  float acc = 0.0f;
  for (int p = 0; p < parts; ++p) acc += s_part[(p * LANES + l) * ld + j];
  return acc;
}
