// Small products of a block that walks a recurrence's steps on its own, shared by
// fused_decode.cu, fused_teacher.cu and bilstm.cu.
//
// A block owns LANES lanes and has NT threads. Every weight matrix is (in, out)
// with its rows padded to four values, and is streamed through L2 at every step:
// four columns per thread (16 bytes of float, 8 of bfloat16) and eight loads in
// flight, each weight read serving all lanes. A product's reduction is split over
// the threads; the partial sums are added in shared memory by gather().

#pragma once

#include <cuda_bf16.h>
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

// Four neighbouring weights as one load: 16 bytes of float, 8 of bfloat16, and
// their values as float (a bfloat16 is the upper half of the float it stands for).
template <typename WT> struct Weights4;
template <> struct Weights4<float> {
  using Vec = float4;
  static __device__ __forceinline__ float4 values(const float4& v) { return v; }
};
template <> struct Weights4<__nv_bfloat16> {
  using Vec = uint2;
  static __device__ __forceinline__ float4 values(const uint2& v) {
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
};

// One value of a kernel's io type (float or bfloat16) as float, a float rounded to
// that type (round to nearest even) and kept as float, and a float stored as it.
template <typename IO> struct Io;
template <> struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __uint_as_float((unsigned int)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
};

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

// Partial sums of s_in (LANES rows of K values, row stride ldi, a multiple of 4)
// times W (K rows of ld values, float or bfloat16, ld a multiple of 4). The K rows
// are cut into `parts` slices of a multiple of 8 rows; a thread owns four
// neighbouring columns of one slice for all lanes:
//   s_part[(p * LANES + l) * ld + j] = sum over slice p of s_in[l][k] * W[k][j].
// Returns `parts`. The caller synchronises, then adds the slices with gather().
template <int LANES, int NT, typename WT>
__device__ __forceinline__ int dense_partial(const WT* __restrict__ W, int ld, int K,
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
    // a pointer to whole groups of four (indexed by single values instead, the loop
    // left fused_decode a quarter slower on an H100)
    using Vec = typename Weights4<WT>::Vec;
    const Vec* w4 = reinterpret_cast<const Vec*>(W) + (size_t)k0 * nc4 + c;
    int k = k0;
    for (; k + 8 <= k1; k += 8) {
      float4 w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = Weights4<WT>::values(__ldg(w4 + (size_t)u * nc4));
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
      const float4 w = Weights4<WT>::values(__ldg(w4));
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
