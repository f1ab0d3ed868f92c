// The helpers every kernel here takes: the io types (float or bfloat16) and their
// loads and roundings, four weights as one load, warp sums and maxima, r4.

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
