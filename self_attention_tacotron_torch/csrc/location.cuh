// The location features of location-sensitive attention inside the loop kernels,
// shared by fused_decode.cu and fused_teacher.cu.
//
// The JAX package's kernels fold the SAME convolution of the (cumulative)
// alignments and the dense layer after it into one (K, A1) matrix W and one bias
// (both linear), and build a (taps, B * S) matrix of shifted alignments for the
// TPU's matrix unit. Here nothing of that size is stored: a thread owns one column
// a of W and LS_RUN neighbouring source positions s0 .. s0 + LS_RUN - 1, holds the
// LS_RUN + LS_TAPS - 1 alignment values those positions' taps read in registers
// (loaded once for every column the thread visits), reads W's column from shared
// memory once per tap, and forms
//
//   loc[s][a] = sum_k prev[s + k - K / 2] * W[k][a]       (prev zero outside [0, S))
//
// with LS_RUN fused multiply-adds per value of W read. W is held zero-padded to
// LS_TAPS rows, so every K up to LS_TAPS takes the same unrolled loop.

#pragma once

#include "dense.cuh"

// Rows of the folded location matrix as the kernels hold it (zero beyond K): the
// most taps they take.
constexpr int LS_TAPS = 32;
// Neighbouring source positions whose location features one thread forms at once.
constexpr int LS_RUN = 8;
constexpr int LS_WIN = LS_RUN + LS_TAPS - 1;

// win[i] = prev[start + i] rounded to IO (the taps are a product's input), 0
// outside [0, S).
template <typename IO>
__device__ __forceinline__ void ls_window(const float* prev, int S, int start,
                                          float (&win)[LS_WIN]) {
#pragma unroll
  for (int i = 0; i < LS_WIN; ++i) {
    const int p = start + i;
    win[i] = (p >= 0 && p < S) ? Io<IO>::round(prev[p]) : 0.0f;
  }
}

// loc[j] = sum_k win[j + k] * s_w[k * ld + a], over the LS_TAPS rows of W in shared
// memory, summed in the order of k.
__device__ __forceinline__ void ls_dot(const float (&win)[LS_WIN], const float* s_w, int ld,
                                       int a, float (&loc)[LS_RUN]) {
#pragma unroll
  for (int j = 0; j < LS_RUN; ++j) loc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < LS_TAPS; ++k) {
    const float wk = s_w[k * ld + a];
#pragma unroll
    for (int j = 0; j < LS_RUN; ++j) loc[j] = fmaf(win[j + k], wk, loc[j]);
  }
}
