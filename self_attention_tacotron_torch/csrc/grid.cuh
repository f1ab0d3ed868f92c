// Building blocks of a persistent loop kernel that spreads every step over the whole
// grid: one block per SM, all resident (a cooperative launch), each block holding its
// slice of every weight matrix in shared memory for the whole launch, and the blocks
// meeting at a grid-wide barrier between the dependent stages of a step.
//
// * share_of: which items (output columns, or the units of an LSTM's gate product)
//   a block owns. Items are dealt out in contiguous runs, the remainder rotated from
//   product to product, so that no block carries every remainder. The host and the
//   kernel evaluate the same formula (and ops/fused_decode.py::grid_plan mirrors it).
// * grid_barrier: a monotone arrival counter in global memory, `red.release.gpu` to
//   arrive and `ld.acquire.gpu` to wait.
// * bulk_copy / mbar_*: rows copied by the Tensor Memory Accelerator.
// * warp_tile / reduce16: one warp computes a 4-lane x 4-column tile of a product,
//   the lanes' input rows and the columns' weights both in shared memory with the
//   reduction index k contiguous, each thread taking every 32nd group of four k;
//   the 16 partial sums are then added over the warp in 16 shuffles, after which
//   thread q holds the sum of value q >> 1 (lane (q >> 3), column ((q >> 1) & 3)).

#pragma once

#include <cuda_runtime.h>

#include "dense.cuh"

struct Share {
  int first, count;
};

// Items [first, first + count) of n dealt out over G blocks from block `start` on:
// every block gets n / G, the n % G blocks from `start` on (wrapping) one more.
__host__ __device__ inline Share share_of(int n, int G, int start, int b) {
  const int base = n / G, extra = n - base * G;
  const int r = (b - start + G) % G;
  Share s;
  s.first = r * base + imin(r, extra);
  s.count = base + (r < extra ? 1 : 0);
  return s;
}

__device__ __forceinline__ long long global_timer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block arrives once per call, in the same order of calls. `goal` is thread
// 0's count of arrivals the counter must have reached (the counter starts at 0 and
// only grows). `stamp`: null, or two slots for block 0's arrival and departure
// (%globaltimer, ns). A block that waits 20 G cycles traps: it fails, never hangs.
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int& goal,
                                             long long* stamp) {
  __syncthreads();
  if (threadIdx.x == 0) {
    goal += gridDim.x;
    if (stamp != nullptr) stamp[0] = global_timer();
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(counter), "r"(1u) : "memory");
    unsigned int seen;
    const long long start = clock64();
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
      if (clock64() - start > 20000000000LL) __trap();
    } while ((int)(seen - goal) < 0);
    if (stamp != nullptr) stamp[1] = global_timer();
  }
  __syncthreads();
}

// A value written by another block of the launch, read through L2 (never from a
// stale L1 line): a float, or an io-type value as float.
__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned int)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Bulk copies through the Tensor Memory Accelerator (one instruction moves a whole
// row; sm_90), their completion counted in bytes on an mbarrier in shared memory.
// Thread 0 announces the bytes of a batch and issues its copies; every thread
// waits on the barrier's phase, which flips once per batch.
__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return (unsigned int)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned int phase) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT_%=;\n\t}" ::"r"(smem_addr(bar)),
      "r"(phase) : "memory");
}
// `bytes` (a multiple of 16) from global to shared memory, both 16-byte aligned. The
// issuing thread orders its earlier accesses of either memory before the copy.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// acc[4 a + c] += sum over k of x_a[k] * w_c[k], for the quads q = lane, lane + 32, ...
// below nq of four rows x_a and four columns w_c (values of type IO, k contiguous).
template <typename IO>
__device__ __forceinline__ void warp_tile(const IO* const (&x)[4], const IO* const (&w)[4],
                                          int nq, int lane, float (&acc)[16]) {
  using Vec = typename Weights4<IO>::Vec;
  for (int q = lane; q < nq; q += 32) {
    float4 xv[4], wv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xv[a] = Weights4<IO>::values(reinterpret_cast<const Vec*>(x[a])[q]);
#pragma unroll
    for (int c = 0; c < 4; ++c) wv[c] = Weights4<IO>::values(reinterpret_cast<const Vec*>(w[c])[q]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[4 * a + c];
        s = fmaf(xv[a].x, wv[c].x, s);
        s = fmaf(xv[a].y, wv[c].y, s);
        s = fmaf(xv[a].z, wv[c].z, s);
        s = fmaf(xv[a].w, wv[c].w, s);
        acc[4 * a + c] = s;
      }
  }
}

// Sums each of the 16 values over the warp; thread q returns the sum of value q >> 1.
// Each halving step keeps the half of the values that its bit of q selects and adds
// the partner's copy of it.
__device__ __forceinline__ float reduce16(float (&v)[16], int lane) {
  constexpr unsigned int FULL = 0xffffffffu;
  {
    const bool hi = lane & 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float send = hi ? v[i] : v[i + 8];
      v[i] = (hi ? v[i + 8] : v[i]) + __shfl_xor_sync(FULL, send, 16);
    }
  }
  {
    const bool hi = lane & 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = hi ? v[i] : v[i + 4];
      v[i] = (hi ? v[i + 4] : v[i]) + __shfl_xor_sync(FULL, send, 8);
    }
  }
  {
    const bool hi = lane & 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = hi ? v[i] : v[i + 2];
      v[i] = (hi ? v[i + 2] : v[i]) + __shfl_xor_sync(FULL, send, 4);
    }
  }
  {
    const bool hi = lane & 2;
    const float send = hi ? v[0] : v[1];
    v[0] = (hi ? v[1] : v[0]) + __shfl_xor_sync(FULL, send, 2);
  }
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}
