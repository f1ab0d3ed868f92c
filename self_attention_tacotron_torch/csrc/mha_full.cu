// Full-sequence (non-causal) multi-head self-attention on packed qkv.
//
// Replaces the Pallas kernel of self_attention_tacotron_tpu/ops/fused_attention.py
// (mha_full_pallas, _make_kernel). For each batch row b, head h and query row i
// it computes, in this body,
//
//   logits[i, j] = (q_i . k_j) / sqrt(HD) + bias[j]     bias = 0 (valid key) or -1e9, added
//   probs[i, :]  = softmax(logits[i, :])                 float32
//   ctx[i, :]    = sum_j io(probs[i, j]) * v_j           float32 sum, stored in the io type
//
// with q, k, v the slices [h*HD, (h+1)*HD) of the three thirds of qkv (B, T, 3D).
// It writes probs (B, H, T, T) float32 and ctx (B, T, D) in the io type.
//
// The function must move qkv, ctx and the (B, H, T, T) float32 probabilities, and
// do 4 * B * H * T^2 * HD operations. At the flagship shape (T = 128, D = 256,
// HD = 128) that is 21 MB and 0.54 GFLOP: in float32, outside the tensor cores,
// the operations bound it; in bfloat16 the bytes do. This first kernel uses plain
// float32 multiply-adds fed from shared memory and no tensor cores; what it does
// for the bound is to move each byte once: logits never go to device memory and
// each probability is written once. Grid: (ceil(T / ROWS), H, B), which is 512
// blocks at the flagship shape. A block owns ROWS query rows against all
// T keys: q rows and the ROWS x T logits live in shared memory, keys are staged in
// chunks of KEYS rows (padded to an odd stride, so that threads on neighbouring
// keys hit different banks), one warp takes the softmax of a row, and the
// probs . v product reads v from global memory with neighbouring threads on
// neighbouring columns.
//
// Plain C interface at the bottom: the functions launch on the given stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 16;     // query rows per block
constexpr int KEYS = 32;     // keys staged per chunk
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float round_io(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void mha_full_kernel(const T* __restrict__ qkv,               // (B, Tn, 3D)
                                const unsigned char* __restrict__ mask,  // (B, Tn) or null
                                T* __restrict__ ctx,                     // (B, Tn, D)
                                float* __restrict__ probs,               // (B, H, Tn, Tn)
                                int B, int Tn, int D, int H, int kstride) {
  extern __shared__ float smem[];
  const int HD = D / H;
  float* s_q = smem;              // ROWS * HD
  float* s_p = s_q + ROWS * HD;   // ROWS * Tn   logits, then probs
  float* s_k = s_p + ROWS * Tn;   // KEYS * kstride

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = (Tn - q0) < ROWS ? (Tn - q0) : ROWS;
  const size_t row_stride = (size_t)3 * D;
  const T* base = qkv + (size_t)b * Tn * row_stride;
  const float scale = sqrtf((float)HD);

  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i % HD;
    s_q[i] = r < rows ? to_float(base[(size_t)(q0 + r) * row_stride + h * HD + d]) : 0.0f;
  }

  // logits = q . k^T / sqrt(HD) + bias, one chunk of keys at a time
  for (int c0 = 0; c0 < Tn; c0 += KEYS) {
    __syncthreads();
    for (int i = tid; i < KEYS * HD; i += THREADS) {
      const int jj = i / HD;
      const int d = i % HD;
      const int j = c0 + jj;
      s_k[jj * kstride + d] =
          j < Tn ? to_float(base[(size_t)j * row_stride + D + h * HD + d]) : 0.0f;
    }
    __syncthreads();
    for (int p = tid; p < ROWS * KEYS; p += THREADS) {
      const int r = p / KEYS;
      const int jj = p % KEYS;
      const int j = c0 + jj;
      if (j < Tn) {
        const float* qr = s_q + r * HD;
        const float* kr = s_k + jj * kstride;
        float acc = 0.0f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) acc = fmaf(qr[d], kr[d], acc);
        const float bias = (mask != nullptr && mask[(size_t)b * Tn + j] == 0) ? NEG_INF : 0.0f;
        s_p[r * Tn + j] = acc / scale + bias;
      }
    }
  }
  __syncthreads();

  // softmax of each row in float32, one warp per row; probs go out once
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    float* row = s_p + r * Tn;
    float m = -INFINITY;
    for (int j = lane; j < Tn; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < Tn; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float* out = probs + (((size_t)b * H + h) * Tn + (q0 + r)) * Tn;
    for (int j = lane; j < Tn; j += 32) {
      const float prob = row[j] / sum;
      out[j] = prob;
      row[j] = round_io<T>(prob);
    }
  }
  __syncthreads();

  // ctx = io(probs) . v
  for (int i = tid; i < rows * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i % HD;
    const float* row = s_p + r * Tn;
    const T* vcol = base + 2 * D + h * HD + d;
    float acc = 0.0f;
#pragma unroll 4
    for (int j = 0; j < Tn; ++j) acc = fmaf(row[j], to_float(vcol[(size_t)j * row_stride]), acc);
    ctx[((size_t)b * Tn + q0 + r) * D + h * HD + d] = from_float<T>(acc);
  }
}

template <typename T>
int launch_mha_full(const void* qkv, const void* mask, void* ctx, void* probs, int B, int Tn,
                    int D, int H, void* stream) {
  if (B <= 0 || Tn <= 0 || D <= 0 || H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int HD = D / H;
  const int kstride = HD | 1;
  const size_t smem =
      sizeof(float) * ((size_t)ROWS * HD + (size_t)ROWS * Tn + (size_t)KEYS * kstride);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(mha_full_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Tn + ROWS - 1) / ROWS, H, B);
  mha_full_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)qkv, (const unsigned char*)mask, (T*)ctx, (float*)probs, B, Tn, D, H, kstride);
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

}  // extern "C"
