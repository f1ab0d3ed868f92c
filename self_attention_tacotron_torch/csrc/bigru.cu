// Bidirectional GRU over a padded batch, both directions in one launch.
//
// Replaces the Pallas kernel of self_attention_tacotron_tpu/ops/fused_rnn.py
// (bigru_pallas, _make_kernel). Per direction and step it computes, in this body,
//
//   rz = sigmoid([x_t, io(h)] . Wg + bg)          r = rz[:H], z = rz[H:]
//   n  = tanh   ([x_t, io(r * h)] . Wc + bc)
//   h' = (1 - z) * n + z * h
//
// where io(.) rounds to the io type (float or bf16) before the product, the
// carry h stays float32, and y is stored in the io type. A step at or beyond a
// lane's length keeps the carry and emits zero; the backward direction walks
// S-1 -> 0, so its carry is still zero when it reaches the lane's last valid step.
//
// What is serial is time; what is parallel is (lane, direction, output column,
// slice of the reduction). Grid: (ceil(B / LANES), 2 directions). A block owns
// LANES lanes of one direction, keeps their carries in shared memory and loops
// over the steps. The time of a step is the latency of one thread's walk down
// the K = C + H rows of a weight matrix (read from global memory, coalesced
// across threads, served by L2 after the first step), so the block splits K
// over `parts` threads per column and adds the partial sums in shared memory;
// each weight read serves LANES lanes. The block stops at the longest length
// among its lanes; rows beyond a lane's length are zero-filled once at the start.
//
// Plain C interface at the bottom: the functions launch on the given stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 4;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float32 value to the io type and bring it back.
template <typename T> __device__ __forceinline__ float round_io(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

// s_part[(p * LANES + l) * ncols + j] = sum over the p-th slice of k of s_in[l][k] * w[k][j]
template <typename T>
__device__ __forceinline__ void partial_products(const T* __restrict__ w, int ncols, int K,
                                                 const float* s_in, float* s_part, int parts,
                                                 int tid, int nt) {
  const int chunk = (K + parts - 1) / parts;
  for (int idx = tid; idx < parts * ncols; idx += nt) {
    const int p = idx / ncols;
    const int j = idx - p * ncols;
    const int k0 = p * chunk;
    const int k1 = (k0 + chunk) < K ? (k0 + chunk) : K;
    float acc[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l) acc[l] = 0.0f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const float wv = to_float(w[(size_t)k * ncols + j]);
#pragma unroll
      for (int l = 0; l < LANES; ++l) acc[l] = fmaf(s_in[l * K + k], wv, acc[l]);
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l) s_part[(p * LANES + l) * ncols + j] = acc[l];
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
bigru_kernel(const T* __restrict__ xs,        // (B, S, C)
             const int* __restrict__ lengths, // (B,)
             const T* __restrict__ wg_f, const T* __restrict__ bg_f,
             const T* __restrict__ wc_f, const T* __restrict__ bc_f,
             const T* __restrict__ wg_b, const T* __restrict__ bg_b,
             const T* __restrict__ wc_b, const T* __restrict__ bc_b,
             T* __restrict__ y,               // (B, S, 2H)
             int B, int S, int C, int H) {
  extern __shared__ float smem[];
  const int K = C + H;
  const int H2 = 2 * H;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* s_in = smem;                  // LANES * K    [x_t | io(h)], then [x_t | io(r * h)]
  float* s_h = s_in + LANES * K;       // LANES * H    carry, float32
  float* s_rz = s_h + LANES * H;       // LANES * 2H   sigmoid gates
  float* s_part = s_rz + LANES * H2;   // LANES * max(nt, 2H) partial sums
  __shared__ int s_len[LANES];

  const int dir = blockIdx.y;
  const int lane0 = blockIdx.x * LANES;
  const T* wg = dir == 0 ? wg_f : wg_b;
  const T* bg = dir == 0 ? bg_f : bg_b;
  const T* wc = dir == 0 ? wc_f : wc_b;
  const T* bc = dir == 0 ? bc_f : bc_b;
  const int parts_g = nt / H2 > 0 ? nt / H2 : 1;   // threads per column, gate product
  const int parts_c = nt / H > 0 ? nt / H : 1;     // threads per column, candidate product

  if (tid < LANES) {
    const int b = lane0 + tid;
    int len = 0;
    if (b < B) {
      len = lengths[b];
      len = len < 0 ? 0 : (len > S ? S : len);
    }
    s_len[tid] = len;
  }
  for (int i = tid; i < LANES * H; i += nt) s_h[i] = 0.0f;
  __syncthreads();

  int max_len = 0;
#pragma unroll
  for (int l = 0; l < LANES; ++l) max_len = s_len[l] > max_len ? s_len[l] : max_len;

  // Zero the padded tail of this direction's half of y.
  for (int l = 0; l < LANES; ++l) {
    const int b = lane0 + l;
    if (b >= B) continue;
    const int len = s_len[l];
    const int n = (S - len) * H;
    for (int i = tid; i < n; i += nt) {
      const int t = len + i / H;
      const int j = i % H;
      y[((size_t)b * S + t) * H2 + dir * H + j] = from_float<T>(0.0f);
    }
  }

  for (int step = 0; step < max_len; ++step) {
    const int t = dir == 0 ? step : max_len - 1 - step;

    // 1. stage [x_t | io(h)]
    for (int i = tid; i < LANES * K; i += nt) {
      const int l = i / K;
      const int k = i - l * K;
      float v;
      if (k < C) {
        v = (t < s_len[l]) ? to_float(xs[((size_t)(lane0 + l) * S + t) * C + k]) : 0.0f;
      } else {
        v = round_io<T>(s_h[l * H + (k - C)]);
      }
      s_in[i] = v;
    }
    __syncthreads();

    // 2. rz = sigmoid([x, io(h)] . Wg + bg)
    partial_products<T>(wg, H2, K, s_in, s_part, parts_g, tid, nt);
    __syncthreads();
    for (int i = tid; i < LANES * H2; i += nt) {
      const int l = i / H2;
      const int j = i - l * H2;
      float acc = 0.0f;
      for (int p = 0; p < parts_g; ++p) acc += s_part[(p * LANES + l) * H2 + j];
      s_rz[i] = sigmoidf_(acc + to_float(bg[j]));
    }
    __syncthreads();

    // 3. the h part of the staged input becomes io(r * h)
    for (int i = tid; i < LANES * H; i += nt) {
      const int l = i / H;
      const int j = i - l * H;
      s_in[l * K + C + j] = round_io<T>(s_rz[l * H2 + j] * s_h[i]);
    }
    __syncthreads();

    // 4. n = tanh([x, io(r*h)] . Wc + bc);  h' = (1 - z) n + z h;  masked store
    partial_products<T>(wc, H, K, s_in, s_part, parts_c, tid, nt);
    __syncthreads();
    for (int i = tid; i < LANES * H; i += nt) {
      const int l = i / H;
      const int j = i - l * H;
      if (t < s_len[l]) {
        float acc = 0.0f;
        for (int p = 0; p < parts_c; ++p) acc += s_part[(p * LANES + l) * H + j];
        const float n = tanhf(acc + to_float(bc[j]));
        const float z = s_rz[l * H2 + H + j];
        const float h_new = (1.0f - z) * n + z * s_h[i];
        s_h[i] = h_new;
        y[((size_t)(lane0 + l) * S + t) * H2 + dir * H + j] = from_float<T>(h_new);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_bigru(const void* xs, const void* lengths, const void* wg_f, const void* bg_f,
                 const void* wc_f, const void* bc_f, const void* wg_b, const void* bg_b,
                 const void* wc_b, const void* bc_b, void* y, int B, int S, int C, int H,
                 void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  int threads = ((8 * H + 31) / 32) * 32;   // four threads per gate column
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const int part_cols = threads > 2 * H ? threads : 2 * H;
  const size_t smem = sizeof(float) * (size_t)LANES * ((C + H) + H + 2 * H + part_cols);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bigru_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((B + LANES - 1) / LANES, 2);
  bigru_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)xs, (const int*)lengths, (const T*)wg_f, (const T*)bg_f, (const T*)wc_f,
      (const T*)bc_f, (const T*)wg_b, (const T*)bg_b, (const T*)wc_b, (const T*)bc_b, (T*)y, B, S,
      C, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bigru_f32(const void* xs, const void* lengths, const void* wg_f, const void* bg_f,
              const void* wc_f, const void* bc_f, const void* wg_b, const void* bg_b,
              const void* wc_b, const void* bc_b, void* y, int B, int S, int C, int H,
              void* stream) {
  return launch_bigru<float>(xs, lengths, wg_f, bg_f, wc_f, bc_f, wg_b, bg_b, wc_b, bc_b, y, B, S,
                             C, H, stream);
}

int bigru_bf16(const void* xs, const void* lengths, const void* wg_f, const void* bg_f,
               const void* wc_f, const void* bc_f, const void* wg_b, const void* bg_b,
               const void* wc_b, const void* bc_b, void* y, int B, int S, int C, int H,
               void* stream) {
  return launch_bigru<__nv_bfloat16>(xs, lengths, wg_f, bg_f, wc_f, bc_f, wg_b, bg_b, wc_b, bc_b,
                                     y, B, S, C, H, stream);
}

}  // extern "C"
