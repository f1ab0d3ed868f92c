// Bidirectional ZoneoutLSTM over a padded batch, eval mode, both directions in one launch.
//
// Replaces the Pallas kernel of self_attention_tacotron_tpu/ops/fused_rnn.py
// (bilstm_pallas, _make_lstm_kernel), the encoder LSTM of ZoneoutEncoderV1. Per
// direction and step it computes, in this body,
//
//   z  = [x_t, io(h)] . W + b                      (gates i, g, f, o; W is (C + H, 4H))
//   c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//   c  = zc * c + (1 - zc) * c'                    (eval-mode zoneout: interpolation)
//   h  = zo * h + (1 - zo) * h'
//
// where io(.) rounds to the io type (float or bf16) before the product, the
// carries c and h stay float32, and y is stored in the io type. A step at or
// beyond a lane's length keeps both carries and emits zero; the backward
// direction walks S-1 -> 0, so its carries are still zero when it reaches the
// lane's last valid step.
//
// What bounds it on an H100 is the chain of S dependent steps, not bytes or
// operations: 2 * sum(lengths) * 2 * (C + H) * 4H operations and a megabyte of
// weights, re-read at every step. The design is bigru.cu's: grid (ceil(B /
// LANES), 2 directions), a block owns LANES lanes of one direction, keeps their
// carries in shared memory and loops over the steps; the gate product streams W
// through L2 with dense_partial (dense.cuh), each weight read serving LANES lanes.
// The block stops at the longest length among its lanes; rows beyond a lane's
// length are zero-filled once at the start.
//
// Plain C interface at the bottom: the functions launch on the given stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense.cuh"

namespace {

constexpr int LANES = 4;
constexpr int NT = 512;

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

struct Shape {
  int B, S, C, H;
  float zc, zo, forget_bias;
};

// Offsets (in floats) of the arrays in dynamic shared memory, each a multiple of 4.
struct Layout {
  int in, c, h, part, total;
};

__host__ __device__ inline Layout make_layout(const Shape& d) {
  Layout L;
  int at = 0;
  L.in = at;    at += LANES * r4(d.C + d.H);   // [x_t | io(h)] per lane
  L.c = at;     at += LANES * r4(d.H);
  L.h = at;     at += LANES * r4(d.H);
  L.part = at;  at += LANES * imax(4 * NT, 4 * d.H);
  L.total = at;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(NT)
bilstm_kernel(const T* __restrict__ xs,         // (B, S, C)
              const int* __restrict__ lengths,  // (B,)
              const T* __restrict__ w_f, const T* __restrict__ b_f,   // (C + H, 4H), (4H,)
              const T* __restrict__ w_b, const T* __restrict__ b_b,
              T* __restrict__ y,                // (B, S, 2H)
              const Shape d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_len[LANES];
  const int B = d.B, S = d.S, C = d.C, H = d.H;
  const int K = C + H, G = 4 * H, H2 = 2 * H;
  const int tid = threadIdx.x;
  const Layout L = make_layout(d);
  float* s_in = smem + L.in;     const int ld_in = r4(K);
  float* s_c = smem + L.c;       const int ld_h = r4(H);
  float* s_h = smem + L.h;
  float* s_part = smem + L.part;

  const int dir = blockIdx.y;
  const int lane0 = blockIdx.x * LANES;
  const T* w = dir == 0 ? w_f : w_b;
  const T* b = dir == 0 ? b_f : b_b;

  if (tid < LANES) {
    const int lb = lane0 + tid;
    int len = 0;
    if (lb < B) {
      len = lengths[lb];
      len = len < 0 ? 0 : (len > S ? S : len);
    }
    s_len[tid] = len;
  }
  for (int i = tid; i < L.total; i += NT) smem[i] = 0.0f;
  __syncthreads();

  int max_len = 0;
#pragma unroll
  for (int l = 0; l < LANES; ++l) max_len = s_len[l] > max_len ? s_len[l] : max_len;

  // Zero the padded tail of this direction's half of y.
  for (int l = 0; l < LANES; ++l) {
    const int lb = lane0 + l;
    if (lb >= B) continue;
    const int len = s_len[l];
    const int n = (S - len) * H;
    for (int i = tid; i < n; i += NT) {
      const int t = len + i / H;
      const int j = i % H;
      y[((size_t)lb * S + t) * H2 + dir * H + j] = from_float<T>(0.0f);
    }
  }

  for (int step = 0; step < max_len; ++step) {
    const int t = dir == 0 ? step : max_len - 1 - step;

    // 1. stage [x_t | io(h)]
    for (int i = tid; i < LANES * K; i += NT) {
      const int l = i / K;
      const int k = i - l * K;
      float v;
      if (k < C) {
        v = (t < s_len[l]) ? to_float(xs[((size_t)(lane0 + l) * S + t) * C + k]) : 0.0f;
      } else {
        v = round_io<T>(s_h[l * ld_h + (k - C)]);
      }
      s_in[l * ld_in + k] = v;
    }
    __syncthreads();

    // 2. z = [x_t | io(h)] . W, split over the threads
    const int parts = dense_partial<LANES, NT>(w, G, K, s_in, ld_in, s_part, tid);
    __syncthreads();

    // 3. the cell and its zoneout interpolation; masked store
    for (int i = tid; i < LANES * H; i += NT) {
      const int l = i / H;
      const int j = i - l * H;
      if (t < s_len[l]) {
        const float zi = gather<LANES>(s_part, parts, G, l, j) + to_float(b[j]);
        const float zg = gather<LANES>(s_part, parts, G, l, H + j) + to_float(b[H + j]);
        const float zf = gather<LANES>(s_part, parts, G, l, 2 * H + j) + to_float(b[2 * H + j]);
        const float zo = gather<LANES>(s_part, parts, G, l, 3 * H + j) + to_float(b[3 * H + j]);
        const float c = s_c[l * ld_h + j];
        const float h = s_h[l * ld_h + j];
        const float new_c = sigmoidf_(zf + d.forget_bias) * c + sigmoidf_(zi) * tanhf(zg);
        const float new_h = sigmoidf_(zo) * tanhf(new_c);
        const float out_c = d.zc * c + (1.0f - d.zc) * new_c;
        const float out_h = d.zo * h + (1.0f - d.zo) * new_h;
        s_c[l * ld_h + j] = out_c;
        s_h[l * ld_h + j] = out_h;
        y[((size_t)(lane0 + l) * S + t) * H2 + dir * H + j] = from_float<T>(out_h);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_bilstm(const void* xs, const void* lengths, const void* w_f, const void* b_f,
                  const void* w_b, const void* b_b, void* y, int B, int S, int C, int H, float zc,
                  float zo, float forget_bias, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Shape d{B, S, C, H, zc, zo, forget_bias};
  const size_t smem = sizeof(float) * (size_t)make_layout(d).total;
  cudaError_t err = cudaFuncSetAttribute(bilstm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + LANES - 1) / LANES, 2);
  bilstm_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)xs, (const int*)lengths, (const T*)w_f, (const T*)b_f, (const T*)w_b,
      (const T*)b_b, (T*)y, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bilstm_f32(const void* xs, const void* lengths, const void* w_f, const void* b_f,
               const void* w_b, const void* b_b, void* y, int B, int S, int C, int H, float zc,
               float zo, float forget_bias, void* stream) {
  return launch_bilstm<float>(xs, lengths, w_f, b_f, w_b, b_b, y, B, S, C, H, zc, zo, forget_bias,
                              stream);
}

int bilstm_bf16(const void* xs, const void* lengths, const void* w_f, const void* b_f,
                const void* w_b, const void* b_b, void* y, int B, int S, int C, int H, float zc,
                float zo, float forget_bias, void* stream) {
  return launch_bilstm<__nv_bfloat16>(xs, lengths, w_f, b_f, w_b, b_b, y, B, S, C, H, zc, zo,
                                      forget_bias, stream);
}

}  // extern "C"
