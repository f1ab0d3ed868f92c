// The adjoint-carry recursion of the bidirectional GRU's backward, both
// directions in one launch.
//
// Replaces the Pallas kernel of self_attention_tacotron_tpu/ops/fused_rnn.py
// (_bigru_bwd, _make_bwd_carry_kernel). Everything that is parallel over time is
// outside: the wrapper recomputes the gates rz, the candidate n and the carries
// h_prev of every step from the forward's outputs, and forms the weight
// gradients and d_x from this kernel's outputs as batched products. What is left
// is serial. With g the cotangent of the carry, per direction and step t (the
// forward direction walks t = len-1 .. 0, the backward direction 0 .. len-1):
//
//   g_h   = g + g_y[t]                       (a padded step passes g through)
//   g_z   = g_h * (h_prev - n)     g_n = g_h * (1 - z)     g_ac = g_n * (1 - n^2)
//   g_rh  = g_ac . Wc_h^T                    (H x H, the candidate's h rows)
//   g_ag  = [g_rh * h_prev, g_z] * rz * (1 - rz)
//   g     = g_h * z + g_rh * r + g_ag . Wg_h^T        (2H x H, the gates' h rows)
//
// and g_ag (2H) and g_ac (H) of every step are the outputs. Rows at and beyond a
// lane's length stay as the wrapper zeroed them.
//
// The bound is the serial chain, as in bigru.cu, and the layout is the same: grid
// (ceil(B / LANES), 2 directions); a block owns LANES lanes of one direction,
// keeps their carries' cotangents in shared memory, walks to the longest length
// among its lanes, and splits each product's reduction over `parts` threads per
// column, adding the partial sums in shared memory. The transposed weights are
// read through L2 at every step, each read serving LANES lanes.
//
// Plain C interface at the bottom: the function launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 4;
constexpr int MAX_THREADS = 1024;

// s_part[(p * LANES + l) * H + j] = sum over the p-th slice of k of s_in[l * K + k] * w[k * H + j]
__device__ __forceinline__ void partial_products(const float* __restrict__ w, int H, int K,
                                                 const float* s_in, float* s_part, int parts,
                                                 int tid, int nt) {
  const int chunk = (K + parts - 1) / parts;
  for (int idx = tid; idx < parts * H; idx += nt) {
    const int p = idx / H;
    const int j = idx - p * H;
    const int k0 = p * chunk;
    const int k1 = (k0 + chunk) < K ? (k0 + chunk) : K;
    float acc[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l) acc[l] = 0.0f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const float wv = __ldg(w + (size_t)k * H + j);
#pragma unroll
      for (int l = 0; l < LANES; ++l) acc[l] = fmaf(s_in[l * K + k], wv, acc[l]);
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l) s_part[(p * LANES + l) * H + j] = acc[l];
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
bigru_bwd_kernel(const float* __restrict__ g_y,     // (B, S, 2H) forward half, backward half
                 const float* __restrict__ rz,      // (2, B, S, 2H)
                 const float* __restrict__ n,       // (2, B, S, H)
                 const float* __restrict__ hp,      // (2, B, S, H)
                 const int* __restrict__ lengths,   // (B,)
                 const float* __restrict__ wgh_t,   // (2, 2H, H)
                 const float* __restrict__ wch_t,   // (2, H, H)
                 float* __restrict__ g_ag,          // (2, B, S, 2H), zero on entry
                 float* __restrict__ g_ac,          // (2, B, S, H), zero on entry
                 int B, int S, int H) {
  extern __shared__ float smem[];
  const int H2 = 2 * H;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* s_g = smem;                    // LANES * H    cotangent of the carry
  float* s_gh = s_g + LANES * H;        // LANES * H    g_h of this step
  float* s_gac = s_gh + LANES * H;      // LANES * H
  float* s_grh = s_gac + LANES * H;     // LANES * H
  float* s_gag = s_grh + LANES * H;     // LANES * 2H
  float* s_part = s_gag + LANES * H2;   // LANES * max(nt, H) partial sums
  __shared__ int s_len[LANES];

  const int dir = blockIdx.y;
  const int lane0 = blockIdx.x * LANES;
  const float* wg = wgh_t + (size_t)dir * H2 * H;
  const float* wc = wch_t + (size_t)dir * H * H;
  const int parts = nt / H > 0 ? nt / H : 1;   // threads per column of a product

  if (tid < LANES) {
    const int b = lane0 + tid;
    int len = 0;
    if (b < B) {
      len = lengths[b];
      len = len < 0 ? 0 : (len > S ? S : len);
    }
    s_len[tid] = len;
  }
  for (int i = tid; i < LANES * H; i += nt) s_g[i] = 0.0f;
  __syncthreads();

  int max_len = 0;
#pragma unroll
  for (int l = 0; l < LANES; ++l) max_len = s_len[l] > max_len ? s_len[l] : max_len;

  for (int step = 0; step < max_len; ++step) {
    const int t = dir == 0 ? max_len - 1 - step : step;

    // 1. g_h, g_ac
    for (int i = tid; i < LANES * H; i += nt) {
      const int l = i / H;
      const int j = i - l * H;
      float g_h = 0.0f, g_ac = 0.0f;
      if (t < s_len[l]) {
        const size_t row = ((size_t)dir * B + lane0 + l) * S + t;
        const float nv = n[row * H + j];
        const float z = rz[row * H2 + H + j];
        g_h = s_g[i] + g_y[((size_t)(lane0 + l) * S + t) * H2 + dir * H + j];
        g_ac = g_h * (1.0f - z) * (1.0f - nv * nv);
      }
      s_gh[i] = g_h;
      s_gac[i] = g_ac;
    }
    __syncthreads();

    // 2. g_rh = g_ac . Wc_h^T
    partial_products(wc, H, H, s_gac, s_part, parts, tid, nt);
    __syncthreads();

    // 3. g_ag = [g_rh * h_prev, g_z] * rz * (1 - rz); outputs of this step
    for (int i = tid; i < LANES * H; i += nt) {
      const int l = i / H;
      const int j = i - l * H;
      float g_rh = 0.0f;
      for (int p = 0; p < parts; ++p) g_rh += s_part[(p * LANES + l) * H + j];
      s_grh[i] = g_rh;
      float g_ar = 0.0f, g_az = 0.0f;
      if (t < s_len[l]) {
        const size_t row = ((size_t)dir * B + lane0 + l) * S + t;
        const float r = rz[row * H2 + j];
        const float z = rz[row * H2 + H + j];
        const float h_prev = hp[row * H + j];
        const float g_h = s_gh[i];
        g_ar = g_rh * h_prev * r * (1.0f - r);
        g_az = g_h * (h_prev - n[row * H + j]) * z * (1.0f - z);
        g_ag[row * H2 + j] = g_ar;
        g_ag[row * H2 + H + j] = g_az;
        g_ac[row * H + j] = s_gac[i];
      }
      s_gag[l * H2 + j] = g_ar;
      s_gag[l * H2 + H + j] = g_az;
    }
    __syncthreads();

    // 4. g = g_h * z + g_rh * r + g_ag . Wg_h^T; a padded step keeps g
    partial_products(wg, H, H2, s_gag, s_part, parts, tid, nt);
    __syncthreads();
    for (int i = tid; i < LANES * H; i += nt) {
      const int l = i / H;
      const int j = i - l * H;
      if (t < s_len[l]) {
        const size_t row = ((size_t)dir * B + lane0 + l) * S + t;
        float acc = 0.0f;
        for (int p = 0; p < parts; ++p) acc += s_part[(p * LANES + l) * H + j];
        s_g[i] = s_gh[i] * rz[row * H2 + H + j] + s_grh[i] * rz[row * H2 + j] + acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int bigru_bwd_f32(const void* g_y, const void* rz, const void* n, const void* hp,
                  const void* lengths, const void* wgh_t, const void* wch_t, void* g_ag,
                  void* g_ac, int B, int S, int H, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  int threads = ((4 * H + 31) / 32) * 32;   // four threads per column
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const int part_cols = threads > H ? threads : H;
  const size_t smem = sizeof(float) * (size_t)LANES * (6 * H + part_cols);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bigru_bwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((B + LANES - 1) / LANES, 2);
  bigru_bwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)g_y, (const float*)rz, (const float*)n, (const float*)hp,
      (const int*)lengths, (const float*)wgh_t, (const float*)wch_t, (float*)g_ag, (float*)g_ac,
      B, S, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
