// Bidirectional GRU over a padded batch: the input projection over the whole card,
// then the recurrence of both directions as thread-block clusters.
//
// Replaces the Pallas kernel of self_attention_tacotron_tpu/ops/fused_rnn.py
// (bigru_pallas, _make_kernel). Per direction and step it computes, in this port's
// own code,
//
//   rz = sigmoid([x_t, io(h)] . Wg + bg)          r = rz[:H], z = rz[H:]
//   n  = tanh   ([x_t, io(r * h)] . Wc + bc)
//   h' = (1 - z) * n + z * h
//
// where io(.) rounds to the io type (float or bf16) before the product, the
// carry h stays float32, sums are float32, and y is stored in the io type. A step
// at or beyond a lane's length keeps the carry and emits zero; the backward
// direction walks S-1 -> 0, so its carry is still zero when it reaches the lane's
// last valid step.
//
// What bounds it on an H100: not operations or bytes (2 * sum(lengths) * 2 *
// (C + H) * 3H operations, a few megabytes) but the chain of S dependent steps, so
// the time is S times the latency of one step. The design cuts that latency:
//
// 1. The x half of both products does not depend on the carry. rnn_proj_kernel
//    (cluster_rnn.cuh, shared with bilstm.cu) computes it for every (lane, step,
//    direction) before the recurrence, biases folded in: proj = x . [Wg_x | Wc_x]
//    (both directions side by side, B*S rows of 6H float32 sums), a tiled FFMA
//    product over the whole card (128 x 128 tiles, 8 x 8 per thread).
// 2. bigru_cluster_kernel runs one thread-block cluster per (direction, group of
//    lanes) (cluster_rnn.cuh). The cluster's blocks share out the H units; each
//    loads its slice of the h rows of Wg and Wc once and keeps it in shared memory,
//    so no weight is read from global memory inside the step loop. A step: the gate
//    product on the block's r and z columns; io(r*h) of its units written into every
//    block of the cluster (distributed shared memory, counted on each block's
//    mbarrier); the candidate product once the block's mbarrier has every unit's
//    io(r*h), h' and the output; io(h') written into every block the same way. Two
//    exchanges a step, no grid barrier and no cluster-wide barrier inside the loop;
//    the next step's projection rows are copied in (cp.async) while the first
//    exchange is in flight. What is left of a step's time is the two products'
//    shared-memory traffic and dependent chains (PERF.md).
//
// The plan (lanes per cluster from B, cluster size from H, the shared memory) is
// cluster_rnn.cuh::rnn_plan, mirrored by ops/fused_rnn.py::bigru_plan.
//
// Plain C interface at the bottom: the functions launch on the given stream,
// allocate nothing, do not synchronise, and return cudaGetLastError() (or a
// negative code of cluster_rnn.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster_rnn.cuh"


namespace {

// The x rows (k < C) of the four weight matrices side by side: column n of
// [Wg_f | Wc_f | Wg_b | Wc_b], and the biases the same way (rnn_proj_kernel's weights:
// at(k, n), bias(n), columns(), aligned(bytes)).
template <typename T>
struct ProjWeights {
  const T *wg_f, *bg_f, *wc_f, *bc_f, *wg_b, *bg_b, *wc_b, *bc_b;
  int H;
  __host__ __device__ __forceinline__ int columns() const { return 6 * H; }
  // groups of bytes / sizeof(T) columns lie in one matrix, each matrix so aligned
  __host__ __device__ __forceinline__ bool aligned(int bytes) const {
    const uintptr_t any = reinterpret_cast<uintptr_t>(wg_f) | reinterpret_cast<uintptr_t>(wc_f) |
                          reinterpret_cast<uintptr_t>(wg_b) | reinterpret_cast<uintptr_t>(wc_b);
    return H % (bytes / (int)sizeof(T)) == 0 && (any & (bytes - 1)) == 0;
  }
  __device__ __forceinline__ const T* at(int k, int n) const {
    const int dir = n >= 3 * H;
    const int c = n - dir * 3 * H;
    return c < 2 * H ? (dir ? wg_b : wg_f) + (size_t)k * 2 * H + c
                     : (dir ? wc_b : wc_f) + (size_t)k * H + (c - 2 * H);
  }
  __device__ __forceinline__ float bias(int n) const {
    const int dir = n >= 3 * H;
    const int c = n - dir * 3 * H;
    if (c < 2 * H) return Io<T>::load((dir ? bg_b : bg_f) + c);
    return Io<T>::load((dir ? bc_b : bc_f) + (c - 2 * H));
  }
};

template <typename T, int LT>
__global__ void __launch_bounds__(RNN_THREADS, 1)
bigru_cluster_kernel(const float* __restrict__ proj,   // (B, S, 6H) from rnn_proj_kernel
                     const int* __restrict__ lengths,  // (B,)
                     const T* __restrict__ wg_f, const T* __restrict__ wc_f,
                     const T* __restrict__ wg_b, const T* __restrict__ wc_b,
                     T* __restrict__ y,                // (B, S, 2H)
                     int B, int S, int C, int H, RnnPlan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = plan.cluster;
  const int rank = (int)cg::this_cluster().block_rank();
  const int cid = blockIdx.x / cs;
  const int dir = cid & 1;
  const Share lane_share = share_of(B, plan.groups, 0, cid >> 1);
  const Share unit_share = share_of(H, cs, 0, rank);
  const int lane0 = lane_share.first, nl = lane_share.count;
  const int first = unit_share.first, u = unit_share.count;
  const int Lp = plan.lanes_padded;
  const RnnLayout lay = rnn_layout(H, plan.units_max, Lp, (int)sizeof(T), RNN_GRU);
  const int ws = lay.ws, u3 = 3 * u, H2 = 2 * H, k4 = r4(H) / 4;
  T* s_w = reinterpret_cast<T*>(smem);                         // [3u][ws]
  float* s_hin = reinterpret_cast<float*>(smem + lay.in1);     // [Lp][ws] io(h)
  float* s_rh = reinterpret_cast<float*>(smem + lay.in2);      // [Lp][ws] io(r * h)
  float* rows0 = reinterpret_cast<float*>(smem + lay.rows0);   // [Lp][3u] step rows, even
  float* rows1 = reinterpret_cast<float*>(smem + lay.rows1);   //          and odd steps
  float* s_h = reinterpret_cast<float*>(smem + lay.own);       // [Lp][u] the carry
  int* s_len = reinterpret_cast<int*>(smem + lay.len);         // [Lp]
  // the bytes of io(h) (from the second step on) and of io(r * h), from every block
  unsigned long long* bar_h = reinterpret_cast<unsigned long long*>(smem + lay.bars);
  unsigned long long* bar_rh = bar_h + 1;
  const int tid = threadIdx.x;
  const T* wg = dir ? wg_b : wg_f;
  const T* wc = dir ? wc_b : wc_f;

  for (int i = tid; i < Lp; i += RNN_THREADS) {
    int len = 0;
    if (i < nl) {
      len = lengths[lane0 + i];
      len = len < 0 ? 0 : (len > S ? S : len);
    }
    s_len[i] = len;
  }
  for (int i = tid; i < Lp * ws; i += RNN_THREADS) s_hin[i] = s_rh[i] = 0.0f;
  for (int i = tid; i < Lp * u3; i += RNN_THREADS) rows0[i] = rows1[i] = 0.0f;
  for (int i = tid; i < Lp * u; i += RNN_THREADS) s_h[i] = 0.0f;
  if (tid == 0) {
    mbar_init(bar_h);
    mbar_init(bar_rh);
  }
  // the block's columns of the h rows (C .. C+H-1): r, z, candidate; k contiguous,
  // zero from H to the padded width
  for (int i = tid; i < r4(H) * u3; i += RNN_THREADS) {
    const int k = i / u3;
    const int c = i - k * u3;
    T v = Io<T>::from(0.0f);
    if (k < H) {
      const size_t row = (size_t)(C + k);
      if (c < u) v = wg[row * H2 + first + c];
      else if (c < 2 * u) v = wg[row * H2 + H + first + c - u];
      else v = wc[row * H + first + c - 2 * u];
    }
    s_w[(size_t)c * ws + k] = v;
  }
  __syncthreads();
  int max_len = 0;
  for (int l = 0; l < nl; ++l) max_len = imax(max_len, s_len[l]);
  // zero the padded tail of the block's units of this direction's half of y
  for (int l = 0; l < nl; ++l) {
    const int len = s_len[l];
    for (int i = tid; i < (S - len) * u; i += RNN_THREADS) {
      const int t = len + i / u;
      const int j = i % u;
      y[((size_t)(lane0 + l) * S + t) * H2 + dir * H + first + j] = Io<T>::from(0.0f);
    }
  }

  Moves mv;
  mv.init(H, first, u, 3, Lp);
  ProductWalk gates, cand;
  gates.init(2 * u, k4, Lp / LT);
  cand.init(u, k4, Lp / LT);
  auto fetch = [&](int t, float* dst) {
    fetch_rows(mv, dst, nl, u, [&](int l, int s) {
      return proj + ((size_t)(lane0 + l) * S + t) * 6 * H + dir * 3 * H + s * H + first;
    }, [&](int l) { return t < s_len[l]; });
  };
  // every block receives 4 * Lp * H bytes of each gathered vector a step
  const unsigned bytes = 4u * Lp * H;
  if (tid == 0 && max_len > 0) mbar_expect(bar_rh, bytes);
  if (tid == 0 && max_len > 1) mbar_expect(bar_h, bytes);
  if (max_len > 0) fetch(dir ? max_len - 1 : 0, rows0);
  copies_wait();
  // every block started, its mbarriers armed; zeroed inputs and the first rows in place
  cluster_barrier();

  for (int step = 0; step < max_len; ++step) {
    const int t = dir ? max_len - 1 - step : step;
    float* rows = (step & 1) ? rows1 : rows0;
    if (step > 0) {
      // io(h) of every unit, from the step before (the first step's is zero)
      bar_wait(bar_h, (step - 1) & 1);
      if (tid == 0 && step + 1 < max_len) mbar_expect(bar_h, bytes);
    }

    // r and z of the block's units; io(r * h) replaces r's projection
    cluster_product<LT, T>(gates, s_w, ws, s_hin, ws, k4, [&](int tile, int col, int i, float acc) {
      const int l = tile * LT + i;
      float* pr = rows + l * u3;
      const float g = sigmoidf_(acc + pr[col]);
      pr[col] = col < u ? Io<T>::round(g * s_h[l * u + col]) : g;
    });
    // every thread of the block is past its reads of io(h) before any block may
    // write the next step's
    __syncthreads();
    push_to_cluster(mv, cs, rows, u3, u, s_rh, ws, first, bar_rh);
    // the next step's rows, while the other blocks' io(r * h) arrives
    if (step + 1 < max_len) fetch(dir ? t - 1 : t + 1, (step & 1) ? rows0 : rows1);
    bar_wait(bar_rh, step & 1);
    if (tid == 0 && step + 1 < max_len) mbar_expect(bar_rh, bytes);

    // n, h' and the output; io(h') replaces n's projection
    cluster_product<LT, T>(cand, s_w + (size_t)2 * u * ws, ws, s_rh, ws, k4,
                           [&](int tile, int j, int i, float acc) {
      const int l = tile * LT + i;
      float* pr = rows + l * u3;
      float h = s_h[l * u + j];
      if (t < s_len[l]) {
        const float n = tanhf(acc + pr[2 * u + j]);
        const float z = pr[u + j];
        h = (1.0f - z) * n + z * h;
        s_h[l * u + j] = h;
        y[((size_t)(lane0 + l) * S + t) * H2 + dir * H + first + j] = Io<T>::from(h);
      }
      pr[2 * u + j] = Io<T>::round(h);
    });
    // past the reads of io(r * h), and the carry and the staged io(h') in place
    __syncthreads();
    if (step + 1 < max_len) push_to_cluster(mv, cs, rows + 2 * u, u3, u, s_hin, ws, first, bar_h);
    copies_wait();
    __syncthreads();
  }
  // no block leaves while its stores into other blocks may be in flight
  cluster_barrier();
}

template <typename T>
int plan_of(int B, int H, RnnPlan* plan, int* n_sms) {
  return rnn_device_plan(bigru_cluster_kernel<T, 4>, B, H, (int)sizeof(T), RNN_GRU, plan, n_sms);
}

template <typename T>
int launch_proj(const void* xs, const void* wg_f, const void* bg_f, const void* wc_f,
                const void* bc_f, const void* wg_b, const void* bg_b, const void* wc_b,
                const void* bc_b, const void* lengths, void* proj, int B, int S, int C, int H,
                void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  ProjWeights<T> w{(const T*)wg_f, (const T*)bg_f, (const T*)wc_f, (const T*)bc_f,
                   (const T*)wg_b, (const T*)bg_b, (const T*)wc_b, (const T*)bc_b, H};
  return rnn_proj_launch((const T*)xs, w, (float*)proj, B, S, C, (const int*)lengths, stream);
}

template <typename T>
int launch_bigru(const void* proj, const void* lengths, const void* wg_f, const void* wc_f,
                 const void* wg_b, const void* wc_b, void* y, int B, int S, int C, int H,
                 void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  RnnPlan p;
  int n_sms = 0;
  const int code = plan_of<T>(B, H, &p, &n_sms);
  if (code != 0) return code;
  auto* kernel = p.lane_tile == 1 ? bigru_cluster_kernel<T, 1> : bigru_cluster_kernel<T, 4>;
  return (int)rnn_launch(kernel, p, stream, (const float*)proj, (const int*)lengths,
                         (const T*)wg_f, (const T*)wc_f, (const T*)wg_b, (const T*)wc_b, (T*)y, B,
                         S, C, H);
}

}  // namespace

extern "C" {

// The x half of both directions' products, biases folded in: proj (B*S, 6H) float32
// (rows of padded steps are left unwritten: the recurrence reads valid steps alone).
int bigru_proj_f32(const void* xs, const void* wg_f, const void* bg_f, const void* wc_f,
                   const void* bc_f, const void* wg_b, const void* bg_b, const void* wc_b,
                   const void* bc_b, const void* lengths, void* proj, int B, int S, int C, int H,
                   void* stream) {
  return launch_proj<float>(xs, wg_f, bg_f, wc_f, bc_f, wg_b, bg_b, wc_b, bc_b, lengths, proj, B,
                            S, C, H, stream);
}

int bigru_proj_bf16(const void* xs, const void* wg_f, const void* bg_f, const void* wc_f,
                    const void* bc_f, const void* wg_b, const void* bg_b, const void* wc_b,
                    const void* bc_b, const void* lengths, void* proj, int B, int S, int C, int H,
                    void* stream) {
  return launch_proj<__nv_bfloat16>(xs, wg_f, bg_f, wc_f, bc_f, wg_b, bg_b, wc_b, bc_b, lengths,
                                    proj, B, S, C, H, stream);
}

// The recurrence of both directions over proj: y (B, S, 2H) in the io type.
int bigru_f32(const void* proj, const void* lengths, const void* wg_f, const void* wc_f,
              const void* wg_b, const void* wc_b, void* y, int B, int S, int C, int H,
              void* stream) {
  return launch_bigru<float>(proj, lengths, wg_f, wc_f, wg_b, wc_b, y, B, S, C, H, stream);
}

int bigru_bf16(const void* proj, const void* lengths, const void* wg_f, const void* wc_f,
               const void* wg_b, const void* wc_b, void* y, int B, int S, int C, int H,
               void* stream) {
  return launch_bigru<__nv_bfloat16>(proj, lengths, wg_f, wc_f, wg_b, wc_b, y, B, S, C, H,
                                     stream);
}

// The plan the recurrence launches with on the current device (rnn_plan_fields).
int bigru_plan_query(int B, int H, int bf16, long long* out) {
  RnnPlan p;
  int n_sms = 0;
  const int code = bf16 ? plan_of<__nv_bfloat16>(B, H, &p, &n_sms) : plan_of<float>(B, H, &p, &n_sms);
  if (code == 0) rnn_plan_fields(p, n_sms, out);
  return code;
}

}  // extern "C"
