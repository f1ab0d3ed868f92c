// The thread-block-cluster design of the recurrent kernels (bigru.cu, bigru_bwd.cu,
// bilstm.cu): the plan each computes for itself (mirrored by ops/fused_rnn.py::rnn_plan),
// the input projection of the forward kernels, the exchanges between a cluster's
// blocks, the asynchronous row copies, and the small product every GRU step runs
// against a block's resident weight slice.
//
// One cluster of CLUSTER blocks runs one direction for one group of lanes. The
// cluster's blocks share out the H units (share_of, whole units, so that a unit's
// gate and candidate columns lie on one block); each block holds its slice of the
// recurrent weights in shared memory for the whole loop, and every step's vector
// that all units need (io(h), io(r*h) forward; io(g_ac), io(g_ag) backward; io(h)
// in the LSTM) is written by each block into every block of its cluster (distributed
// shared memory, st.async), where an mbarrier counts its bytes: a block waits for the
// bytes of the vector it needs, not for the other blocks to reach a barrier. Each
// block has an SM of its own: the launch asks for the device's whole opt-in shared
// memory, so that the clusters of a wave spread over the card. The plan, the layout
// and the card query take the kernel's kind (RNN_GRU, RNN_GRU_BWD, RNN_LSTM).
//
// Why two exchanges a step are safe with one copy of each gathered vector (the GRU
// kernels): a block writes step t+1's vector into another block only after it has
// that block's part of a vector which that block sends after a __syncthreads that
// follows its last read of step t's copy; and an mbarrier's next phase cannot
// complete before every thread of the block has waited on the current one, because
// it needs the block's own part, sent after such a __syncthreads.
//
// Why one exchange a step needs two copies (the LSTM, whose step gathers io(h)
// alone): with one copy, a block that has every part of io(h_t) would write
// io(h_{t+1}) into a block that may still be reading io(h_t). So io(h) has two
// copies, chosen by the parity of the step, each counted on an mbarrier of its own:
// step t reads copy t & 1 and writes copy (t + 1) & 1. A block writes io(h_{t+1})
// only after it holds every block's part of io(h_t), and each block sends that part
// after a __syncthreads that follows its last read of io(h_{t-1}), the copy that
// io(h_{t+1}) overwrites. A copy's mbarrier completes a phase every other step; its
// next phase needs the block's own part of io(h_{t+1}), sent after the __syncthreads
// that follows every thread's wait on the current phase, so no thread can miss one.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "dense.cuh"
#include "grid.cuh"
#include "tensor.cuh"

namespace cg = cooperative_groups;

constexpr int RNN_THREADS = 256;
// The opt-in shared memory of one block on an H100 (the plan's limit; the kernels
// read the device's own).
constexpr int RNN_SMEM_LIMIT = 232448;
// A launch that finds no cluster of the plan's size resident on the card.
constexpr int RNN_NO_CLUSTER = -2;
// A width whose resident slice does not fit a block of a cluster of 16.
constexpr int RNN_TOO_WIDE = -3;
// What a cluster kernel computes, for its plan and layout.
enum RnnKind { RNN_GRU = 0, RNN_GRU_BWD = 1, RNN_LSTM = 2 };

__host__ __device__ inline long long r16ll(long long n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Byte offsets of a block's shared memory. GRU forward: weights [3u][ws] (r, z and
// candidate columns, k contiguous, io type), io(h) [Lp][ws], io(r*h) [Lp][ws], two
// buffers of projection rows [Lp][3u], the float carry [Lp][u], the lengths [Lp].
// GRU backward: weights [u][ws] (Wc_h^T's columns) and [u][ws2] (Wg_h^T's), io(g_ac)
// [Lp][ws], io(g_ag) [Lp][ws2], two buffers of rows [Lp][5u] (r, z, n, h_prev, g_y),
// g, g_h, g_rh [Lp][u] each, the g_ag staging [Lp][2u], the lengths. LSTM: weights
// [4u][wsl] (i, g, f, o columns; wsl: H rounded up to 32 values in float, 64 in
// bfloat16, each row's groups of four swizzled as bilstm.cu says), the two copies of
// io(h) [Lp][ws] each, two buffers of projection rows [Lp][4u], the float carries c
// and h and the io(h') to send [Lp][u] each, the lengths. All end with two mbarriers (8 bytes each,
// 8-aligned), one per gathered input (the LSTM: one per copy). ws = r4(H) + 4 and ws2
// = r4(2H) + 4 (four values of padding keep the threads of a warp, one column each, on
// different banks); u is the largest share of units.
struct RnnLayout {
  int ws, ws2, wsl;
  long long in1, in2, rows0, rows1, own, len, bars, total;
};

__host__ __device__ inline RnnLayout rnn_layout(int H, int u, int Lp, int io_bytes, int kind) {
  RnnLayout s;
  s.ws = r4(H) + 4;
  s.ws2 = r4(2 * H) + 4;
  s.wsl = io_bytes == 2 ? (H + 63) / 64 * 64 : (H + 31) / 32 * 32;
  const long long L = Lp;
  if (kind == RNN_GRU) {
    s.in1 = r16ll(3LL * u * s.ws * io_bytes);
    s.in2 = s.in1 + 4 * L * s.ws;
    s.rows0 = s.in2 + 4 * L * s.ws;
    s.rows1 = s.rows0 + 4 * L * 3 * u;
    s.own = s.rows1 + 4 * L * 3 * u;
    s.len = s.own + 4 * L * u;
  } else if (kind == RNN_GRU_BWD) {
    s.in1 = r16ll((long long)u * (s.ws + s.ws2) * io_bytes);
    s.in2 = s.in1 + 4 * L * s.ws;
    s.rows0 = s.in2 + 4 * L * s.ws2;
    s.rows1 = s.rows0 + 4 * L * 5 * u;
    s.own = s.rows1 + 4 * L * 5 * u;
    s.len = s.own + 4 * L * 5 * u;
  } else {
    s.in1 = r16ll(4LL * u * s.wsl * io_bytes);
    s.in2 = s.in1 + 4 * L * s.ws;
    s.rows0 = s.in2 + 4 * L * s.ws;
    s.rows1 = s.rows0 + 4 * L * 4 * u;
    s.own = s.rows1 + 4 * L * 4 * u;
    s.len = s.own + 4 * L * 3 * u;
  }
  s.bars = (s.len + 4 * L + 7) / 8 * 8;
  s.total = s.bars + 16;
  return s;
}

// The most lanes one block's room holds at cluster size cs (a multiple of 4, the
// product's lane tile, or 1); 0 where not one lane fits.
inline int rnn_max_lanes(int H, int cs, int io_bytes, int kind, long long limit) {
  const int u = cdiv(H, cs);
  const long long a = rnn_layout(H, u, 0, io_bytes, kind).total;
  const long long b = rnn_layout(H, u, 1, io_bytes, kind).total - a;
  if (limit < a + b) return 0;
  const long long fit = (limit - a) / b;
  return fit >= 4 ? (int)(fit / 4 * 4) : 1;
}

// The portable cluster of 8 where one lane fits it, else 16; 0 where neither does.
inline int rnn_cluster_size(int H, int io_bytes, int kind, long long limit) {
  if (rnn_max_lanes(H, 8, io_bytes, kind, limit) > 0) return 8;
  if (rnn_max_lanes(H, 16, io_bytes, kind, limit) > 0) return 16;
  return 0;
}

struct RnnPlan {
  int cluster;        // blocks per cluster
  int units_max;      // units of the largest share
  int max_lanes;      // lanes one block's room holds
  int slots;          // clusters resident at once (one block per SM)
  int groups;         // lane groups per direction: clusters = 2 * groups
  int lanes;          // lanes of the largest group
  int lane_tile;      // lanes per thread in the products: 1 for one lane, else 4
  int lanes_padded;   // lanes rounded up to the tile
  int clusters;
  int waves;          // ceil(clusters / slots): the least the room and the card allow
  int threads;
  long long smem_bytes;
  long long smem_limit;
};

// As few waves as the room per block allows, and within them as many lane groups as
// there are clusters to run them (the lanes spread over the card), both directions.
inline RnnPlan rnn_plan(int B, int H, int io_bytes, int kind, int cs, int slots,
                        long long limit) {
  RnnPlan p;
  p.cluster = cs;
  p.units_max = cdiv(H, cs);
  p.max_lanes = rnn_max_lanes(H, cs, io_bytes, kind, limit);
  p.slots = slots;
  const int need = cdiv(B, p.max_lanes);
  p.waves = imax(1, cdiv(2 * need, slots));
  p.groups = imin(B, imax(1, p.waves * slots / 2));
  p.lanes = cdiv(B, p.groups);
  p.lane_tile = p.lanes == 1 ? 1 : 4;
  p.lanes_padded = cdiv(p.lanes, p.lane_tile) * p.lane_tile;
  p.clusters = 2 * p.groups;
  p.threads = RNN_THREADS;
  p.smem_bytes = rnn_layout(H, p.units_max, p.lanes_padded, io_bytes, kind).total;
  p.smem_limit = limit;
  return p;
}

// What the C interface's query functions write, in this order (the fields of
// ops/fused_rnn.py::RnnPlan).
inline void rnn_plan_fields(const RnnPlan& p, int n_sms, long long* out) {
  const long long v[] = {p.cluster, p.units_max, p.max_lanes, p.slots, p.groups, p.lanes,
                         p.lane_tile, p.lanes_padded, p.clusters, p.waves, p.threads,
                         p.smem_bytes, p.smem_limit, n_sms};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
}

// The launch configuration of a cluster kernel: `clusters` clusters of `cs` blocks,
// each block with `smem` bytes of dynamic shared memory (the whole opt-in shared
// memory: one block per SM). Built in place: the configuration points at its own
// attribute.
struct RnnLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  RnnLaunch(int cs, int clusters, long long smem, void* stream) : cfg{} {
    cfg.gridDim = dim3(cs * clusters, 1, 1);
    cfg.blockDim = dim3(RNN_THREADS, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  RnnLaunch(const RnnLaunch&) = delete;
};

// What a kernel's plan reads from the card, kept per (kernel, device): the SM count,
// the opt-in shared memory of a block, and the clusters of 8 and of 16 blocks resident
// at once (-1 until a plan first asks). The kernel's attributes (that whole shared
// memory, clusters of 16 allowed) are set once, at its first use on the device.
struct RnnCard {
  const void* kernel;
  int dev, n_sms, limit;
  int slots[2];
};

struct RnnCards {
  std::mutex mutex;
  std::vector<RnnCard> list;
};

inline RnnCards& rnn_cards() {
  static RnnCards cards;
  return cards;
}

// The card's numbers for `kernel` on the current device; with cs > 0, also the
// clusters of cs blocks resident at once. Returns 0 or a CUDA error.
template <typename Kernel>
int rnn_card(Kernel kernel, int cs, RnnCard* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  RnnCards& cards = rnn_cards();
  std::lock_guard<std::mutex> lock(cards.mutex);
  RnnCard* card = nullptr;
  for (RnnCard& c : cards.list)
    if (c.kernel == (const void*)kernel && c.dev == dev) card = &c;
  if (card == nullptr) {
    RnnCard c{(const void*)kernel, dev, 0, 0, {-1, -1}};
    err = cudaDeviceGetAttribute(&c.n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.limit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cards.list.push_back(c);
    card = &cards.list.back();
  }
  if (cs > 0 && card->slots[cs > 8] < 0) {
    RnnLaunch l(cs, 1, card->limit, nullptr);
    int slots = 0;
    err = cudaOccupancyMaxActiveClusters(&slots, kernel, &l.cfg);
    if (err != cudaSuccess) return (int)err;
    card->slots[cs > 8] = slots;
  }
  *out = *card;
  return 0;
}

// Launch one instantiation of a cluster kernel with the plan, which is the kernel's
// last argument.
template <typename... Params, typename... Args>
cudaError_t rnn_launch(void (*kernel)(Params...), const RnnPlan& p, void* stream, Args... args) {
  RnnCard card;
  const int code = rnn_card(kernel, 0, &card);
  if (code != 0) return (cudaError_t)code;
  RnnLaunch l(p.cluster, p.clusters, p.smem_limit, stream);
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, kernel, args..., p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The device's plan for a kernel (any of its lane-tile instantiations: all ask for
// the same shared memory and threads): the cluster size from the width, the resident
// clusters from the card, the rest from rnn_plan. Returns 0, a CUDA error,
// RNN_TOO_WIDE or RNN_NO_CLUSTER.
template <typename Kernel>
int rnn_device_plan(Kernel kernel, int B, int H, int io_bytes, int kind, RnnPlan* plan,
                    int* n_sms) {
  RnnCard card;
  int code = rnn_card(kernel, 0, &card);
  if (code != 0) return code;
  const int cs = rnn_cluster_size(H, io_bytes, kind, card.limit);
  if (cs == 0) return RNN_TOO_WIDE;
  code = rnn_card(kernel, cs, &card);
  if (code != 0) return code;
  const int slots = card.slots[cs > 8];
  if (slots < 1) return RNN_NO_CLUSTER;
  *n_sms = card.n_sms;
  *plan = rnn_plan(B, H, io_bytes, kind, cs, slots, card.limit);
  return 0;
}

// ----------------------------------------------------------------------------- //
// The input projection of the forward kernels
// ----------------------------------------------------------------------------- //

// The x half of every step's products does not depend on the carry: one tiled FFMA
// product over the whole card computes it for every (lane, step, direction) before the
// recurrence, biases folded in, into a float32 scratch of B*S rows the wrapper
// allocates (128 x 128 tiles, 8 x 8 outputs a thread, k in steps of 8 double-buffered
// through shared memory).
constexpr int PROJ_BM = 128;
constexpr int PROJ_BN = 128;
constexpr int PROJ_BK = 8;

// proj[m][n] = sum over k < C of xs[m][k] * W[k][n] + b[n], m < M = B*S, n < N, where
// W's columns and biases are the weights type's (bigru.cu: the four GRU matrices, 6H
// columns; bilstm.cu: the two LSTM matrices, 8H): w.at(k, n) points at W[k][n],
// w.bias(n), w.columns(), and w.aligned(bytes) says whether every group of bytes /
// sizeof(T) columns lies in one matrix, aligned to `bytes`.
// Where C is a multiple of 4 too, a thread loads its four k of x and its four columns
// of W as one vector each and stores four sums as one (a 32-byte sector a store, not
// a quarter of one); otherwise value by value. Row m is step m % S of lane m / S; rows
// of padded steps (at or beyond the lane's length) are not written, since no
// recurrence reads them (fetch_rows takes the rows of valid steps alone), and a warp
// whose 16 rows are all padded skips the multiply-adds.
template <typename T, typename W>
__global__ void __launch_bounds__(256, 2)
rnn_proj_kernel(const T* __restrict__ xs, W w, float* __restrict__ proj, int M, int C,
                const int* __restrict__ lengths, int S) {
  using Vec = typename Weights4<T>::Vec;
  __shared__ __align__(16) float As[2][PROJ_BK][PROJ_BM];
  __shared__ __align__(16) float Bs[2][PROJ_BK][PROJ_BN];
  const int N = w.columns();
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * PROJ_BM, n0 = blockIdx.x * PROJ_BN;
  const int tx = tid & 15, ty = tid >> 4;
  const int am = tid >> 1, ak = (tid & 1) * 4;     // A: one row, four k
  const int bk = tid >> 5, bn = (tid & 31) * 4;    // B: one k, four columns
  const bool vec = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(xs) & 15) == 0 &&
                   w.aligned(4 * (int)sizeof(T));
  // the thread's rows are m0 + ty * 8 + (0..7), bit i of `valid` where row i is a valid
  // step; the warp's 16 rows need the product where one of them is
  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m < M) {
      const int b = m / S;
      valid |= (m - b * S < lengths[b] ? 1u : 0u) << i;
    }
  }
  const bool live = __any_sync(0xffffffffu, valid != 0);
  float a_reg[4], b_reg[4];
  auto load = [&](int k0) {
    const int m = m0 + am;
    const int k = k0 + bk;
    if (vec) {   // k0 + ak .. + 3 all below C or none; the same for n0 + bn .. + 3 and N
      const float4 a = (m < M && k0 + ak < C)
          ? Weights4<T>::values(__ldg(reinterpret_cast<const Vec*>(xs + (size_t)m * C + k0 + ak)))
          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b = (n0 + bn < N && k < C)
          ? Weights4<T>::values(__ldg(reinterpret_cast<const Vec*>(w.at(k, n0 + bn))))
          : make_float4(0.f, 0.f, 0.f, 0.f);
      a_reg[0] = a.x, a_reg[1] = a.y, a_reg[2] = a.z, a_reg[3] = a.w;
      b_reg[0] = b.x, b_reg[1] = b.y, b_reg[2] = b.z, b_reg[3] = b.w;
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + ak + i;
      a_reg[i] = (m < M && kk < C) ? Io<T>::load(xs + (size_t)m * C + kk) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + bn + i;
      b_reg[i] = (n < N && k < C) ? Io<T>::load(w.at(k, n)) : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][ak + i][am] = a_reg[i];
    *reinterpret_cast<float4*>(&Bs[buf][bk][bn]) = make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int nk = (C + PROJ_BK - 1) / PROJ_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * PROJ_BK);
    if (live) {
#pragma unroll
    for (int k = 0; k < PROJ_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
  // the thread's columns: tx * 4 + (0..3) and 64 + tx * 4 + (0..3) of the tile
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    bias[j] = n < N ? w.bias(n) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (!(valid >> i & 1u)) continue;   // past M, or a padded step: never read
    float* row = proj + (size_t)m * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + tx * 4;
      if (vec) {
        if (n < N)
          *reinterpret_cast<float4*>(row + n) =
              make_float4(acc[i][4 * h] + bias[4 * h], acc[i][4 * h + 1] + bias[4 * h + 1],
                          acc[i][4 * h + 2] + bias[4 * h + 2], acc[i][4 * h + 3] + bias[4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) row[n + e] = acc[i][4 * h + e] + bias[4 * h + e];
      }
    }
  }
}

// The same product for bfloat16 io on the tensor cores (mma.sync m16n8k16, bf16 x bf16
// -> f32: the rounding of the FFMA product, in another order): 128 x 128 tiles, k in
// steps of 32 double-buffered by cp.async, a warp 64 rows x 32 columns. Needs C and
// the column groups of eight in whole 16-byte pieces (w.aligned(16)).
constexpr int PROJ_MMA_BK = 32;

template <typename W>
__global__ void __launch_bounds__(256, 2)
rnn_proj_mma_kernel(const __nv_bfloat16* __restrict__ xs, W w, float* __restrict__ proj, int M,
                    int C, const int* __restrict__ lengths, int S) {
  constexpr int BK = PROJ_MMA_BK, AS = BK + 8, BS = PROJ_BN + 8;   // rows of 80 and 272 bytes
  __shared__ __align__(16) __nv_bfloat16 As[2][PROJ_BM][AS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK][BS];
  const int N = w.columns();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * PROJ_BM, n0 = blockIdx.x * PROJ_BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // the warp's rows and columns
  // a row of a valid step (rows of padded steps are neither computed by a warp whose
  // 64 rows are all padded, nor written)
  auto valid_row = [&](int m) {
    if (m >= M) return false;
    const int b = m / S;
    return m - b * S < lengths[b];
  };
  bool valid = false;
  for (int i = lane; i < 64; i += 32) valid |= valid_row(m0 + wm + i);
  const bool live = __any_sync(0xffffffffu, valid);
  auto load = [&](int buf, int k0) {
    for (int i = tid; i < PROJ_BM * (BK / 8); i += 256) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      const bool in = m < M && k < C;
      cp_async16(&As[buf][r][c], in ? xs + (size_t)m * C + k : xs, in);
    }
    for (int i = tid; i < BK * (PROJ_BN / 8); i += 256) {
      const int r = i / (PROJ_BN / 8), c = (i % (PROJ_BN / 8)) * 8;
      const int k = k0 + r, n = n0 + c;
      const bool in = k < C && n < N;
      cp_async16(&Bs[buf][r][c], in ? w.at(k, n) : xs, in);
    }
    cp_async_commit();
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int nk = (C + BK - 1) / BK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load(buf ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        unsigned a[4][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldsm_x4(a[mt], &As[buf][wm + 16 * mt + (lane & 15)][ks + (lane >> 4) * 8]);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm_x4_trans(b[np], &Bs[buf][ks + (lane & 7) + ((lane >> 3) & 1) * 8][wn + 16 * np + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma_bf16(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
          }
      }
    }
    __syncthreads();   // the tile is read before the next load overwrites it
  }
  // the thread's 8 rows: bit 2 mt + h for row wm + 16 mt + lane / 4 + 8 h
  unsigned rows = 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rows |= (valid_row(m0 + wm + 16 * mt + (lane >> 2) + 8 * h) ? 1u : 0u) << (2 * mt + h);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn + 8 * nt + 2 * (lane & 3);
    if (n >= N) continue;   // N is a multiple of 8: n + 1 < N too
    const float b0 = w.bias(n), b1 = w.bias(n + 1);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * mt + (lane >> 2) + 8 * h;
        if (rows >> (2 * mt + h) & 1u)
          *reinterpret_cast<float2*>(proj + (size_t)m * N + n) =
              make_float2(acc[mt][nt][2 * h] + b0, acc[mt][nt][2 * h + 1] + b1);
      }
  }
}

// The projection of the B*S rows of B lanes of the given lengths on the given stream:
// bfloat16 io on the tensor cores where its pieces allow, else FFMA. Returns
// cudaGetLastError().
template <typename T, typename W>
int rnn_proj_launch(const T* xs, const W& w, float* proj, int B, int S, int C,
                    const int* lengths, void* stream) {
  const int M = B * S;
  dim3 grid((w.columns() + PROJ_BN - 1) / PROJ_BN, (M + PROJ_BM - 1) / PROJ_BM);
  if constexpr (sizeof(T) == 2) {
    if (C % 8 == 0 && (reinterpret_cast<uintptr_t>(xs) & 15) == 0 && w.aligned(16)) {
      rnn_proj_mma_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(xs, w, proj, M, C, lengths, S);
      return (int)cudaGetLastError();
    }
  }
  rnn_proj_kernel<T><<<grid, 256, 0, (cudaStream_t)stream>>>(xs, w, proj, M, C, lengths, S);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------------- //
// Device helpers
// ----------------------------------------------------------------------------- //

// Every thread of the cluster arrives, its stores (to its own and to other blocks'
// shared memory) released, and waits for all the others.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The mbarriers that count the bytes of a gathered input (grid.cuh's mbar_init and
// mbar_expect): one arrival a phase (the block's thread 0, with the bytes to expect),
// and the bytes the cluster's blocks write into it with st.async. A phase's bytes may
// come before its arrival. bar_wait waits until the phase of the given parity is
// complete, with the cluster's acquire: the bytes other blocks wrote are then visible
// to this thread.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ unsigned cluster_addr(const void* local, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(local)), "r"(rank));
  return out;
}

__device__ __forceinline__ void store_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void store_async4(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// The items i = tid, tid + RNN_THREADS, ... of a thread, split as
// i = (a * M + b) * Q + c. The first item's split and the stride in the same radices
// are computed once, before the step loop, so that a walk divides nothing.
struct Walk {
  int a, b, c;
  int da, db, dc;
  int M, Q;
  __device__ __forceinline__ void init(int m, int q) {
    M = imax(m, 1);
    Q = imax(q, 1);
    int i = threadIdx.x;
    c = i % Q;
    i /= Q;
    b = i % M;
    a = i / M;
    int d = RNN_THREADS;
    dc = d % Q;
    d /= Q;
    db = d % M;
    da = d / M;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    if (c >= Q) {
      c -= Q;
      ++b;
    }
    b += db;
    if (b >= M) {
      b -= M;
      ++a;
    }
    a += da;
  }
};

// How a block copies each step's rows of its units and writes its values into the
// cluster: 16 bytes at a time where every offset is a multiple of 4 values.
struct Moves {
  bool vec;   // (H | first | u) % 4 == 0
  Walk rows;  // (lane, segment, value or group of four)
  Walk push;  // (block of the cluster, lane, value or group of four)
  __device__ __forceinline__ void init(int H, int first, int u, int segs, int Lp) {
    vec = ((H | first | u) & 3) == 0;
    const int q = vec ? u >> 2 : u;
    rows.init(segs, q);
    push.init(Lp, q);
  }
};

// One step's rows of the block's units into shared memory, asynchronously: for each
// of `nl` lanes (those where want(l)) and each of the walk's segments, the u values at
// src(l, s) go to dst[(l * segs + s) * u ...].
template <typename Src, typename Want>
__device__ __forceinline__ void fetch_rows(const Moves& mv, float* dst, int nl, int u, Src src,
                                           Want want) {
  if (u == 0) return;
  const int segs = mv.rows.M;
  for (Walk w = mv.rows; w.a < nl; w.next()) {
    if (!want(w.a)) continue;
    if (mv.vec) {
      const int j = 4 * w.c;
      copy16_async(dst + (w.a * segs + w.b) * u + j, src(w.a, w.b) + j);
    } else {
      copy4_async(dst + (w.a * segs + w.b) * u + w.c, src(w.a, w.b) + w.c);
    }
  }
}

template <typename Src>
__device__ __forceinline__ void fetch_rows(const Moves& mv, float* dst, int nl, int u, Src src) {
  fetch_rows(mv, dst, nl, u, src, [](int) { return true; });
}

// The block's u values of each of Lp lanes (src[l * stride + j]) into row l of `dst`
// (row stride ws) at column `at`, in every block of the cluster, each store counted
// on that block's mbarrier `bar` (4 * Lp * u bytes a block). `at` and `stride` are
// multiples of u.
__device__ __forceinline__ void push_to_cluster(const Moves& mv, int cs, const float* src,
                                                int stride, int u, float* dst, int ws, int at,
                                                unsigned long long* bar) {
  if (u == 0) return;
  for (Walk w = mv.push; w.a < cs; w.next()) {
    const int l = w.b;
    if (mv.vec) {   // then at and stride are multiples of 4 too
      const int j = 4 * w.c;
      const float4 v = *reinterpret_cast<const float4*>(src + l * stride + j);
      store_async4(cluster_addr(dst + l * ws + at + j, w.a), v, cluster_addr(bar, w.a));
    } else {
      store_async(cluster_addr(dst + l * ws + at + w.c, w.a), src[l * stride + w.c],
                  cluster_addr(bar, w.a));
    }
  }
}

// How a block's threads share out one product of `cols` columns over `tiles` tiles
// of lanes and K = 4 * k4: a thread takes one (tile, column) item at a time and a
// `parts`-th of its groups of four (parts a power of two up to 32, as many as the
// threads allow), computed once before the step loop.
struct ProductWalk {
  int parts, p, items, item, per_pass;
  int tile, col, dtile, dcol, cols;
  __device__ __forceinline__ void init(int ncols, int k4, int tiles) {
    int n = 1;
    while (n < 32 && ncols * tiles * n * 2 <= RNN_THREADS && n * 2 <= k4) n *= 2;
    init_parts(ncols, tiles, n);
  }
  // the same with the number of parts given
  __device__ __forceinline__ void init_parts(int ncols, int tiles, int n) {
    cols = imax(ncols, 1);
    items = ncols * tiles;
    parts = n;
    p = threadIdx.x & (parts - 1);
    item = (int)threadIdx.x / parts;
    per_pass = RNN_THREADS / parts;
    tile = item / cols;
    col = item - tile * cols;
    dtile = per_pass / cols;
    dcol = per_pass - dtile * cols;
  }
};

// out[l][c] = sum over k of in[l][k] * w[c][k] for the block's columns (rows of w, k
// contiguous, stride ws, io type; K zero-padded to 4 * k4 in both operands) and its
// tiles of LT lanes of `in` (float, row stride is), as `pw` shares it out. The parts
// of an item read neighbouring 16 bytes and are added by warp shuffles in a fixed
// order (a butterfly, so that every thread of the item holds the sums); the item's
// threads share out its lanes: epi(tile, column, lane of the tile, sum) for each
// lane, once.
template <int LT, typename WT, typename Epi>
__device__ __forceinline__ void cluster_product(const ProductWalk& pw, const WT* __restrict__ w,
                                                int ws, const float* __restrict__ in, int is,
                                                int k4, Epi&& epi) {
  using Vec = typename Weights4<WT>::Vec;
  const int parts = pw.parts, p = pw.p;
  int tile = pw.tile, col = pw.col;
  for (int base = 0; base < pw.items; base += pw.per_pass) {
    const bool active = base + pw.item < pw.items;
    float acc[LT];
#pragma unroll
    for (int l = 0; l < LT; ++l) acc[l] = 0.0f;
    if (active) {
      const Vec* wr = reinterpret_cast<const Vec*>(w + (size_t)col * ws);
      const float* ir = in + (size_t)tile * LT * is;
#pragma unroll 4
      for (int q = p; q < k4; q += parts) {
        const float4 wv = Weights4<WT>::values(wr[q]);
#pragma unroll
        for (int l = 0; l < LT; ++l) {
          const float4 a = *reinterpret_cast<const float4*>(ir + l * is + 4 * q);
          acc[l] = fmaf(a.x, wv.x, acc[l]);
          acc[l] = fmaf(a.y, wv.y, acc[l]);
          acc[l] = fmaf(a.z, wv.z, acc[l]);
          acc[l] = fmaf(a.w, wv.w, acc[l]);
        }
      }
    }
    for (int o = parts >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int l = 0; l < LT; ++l) acc[l] += __shfl_xor_sync(0xffffffffu, acc[l], o);
    }
    // thread p of the item finishes lanes p, p + parts, ...: the lane's sum is selected
    // first, so that a warp runs the epilogue's body once per lane a thread finishes
    // and not once per lane of the tile
    if (active) {
      for (int l = p; l < LT; l += parts) {
        float v = acc[0];
#pragma unroll
        for (int i = 1; i < LT; ++i)
          if (i == l) v = acc[i];
        epi(tile, col, l, v);
      }
    }
    col += pw.dcol;
    if (col >= pw.cols) {
      col -= pw.cols;
      ++tile;
    }
    tile += pw.dtile;
  }
}
