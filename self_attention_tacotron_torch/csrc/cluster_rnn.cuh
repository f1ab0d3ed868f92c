// The thread-block-cluster design of the BiGRU kernels (bigru.cu, bigru_bwd.cu):
// the plan both compute for themselves (mirrored by ops/fused_rnn.py::bigru_plan),
// the exchanges between a cluster's blocks, the asynchronous row copies, and the
// small product every step runs against a block's resident weight slice.
//
// One cluster of CLUSTER blocks runs one direction for one group of lanes. The
// cluster's blocks share out the H units (share_of, whole units, so that a unit's
// gate and candidate columns lie on one block); each block holds its slice of the
// recurrent weights in shared memory for the whole loop, and every step's vector
// that all units need (io(h), io(r*h) forward; io(g_ac), io(g_ag) backward) is
// written by each block into every block of its cluster (distributed shared memory,
// st.async), where an mbarrier counts its bytes: a block waits for the bytes of the
// vector it needs, not for the other blocks to reach a barrier. Each block has an SM
// of its own: the launch asks for the device's whole opt-in shared memory, so that
// the clusters of a wave spread over the card.
//
// Why two exchanges a step are safe with one copy of each gathered vector: a block
// writes step t+1's vector into another block only after it has that block's part
// of a vector which that block sends after a __syncthreads that follows its last
// read of step t's copy; and an mbarrier's next phase cannot complete before every
// thread of the block has waited on the current one, because it needs the block's
// own part, sent after such a __syncthreads.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#include "dense.cuh"
#include "grid.cuh"

namespace cg = cooperative_groups;

constexpr int RNN_THREADS = 256;
// The opt-in shared memory of one block on an H100 (the plan's limit; the kernels
// read the device's own).
constexpr int RNN_SMEM_LIMIT = 232448;
// A launch that finds no cluster of the plan's size resident on the card.
constexpr int RNN_NO_CLUSTER = -2;
// A width whose resident slice does not fit a block of a cluster of 16.
constexpr int RNN_TOO_WIDE = -3;

__host__ __device__ inline long long r16ll(long long n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Byte offsets of a block's shared memory. Forward: weights [3u][ws] (r, z and
// candidate columns, k contiguous, io type), io(h) [Lp][ws], io(r*h) [Lp][ws], two
// buffers of projection rows [Lp][3u], the float carry [Lp][u], the lengths [Lp].
// Backward: weights [u][ws] (Wc_h^T's columns) and [u][ws2] (Wg_h^T's), io(g_ac)
// [Lp][ws], io(g_ag) [Lp][ws2], two buffers of rows [Lp][5u] (r, z, n, h_prev, g_y),
// g, g_h, g_rh [Lp][u] each, the g_ag staging [Lp][2u], the lengths. Both end with
// two mbarriers (8 bytes each, 8-aligned), one per gathered input. ws = r4(H) + 4
// and ws2 = r4(2H) + 4 (four values of padding keep the threads of a warp, one
// column each, on different banks); u is the largest share of units.
struct RnnLayout {
  int ws, ws2;
  long long in1, in2, rows0, rows1, own, len, bars, total;
};

__host__ __device__ inline RnnLayout rnn_layout(int H, int u, int Lp, int io_bytes, bool backward) {
  RnnLayout s;
  s.ws = r4(H) + 4;
  s.ws2 = r4(2 * H) + 4;
  const long long L = Lp;
  if (!backward) {
    s.in1 = r16ll(3LL * u * s.ws * io_bytes);
    s.in2 = s.in1 + 4 * L * s.ws;
    s.rows0 = s.in2 + 4 * L * s.ws;
    s.rows1 = s.rows0 + 4 * L * 3 * u;
    s.own = s.rows1 + 4 * L * 3 * u;
    s.len = s.own + 4 * L * u;
  } else {
    s.in1 = r16ll((long long)u * (s.ws + s.ws2) * io_bytes);
    s.in2 = s.in1 + 4 * L * s.ws;
    s.rows0 = s.in2 + 4 * L * s.ws2;
    s.rows1 = s.rows0 + 4 * L * 5 * u;
    s.own = s.rows1 + 4 * L * 5 * u;
    s.len = s.own + 4 * L * 5 * u;
  }
  s.bars = (s.len + 4 * L + 7) / 8 * 8;
  s.total = s.bars + 16;
  return s;
}

// The most lanes one block's room holds at cluster size cs (a multiple of 4, the
// product's lane tile, or 1); 0 where not one lane fits.
inline int rnn_max_lanes(int H, int cs, int io_bytes, bool backward, long long limit) {
  const int u = cdiv(H, cs);
  const long long a = rnn_layout(H, u, 0, io_bytes, backward).total;
  const long long b = rnn_layout(H, u, 1, io_bytes, backward).total - a;
  if (limit < a + b) return 0;
  const long long fit = (limit - a) / b;
  return fit >= 4 ? (int)(fit / 4 * 4) : 1;
}

// The portable cluster of 8 where one lane fits it, else 16; 0 where neither does.
inline int rnn_cluster_size(int H, int io_bytes, bool backward, long long limit) {
  if (rnn_max_lanes(H, 8, io_bytes, backward, limit) > 0) return 8;
  if (rnn_max_lanes(H, 16, io_bytes, backward, limit) > 0) return 16;
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
inline RnnPlan rnn_plan(int B, int H, int io_bytes, bool backward, int cs, int slots,
                        long long limit) {
  RnnPlan p;
  p.cluster = cs;
  p.units_max = cdiv(H, cs);
  p.max_lanes = rnn_max_lanes(H, cs, io_bytes, backward, limit);
  p.slots = slots;
  const int need = cdiv(B, p.max_lanes);
  p.waves = imax(1, cdiv(2 * need, slots));
  p.groups = imin(B, imax(1, p.waves * slots / 2));
  p.lanes = cdiv(B, p.groups);
  p.lane_tile = p.lanes == 1 ? 1 : 4;
  p.lanes_padded = cdiv(p.lanes, p.lane_tile) * p.lane_tile;
  p.clusters = 2 * p.groups;
  p.threads = RNN_THREADS;
  p.smem_bytes = rnn_layout(H, p.units_max, p.lanes_padded, io_bytes, backward).total;
  p.smem_limit = limit;
  return p;
}

// What the C interface's query functions write, in this order (the fields of
// ops/fused_rnn.py::BiGRUPlan).
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
int rnn_device_plan(Kernel kernel, int B, int H, int io_bytes, bool backward, RnnPlan* plan,
                    int* n_sms) {
  RnnCard card;
  int code = rnn_card(kernel, 0, &card);
  if (code != 0) return code;
  const int cs = rnn_cluster_size(H, io_bytes, backward, card.limit);
  if (cs == 0) return RNN_TOO_WIDE;
  code = rnn_card(kernel, cs, &card);
  if (code != 0) return code;
  const int slots = card.slots[cs > 8];
  if (slots < 1) return RNN_NO_CLUSTER;
  *n_sms = card.n_sms;
  *plan = rnn_plan(B, H, io_bytes, backward, cs, slots, card.limit);
  return 0;
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
// of `nl` lanes and each of the walk's segments, the u values at src(l, s) go to
// dst[(l * segs + s) * u ...].
template <typename Src>
__device__ __forceinline__ void fetch_rows(const Moves& mv, float* dst, int nl, int u, Src src) {
  if (u == 0) return;
  const int segs = mv.rows.M;
  for (Walk w = mv.rows; w.a < nl; w.next()) {
    if (mv.vec) {
      const int j = 4 * w.c;
      copy16_async(dst + (w.a * segs + w.b) * u + j, src(w.a, w.b) + j);
    } else {
      copy4_async(dst + (w.a * segs + w.b) * u + w.c, src(w.a, w.b) + w.c);
    }
  }
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
    cols = imax(ncols, 1);
    items = ncols * tiles;
    parts = 1;
    while (parts < 32 && items * parts * 2 <= RNN_THREADS && parts * 2 <= k4) parts *= 2;
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
