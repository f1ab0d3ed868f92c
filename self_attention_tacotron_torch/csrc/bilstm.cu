// Bidirectional ZoneoutLSTM over a padded batch, eval mode: the input projection over
// the whole card, then the recurrence of both directions as thread-block clusters.
//
// Replaces the Pallas kernel of self_attention_tacotron_tpu/ops/fused_rnn.py
// (bilstm_pallas, _make_lstm_kernel), the encoder LSTM of ZoneoutEncoderV1. Per
// direction and step it computes, in this port's own code,
//
//   z  = [x_t, io(h)] . W + b                      (gates i, g, f, o; W is (C + H, 4H))
//   c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//   c  = zc * c + (1 - zc) * c'                    (eval-mode zoneout: interpolation)
//   h  = zo * h + (1 - zo) * h'
//
// where io(.) rounds to the io type (float or bf16) before the product, the
// carries c and h stay float32, sums are float32, and y is stored in the io type. A
// step at or beyond a lane's length keeps both carries and emits zero; the backward
// direction walks S-1 -> 0, so its carries are still zero when it reaches the lane's
// last valid step.
//
// What bounds it on an H100: not operations or bytes (2 * sum(lengths) * 2 * (C + H)
// * 4H operations, a megabyte of weights) but the chain of S dependent steps, so the
// time is S times the latency of one step. The design is bigru.cu's (cluster_rnn.cuh)
// and cuts that latency:
//
// 1. The x half of the product does not depend on the carry. rnn_proj_kernel (the
//    projection bigru.cu launches too) computes it for every (lane, step, direction)
//    before the recurrence, the bias folded in: proj = x . W_x + b, both directions
//    side by side (B*S rows of 8H float32 sums, FFMA).
// 2. bilstm_cluster_kernel runs one thread-block cluster per (direction, group of
//    lanes). The cluster's blocks share out the H units; each loads the i, g, f and o
//    columns of its units from the h rows of W once and keeps them in shared memory,
//    so no weight is read from global memory inside the step loop. A step: the
//    product on the block's columns, a thread taking all four gates of one unit for
//    a tile of lanes, the K reduction split over a few threads and added by warp
//    shuffles; the cell, the zoneout interpolation and the masked store of y in that
//    product's epilogue (the carries stay float32 in the block's shared memory); then
//    io(h') of the block's units written into every block of the cluster with
//    st.async, counted on an mbarrier: one exchange a step, into one of two copies of
//    io(h) chosen by the step's parity (cluster_rnn.cuh says why two), and one
//    __syncthreads a step. The next step's projection rows are copied in (cp.async)
//    while the step waits for the exchange and computes.
//
// The plan (lanes per cluster from B, cluster size from H, the shared memory) is
// cluster_rnn.cuh::rnn_plan of kind RNN_LSTM, mirrored by ops/fused_rnn.py::bilstm_plan.
// Every sum has one owner thread and a fixed order: two launches agree bit for bit.
//
// Plain C interface at the bottom: the functions launch on the given stream,
// allocate nothing, do not synchronise, and return cudaGetLastError() (or a
// negative code of cluster_rnn.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster_rnn.cuh"

namespace {

// The x rows (k < C) of both directions' W side by side: column n of [W_f | W_b],
// each 4H wide (gates i, g, f, o), and the biases the same way (rnn_proj_kernel's
// weights: at(k, n), bias(n), columns(), aligned(bytes)).
template <typename T>
struct LstmProjWeights {
  const T *w_f, *b_f, *w_b, *b_b;
  int H;
  __host__ __device__ __forceinline__ int columns() const { return 8 * H; }
  // groups of bytes / sizeof(T) columns lie in one matrix, each matrix so aligned
  __host__ __device__ __forceinline__ bool aligned(int bytes) const {
    const uintptr_t any = reinterpret_cast<uintptr_t>(w_f) | reinterpret_cast<uintptr_t>(w_b);
    return H % (bytes / (int)sizeof(T)) == 0 && (any & (bytes - 1)) == 0;
  }
  __device__ __forceinline__ const T* at(int k, int n) const {
    const int dir = n >= 4 * H;
    return (dir ? w_b : w_f) + (size_t)k * 4 * H + (n - dir * 4 * H);
  }
  __device__ __forceinline__ float bias(int n) const {
    const int dir = n >= 4 * H;
    return Io<T>::load((dir ? b_b : b_f) + (n - dir * 4 * H));
  }
};

struct Zoneout {
  float cell, output, forget_bias;
};

// sigmoid as dense.cuh's sigmoidf_, 1 / (1 + exp(-v)), with the quotient as the
// correctly rounded reciprocal: the same bits, without the division's slow path
__device__ __forceinline__ float sigmoid_rcp(float v) { return __frcp_rn(1.0f + expf(-v)); }

// Where a weight row's group of four values q lies: at q ^ swizzle(row). A thread of
// an item reads group q of its unit's four rows; a warp's load is served in phases of
// 8 threads (float: 16 bytes a group, 8 groups to the 128 bytes of the banks) or 16
// (bfloat16: 8 bytes, 16 groups), and a phase spans 8 / parts (16 / parts) neighbouring
// rows times `parts` neighbouring groups. The row's low 3 (4) bits, reversed, are XORed
// into the group's, so that for every power of two `parts` the phase's rows and groups
// fill the bank groups once. Rows are whole multiples of 8 (16) groups.
template <typename WT>
__host__ __device__ __forceinline__ int swizzle(int row) {
  if (sizeof(WT) == 2)
    return ((row & 1) << 3) | ((row & 2) << 1) | ((row & 4) >> 1) | ((row & 8) >> 3);
  return ((row & 1) << 2) | (row & 2) | ((row & 4) >> 2);
}

// The reduction of one item's sums over its `parts` threads and the epilogue (see
// gate_product). v[4 l + g]: the thread's part of gate g of lane l.
template <int LT, typename Epi>
__device__ __forceinline__ void finish_item(float (&v)[4 * LT], int parts, int p, bool active,
                                            int tile, int col, Epi&& epi) {
  constexpr unsigned FULL = 0xffffffffu;
  int lane0 = 0, lanes = LT;   // the lanes whose four sums this thread holds
  int o = parts >> 1;
  if constexpr (LT == 4) {
    // halve 16 -> 8 -> 4 at the two largest offsets: the thread whose bit is set
    // keeps the upper half, its partner's copy of it added
#pragma unroll
    for (int level = 0; level < 2; ++level) {
      if (o > 0) {
        const int half = 8 >> level;
        const bool hi = (p & o) != 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < half) {
            const float send = hi ? v[i] : v[i + half];
            const float keep = hi ? v[i + half] : v[i];
            v[i] = keep + __shfl_xor_sync(FULL, send, o);
          }
        }
        lanes >>= 1;
        lane0 += hi ? lanes : 0;
        o >>= 1;
      }
    }
  }
  // the remaining levels: every thread of the lanes' group gets the four sums
  for (; o > 0; o >>= 1) {
#pragma unroll
    for (int g = 0; g < 4; ++g) v[g] += __shfl_xor_sync(FULL, v[g], o);
  }
  // one thread of each group finishes its lanes: the one whose remaining bits are 0.
  // The lane's sums are selected first, so that the epilogue's body is compiled once
  if (active && (p & (parts * lanes / LT - 1)) == 0) {
#pragma unroll 1
    for (int i = 0; i < lanes; ++i) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        z[g] = v[g];
#pragma unroll
        for (int j = 1; j < LT; ++j)
          if (j == i) z[g] = v[4 * j + g];
      }
      epi(tile, col, lane0 + i, z);
    }
  }
}

// The first HELD groups of four of a thread's slice of its unit's four weight rows,
// groups q = p + i * parts, held in registers for the whole step loop. Possible where
// every pass keeps the thread on one unit (a pass's items a multiple of u).
constexpr int HELD = 4;

template <typename WT>
struct HeldWeights {
  typename Weights4<WT>::Vec w[4][HELD];
  __device__ __forceinline__ void load(const ProductWalk& pw, const WT* s_w, int wsw, int u,
                                       int k4) {
    using Vec = typename Weights4<WT>::Vec;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const Vec* wr = reinterpret_cast<const Vec*>(s_w + (size_t)(g * u + pw.col) * wsw);
      const int sw = swizzle<WT>(g * u + pw.col);
#pragma unroll
      for (int i = 0; i < HELD; ++i) {
        const int q = pw.p + i * pw.parts;
        w[g][i] = q < k4 ? wr[q ^ sw] : Vec{};
      }
    }
  }
};

// The four gate sums of each lane of a tile for the block's units: for each (tile of
// LT lanes, unit j) item, sums over k of in[l][k] * w[g * u + j][k] for the gates g
// = i, g, f, o (the block's weight rows, k contiguous, stride wsw, io type, groups of
// four swizzled; K zero-padded to 4 * k4 in both operands; the input rows' stride is),
// with the reduction shared out as `pw` says (cluster_rnn.cuh::ProductWalk over u
// items a tile): thread p of an item takes the groups q = p, p + parts, ..., the
// first HELD of them from registers where `held` (hw), the rest from shared memory.
// The parts add their sums by warp shuffles in a fixed order (finish_item), and one
// thread per lane finishes it: epi(tile, unit, lane of the tile, the four sums).
template <int LT, typename WT, typename Epi>
__device__ __forceinline__ void gate_product(const ProductWalk& pw, const HeldWeights<WT>& hw,
                                             bool held, const WT* __restrict__ w, int wsw, int u,
                                             const float* __restrict__ in, int is, int k4,
                                             Epi&& epi) {
  using Vec = typename Weights4<WT>::Vec;
  const int parts = pw.parts, p = pw.p;
  int tile = pw.tile, col = pw.col;
  auto fma_group = [&](float (&v)[4 * LT], const float* ir, int q, const float4 (&wv)[4]) {
#pragma unroll
    for (int l = 0; l < LT; ++l) {
      const float4 a = *reinterpret_cast<const float4*>(ir + l * is + 4 * q);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = v[4 * l + g];
        s = fmaf(a.x, wv[g].x, s);
        s = fmaf(a.y, wv[g].y, s);
        s = fmaf(a.z, wv[g].z, s);
        s = fmaf(a.w, wv[g].w, s);
        v[4 * l + g] = s;
      }
    }
  };
  for (int base = 0; base < pw.items; base += pw.per_pass) {
    const bool active = base + pw.item < pw.items;
    float v[4 * LT];   // v[4 l + g]: gate g of lane l
#pragma unroll
    for (int i = 0; i < 4 * LT; ++i) v[i] = 0.0f;
    if (active) {
      const float* ir = in + (size_t)tile * LT * is;
      int q = p;
      if (held) {
#pragma unroll
        for (int i = 0; i < HELD; ++i) {
          if (q + i * parts < k4) {
            float4 wv[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) wv[g] = Weights4<WT>::values(hw.w[g][i]);
            fma_group(v, ir, q + i * parts, wv);
          }
        }
        q += HELD * parts;
      }
      const Vec* wr[4];
      int sw[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        wr[g] = reinterpret_cast<const Vec*>(w + (size_t)(g * u + col) * wsw);
        sw[g] = swizzle<WT>(g * u + col);
      }
#pragma unroll 2
      for (; q < k4; q += parts) {
        float4 wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) wv[g] = Weights4<WT>::values(wr[g][q ^ sw[g]]);
        fma_group(v, ir, q, wv);
      }
    }
    finish_item<LT>(v, parts, p, active, tile, col, epi);
    col += pw.dcol;
    if (col >= pw.cols) {
      col -= pw.cols;
      ++tile;
    }
    tile += pw.dtile;
  }
}

__device__ __forceinline__ int ilog2(int n) {
  int l = 0;
  while ((2 << l) <= n) ++l;
  return l;
}

// How many threads share an item's K reduction, and whether a thread holds the first
// HELD groups of its weights in registers (where each pass keeps it on one unit: a
// pass's items a multiple of u). The power of two (up to 32, at most k4) that takes
// the least time by a count of a thread's instructions, where more parts cost shuffles
// and fewer may leave a pass of the items on a few threads (304 items of 256 threads
// in two passes); but the fewest parts whose groups the registers hold whole, where
// that costs at most two passes more (on an H100: faster at 8 and 20 lanes a block,
// slower at 72 and 76).
template <int LT>
__device__ __forceinline__ int gate_parts(int items, int k4, int u, bool* held) {
  auto holds = [&](int n) { return (RNN_THREADS / n) % imax(u, 1) == 0; };
  int whole = 0;
  for (int n = 32; n >= 1; n /= 2)
    if (holds(n) && cdiv(k4, n) <= HELD) whole = n;
  int best = 1, best_cost = 0x7fffffff;
  for (int n = 1; n <= 32 && n <= imax(k4, 1); n *= 2) {
    const int levels = ilog2(n);
    const int shuffles = LT == 4 ? (levels >= 1 ? 8 : 0) + (levels >= 2 ? 4 : 0) + 4 * imax(levels - 2, 0)
                                 : 4 * levels;
    const int passes = cdiv(items * n, RNN_THREADS);
    const int cost = passes * (cdiv(k4, n) * (17 * LT + 4) + 2 * shuffles + 100 * cdiv(LT, n));
    if (cost < best_cost) {
      best = n;
      best_cost = cost;
    }
  }
  if (whole > 0 && cdiv(items * whole, RNN_THREADS) <= cdiv(items * best, RNN_THREADS) + 2)
    best = whole;
  *held = holds(best);
  return best;
}

template <typename T, int LT>
__global__ void __launch_bounds__(RNN_THREADS, 1)
bilstm_cluster_kernel(const float* __restrict__ proj,   // (B, S, 8H) from rnn_proj_kernel
                      const int* __restrict__ lengths,  // (B,)
                      const T* __restrict__ w_f, const T* __restrict__ w_b,  // (C + H, 4H)
                      T* __restrict__ y,                // (B, S, 2H)
                      int B, int S, int C, int H, Zoneout zone, RnnPlan plan) {
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
  const RnnLayout lay = rnn_layout(H, plan.units_max, Lp, (int)sizeof(T), RNN_LSTM);
  const int ws = lay.ws, wsl = lay.wsl, u4 = 4 * u, H2 = 2 * H, H4 = 4 * H, k4 = r4(H) / 4;
  T* s_w = reinterpret_cast<T*>(smem);                          // [4u][wsl] i, g, f, o
  float* s_in0 = reinterpret_cast<float*>(smem + lay.in1);     // [Lp][ws] io(h), even steps
  float* s_in1 = reinterpret_cast<float*>(smem + lay.in2);     //          and odd steps
  float* rows0 = reinterpret_cast<float*>(smem + lay.rows0);    // [Lp][4u] step rows, even
  float* rows1 = reinterpret_cast<float*>(smem + lay.rows1);    //          and odd steps
  float* s_c = reinterpret_cast<float*>(smem + lay.own);        // [Lp][u] the carries
  float* s_h = s_c + Lp * u;                                    // [Lp][u]
  float* s_out = s_h + Lp * u;                                  // [Lp][u] io(h') to send
  int* s_len = reinterpret_cast<int*>(smem + lay.len);          // [Lp]
  // the bytes of copy 0 and of copy 1 of io(h), from every block
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + lay.bars);
  const int tid = threadIdx.x;
  const T* w = dir ? w_b : w_f;

  for (int i = tid; i < Lp; i += RNN_THREADS) {
    int len = 0;
    if (i < nl) {
      len = lengths[lane0 + i];
      len = len < 0 ? 0 : (len > S ? S : len);
    }
    s_len[i] = len;
  }
  for (int i = tid; i < Lp * ws; i += RNN_THREADS) s_in0[i] = s_in1[i] = 0.0f;
  for (int i = tid; i < Lp * u4; i += RNN_THREADS) rows0[i] = rows1[i] = 0.0f;
  for (int i = tid; i < 3 * Lp * u; i += RNN_THREADS) s_c[i] = 0.0f;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
  }
  // the block's columns of the h rows (C .. C+H-1): gate g of unit j at row g*u + j,
  // k contiguous in swizzled groups of four, zero from H to the padded width
  for (int i = tid; i < wsl * u4; i += RNN_THREADS) {
    const int k = i / u4;
    const int c = i - k * u4;
    T v = Io<T>::from(0.0f);
    if (k < H) {
      const int g = c / u;
      v = w[(size_t)(C + k) * H4 + g * H + first + (c - g * u)];
    }
    s_w[(size_t)c * wsl + (((k >> 2) ^ swizzle<T>(c)) << 2) + (k & 3)] = v;
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
  mv.init(H, first, u, 4, Lp);
  ProductWalk pw;
  bool held = false;
  pw.init_parts(u, Lp / LT, gate_parts<LT>(u * (Lp / LT), k4, u, &held));
  HeldWeights<T> hw;
  if (held) hw.load(pw, s_w, wsl, u, k4);
  auto fetch = [&](int t, float* dst) {
    fetch_rows(mv, dst, nl, u, [&](int l, int s) {
      return proj + ((size_t)(lane0 + l) * S + t) * 8 * H + dir * H4 + s * H + first;
    }, [&](int l) { return t < s_len[l]; });
  };
  // every block receives 4 * Lp * H bytes of io(h) a step. Step t reads copy t & 1,
  // which holds io(h) of step t - 1: copy 1 first holds step 0's (read at step 1),
  // copy 0 step 1's (read at step 2); each mbarrier is armed once per use
  const unsigned bytes = 4u * Lp * H;
  if (tid == 0 && max_len > 1) mbar_expect(bars + 1, bytes);
  if (tid == 0 && max_len > 2) mbar_expect(bars, bytes);
  if (max_len > 0) fetch(dir ? max_len - 1 : 0, rows0);
  copies_wait();
  // every block started, its mbarriers armed; zeroed inputs and the first rows in place
  cluster_barrier();

  for (int step = 0; step < max_len; ++step) {
    const int t = dir ? max_len - 1 - step : step;
    const int par = step & 1;
    float* rows = par ? rows1 : rows0;
    // the next step's rows, while this one waits and computes (the buffer's last
    // reader was the step before, past its __syncthreads)
    if (step + 1 < max_len) fetch(dir ? t - 1 : t + 1, par ? rows0 : rows1);
    if (step > 0) {
      // io(h) of every unit, from the step before (the first step's is zero)
      bar_wait(bars + par, ((step - 1) >> 1) & 1);
      if (tid == 0 && step + 2 < max_len) mbar_expect(bars + par, bytes);
    }

    // the four gates of the block's units, the cell and the output
    auto cell = [&](int tile, int j, int i, const float (&z)[4]) {
      const int l = tile * LT + i;
      const float* pr = rows + l * u4;
      float h = s_h[l * u + j];
      if (t < s_len[l]) {
        const float c = s_c[l * u + j];
        const float zi = z[0] + pr[j], zg = z[1] + pr[u + j];
        const float zf = z[2] + pr[2 * u + j], zo = z[3] + pr[3 * u + j];
        const float new_c = sigmoid_rcp(zf + zone.forget_bias) * c + sigmoid_rcp(zi) * tanhf(zg);
        const float new_h = sigmoid_rcp(zo) * tanhf(new_c);
        s_c[l * u + j] = zone.cell * c + (1.0f - zone.cell) * new_c;
        h = zone.output * h + (1.0f - zone.output) * new_h;
        s_h[l * u + j] = h;
        y[((size_t)(lane0 + l) * S + t) * H2 + dir * H + first + j] = Io<T>::from(h);
      }
      s_out[l * u + j] = Io<T>::round(h);
    };
    gate_product<LT, T>(pw, hw, held, s_w, wsl, u, par ? s_in1 : s_in0, ws, k4, cell);
    copies_wait();
    // every thread past its reads of this step's io(h) copy and rows, io(h') staged,
    // the next rows in place
    __syncthreads();
    if (step + 1 < max_len)
      push_to_cluster(mv, cs, s_out, u, u, par ? s_in0 : s_in1, ws, first, bars + (par ^ 1));
  }
  // no block leaves while its stores into other blocks may be in flight
  cluster_barrier();
}

template <typename T>
int plan_of(int B, int H, RnnPlan* plan, int* n_sms) {
  return rnn_device_plan(bilstm_cluster_kernel<T, 4>, B, H, (int)sizeof(T), RNN_LSTM, plan, n_sms);
}

template <typename T>
int launch_proj(const void* xs, const void* w_f, const void* b_f, const void* w_b,
                const void* b_b, const void* lengths, void* proj, int B, int S, int C, int H,
                void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  LstmProjWeights<T> w{(const T*)w_f, (const T*)b_f, (const T*)w_b, (const T*)b_b, H};
  return rnn_proj_launch((const T*)xs, w, (float*)proj, B, S, C, (const int*)lengths, stream);
}

template <typename T>
int launch_bilstm(const void* proj, const void* lengths, const void* w_f, const void* w_b,
                  void* y, int B, int S, int C, int H, float zc, float zo, float forget_bias,
                  void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  RnnPlan p;
  int n_sms = 0;
  const int code = plan_of<T>(B, H, &p, &n_sms);
  if (code != 0) return code;
  auto* kernel = p.lane_tile == 1 ? bilstm_cluster_kernel<T, 1> : bilstm_cluster_kernel<T, 4>;
  return (int)rnn_launch(kernel, p, stream, (const float*)proj, (const int*)lengths,
                         (const T*)w_f, (const T*)w_b, (T*)y, B, S, C, H,
                         Zoneout{zc, zo, forget_bias});
}

}  // namespace

extern "C" {

// The x half of both directions' products, biases folded in: proj (B*S, 8H) float32
// (rows of padded steps are left unwritten: the recurrence reads valid steps alone).
int bilstm_proj_f32(const void* xs, const void* w_f, const void* b_f, const void* w_b,
                    const void* b_b, const void* lengths, void* proj, int B, int S, int C, int H,
                    void* stream) {
  return launch_proj<float>(xs, w_f, b_f, w_b, b_b, lengths, proj, B, S, C, H, stream);
}

int bilstm_proj_bf16(const void* xs, const void* w_f, const void* b_f, const void* w_b,
                     const void* b_b, const void* lengths, void* proj, int B, int S, int C, int H,
                     void* stream) {
  return launch_proj<__nv_bfloat16>(xs, w_f, b_f, w_b, b_b, lengths, proj, B, S, C, H, stream);
}

// The recurrence of both directions over proj: y (B, S, 2H) in the io type.
int bilstm_f32(const void* proj, const void* lengths, const void* w_f, const void* w_b, void* y,
               int B, int S, int C, int H, float zc, float zo, float forget_bias, void* stream) {
  return launch_bilstm<float>(proj, lengths, w_f, w_b, y, B, S, C, H, zc, zo, forget_bias,
                              stream);
}

int bilstm_bf16(const void* proj, const void* lengths, const void* w_f, const void* w_b, void* y,
                int B, int S, int C, int H, float zc, float zo, float forget_bias, void* stream) {
  return launch_bilstm<__nv_bfloat16>(proj, lengths, w_f, w_b, y, B, S, C, H, zc, zo,
                                      forget_bias, stream);
}

// The plan the recurrence launches with on the current device (rnn_plan_fields).
int bilstm_plan_query(int B, int H, int bf16, long long* out) {
  RnnPlan p;
  int n_sms = 0;
  const int code = bf16 ? plan_of<__nv_bfloat16>(B, H, &p, &n_sms) : plan_of<float>(B, H, &p, &n_sms);
  if (code == 0) rnn_plan_fields(p, n_sms, out);
  return code;
}

}  // extern "C"
