// The adjoint-carry recursion of the bidirectional GRU's backward, both
// directions as thread-block clusters.
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
// The kernel is compiled for two weight types, float and bfloat16 (WT). With
// bfloat16 it rounds what enters each product where the Pallas kernel casts to
// its io_dtype: the cotangents g_ac and g_ag before their products with the
// bfloat16 transposed weights. g_y, rz, n, h_prev, the sums, the carry's
// cotangent and the outputs stay float; g_ac keeps its float value for the output
// and a rounded copy for the product.
//
// What bounds it on an H100 is the chain of S dependent steps, as in bigru.cu, and
// the design is the forward's (cluster_rnn.cuh): one thread-block cluster per
// (direction, group of lanes), the cluster's blocks sharing out the H output units.
// Each block keeps its units' columns of Wc_h^T and Wg_h^T resident in shared memory
// for the whole loop. A step: g_h and g_ac of its units, io(g_ac) written into every
// block of the cluster (distributed shared memory, counted on each block's
// mbarrier); g_rh = g_ac . Wc_h^T and g_ag of its units (whose 2H entries the units
// own) once every unit's io(g_ac) is in, io(g_ag) written into every block the same
// way; g of its units once every unit's io(g_ag) is in. Two exchanges a step, no
// cluster-wide barrier inside the loop; the next step's rows of rz, n, h_prev and
// g_y are copied in (cp.async) while the first exchange is in flight. Every sum has
// one owner thread and a fixed order, so two launches agree bit for bit.
//
// Plain C interface at the bottom: the function launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError() (or a
// negative code of cluster_rnn.cuh).

#include <cuda_runtime.h>

#include "cluster_rnn.cuh"

namespace {

template <typename WT, int LT>
__global__ void __launch_bounds__(RNN_THREADS, 1)
bigru_bwd_kernel(const float* __restrict__ g_y,     // (B, S, 2H) forward half, backward half
                 const float* __restrict__ rz,      // (2, B, S, 2H)
                 const float* __restrict__ n,       // (2, B, S, H)
                 const float* __restrict__ hp,      // (2, B, S, H)
                 const int* __restrict__ lengths,   // (B,)
                 const WT* __restrict__ wgh_t,      // (2, 2H, H)
                 const WT* __restrict__ wch_t,      // (2, H, H)
                 float* __restrict__ g_ag,          // (2, B, S, 2H), zero on entry
                 float* __restrict__ g_ac_out,      // (2, B, S, H), zero on entry
                 int B, int S, int H, RnnPlan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = plan.cluster;
  const int rank = (int)cg::this_cluster().block_rank();
  const int cid = blockIdx.x / cs;
  const int dir = cid & 1;
  const Share lane_share = share_of(B, plan.groups, 0, cid >> 1);
  const Share unit_share = share_of(H, cs, 0, rank);
  const int lane0 = lane_share.first, nl = lane_share.count;
  const int first = unit_share.first, u = unit_share.count;
  const int Lp = plan.lanes_padded, um = plan.units_max;
  const RnnLayout lay = rnn_layout(H, um, Lp, (int)sizeof(WT), RNN_GRU_BWD);
  const int ws = lay.ws, ws2 = lay.ws2, H2 = 2 * H, u5 = 5 * u;
  WT* s_w1 = reinterpret_cast<WT*>(smem);                       // [u][ws]  Wc_h^T columns
  WT* s_w2 = s_w1 + (size_t)um * ws;                             // [u][ws2] Wg_h^T columns
  float* s_gac = reinterpret_cast<float*>(smem + lay.in1);      // [Lp][ws]  io(g_ac)
  float* s_gag = reinterpret_cast<float*>(smem + lay.in2);      // [Lp][ws2] io(g_ag)
  float* rows0 = reinterpret_cast<float*>(smem + lay.rows0);    // [Lp][5u] step rows, even
  float* rows1 = reinterpret_cast<float*>(smem + lay.rows1);    //          and odd steps
  float* s_g = reinterpret_cast<float*>(smem + lay.own);        // [Lp][u] cotangent of the carry
  float* s_gh = s_g + Lp * u;                                    // [Lp][u] g_h of this step
  float* s_grh = s_gh + Lp * u;                                  // [Lp][u]
  float* s_st = s_grh + Lp * u;                                  // [Lp][2u] io(g_ag), staged
  int* s_len = reinterpret_cast<int*>(smem + lay.len);
  // the bytes of io(g_ac) and of io(g_ag), from every block
  unsigned long long* bar_ac = reinterpret_cast<unsigned long long*>(smem + lay.bars);
  unsigned long long* bar_ag = bar_ac + 1;
  const int tid = threadIdx.x;
  const WT* wg = wgh_t + (size_t)dir * H2 * H;
  const WT* wc = wch_t + (size_t)dir * H * H;

  for (int i = tid; i < Lp; i += RNN_THREADS) {
    int len = 0;
    if (i < nl) {
      len = lengths[lane0 + i];
      len = len < 0 ? 0 : (len > S ? S : len);
    }
    s_len[i] = len;
  }
  for (int i = tid; i < Lp * ws; i += RNN_THREADS) s_gac[i] = 0.0f;
  for (int i = tid; i < Lp * ws2; i += RNN_THREADS) s_gag[i] = 0.0f;
  for (int i = tid; i < Lp * u5; i += RNN_THREADS) rows0[i] = rows1[i] = 0.0f;
  for (int i = tid; i < Lp * u; i += RNN_THREADS) s_g[i] = 0.0f;
  if (tid == 0) {
    mbar_init(bar_ac);
    mbar_init(bar_ag);
  }
  // the block's output units' columns of the transposed h rows, k contiguous, zero
  // to the padded depths
  for (int i = tid; i < r4(H) * u; i += RNN_THREADS) {
    const int k = i / u;
    const int j = i - k * u;
    s_w1[(size_t)j * ws + k] = k < H ? wc[(size_t)k * H + first + j] : Io<WT>::from(0.0f);
  }
  for (int i = tid; i < r4(H2) * u; i += RNN_THREADS) {
    const int k = i / u;
    const int j = i - k * u;
    s_w2[(size_t)j * ws2 + k] = k < H2 ? wg[(size_t)k * H + first + j] : Io<WT>::from(0.0f);
  }
  __syncthreads();
  int max_len = 0;
  for (int l = 0; l < nl; ++l) max_len = imax(max_len, s_len[l]);

  Moves mv;
  mv.init(H, first, u, 5, Lp);
  ProductWalk p1, p2;
  p1.init(u, r4(H) / 4, Lp / LT);
  p2.init(u, r4(H2) / 4, Lp / LT);
  Walk units;   // (lane, unit) of the pointwise pass
  units.init(u, 1);
  auto fetch = [&](int t, float* dst) {
    fetch_rows(mv, dst, nl, u, [&](int l, int s) {
      const size_t row = ((size_t)dir * B + lane0 + l) * S + t;
      switch (s) {
        case 0: return rz + row * H2 + first;
        case 1: return rz + row * H2 + H + first;
        case 2: return n + row * H + first;
        case 3: return hp + row * H + first;
        default: return g_y + ((size_t)(lane0 + l) * S + t) * H2 + dir * H + first;
      }
    });
  };
  // every block receives 4 * Lp * H bytes of io(g_ac) and 8 * Lp * H of io(g_ag) a step
  const unsigned bytes = 4u * Lp * H;
  if (tid == 0 && max_len > 0) {
    mbar_expect(bar_ac, bytes);
    mbar_expect(bar_ag, 2 * bytes);
  }
  if (max_len > 0) fetch(dir == 0 ? max_len - 1 : 0, rows0);
  copies_wait();
  // every block started, its mbarriers armed; zeroed inputs and the first rows in place
  cluster_barrier();

  for (int step = 0; step < max_len; ++step) {
    const int t = dir == 0 ? max_len - 1 - step : step;
    float* rows = (step & 1) ? rows1 : rows0;   // [l][r | z | n | h_prev | g_y]

    // 1. g_h, g_ac of the block's units; io(g_ac) replaces g_y's row
    for (Walk w = units; u > 0 && w.a < Lp; w.next()) {
      const int l = w.a, j = w.b, i = l * u + j;
      float* pr = rows + l * u5;
      const bool valid = t < s_len[l];
      const float g_h = valid ? s_g[i] + pr[4 * u + j] : 0.0f;
      const float z = pr[u + j], nv = pr[2 * u + j];
      const float g_ac = g_h * (1.0f - z) * (1.0f - nv * nv);
      s_gh[i] = g_h;
      pr[4 * u + j] = Io<WT>::round(g_ac);
      if (valid) g_ac_out[(((size_t)dir * B + lane0 + l) * S + t) * H + first + j] = g_ac;
    }
    __syncthreads();
    push_to_cluster(mv, cs, rows + 4 * u, u5, u, s_gac, ws, first, bar_ac);
    // the next step's rows, while the other blocks' io(g_ac) arrives
    if (step + 1 < max_len) fetch(dir == 0 ? t - 1 : t + 1, (step & 1) ? rows0 : rows1);
    bar_wait(bar_ac, step & 1);
    if (tid == 0 && step + 1 < max_len) mbar_expect(bar_ac, bytes);

    // 2. g_rh = g_ac . Wc_h^T; g_ag = [g_rh * h_prev, g_z] * rz * (1 - rz) of the units
    cluster_product<LT, WT>(p1, s_w1, ws, s_gac, ws, r4(H) / 4,
                            [&](int tile, int j, int i, float g_rh) {
      const int l = tile * LT + i;
      const int idx = l * u + j;
      const float* pr = rows + l * u5;
      s_grh[idx] = g_rh;
      float g_ar = 0.0f, g_az = 0.0f;
      if (t < s_len[l]) {
        const float r = pr[j], z = pr[u + j], nv = pr[2 * u + j], h_prev = pr[3 * u + j];
        g_ar = g_rh * h_prev * r * (1.0f - r);
        g_az = s_gh[idx] * (h_prev - nv) * z * (1.0f - z);
        const size_t row = ((size_t)dir * B + lane0 + l) * S + t;
        g_ag[row * H2 + first + j] = g_ar;
        g_ag[row * H2 + H + first + j] = g_az;
      }
      s_st[l * 2 * u + j] = Io<WT>::round(g_ar);
      s_st[l * 2 * u + u + j] = Io<WT>::round(g_az);
    });
    // every thread of the block is past its reads of io(g_ac) before any block may
    // write the next step's
    __syncthreads();
    push_to_cluster(mv, cs, s_st, 2 * u, u, s_gag, ws2, first, bar_ag);
    push_to_cluster(mv, cs, s_st + u, 2 * u, u, s_gag, ws2, H + first, bar_ag);
    bar_wait(bar_ag, step & 1);
    if (tid == 0 && step + 1 < max_len) mbar_expect(bar_ag, 2 * bytes);

    // 3. g = g_h * z + g_rh * r + g_ag . Wg_h^T; a padded step keeps g
    cluster_product<LT, WT>(p2, s_w2, ws2, s_gag, ws2, r4(H2) / 4,
                            [&](int tile, int j, int i, float acc) {
      const int l = tile * LT + i;
      if (t < s_len[l]) {
        const int idx = l * u + j;
        const float* pr = rows + l * u5;
        s_g[idx] = s_gh[idx] * pr[u + j] + s_grh[idx] * pr[j] + acc;
      }
    });
    // past the reads of io(g_ag), g in place, the next step's rows arrived
    copies_wait();
    __syncthreads();
  }
  // no block leaves while its stores into other blocks may be in flight
  cluster_barrier();
}

template <typename WT>
int plan_of(int B, int H, RnnPlan* plan, int* n_sms) {
  return rnn_device_plan(bigru_bwd_kernel<WT, 4>, B, H, (int)sizeof(WT), RNN_GRU_BWD, plan, n_sms);
}

template <typename WT>
int launch(const void* g_y, const void* rz, const void* n, const void* hp, const void* lengths,
           const void* wgh_t, const void* wch_t, void* g_ag, void* g_ac, int B, int S, int H,
           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  RnnPlan p;
  int n_sms = 0;
  const int code = plan_of<WT>(B, H, &p, &n_sms);
  if (code != 0) return code;
  auto* kernel = p.lane_tile == 1 ? bigru_bwd_kernel<WT, 1> : bigru_bwd_kernel<WT, 4>;
  return (int)rnn_launch(kernel, p, stream, (const float*)g_y, (const float*)rz,
                         (const float*)n, (const float*)hp, (const int*)lengths,
                         (const WT*)wgh_t, (const WT*)wch_t, (float*)g_ag, (float*)g_ac, B, S, H);
}

}  // namespace

extern "C" {

// g_y, rz, n, hp, g_ag and g_ac are float; the transposed weights float (_f32)
// or bfloat16 (_bf16).
int bigru_bwd_f32(const void* g_y, const void* rz, const void* n, const void* hp,
                  const void* lengths, const void* wgh_t, const void* wch_t, void* g_ag,
                  void* g_ac, int B, int S, int H, void* stream) {
  return launch<float>(g_y, rz, n, hp, lengths, wgh_t, wch_t, g_ag, g_ac, B, S, H, stream);
}

int bigru_bwd_bf16(const void* g_y, const void* rz, const void* n, const void* hp,
                   const void* lengths, const void* wgh_t, const void* wch_t, void* g_ag,
                   void* g_ac, int B, int S, int H, void* stream) {
  return launch<__nv_bfloat16>(g_y, rz, n, hp, lengths, wgh_t, wch_t, g_ag, g_ac, B, S, H,
                               stream);
}

// The plan the kernel launches with on the current device (rnn_plan_fields).
int bigru_bwd_plan_query(int B, int H, int bf16, long long* out) {
  RnnPlan p;
  int n_sms = 0;
  const int code = bf16 ? plan_of<__nv_bfloat16>(B, H, &p, &n_sms) : plan_of<float>(B, H, &p, &n_sms);
  if (code == 0) rnn_plan_fields(p, n_sms, out);
  return code;
}

}  // extern "C"
