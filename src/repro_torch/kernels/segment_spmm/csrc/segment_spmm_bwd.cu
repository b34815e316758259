// The gradients of the segment_spmm kernels for Hopper (sm_90a), in two
// variants.
//
// "sum_bwd": the gradient of "sum" (out[v] = sum of msgs[e] over the
//         edges e with dst[e] == v): dmsgs[e] = dout[dst[e]], rounded to
//         the messages' type.  A row gather of dout by destination.
// "gat_bwd": the gradient of "gat" (one GAT layer's edge softmax and
//         aggregation, segment_spmm.cu) with respect to hw, s_src and
//         s_dst.  Per head, for destination v, its live edges e from
//         source u = src_e, and the forward's own values
//           x_e = s_src[u] + s_dst[v],  score_e = leaky_relu(x_e, 0.2),
//           m_v = max score,  p_e = exp(score_e - m_v),  ex_e = TA(p_e),
//           den_v = max(TA(sum ex_e), 1e-9),  alpha_e = TD(ex_e / den_v),
//           out_v = sum of alpha_e * hw[u]  (in TA, as the forward wrote it):
//           dalpha_e = <TD(dout[v]), hw[u]>        (over the head's values)
//           delta_v  = <TD(dout[v]), out_v>
//           da_e     = p_e * (dalpha_e - delta_v) / den_v,
//                      times 0.2 where score_e < 0 (leaky_relu's slope;
//                      1 at x_e == 0, as jax.nn.leaky_relu's where(x >= 0)
//                      gives it)
//           ds_dst[v] = sum of da_e over v's edges
//           ds_src[u] = sum of da_e over u's edges
//           dhw[u]    = sum of TD(dout[v]) * alpha_e over u's edges
//         every sum in float32, each gradient rounded to the model's type
//         TD once (ops.gat_aggregate_bwd_plain computes the same).  delta_v
//         is the softmax's sum of dalpha_e * alpha_e (flash attention's
//         "delta" = rowsum(dO * O)), taken from the forward's output, so
//         no walk over v's edges has to come first.  The reference's
//         autodiff passes a gradient through each of the forward's
//         roundings unchanged, and through the row max, where the terms
//         cancel: the sums here are that gradient.
//
// Neither has a TPU kernel: they are the gradient of segment_spmm_pallas
// (src/repro/kernels/segment_spmm/kernel.py), which the TPU package never
// differentiates, written for the port's training path.
//
// What bounds them.  "sum_bwd": bytes, or at small shapes the call.  It
// reads dout, perm and the row spans once and writes each edge's row
// once: at D = 64 f32 on ogbn-products' shape (E = 61,859,140) 16.7 GB,
// about 5.0 ms at 3.35 TB/s; at GraphCast's Cora-sized training shape
// (E = 10,556, D = 512, bf16) 13.7 MB, 0.004 ms, where a call's host
// time (about 0.02-0.04 ms on an H100 host) is most of its cost.
// "gat_bwd": bytes gathered at random.  Per edge it must read the dout
// row of its destination (for dalpha and dhw) and that row's per-head
// max, denominator, delta and s_dst, where the forward gathers hw[u]
// once: at GAT's first layer in bf16 about 300 bytes an edge, 18 GB a
// call at the products shape.  Its scores and weights are recomputed,
// not stored.
//
// Design.  "sum_bwd" walks the forward's plan: a group of lanes per
// destination row (a block for a hub row, whose edges its slots split),
// each lane loading its 16-byte vectors of dout[v] once and storing them
// to each of the row's edges, four edge ids loaded ahead of the stores.
// The stores are streaming (evict-first): at the products shape that
// took a call from 9.8 to 6.6 ms on an H100.  An edge-order grid (dst
// read in order, dout gathered per edge, dmsgs written contiguously)
// was timed beside it and was slower there, 11.7 ms, since dout (627 MB)
// does not stay in L2 and every edge's row came from device memory; at
// the Cora shape both take about 0.005 ms on the device.
// "gat_bwd" starts from what the forward saved (gat_aggregate_launch's m
// and den, and its output) and runs three kernels:
//  1. by node (N * H threads): delta_v from dout and the forward's output,
//     packed with m_v, den_v and s_dst[v] into one 16-byte record per
//     node and head; dout rounded to TD where the forward summed in
//     float32 and the model is bfloat16 (else the walk reads dout as it
//     is, converting exactly).
//  2. by source, over the source plan (ops.source_plan: each source's
//     edges, as positions of the forward's plan): a group of lanes per
//     source row u (a block for a hub row, whose edges its slots split),
//     each lane owning one 16-byte vector of hw[u] (one or two heads) and
//     its s_src values, loaded once.  Per edge it gathers the lane's
//     vector of dout[v] and v's records for its heads, recomputes score,
//     p and alpha, sums dhw[u] and ds_src[u] in edge order, each written
//     once, and writes da_e (0 for a masked edge), float32, at the edge's
//     position in the forward's plan with a streaming store.  Only the
//     lane that owns a head needs dalpha's sum over it: it adds the
//     partials of the lanes after it that hold the head, brought down by
//     shuffles (none where every head lies in one vector).  Four edges a
//     step, their ids loaded a step ahead; at most 128 registers, two
//     blocks an SM (three, or eight edges a step, were slower on an
//     H100, and L2 hints on the record loads changed nothing).
//  3. by destination, over the forward's plan: ds_dst[v] sums da over
//     v's positions, contiguous and in plan order, a thread per row and
//     head (a block for a hub row).
// A hub row's slots are combined in slot order, and no float add is
// atomic, so two calls give the same bits.
#include "segment_spmm.cuh"

namespace {

// ------------------------------------------------------------------------ //
// streaming (evict-first) stores
// ------------------------------------------------------------------------ //

// VEC values from a to p with a streaming store, rounded to p's type
template <int VEC>
__device__ __forceinline__ void store_cs(float* p, const float* a) {
  if constexpr (VEC == 1) {
    __stcs(p, a[0]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]));
  }
}
template <int VEC>
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, const float* a) {
  if constexpr (VEC == 1) {
    const __nv_bfloat16 h = __float2bfloat16_rn(a[0]);
    __stcs(reinterpret_cast<unsigned short*>(p),
           *reinterpret_cast<const unsigned short*>(&h));
  } else {
    static_assert(VEC == 4 || VEC == 8, "bf16 rows store 1, 4 or 8 values");
    uint32_t w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (VEC == 8) {
      __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
    } else {
      __stcs(reinterpret_cast<uint2*>(p), make_uint2(w[0], w[1]));
    }
  }
}

// ------------------------------------------------------------------------ //
// "sum_bwd"
// ------------------------------------------------------------------------ //

// Blocks [0, n_heavy) take one hub row each, its edges split among the
// block's kThreads / LPR slots; the others one row per group of LPR
// lanes, as the forward's grid.  Lane `sub` owns vectors sub, sub + LPR,
// ... of the row; for each, it loads dout's vector once and stores it to
// the row's edges (streaming stores), four edge ids loaded ahead.
template <typename TOut, typename TIn, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_bwd_kernel(const TOut* __restrict__ dout,
                       const int32_t* __restrict__ perm,
                       const int4* __restrict__ spans, int n_heavy,
                       TIn* __restrict__ dmsgs, long long n, int units,
                       int lpr_log2) {
  constexpr int U = 4;
  const long long D = (long long)units * VEC;
  const int lpr = 1 << lpr_log2;
  int4 sp;
  int sub, first = 0, step = 1;
  if ((int)blockIdx.x < n_heavy) {
    sp = __ldg(spans + blockIdx.x);   // (row, begin, end, 0)
    sub = threadIdx.x & (lpr - 1);
    first = threadIdx.x >> lpr_log2;
    step = kThreads >> lpr_log2;
  } else {
    const int lane = threadIdx.x & 31;
    const long long warp =
        ((long long)(blockIdx.x - n_heavy) * kThreads + threadIdx.x) >> 5;
    const long long idx =
        n_heavy + (warp << (5 - lpr_log2)) + (lane >> lpr_log2);
    if (idx >= n) return;
    sp = __ldg(spans + idx);
    sub = lane & (lpr - 1);
  }
  const TOut* drow = dout + sp.x * D;
  for (int c = sub; c < units; c += lpr) {
    float v[VEC];
    load<TOut, VEC>(drow + (long long)c * VEC, v);
    const long long off = (long long)c * VEC;
    int e = sp.y + first;
    for (; e + (U - 1) * step < sp.z; e += U * step) {
      int id[U];
#pragma unroll
      for (int u = 0; u < U; ++u) id[u] = __ldcs(perm + e + u * step);
#pragma unroll
      for (int u = 0; u < U; ++u)
        store_cs<VEC>(dmsgs + (long long)id[u] * D + off, v);
    }
    for (; e < sp.z; e += step)
      store_cs<VEC>(dmsgs + (long long)__ldcs(perm + e) * D + off, v);
  }
}

template <typename TOut, typename TIn, int VEC>
int launch_sum_bwd(const void* dout, const void* perm, const void* spans,
                   long long n_heavy, void* dmsgs, long long n, long long d,
                   cudaStream_t stream) {
  const int units = (int)(d / VEC);
  const int lpr_log2 = lanes_log2(units);
  const long long blocks = grid_blocks(n, lpr_log2, n_heavy);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  segment_sum_bwd_kernel<TOut, TIn, VEC>
      <<<dim3((unsigned)blocks), kThreads, 0, stream>>>(
          static_cast<const TOut*>(dout), static_cast<const int32_t*>(perm),
          static_cast<const int4*>(spans), (int)n_heavy,
          static_cast<TIn*>(dmsgs), n, units, lpr_log2);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------ //
// "gat_bwd", kernel 1: by node
// ------------------------------------------------------------------------ //

// Thread i = v * H + h: rec[i] = (m, den, delta, s_dst) of node v and
// head h, delta = sum over the head's values of TD(dout) * out in
// float32, in order; dout_td (null when the walk reads dout itself)
// gets TD(dout).
template <typename TD, typename TA>
__global__ void __launch_bounds__(kThreads)
gat_bwd_node_kernel(const TA* __restrict__ dout, const TA* __restrict__ out,
                    const float* __restrict__ m,
                    const float* __restrict__ den,
                    const TD* __restrict__ s_dst, TD* __restrict__ dout_td,
                    float4* __restrict__ rec, long long nh, int dout_dim) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nh) return;
  const long long base = i * dout_dim;
  float delta = 0.f;
  for (int k = 0; k < dout_dim; ++k) {
    float g, o;
    load<TA, 1>(dout + base + k, &g);
    load<TA, 1>(out + base + k, &o);
    g = round_to<TD>(g);
    if (dout_td != nullptr) store<1>(dout_td + base + k, &g);
    delta = __fadd_rn(delta, __fmul_rn(g, o));
  }
  float sd;
  load<TD, 1>(s_dst + i, &sd);
  rec[i] = make_float4(__ldg(m + i), __ldg(den + i), delta, sd);
}

// ------------------------------------------------------------------------ //
// "gat_bwd", kernel 2: by source
// ------------------------------------------------------------------------ //

// The ids of U edges e, e + step, ... of a source row: each one's
// position in the forward's plan (for every edge below `end`, so a
// masked edge's da can be written 0), its destination and whether it
// exists and is live; a lane that owns no vector (on = false) takes none.
template <int U>
struct SrcEdges {
  int pos[U], v[U];
  bool in[U], ok[U];
};

template <int U>
__device__ __forceinline__ void load_src_edges(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ vdst,
    const uint8_t* __restrict__ live, int e, int end, int step, bool on,
    SrcEdges<U>& x) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int ee = e + u * step;
    x.in[u] = on && ee < end;
    x.ok[u] = x.in[u] && __ldcs(live + ee) != 0;
    x.pos[u] = x.in[u] ? __ldcs(pos + ee) : 0;
    x.v[u] = x.in[u] ? __ldcs(vdst + ee) : 0;   // not waiting on live
  }
}

template <typename TD, typename TG>
struct WalkArgs {
  const TD* hw;            // (N, H * dout_dim)
  const TD* s_src;         // (N, H)
  const TG* dout;          // (N, H * dout_dim): TD(dout) as TG holds it
  const float4* rec;       // (N, H): m, den, delta, s_dst
  const int32_t* pos;      // source plan: positions in the forward's plan
  const int32_t* vdst;     //   their destinations
  const uint8_t* live;     //   their mask
  const int4* spans;       //   rows by out-degree
  int n_heavy;
  float* da;               // (E, H) in the forward's plan order
  TD* dhw;                 // (N, H * dout_dim)
  TD* ds_src;              // (N, H)
  int heads, dout_dim, units;
  int reach;               // most lanes after a head's first that hold it
};

// Blocks [0, n_heavy) each take one hub source row, spans[blockIdx.x],
// its edges split among the block's kThreads / LPR slots; the others one
// source row per group of LPR lanes, lane `sub` owning vector `sub`,
// which touches at most MAXH heads.  dalpha's sum over a head is needed
// only by the head's owner (the lane holding its first value, which
// writes da): it adds the partials of the `reach` lanes after it that
// hold the rest of the head, brought down by shuffles, in lane order
// (none where every head lies in one vector).  Every lane of a group
// runs those shuffles and stays to the end; a hub block meets at a
// barrier.
template <typename TD, typename TG, typename TA, int VEC, int MAXH>
__global__ void __launch_bounds__(kThreads, 2)
gat_bwd_src_kernel(WalkArgs<TD, TG> w, long long n, int lpr_log2) {
  constexpr int U = 4;
  const long long D = (long long)w.units * VEC;
  const int lpr = 1 << lpr_log2;
  const bool hub = (int)blockIdx.x < w.n_heavy;
  int4 sp;
  int sub, slot = 0, slots = 1;
  if (hub) {
    sp = __ldg(w.spans + blockIdx.x);
    slots = kThreads >> lpr_log2;
    slot = threadIdx.x >> lpr_log2;
    sub = threadIdx.x & (lpr - 1);
  } else {
    const int lane = threadIdx.x & 31;
    const long long warp =
        ((long long)(blockIdx.x - w.n_heavy) * kThreads + threadIdx.x) >> 5;
    const long long idx =
        w.n_heavy + (warp << (5 - lpr_log2)) + (lane >> lpr_log2);
    if (idx >= n) return;   // whole lane groups leave together
    sp = __ldg(w.spans + idx);
    sub = lane & (lpr - 1);
  }
  const long long row = sp.x;
  const GatLane L =
      lane_of<TD, VEC>(w.s_src, row, sub, w.heads, w.dout_dim, w.units);
  const bool on = L.nh > 0;
  // for each of the lane's heads it owns: how many lanes after it hold
  // the rest of the head (their first value is the head's)
  bool owner[MAXH];
  int more[MAXH];
#pragma unroll
  for (int j = 0; j < MAXH; ++j) {
    owner[j] = head_owner<VEC>(L, j, w.dout_dim);
    more[j] = owner[j] ? ((L.h0 + j + 1) * w.dout_dim - 1) / VEC - sub : 0;
  }
  const unsigned mask =
      lpr == 32 ? 0xffffffffu
                : ((1u << lpr) - 1u) << ((threadIdx.x & 31) & ~(lpr - 1));
  Packed<TD, VEC> h;
  if (on) h.load(w.hw + row * D + (long long)sub * VEC);
  float acc[VEC], ds[MAXH];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
  for (int j = 0; j < MAXH; ++j) ds[j] = 0.f;

  SrcEdges<U> cur, nxt;
  load_src_edges<U>(w.pos, w.vdst, w.live, sp.y + slot, sp.z, slots, on,
                    cur);
  for (int e = sp.y + slot; e < sp.z; e += U * slots) {
    load_src_edges<U>(w.pos, w.vdst, w.live, e + U * slots, sp.z, slots, on,
                      nxt);
    Packed<TG, VEC> g[U];
    float4 r[U][MAXH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!cur.ok[u]) continue;
      const long long v = cur.v[u];
      g[u].load(w.dout + v * D + (long long)sub * VEC);
#pragma unroll
      for (int j = 0; j < MAXH; ++j)
        if (j < L.nh) r[u][j] = __ldg(w.rec + v * w.heads + L.h0 + j);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // dalpha: the lane's partial sums by head, then the owner's totals
      float p[MAXH];
#pragma unroll
      for (int j = 0; j < MAXH; ++j) p[j] = 0.f;
      if (cur.ok[u]) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float x = __fmul_rn(g[u].at(k), h.at(k));
          if (MAXH > 1 && ((L.second >> k) & 1u))
            p[MAXH - 1] = __fadd_rn(p[MAXH - 1], x);
          else
            p[0] = __fadd_rn(p[0], x);
        }
      }
      float tot[MAXH];
#pragma unroll
      for (int j = 0; j < MAXH; ++j) tot[j] = p[j];
      for (int k = 1; k <= w.reach; ++k) {
        const float q = __shfl_down_sync(mask, p[0], k, lpr);
#pragma unroll
        for (int j = 0; j < MAXH; ++j)
          if (k <= more[j]) tot[j] = __fadd_rn(tot[j], q);
      }
      if (!cur.in[u]) continue;
      const long long base = (long long)cur.pos[u] * w.heads + L.h0;
      float alpha[MAXH];
#pragma unroll
      for (int j = 0; j < MAXH; ++j) {
        alpha[j] = 0.f;
        if (j >= L.nh) continue;
        float da = 0.f;
        if (cur.ok[u]) {
          const float4 q = r[u][j];   // (m, den, delta, s_dst)
          const float sc = gat_score<TD>(L.sd[j], q.w);
          const float pe = expf(__fsub_rn(sc, q.x));
          alpha[j] = round_to<TD>(__fdiv_rn(round_to<TA>(pe), q.y));
          if (owner[j]) {
            const float d =
                __fdiv_rn(__fmul_rn(pe, __fsub_rn(tot[j], q.z)), q.y);
            da = sc >= 0.f ? d : __fmul_rn(d, 0.2f);
          }
        }
        if (owner[j]) {
          __stcs(w.da + base + j, da);
          ds[j] = __fadd_rn(ds[j], da);
        }
      }
      if (!cur.ok[u]) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] = __fadd_rn(
            acc[k],
            __fmul_rn(g[u].at(k), MAXH > 1 && ((L.second >> k) & 1u)
                                      ? alpha[MAXH - 1]
                                      : alpha[0]));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur.pos[u] = nxt.pos[u];
      cur.v[u] = nxt.v[u];
      cur.in[u] = nxt.in[u];
      cur.ok[u] = nxt.ok[u];
    }
  }
  if (hub) {
    // the slots' partials, combined in slot order
    constexpr int W = VEC + MAXH;
    __shared__ float part[kThreads * W];
#pragma unroll
    for (int k = 0; k < VEC; ++k) part[threadIdx.x * W + k] = acc[k];
#pragma unroll
    for (int j = 0; j < MAXH; ++j) part[threadIdx.x * W + VEC + j] = ds[j];
    __syncthreads();
    if (slot != 0) return;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      float s = 0.f;
      for (int q = 0; q < slots; ++q)
        s = __fadd_rn(s, part[(q * lpr + sub) * W + k]);
      if (k < VEC)
        acc[k] = s;
      else
        ds[k - VEC] = s;
    }
  }
  if (!on) return;
  store<VEC>(w.dhw + row * D + (long long)sub * VEC, acc);
#pragma unroll
  for (int j = 0; j < MAXH; ++j)
    if (owner[j]) store<1>(w.ds_src + row * w.heads + L.h0 + j, &ds[j]);
}

// ------------------------------------------------------------------------ //
// "gat_bwd", kernel 3: ds_dst by destination
// ------------------------------------------------------------------------ //

// Blocks [0, n_heavy) each take one hub row of the forward's plan, thread
// t summing head t % H over every (kThreads / H)-th of the row's edges,
// the slots then added in order; the others one (row, head) a thread,
// the rows of spans[n_heavy:] in turn: ds_dst[v, h] = the sum of da over
// v's positions in order.
template <typename TD>
__global__ void __launch_bounds__(kThreads)
gat_bwd_dst_kernel(const float* __restrict__ da,
                   const int4* __restrict__ spans, int n_heavy,
                   TD* __restrict__ ds_dst, long long n, int heads) {
  constexpr int U = 4;
  if ((int)blockIdx.x < n_heavy) {
    __shared__ float part[kThreads];
    const int4 sp = __ldg(spans + blockIdx.x);
    const int slots = kThreads / heads;
    const int slot = threadIdx.x / heads, h = threadIdx.x % heads;
    float s = 0.f;
    if (slot < slots)
      for (int e = sp.y + slot; e < sp.z; e += slots)
        s = __fadd_rn(s, __ldcs(da + (long long)e * heads + h));
    part[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < heads) {
      float t = 0.f;
      for (int q = 0; q < slots; ++q)
        t = __fadd_rn(t, part[q * heads + threadIdx.x]);
      store<1>(ds_dst + (long long)sp.x * heads + threadIdx.x, &t);
    }
    return;
  }
  const long long i =
      (long long)(blockIdx.x - n_heavy) * kThreads + threadIdx.x;
  const long long idx = n_heavy + i / heads;
  if (idx >= n) return;
  const int h = (int)(i % heads);
  const int4 sp = __ldg(spans + idx);
  float s = 0.f;
  int e = sp.y;
  for (; e + U <= sp.z; e += U) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u] = __ldcs(da + (long long)(e + u) * heads + h);
#pragma unroll
    for (int u = 0; u < U; ++u) s = __fadd_rn(s, x[u]);
  }
  for (; e < sp.z; ++e) s = __fadd_rn(s, __ldcs(da + (long long)e * heads + h));
  store<1>(ds_dst + (long long)sp.x * heads + h, &s);
}

// The three kernels on `stream`.  `w` names dout (in TA: the walk reads
// the node kernel's rounded copy dout_td instead where TD is bf16 and TA
// f32; a bf16 dout of an f32 model converts exactly, and f32 stays f32).
template <typename TD, typename TA, int VEC>
int launch_gat_bwd(WalkArgs<TD, TA> w, const float* m, const float* den,
                   const TA* out, const TD* s_dst, TD* dout_td, float4* rec,
                   const int4* spans, long long n_heavy, TD* ds_dst,
                   long long n, cudaStream_t stream) {
  constexpr bool kRound = std::is_same<TD, __nv_bfloat16>::value &&
                          std::is_same<TA, float>::value;
  using TG = typename std::conditional<std::is_same<TD, float>::value &&
                                           std::is_same<TA, float>::value,
                                       float, __nv_bfloat16>::type;
  const long long nh = n * w.heads;
  const int lpr_log2 = lanes_log2(w.units);
  const long long blocks_n = (nh + kThreads - 1) / kThreads;
  const long long blocks_t = grid_blocks(n, lpr_log2, w.n_heavy);
  const long long blocks_d = n_heavy + blocks_n;
  if (blocks_t > 0x7fffffffLL || blocks_d > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  gat_bwd_node_kernel<TD, TA>
      <<<dim3((unsigned)blocks_n), kThreads, 0, stream>>>(
          w.dout, out, m, den, s_dst, kRound ? dout_td : nullptr, rec, nh,
          w.dout_dim);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  WalkArgs<TD, TG> t{w.hw, w.s_src,
                     kRound ? reinterpret_cast<const TG*>(dout_td)
                            : reinterpret_cast<const TG*>(w.dout),
                     rec, w.pos, w.vdst, w.live, w.spans, w.n_heavy, w.da,
                     w.dhw, w.ds_src, w.heads, w.dout_dim, w.units, 0};
  for (int hd = 0; hd < t.heads; ++hd) {
    const int r = ((hd + 1) * t.dout_dim - 1) / VEC - (hd * t.dout_dim) / VEC;
    if (r > t.reach) t.reach = r;
  }
  const dim3 grid_t((unsigned)blocks_t);
  // two heads in some lane's vector where heads straddle vectors or two
  // fit in one; one where each vector lies in one head
  bool two = false;
  if constexpr (VEC > 1)
    two = VEC % t.dout_dim != 0 ? t.dout_dim % VEC != 0 : t.dout_dim < VEC;
  if constexpr (VEC > 1) {
    if (two)
      gat_bwd_src_kernel<TD, TG, TA, VEC, 2>
          <<<grid_t, kThreads, 0, stream>>>(t, n, lpr_log2);
  }
  if (!two)
    gat_bwd_src_kernel<TD, TG, TA, VEC, 1>
        <<<grid_t, kThreads, 0, stream>>>(t, n, lpr_log2);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  gat_bwd_dst_kernel<TD><<<dim3((unsigned)blocks_d), kThreads, 0, stream>>>(
      w.da, spans, (int)n_heavy, ds_dst, n, w.heads);
  return (int)cudaGetLastError();
}

}  // namespace

// "sum_bwd".  dout (n, D) float32 (dout_bf16 = 0) or bfloat16 (1); perm,
// spans and n_heavy the forward's plan (segment_spmm_launch); dmsgs (E, D)
// float32 (msgs_bf16 = 0) or bfloat16 (1; a bfloat16 dout only with
// bfloat16 messages): dmsgs[e] = dout[dst[e]] rounded to its type.  All
// contiguous on the current device, n >= 1, D >= 1.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int segment_spmm_bwd_launch(const void* dout, const void* perm,
                                       const void* spans, long long n_heavy,
                                       void* dmsgs, long long n, long long d,
                                       int dout_bf16, int msgs_bf16,
                                       void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(dout) && aligned16(dmsgs);
  using bf16 = __nv_bfloat16;
  const auto go = [&](auto o, auto in, auto vec) {
    return launch_sum_bwd<decltype(o), decltype(in), decltype(vec)::value>(
        dout, perm, spans, n_heavy, dmsgs, n, d, s);
  };
  using V1 = std::integral_constant<int, 1>;
  using V4 = std::integral_constant<int, 4>;
  using V8 = std::integral_constant<int, 8>;
  if (!msgs_bf16) {
    if (dout_bf16) return (int)cudaErrorInvalidValue;
    return vec_ok && d % 4 == 0 ? go(0.f, 0.f, V4()) : go(0.f, 0.f, V1());
  }
  if (dout_bf16)
    return vec_ok && d % 8 == 0 ? go(bf16(), bf16(), V8())
                                : go(bf16(), bf16(), V1());
  return vec_ok && d % 8 == 0 ? go(0.f, bf16(), V8()) : go(0.f, bf16(), V1());
}

// "gat_bwd".  hw (N, heads * dout), s_src and s_dst (N, heads), float32
// (td_bf16 = 0) or bfloat16 (1); m, den (N, heads) float32, the forward's
// saved row statistics (gat_aggregate_launch), and out (N, heads * dout),
// its output, float32 (ta_bf16 = 0) or bfloat16 (1); dout, the gradient
// of out, in out's type; spans, n_heavy the forward's plan; pos, vdst
// (E,) int32, live_t (E,) bytes, spans_t (N, 4) int32 and n_heavy_t the
// source plan over the forward plan's edge positions (ops.source_plan).
// Scratch: rec (N, heads) of 16 bytes, dout_td (N, heads * dout) in hw's
// type (used only when hw is bfloat16 and out float32), da (E, heads)
// float32.  dhw (N, heads * dout), ds_src, ds_dst (N, heads) in hw's
// type, written whole.  The forward's shape limits hold (the wrapper
// checks first).  Launches the three kernels on `stream` and returns
// cudaGetLastError().  Does not synchronise.
extern "C" int gat_bwd_launch(const void* hw, const void* s_src,
                              const void* s_dst, const void* m,
                              const void* den, const void* out,
                              const void* dout, const void* spans,
                              long long n_heavy, const void* pos,
                              const void* vdst, const void* live_t,
                              const void* spans_t, long long n_heavy_t,
                              void* rec, void* dout_td, void* da, void* dhw,
                              void* ds_src, void* ds_dst, long long n,
                              int heads, int dout_dim, int td_bf16,
                              int ta_bf16, void* stream) {
  if (n <= 0 || heads <= 0 || dout_dim <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(hw) && aligned16(dout) && aligned16(dhw) &&
                      (dout_td == nullptr || aligned16(dout_td));
  const auto go = [&](auto td, auto ta) {
    using TD = decltype(td);
    using TA = decltype(ta);
    constexpr int V = 16 / sizeof(TD);
    const long long d = (long long)heads * dout_dim;
    WalkArgs<TD, TA> w{static_cast<const TD*>(hw),
                       static_cast<const TD*>(s_src),
                       static_cast<const TA*>(dout),
                       static_cast<const float4*>(rec),
                       static_cast<const int32_t*>(pos),
                       static_cast<const int32_t*>(vdst),
                       static_cast<const uint8_t*>(live_t),
                       static_cast<const int4*>(spans_t),
                       (int)n_heavy_t,
                       static_cast<float*>(da),
                       static_cast<TD*>(dhw),
                       static_cast<TD*>(ds_src),
                       heads, dout_dim, 0, 0};
    const auto run = [&](auto vec) {
      return launch_gat_bwd<TD, TA, decltype(vec)::value>(
          w, static_cast<const float*>(m), static_cast<const float*>(den),
          static_cast<const TA*>(out), static_cast<const TD*>(s_dst),
          static_cast<TD*>(dout_td), static_cast<float4*>(rec),
          static_cast<const int4*>(spans), n_heavy,
          static_cast<TD*>(ds_dst), n, s);
    };
    if (vec_ok && d % V == 0) {
      w.units = (int)(d / V);
      if (w.units > kMaxUnits) return (int)cudaErrorInvalidValue;
      for (int c = 0; c < w.units; ++c)
        if ((c * V + V - 1) / dout_dim - (c * V) / dout_dim >= kMaxHeads)
          return (int)cudaErrorInvalidValue;
      return run(std::integral_constant<int, V>());
    }
    w.units = (int)d;
    if (w.units > kMaxUnits) return (int)cudaErrorInvalidValue;
    return run(std::integral_constant<int, 1>());
  };
  using bf16 = __nv_bfloat16;
  if (td_bf16) return ta_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.f);
  return ta_bf16 ? go(0.f, bf16()) : go(0.f, 0.f);
}
