// Segment sums by destination for Hopper (sm_90a), in two variants.
//
// "sum":  out[v] = sum of msgs[e] over the edges e with dst[e] == v
//         for msgs (E, D) float32 or bfloat16, summed in float32, written
//         as float32 or bfloat16.  It is the GNN message aggregation of
//         every `_seg_sum` in the model zoo (GraphCast, SchNet, PNA).
// "gat":  one GAT layer's edge softmax and aggregation, fused: for each
//         destination v and head h, from the node rows hw (N, H, dout)
//         and the per-node scores s_src, s_dst (N, H),
//           score_e = leaky_relu(s_src[src_e, h] + s_dst[v, h], 0.2)
//           alpha_e = exp(score_e - max score) / sum of exp(...)
//           out[v, h] = sum of alpha_e * hw[src_e, h]
//         over v's live edges, with every rounding of the plain version
//         (ops.gat_aggregate_plain) repeated: see gat_row below.
//
// Replaces the TPU kernel segment_spmm_pallas
// (src/repro/kernels/segment_spmm/kernel.py) with its function, not its
// form.  The TPU sorts edges into destination tiles on the host and turns
// each tile's scatter into one_hot(dst_local)^T @ msgs on the MXU: a
// product that multiplies by zero for (TN - 1)/TN of its work, and that
// needs the (E, ...) messages written out first, so GAT's scores,
// exponentials, weights and messages were edge-sized tensors.  Here the
// edges come as a CSR plan built once per graph (ops.segment_plan): a
// stable sort of the edges by destination, `perm`, and `rowptr` (n + 1),
// so destination v owns the edges perm[rowptr[v] : rowptr[v + 1]]; for
// GAT also src_sorted = edge_src[perm] and live_sorted = edge_mask[perm].
//
// What bounds it: bytes.  "sum" reads each message once, perm and the
// row spans once, and writes each output row once: at GAT-sized messages
// on ogbn-products' shape (E = 61,859,140, D = 64, f32 in and out,
// N = 2,449,029) that is 16.7 GB, about 5.0 ms at 3.35 TB/s.  "gat" writes
// no edge-sized tensor at all.  A three-pass design that gathers each
// edge's source id, live byte and s_src row in every pass and its hw row
// in the last reads about (4 + 1 + 16) * 3 + 128 = 191 bytes an edge at
// GAT's first layer in bf16 (11.8 GB, 3.5 ms): the "gather-once" bound
// (the score cache below saves most of the s_src rows after the first).
//
// Design.  Each destination row belongs to a group of LPR lanes of one
// warp (LPR the smallest power of two >= the row's 16-byte vectors, at
// most 32), so narrow rows pack several rows into a warp and no lane
// idles.  The lanes run across the row with 16-byte loads (4 f32 or 8
// bf16 values) and gather each source row through the plan, so nothing is
// permuted into a copy; a row whose bytes are not a multiple of 16 (PNA's
// D = 75) takes scalar loads, still coalesced across lanes.  Sums live in
// f32 registers, several edges are loaded ahead of the adds (their ids
// one step earlier still), and each output row is written once; an empty
// row writes 0.  In "gat" a lane owns one vector of the row, so one or
// two heads: it keeps its heads' running max and denominator in
// registers through three passes over the row's edges (max, denominator,
// weighted sum).  The first pass computes each edge's score from the
// gathered s_src row and keeps the lane's first kCache scores in shared
// memory for the later passes, which recompute only the scores of longer
// rows' later edges; only the last pass reads hw.
//
// Hub rows.  A power-law graph's largest in-degree (16,961 on the
// products-sized graph) would keep one lane group busy long after every
// other row is done.  So the plan lists the rows whose in-degree is above
// a threshold (ops.HUB_DEGREE), and each such row gets a whole block of
// its own, scheduled first (the first blocks of the grid): the block's
// kThreads / LPR lane groups ("slots") take every slots-th edge of the
// row, and their partial maxima, denominators and sums are combined
// through shared memory in slot order.  The other rows go to lane groups
// in the plan's order, by in-degree, largest first: the longest rows
// start first, and the rows that share a warp have about the same length,
// so no lane group waits long on another.  The plan's `spans` list each
// row in that order with its first and end edge, so a lane group finds
// its row's edges in one 16-byte load.
//
// Every add runs in a fixed order, with no atomics, so a run repeats bit
// for bit: a row's own edges in the plan's (stable) edge order, and for a
// hub row each slot's edges in order and then the slots in order.
//
// The loads, stores, roundings and GAT score passes live in
// segment_spmm.cuh, which the backward kernels (segment_spmm_bwd.cu)
// share.
#include "segment_spmm.cuh"

namespace {

// ------------------------------------------------------------------------ //
// "sum"
// ------------------------------------------------------------------------ //

// One hub row, by the whole block: slot s of the block's kThreads / LPR
// lane groups sums the edges beg + s, beg + s + slots, ... in that order,
// UNROLL of them loaded ahead of the adds; the slots' sums are added in
// slot order through shared memory.  The row's vectors are taken LPR at a
// time.
template <typename TIn, typename TOut, int VEC, int UNROLL>
__device__ void hub_sum(const TIn* __restrict__ msgs,
                        const int32_t* __restrict__ perm, int beg, int end,
                        TOut* __restrict__ orow, int units, int lpr_log2) {
  __shared__ float part[kThreads * kMaxVec];
  const int lpr = 1 << lpr_log2;
  const int slots = kThreads >> lpr_log2;
  const int slot = threadIdx.x >> lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const long long D = (long long)units * VEC;
  for (int c0 = 0; c0 < units; c0 += lpr) {
    const int c = c0 + sub;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    if (c < units) {
      for (int e = beg + slot; e < end; e += UNROLL * slots) {
        int id[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int ee = e + u * slots;
          id[u] = ee < end ? __ldg(perm + ee) : -1;
        }
        float v[UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (id[u] >= 0)
            load<TIn, VEC>(msgs + (long long)id[u] * D + (long long)c * VEC,
                           v[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (id[u] >= 0)
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) part[threadIdx.x * VEC + k] = acc[k];
    __syncthreads();
    for (int i = threadIdx.x; i < lpr * VEC; i += kThreads) {
      const int s = i / VEC;
      if (c0 + s < units) {
        float t = 0.f;
        for (int j = 0; j < slots; ++j) t += part[j * lpr * VEC + i];
        store<1>(orow + (long long)c0 * VEC + i, &t);
      }
    }
    __syncthreads();
  }
}

// Blocks [0, n_heavy) each take one hub row, spans[blockIdx.x]; the
// others take one destination row per group of (1 << lpr_log2) lanes, the
// rows of spans[n_heavy:] in turn.  A row has `units` vectors of VEC values;
// lane `sub`
// of the group owns vectors sub, sub + LPR, ..., ITEMS of them per pass
// over the row's edges (a row wider than LPR * ITEMS vectors takes
// several passes).  UNROLL edges are loaded before they are added, in
// edge order: ITEMS * UNROLL = 8 keeps 8 loads of 16 bytes in flight per
// lane.
template <typename TIn, typename TOut, int VEC, int ITEMS, int UNROLL>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const TIn* __restrict__ msgs,
                   const int32_t* __restrict__ perm,
                   const int4* __restrict__ spans, int n_heavy,
                   TOut* __restrict__ out, long long n, int units,
                   int lpr_log2) {
  const long long D = (long long)units * VEC;
  if ((int)blockIdx.x < n_heavy) {
    const int4 sp = __ldg(spans + blockIdx.x);   // (row, begin, end, 0)
    hub_sum<TIn, TOut, VEC, 4>(msgs, perm, sp.y, sp.z, out + sp.x * D, units,
                               lpr_log2);
    return;
  }
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)(blockIdx.x - n_heavy) * kThreads + threadIdx.x) >> 5;
  const long long idx =
      n_heavy + (warp << (5 - lpr_log2)) + (lane >> lpr_log2);
  if (idx >= n) return;
  const int4 sp = __ldg(spans + idx);
  const int sub = lane & (lpr - 1);
  const int beg = sp.y, end = sp.z;
  TOut* orow = out + sp.x * D;

  for (int c0 = sub; c0 < units; c0 += lpr * ITEMS) {
    float acc[ITEMS][VEC];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[i][k] = 0.f;

    // the ids of the next UNROLL edges are loaded one step ahead, so a
    // step waits for its message loads only, not for perm first
    int e = beg;
    int next[UNROLL];
    if (e + UNROLL <= end) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) next[u] = __ldg(perm + e + u);
    }
    for (; e + UNROLL <= end; e += UNROLL) {
      int cur[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) cur[u] = next[u];
      if (e + 2 * UNROLL <= end) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          next[u] = __ldg(perm + e + UNROLL + u);
      }
      float v[UNROLL][ITEMS][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const TIn* src = msgs + (long long)cur[u] * D;
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          const int c = c0 + i * lpr;
          if (c < units) load<TIn, VEC>(src + (long long)c * VEC, v[u][i]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < ITEMS; ++i)
          if (c0 + i * lpr < units)
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[i][k] += v[u][i][k];
    }
    for (; e < end; ++e) {
      const TIn* src = msgs + (long long)__ldg(perm + e) * D;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int c = c0 + i * lpr;
        if (c < units) {
          float v[VEC];
          load<TIn, VEC>(src + (long long)c * VEC, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[i][k] += v[k];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = c0 + i * lpr;
      if (c < units) store<VEC>(orow + (long long)c * VEC, acc[i]);
    }
  }
}

template <typename TIn, typename TOut, int VEC>
int launch_sum(const void* msgs, const void* perm, const void* spans,
               long long n_heavy, void* out,
               long long n, long long d, cudaStream_t stream) {
  const int units = (int)(d / VEC);
  const int lpr_log2 = lanes_log2(units);
  const int per_lane = (units + (1 << lpr_log2) - 1) >> lpr_log2;
  const long long blocks = grid_blocks(n, lpr_log2, n_heavy);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const auto* m = static_cast<const TIn*>(msgs);
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* sp = static_cast<const int4*>(spans);
  auto* o = static_cast<TOut*>(out);
  const dim3 grid((unsigned)blocks);
  const int nh = (int)n_heavy;
  if (per_lane <= 1) {
    segment_sum_kernel<TIn, TOut, VEC, 1, 8><<<grid, kThreads, 0, stream>>>(
        m, p, sp, nh, o, n, units, lpr_log2);
  } else if (per_lane <= 2) {
    segment_sum_kernel<TIn, TOut, VEC, 2, 4><<<grid, kThreads, 0, stream>>>(
        m, p, sp, nh, o, n, units, lpr_log2);
  } else if (per_lane <= 4) {
    segment_sum_kernel<TIn, TOut, VEC, 4, 2><<<grid, kThreads, 0, stream>>>(
        m, p, sp, nh, o, n, units, lpr_log2);
  } else {
    segment_sum_kernel<TIn, TOut, VEC, 8, 1><<<grid, kThreads, 0, stream>>>(
        m, p, sp, nh, o, n, units, lpr_log2);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------ //
// "gat"
// ------------------------------------------------------------------------ //

// The three passes over one destination row's edges e0, e0 + step, ...
// < end, for one lane: acc ends as the lane's vector of out[v], in f32.
// COMBINE(kind, values) merges the lanes' partial maxima (kind 0) and
// denominators (kind 1) across the block's slots for a hub row (nothing
// for a row of one lane group).  A row without a live edge ends with
// acc = 0.  A step takes 8 edges in the score passes and 4 in the
// weighted sum, where each edge's vector of hw stays packed until used:
// enough loads in flight at 3 blocks of 256 threads an SM.  With STATS,
// `stats` holds the row's (H,) slices of the saved max and denominator
// (or null, for a hub row's slots other than 0): the lane writes the
// final m and den of the heads whose first value it holds, the
// backward's starting point.  Without, the kernel is what serving runs.
template <typename TD, typename TA, int VEC, bool STATS, typename Combine>
__device__ __forceinline__ void gat_row(const GatArgs<TD>& g,
                                        const GatLane& L, int e0, int end,
                                        int step, float* cache,
                                        float (&acc)[VEC], Combine combine,
                                        GatStats stats) {
  constexpr int kScoreEdges = 8;
  constexpr int kRowEdges = 4;
  float m[kMaxHeads], den[kMaxHeads];
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j) {
    m[j] = -INFINITY;
    den[j] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  gat_pass<0, kScoreEdges, TD, TA, VEC>(g, L, e0, end, step, cache, m, den,
                                        acc);
  combine(0, m);
  gat_pass<1, kScoreEdges, TD, TA, VEC>(g, L, e0, end, step, cache, m, den,
                                        acc);
  combine(1, den);
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j) {
    den[j] = fmaxf(round_to<TA>(den[j]), 1e-9f);
    if constexpr (STATS) {
      if (stats.m != nullptr && head_owner<VEC>(L, j, g.dout)) {
        stats.m[L.h0 + j] = m[j];
        stats.den[L.h0 + j] = den[j];
      }
    }
  }
  gat_pass<2, kRowEdges, TD, TA, VEC>(g, L, e0, end, step, cache, m, den,
                                     acc);
}

// Blocks [0, n_heavy) each take one hub row, spans[blockIdx.x]; the
// others one row per group of (1 << lpr_log2) lanes, lane `sub` owning
// vector `sub`, the rows of spans[n_heavy:] in turn.  With STATS,
// `stats` (N, H) each gets the rows' max and denominator (a hub row's
// slot 0 writes them).
template <typename TD, typename TA, int VEC, bool STATS>
__global__ void __launch_bounds__(kThreads, 3)
gat_aggregate_kernel(GatArgs<TD> g, const int4* __restrict__ spans,
                     int n_heavy, TA* __restrict__ out, GatStats stats,
                     long long n, int lpr_log2) {
  const long long D = (long long)g.units * VEC;
  const int lpr = 1 << lpr_log2;
  __shared__ float cache[kCache * kMaxHeads * kThreads];
  if ((int)blockIdx.x < n_heavy) {
    // a hub row: slot `slot` of the block takes every slots-th edge; the
    // partials meet in shared memory and are combined in slot order, by
    // every lane alike, so all slots go on with the same max and
    // denominator
    __shared__ float part[kThreads * kMaxVec];
    const int slots = kThreads >> lpr_log2;
    const int slot = threadIdx.x >> lpr_log2;
    const int sub = threadIdx.x & (lpr - 1);
    const int4 sp = __ldg(spans + blockIdx.x);   // (row, begin, end, 0)
    const long long row = sp.x;
    const GatLane L = gat_lane<TD, VEC>(g, row, sub);
    const auto combine = [&](int kind, float(&x)[kMaxHeads]) {
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j)
        part[threadIdx.x * kMaxHeads + j] = x[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j) {
        float t = kind == 0 ? -INFINITY : 0.f;
        for (int s = 0; s < slots; ++s) {
          const float y = part[(s * lpr + sub) * kMaxHeads + j];
          t = kind == 0 ? fmaxf(t, y) : __fadd_rn(t, y);
        }
        x[j] = t;
      }
      __syncthreads();
    };
    float acc[VEC];
    gat_row<TD, TA, VEC, STATS>(
        g, L, sp.y + slot, sp.z, slots, cache + threadIdx.x, acc, combine,
        slot == 0 ? stats.row(row, g.heads) : GatStats{});
#pragma unroll
    for (int k = 0; k < VEC; ++k) part[threadIdx.x * VEC + k] = acc[k];
    __syncthreads();
    for (int i = threadIdx.x; i < g.units * VEC; i += kThreads) {
      float t = 0.f;
      for (int s = 0; s < slots; ++s)
        t = __fadd_rn(t, part[s * lpr * VEC + i]);
      store<1>(out + row * D + i, &t);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)(blockIdx.x - n_heavy) * kThreads + threadIdx.x) >> 5;
  const long long idx =
      n_heavy + (warp << (5 - lpr_log2)) + (lane >> lpr_log2);
  const int sub = lane & (lpr - 1);
  if (idx >= n || sub >= g.units) return;
  const int4 sp = __ldg(spans + idx);
  const long long row = sp.x;
  const GatLane L = gat_lane<TD, VEC>(g, row, sub);
  float acc[VEC];
  gat_row<TD, TA, VEC, STATS>(g, L, sp.y, sp.z, 1, cache + threadIdx.x,
                              acc, [](int, float(&)[kMaxHeads]) {},
                              stats.row(row, g.heads));
  store<VEC>(out + row * D + (long long)sub * VEC, acc);
}

template <typename TD, typename TA, int VEC>
int launch_gat(const GatArgs<TD>& g, const void* spans, long long n_heavy,
               void* out, GatStats stats, long long n,
               cudaStream_t stream) {
  const int lpr_log2 = lanes_log2(g.units);
  const long long blocks = grid_blocks(n, lpr_log2, n_heavy);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  if (stats.m != nullptr)
    gat_aggregate_kernel<TD, TA, VEC, true><<<grid, kThreads, 0, stream>>>(
        g, static_cast<const int4*>(spans), (int)n_heavy,
        static_cast<TA*>(out), stats, n, lpr_log2);
  else
    gat_aggregate_kernel<TD, TA, VEC, false><<<grid, kThreads, 0, stream>>>(
        g, static_cast<const int4*>(spans), (int)n_heavy,
        static_cast<TA*>(out), stats, n, lpr_log2);
  return (int)cudaGetLastError();
}

template <typename TD, typename TA>
int dispatch_gat(const void* hw, const void* s_src, const void* s_dst,
                 const void* src, const void* live, const void* spans,
                 long long n_heavy, void* out, GatStats stats, long long n,
                 int heads, int dout, bool vec_ok, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TD);
  const long long d = (long long)heads * dout;
  GatArgs<TD> g{static_cast<const TD*>(hw), static_cast<const TD*>(s_src),
                static_cast<const TD*>(s_dst),
                static_cast<const int32_t*>(src),
                static_cast<const uint8_t*>(live), heads, dout, 0};
  if (vec_ok && d % V == 0) {
    g.units = (int)(d / V);
    if (g.units > kMaxUnits) return (int)cudaErrorInvalidValue;
    for (int c = 0; c < g.units; ++c)
      if ((c * V + V - 1) / dout - (c * V) / dout >= kMaxHeads)
        return (int)cudaErrorInvalidValue;
    return launch_gat<TD, TA, V>(g, spans, n_heavy, out, stats, n, stream);
  }
  g.units = (int)d;
  if (g.units > kMaxUnits) return (int)cudaErrorInvalidValue;
  return launch_gat<TD, TA, 1>(g, spans, n_heavy, out, stats, n, stream);
}

}  // namespace

// "sum".  msgs (E, D) float32 (in_bf16 = 0) or bfloat16 (1); perm (E,)
// int32, the edges sorted stably by destination; spans (n, 4) int32, every
// row once as (row, its first edge in perm, its end edge, 0), 16-byte
// aligned, the first n_heavy the hub rows (the plan lists the rows by
// in-degree, largest first); out (n, D) float32 (out_bf16 = 0) or
// bfloat16 (1, only for bfloat16 messages).  All contiguous on the
// current device, n >= 1, D >= 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int segment_spmm_launch(const void* msgs, const void* perm,
                                   const void* spans, long long n_heavy,
                                   void* out, long long n, long long d,
                                   int in_bf16, int out_bf16, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(msgs) && aligned16(out);
  using bf16 = __nv_bfloat16;
  const auto go = [&](auto in, auto o, auto vec) {
    using TIn = decltype(in);
    using TOut = decltype(o);
    return launch_sum<TIn, TOut, decltype(vec)::value>(
        msgs, perm, spans, n_heavy, out, n, d, s);
  };
  using V1 = std::integral_constant<int, 1>;
  using V4 = std::integral_constant<int, 4>;
  using V8 = std::integral_constant<int, 8>;
  if (!in_bf16) {
    if (out_bf16) return (int)cudaErrorInvalidValue;
    return vec_ok && d % 4 == 0 ? go(0.f, 0.f, V4()) : go(0.f, 0.f, V1());
  }
  if (out_bf16)
    return vec_ok && d % 8 == 0 ? go(bf16(), bf16(), V8())
                                : go(bf16(), bf16(), V1());
  return vec_ok && d % 8 == 0 ? go(bf16(), 0.f, V8()) : go(bf16(), 0.f, V1());
}

// "gat".  hw (N, heads * dout), s_src and s_dst (N, heads), all float32
// (td_bf16 = 0) or bfloat16 (1); src (E,) int32 = edge_src[perm]; live
// (E,) one byte per edge, edge_mask[perm]; spans, n_heavy as for "sum";
// out (N, heads * dout) float32 (ta_bf16 = 0) or bfloat16 (1); m, den
// (N, heads) float32, both null or both given: each row's and head's
// max score and clamped denominator, which "gat_bwd" starts from (-inf
// and 1e-9 for a row without a live edge).  A row of heads * dout
// values takes at most 32 vectors (16 bytes each, or single values when
// the row is not a multiple of 16 bytes), and a vector may touch at most
// 2 heads: other shapes return
// cudaErrorInvalidValue (the wrapper checks first).  Launches on `stream`
// and returns cudaGetLastError().  Does not synchronise.
extern "C" int gat_aggregate_launch(const void* hw, const void* s_src,
                                    const void* s_dst, const void* src,
                                    const void* live, const void* spans,
                                    long long n_heavy, void* out, void* m,
                                    void* den, long long n, int heads,
                                    int dout, int td_bf16, int ta_bf16,
                                    void* stream) {
  if (n <= 0 || heads <= 0 || dout <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(hw) && aligned16(out);
  if ((m == nullptr) != (den == nullptr)) return (int)cudaErrorInvalidValue;
  const GatStats stats{static_cast<float*>(m), static_cast<float*>(den)};
  using bf16 = __nv_bfloat16;
  const auto go = [&](auto td, auto ta) {
    return dispatch_gat<decltype(td), decltype(ta)>(
        hw, s_src, s_dst, src, live, spans, n_heavy, out, stats, n, heads,
        dout, vec_ok, s);
  };
  if (td_bf16) return ta_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.f);
  return ta_bf16 ? go(0.f, bf16()) : go(0.f, 0.f);
}
