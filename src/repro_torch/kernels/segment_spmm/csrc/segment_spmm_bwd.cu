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
//           den_v = max(TA(sum ex_e), 1e-9),  alpha_e = TD(ex_e / den_v):
//           dalpha_e = <TD(dout[v]), hw[u]>        (over the head's values)
//           T_v      = sum of dalpha_e * ex_e
//           da_e     = p_e * (dalpha_e - T_v / den_v) / den_v,
//                      times 0.2 where score_e < 0 (leaky_relu's slope;
//                      1 at x_e == 0, as jax.nn.leaky_relu's where(x >= 0)
//                      gives it)
//           ds_dst[v] = sum of da_e over v's edges
//           ds_src[u] = sum of da_e over u's edges
//           dhw[u]    = sum of TD(dout[v]) * alpha_e over u's edges
//         every sum in float32, each gradient rounded to the model's type
//         TD once (ops.gat_aggregate_bwd_plain computes the same).  The
//         reference's autodiff passes a gradient through each of the
//         forward's roundings unchanged, and through the row max, where
//         the terms cancel: the sums here are that gradient.
//
// Neither has a TPU kernel: they are the gradient of segment_spmm_pallas
// (src/repro/kernels/segment_spmm/kernel.py), which the TPU package never
// differentiates, written for the port's training path.
//
// What bounds them: bytes.  "sum_bwd" reads each row of dout once, perm
// and the row spans once, and writes each edge's row once: at GAT-sized
// messages on ogbn-products' shape (E = 61,859,140, D = 64, f32) 16.7 GB,
// about 5.0 ms at 3.35 TB/s.  "gat_bwd" must gather hw[u] and dout[v] once
// an edge (for dalpha and for dhw), where the forward gathers hw[u] once;
// it runs in two passes over the edges, one by destination and one by
// source, so that every sum is a sum of its own lane's terms in a fixed
// order and no float add is atomic.  dout comes rounded to TD, as the
// messages' gradient is used: the source pass gathers its rows at TD's
// width, not the forward output's (half the bytes when that is f32).
//
// Design.  "sum_bwd" walks the forward's plan: a group of lanes per
// destination row (a block for a hub row, whose edges its slots split),
// each lane loads its 16-byte vectors of dout[v] once and stores them to
// each of the row's edges, four edge ids loaded ahead of the stores.
// "gat_bwd", pass 1, by destination over the forward's plan, with the
// forward's lane layout (a lane owns one 16-byte vector of a row, so one
// or two heads), its hub blocks and three blocks an SM: it recomputes m_v
// with the forward's own score pass (segment_spmm.cuh), then walks the
// row's edges twice more: once for den_v (the forward's adds in the
// forward's order), dalpha_e, whose per-head sum runs across the lanes
// that share the head (warp shuffles within the lane group, in lane
// order), and T_v; once for alpha_e, da_e and ds_dst[v].  It writes
// alpha_e and da_e, (E, H) float32 each in the plan's edge order, and
// ds_dst.  Pass 2, by source, walks a second plan whose rows are the
// sources and whose "edges" are pass 1's edge positions
// (ops.source_plan): each lane sums its vector of dhw[u] from the
// gathered rows of dout and the edges' alpha, and ds_src[u] from their
// da, and writes both once.  A hub row in either pass takes a block whose
// slots split its edges; their partials are combined in slot order.
#include "segment_spmm.cuh"

namespace {

// ------------------------------------------------------------------------ //
// "sum_bwd"
// ------------------------------------------------------------------------ //

// Blocks [0, n_heavy) take one hub row each, its edges split among the
// block's kThreads / LPR slots; the others one row per group of LPR
// lanes, as the forward's grid.  Lane `sub` owns vectors sub, sub + LPR,
// ... of the row; for each, it loads dout's vector once and stores it to
// the row's edges.
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
      for (int u = 0; u < U; ++u) id[u] = __ldg(perm + e + u * step);
#pragma unroll
      for (int u = 0; u < U; ++u)
        store<VEC>(dmsgs + (long long)id[u] * D + off, v);
    }
    for (; e < sp.z; e += step)
      store<VEC>(dmsgs + (long long)__ldg(perm + e) * D + off, v);
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
// "gat_bwd", pass 1: by destination
// ------------------------------------------------------------------------ //

// Which lanes of a lane group hold a lane's heads: the group's lanes in
// the warp (`mask`, LPR = `width` of them), the group lane holding the
// first value of head h0 (`first`), how many lanes from there can hold a
// value of head h0 or h0 + 1 (`span`, the same for every lane of the
// group), and whether this lane holds the first value of head h0 + j
// (`owner`: that lane writes the head's per-edge and per-row values).
struct HeadMap {
  unsigned mask;
  int width, first, span;
  bool owner[kMaxHeads];
};

template <int VEC>
__device__ __forceinline__ HeadMap head_map(const GatLane& L, int lpr,
                                            int dout) {
  HeadMap hm;
  const int lane = threadIdx.x & 31;
  hm.mask = lpr == 32 ? 0xffffffffu
                      : ((1u << lpr) - 1u) << (lane & ~(lpr - 1));
  hm.width = lpr;
  hm.first = L.nh > 0 ? (L.h0 * dout) / VEC : 0;
  hm.span = min(lpr, (2 * dout + VEC - 1) / VEC + 1);
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j)
    hm.owner[j] = j < L.nh && (L.h0 + j) * dout >= L.c * VEC;
  return hm;
}

// tot[j] = the sum over the group's lanes, in lane order, of their
// partials p of head h0 + j.  Every lane of the group calls it together.
template <int VEC>
__device__ __forceinline__ void head_totals(const HeadMap& hm,
                                            const GatLane& L, int dout,
                                            int units,
                                            const float (&p)[kMaxHeads],
                                            float (&tot)[kMaxHeads]) {
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j) tot[j] = 0.f;
  for (int s = 0; s < hm.span; ++s) {
    const int l = hm.first + s;
    const float q0 = __shfl_sync(hm.mask, p[0], l, hm.width);
    const float q1 = __shfl_sync(hm.mask, p[1], l, hm.width);
    if (l < units) {
      const int h = (l * VEC) / dout;
      const bool two = (l * VEC + VEC - 1) / dout != h;
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j) {
        if (j >= L.nh) continue;
        if (h == L.h0 + j) tot[j] = __fadd_rn(tot[j], q0);
        if (two && h + 1 == L.h0 + j) tot[j] = __fadd_rn(tot[j], q1);
      }
    }
  }
}

// The score of the lane's k-th edge for head h0 + j: from the score cache
// that the forward's PASS 0 filled for the first kCache edges, else from
// the gathered s_src value a.
template <typename TD>
__device__ __forceinline__ float cached_score(const GatLane& L,
                                              const float* cache, int k,
                                              int j, float a) {
  return k < kCache ? cache[(k * kMaxHeads + j) * kThreads]
                    : gat_score<TD>(a, L.sd[j]);
}

// One pass over the edges e0, e0 + step, ... < end of a destination row,
// U edges a step, after the row max m is known:
//   PASS 3: den[j] = sum in f32 of ex_e (the forward's PASS 1, the same
//           adds in the same order) and t[j] = sum of dalpha_e * ex_e;
//           the owner of head h0 + j writes dalpha_e into dsc at
//           e * H + h0 + j;
//   PASS 4 (den final, clamped; t final): the owner writes alpha_e, turns
//           dsc[e, h] from dalpha_e into da_e, and sums da_e into acc[j].
// Masked and missing edges take no part, but every lane of the group
// runs PASS 3's shuffles for each edge slot.
template <int PASS, int U, typename TD, typename TA, int VEC>
__device__ __forceinline__ void gat_bwd_pass(
    const GatArgs<TD>& g, const GatLane& L, const HeadMap& hm, int e0,
    int end, int step, const float* cache, const float (&m)[kMaxHeads],
    float (&den)[kMaxHeads], const float (&dv)[VEC],
    float* __restrict__ alpha, float* __restrict__ dsc,
    float (&t)[kMaxHeads], float (&acc)[kMaxHeads]) {
  Edges<U> cur, nxt;
  load_edges<TD, U>(g, e0, end, step, L.nh > 0, cur);
  for (int e = e0, k0 = 0; e < end; e += U * step, k0 += U) {
    load_edges<TD, U>(g, e + U * step, end, step, L.nh > 0, nxt);
    float a[U][kMaxHeads];
    Packed<TD, VEC> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long s = cur.id[u];
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j) {
        a[u][j] = 0.f;
        const bool need = PASS == 3 || hm.owner[j];
        if (cur.ok[u] && j < L.nh && need && k0 + u >= kCache)
          load<TD, 1>(g.s_src + s * g.heads + L.h0 + j, &a[u][j]);
      }
      if (PASS == 3 && cur.ok[u])
        v[u].load(g.hw + s * ((long long)g.units * VEC) +
                  (long long)L.c * VEC);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long base = (long long)(e + u * step) * g.heads + L.h0;
      if (PASS == 3) {
        float p[kMaxHeads] = {0.f, 0.f};
        if (cur.ok[u]) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float x = __fmul_rn(dv[k], v[u].at(k));
            if ((L.second >> k) & 1u)
              p[1] = __fadd_rn(p[1], x);
            else
              p[0] = __fadd_rn(p[0], x);
          }
        }
        float tot[kMaxHeads];
        head_totals<VEC>(hm, L, g.dout, g.units, p, tot);
        if (!cur.ok[u]) continue;
#pragma unroll
        for (int j = 0; j < kMaxHeads; ++j) {
          if (j >= L.nh) continue;
          const float sc = cached_score<TD>(L, cache, k0 + u, j, a[u][j]);
          const float ex = gat_exp<TA>(sc, m[j]);
          den[j] = __fadd_rn(den[j], ex);
          t[j] = __fadd_rn(t[j], __fmul_rn(tot[j], ex));
          if (hm.owner[j]) dsc[base + j] = tot[j];
        }
      } else {
        if (!cur.ok[u]) continue;
#pragma unroll
        for (int j = 0; j < kMaxHeads; ++j) {
          if (!hm.owner[j]) continue;
          const float sc = cached_score<TD>(L, cache, k0 + u, j, a[u][j]);
          const float p = expf(__fsub_rn(sc, m[j]));
          alpha[base + j] = round_to<TD>(__fdiv_rn(round_to<TA>(p), den[j]));
          const float q = __fsub_rn(dsc[base + j], __fdiv_rn(t[j], den[j]));
          const float ds = __fdiv_rn(__fmul_rn(p, q), den[j]);
          const float da = sc >= 0.f ? ds : __fmul_rn(ds, 0.2f);
          dsc[base + j] = da;
          acc[j] = __fadd_rn(acc[j], da);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur.id[u] = nxt.id[u];
      cur.ok[u] = nxt.ok[u];
    }
  }
}

// Blocks [0, n_heavy) each take one hub row, spans[blockIdx.x]; the
// others one destination row per group of LPR lanes, lane `sub` owning
// vector `sub` (the forward's grid).  Every lane of a group stays to the
// end, since the per-edge head sums shuffle across the group.
template <typename TD, typename TA, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
gat_bwd_dst_kernel(GatArgs<TD> g, const TD* __restrict__ dout,
                   const int4* __restrict__ spans, int n_heavy,
                   float* __restrict__ alpha, float* __restrict__ dsc,
                   TD* __restrict__ ds_dst, long long n, int lpr_log2) {
  constexpr int kScoreEdges = 8;
  constexpr int kGradEdges = 4;
  const long long D = (long long)g.units * VEC;
  const int lpr = 1 << lpr_log2;
  __shared__ float cache[kCache * kMaxHeads * kThreads];
  __shared__ float part[kThreads * kMaxHeads];
  const bool hub = (int)blockIdx.x < n_heavy;
  int4 sp;
  int sub, slot = 0, slots = 1;
  if (hub) {
    sp = __ldg(spans + blockIdx.x);
    slots = kThreads >> lpr_log2;
    slot = threadIdx.x >> lpr_log2;
    sub = threadIdx.x & (lpr - 1);
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
  const long long row = sp.x;
  const GatLane L = gat_lane<TD, VEC>(g, row, sub);
  // a hub row's slots meet in shared memory, as in the forward: sums
  // (kind 1) in slot order, so every slot goes on with the same values
  const auto combine = [&](int kind, float(&x)[kMaxHeads]) {
    if (!hub) return;
#pragma unroll
    for (int j = 0; j < kMaxHeads; ++j)
      part[threadIdx.x * kMaxHeads + j] = x[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxHeads; ++j) {
      float s = kind == 0 ? -INFINITY : 0.f;
      for (int q = 0; q < slots; ++q) {
        const float y = part[(q * lpr + sub) * kMaxHeads + j];
        s = kind == 0 ? fmaxf(s, y) : __fadd_rn(s, y);
      }
      x[j] = s;
    }
    __syncthreads();
  };
  float m[kMaxHeads], den[kMaxHeads], t[kMaxHeads], dsd[kMaxHeads];
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j) {
    m[j] = -INFINITY;
    den[j] = t[j] = dsd[j] = 0.f;
  }
  float* cache_t = cache + threadIdx.x;
  const int e0 = sp.y + slot, end = sp.z;
  float unused[VEC];
  gat_pass<0, kScoreEdges, TD, TA, VEC>(g, L, e0, end, slots, cache_t, m,
                                        den, unused);
  combine(0, m);
  // the lane's vector of dout[v] (rounded to TD by the caller): the
  // gradient of the messages TD(alpha * hw) that the forward summed
  float dv[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) dv[k] = 0.f;
  if (L.nh > 0) load<TD, VEC>(dout + row * D + (long long)L.c * VEC, dv);
  const HeadMap hm = head_map<VEC>(L, lpr, g.dout);
  gat_bwd_pass<3, kGradEdges, TD, TA, VEC>(g, L, hm, e0, end, slots,
                                           cache_t, m, den, dv, alpha, dsc,
                                           t, dsd);
  combine(1, den);
  combine(1, t);
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j)
    den[j] = fmaxf(round_to<TA>(den[j]), 1e-9f);
  gat_bwd_pass<4, kGradEdges, TD, TA, VEC>(g, L, hm, e0, end, slots,
                                           cache_t, m, den, dv, alpha, dsc,
                                           t, dsd);
  combine(1, dsd);
  if (slot == 0) {
#pragma unroll
    for (int j = 0; j < kMaxHeads; ++j)
      if (hm.owner[j]) store<1>(ds_dst + row * g.heads + L.h0 + j, &dsd[j]);
  }
}

// ------------------------------------------------------------------------ //
// "gat_bwd", pass 2: by source
// ------------------------------------------------------------------------ //

// One source row u per group of LPR lanes (a block for a hub row), lane
// `sub` owning vector `sub` of dhw[u]: over the row's edges, four a
// step, in the source plan's order, acc += dout[v] * alpha_e for its
// vector (dout in TD) and, for the heads whose first value it holds,
// ds += da_e.  pos[e] is the edge's position in pass 1's order, vdst[e]
// its destination, live[e] its mask.
template <typename TD, typename TA, int VEC>
__global__ void __launch_bounds__(kThreads)
gat_bwd_src_kernel(const TD* __restrict__ dout,
                   const int32_t* __restrict__ pos,
                   const int32_t* __restrict__ vdst,
                   const uint8_t* __restrict__ live,
                   const int4* __restrict__ spans, int n_heavy,
                   const float* __restrict__ alpha,
                   const float* __restrict__ dsc, TD* __restrict__ dhw,
                   TD* __restrict__ ds_src, long long n, int heads, int dout_,
                   int units, int lpr_log2) {
  constexpr int U = 4;
  const long long D = (long long)units * VEC;
  const int lpr = 1 << lpr_log2;
  const bool hub = (int)blockIdx.x < n_heavy;
  int4 sp;
  int sub, slot = 0, slots = 1;
  if (hub) {
    sp = __ldg(spans + blockIdx.x);
    slots = kThreads >> lpr_log2;
    slot = threadIdx.x >> lpr_log2;
    sub = threadIdx.x & (lpr - 1);
  } else {
    const int lane = threadIdx.x & 31;
    const long long warp =
        ((long long)(blockIdx.x - n_heavy) * kThreads + threadIdx.x) >> 5;
    const long long idx =
        n_heavy + (warp << (5 - lpr_log2)) + (lane >> lpr_log2);
    sub = lane & (lpr - 1);
    if (idx >= n || sub >= units) return;
    sp = __ldg(spans + idx);
  }
  const long long row = sp.x;
  const bool on = sub < units;
  int h0 = 0, nh = 0;
  uint32_t second = 0;
  bool owner[kMaxHeads] = {false, false};
  if (on) {
    const int first = sub * VEC;
    h0 = first / dout_;
    nh = (first + VEC - 1) / dout_ - h0 + 1;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if ((first + k) / dout_ != h0) second |= 1u << k;
#pragma unroll
    for (int j = 0; j < kMaxHeads; ++j)
      owner[j] = j < nh && (h0 + j) * dout_ >= first;
  }
  float acc[VEC], ds[kMaxHeads] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int e = sp.y + slot; on && e < sp.z; e += U * slots) {
    int p[U], v[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ee = e + u * slots;
      ok[u] = ee < sp.z && __ldg(live + ee) != 0;
      p[u] = ok[u] ? __ldg(pos + ee) : 0;
      v[u] = ok[u] ? __ldg(vdst + ee) : 0;
    }
    float d[U][VEC], w[U][kMaxHeads], g[U][kMaxHeads];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      load<TD, VEC>(dout + (long long)v[u] * D + (long long)sub * VEC, d[u]);
      const long long base = (long long)p[u] * heads + h0;
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j) {
        w[u][j] = j < nh ? __ldg(alpha + base + j) : 0.f;
        g[u][j] = owner[j] ? __ldg(dsc + base + j) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] = __fadd_rn(
            acc[k],
            __fmul_rn(d[u][k], (second >> k) & 1u ? w[u][1] : w[u][0]));
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j)
        if (owner[j]) ds[j] = __fadd_rn(ds[j], g[u][j]);
    }
  }
  if (hub) {
    // the slots' partials, combined in slot order
    __shared__ float part[kThreads * (kMaxVec + kMaxHeads)];
    constexpr int W = kMaxVec + kMaxHeads;
#pragma unroll
    for (int k = 0; k < VEC; ++k) part[threadIdx.x * W + k] = acc[k];
#pragma unroll
    for (int j = 0; j < kMaxHeads; ++j)
      part[threadIdx.x * W + kMaxVec + j] = ds[j];
    __syncthreads();
    if (slot != 0 || !on) return;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float s = 0.f;
      for (int q = 0; q < slots; ++q)
        s = __fadd_rn(s, part[(q * lpr + sub) * W + k]);
      acc[k] = s;
    }
#pragma unroll
    for (int j = 0; j < kMaxHeads; ++j) {
      float s = 0.f;
      for (int q = 0; q < slots; ++q)
        s = __fadd_rn(s, part[(q * lpr + sub) * W + kMaxVec + j]);
      ds[j] = s;
    }
  }
  store<VEC>(dhw + row * D + (long long)sub * VEC, acc);
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j)
    if (owner[j]) store<1>(ds_src + row * heads + h0 + j, &ds[j]);
}

template <typename TD, typename TA, int VEC>
int launch_gat_bwd(const GatArgs<TD>& g, const void* spans,
                   long long n_heavy, const void* pos, const void* vdst,
                   const void* live_t, const void* spans_t,
                   long long n_heavy_t, const void* dout, void* alpha,
                   void* dsc, void* dhw, void* ds_src, void* ds_dst,
                   long long n, cudaStream_t stream) {
  const int lpr_log2 = lanes_log2(g.units);
  const long long blocks = grid_blocks(n, lpr_log2, n_heavy);
  const long long blocks_t = grid_blocks(n, lpr_log2, n_heavy_t);
  if (blocks > 0x7fffffffLL || blocks_t > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  gat_bwd_dst_kernel<TD, TA, VEC>
      <<<dim3((unsigned)blocks), kThreads, 0, stream>>>(
          g, static_cast<const TD*>(dout), static_cast<const int4*>(spans),
          (int)n_heavy, static_cast<float*>(alpha), static_cast<float*>(dsc),
          static_cast<TD*>(ds_dst), n, lpr_log2);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  gat_bwd_src_kernel<TD, TA, VEC>
      <<<dim3((unsigned)blocks_t), kThreads, 0, stream>>>(
          static_cast<const TD*>(dout), static_cast<const int32_t*>(pos),
          static_cast<const int32_t*>(vdst),
          static_cast<const uint8_t*>(live_t),
          static_cast<const int4*>(spans_t), (int)n_heavy_t,
          static_cast<const float*>(alpha), static_cast<const float*>(dsc),
          static_cast<TD*>(dhw), static_cast<TD*>(ds_src), n, g.heads,
          g.dout, g.units, lpr_log2);
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
// (td_bf16 = 0) or bfloat16 (1); src, live, spans, n_heavy the forward's
// plan (gat_aggregate_launch); pos, vdst (E,) int32, live_t (E,) bytes,
// spans_t (N, 4) int32 and n_heavy_t the source plan over pass 1's edge
// positions; dout (N, heads * dout) in hw's type, the gradient of the
// forward's output rounded to it (the forward summed float32 (ta_bf16 =
// 0) or bfloat16 (1) messages); alpha, dsc (E, heads)
// float32 scratch; dhw (N, heads * dout), ds_src, ds_dst (N, heads) in
// hw's type, written whole.  The forward's shape limits hold (the wrapper
// checks first).  Launches pass 1, then pass 2, on `stream` and returns
// cudaGetLastError().  Does not synchronise.
extern "C" int gat_bwd_launch(const void* hw, const void* s_src,
                              const void* s_dst, const void* src,
                              const void* live, const void* spans,
                              long long n_heavy, const void* pos,
                              const void* vdst, const void* live_t,
                              const void* spans_t, long long n_heavy_t,
                              const void* dout, void* alpha, void* dsc,
                              void* dhw, void* ds_src, void* ds_dst,
                              long long n, int heads, int dout_dim,
                              int td_bf16, int ta_bf16, void* stream) {
  if (n <= 0 || heads <= 0 || dout_dim <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(hw) && aligned16(dout) && aligned16(dhw);
  const auto go = [&](auto td, auto ta) {
    using TD = decltype(td);
    using TA = decltype(ta);
    constexpr int V = 16 / sizeof(TD);
    const long long d = (long long)heads * dout_dim;
    GatArgs<TD> g{static_cast<const TD*>(hw), static_cast<const TD*>(s_src),
                  static_cast<const TD*>(s_dst),
                  static_cast<const int32_t*>(src),
                  static_cast<const uint8_t*>(live), heads, dout_dim, 0};
    const auto run = [&](auto vec) {
      return launch_gat_bwd<TD, TA, decltype(vec)::value>(
          g, spans, n_heavy, pos, vdst, live_t, spans_t, n_heavy_t, dout,
          alpha, dsc, dhw, ds_src, ds_dst, n, s);
    };
    if (vec_ok && d % V == 0) {
      g.units = (int)(d / V);
      if (g.units > kMaxUnits) return (int)cudaErrorInvalidValue;
      for (int c = 0; c < g.units; ++c)
        if ((c * V + V - 1) / dout_dim - (c * V) / dout_dim >= kMaxHeads)
          return (int)cudaErrorInvalidValue;
      return run(std::integral_constant<int, V>());
    }
    g.units = (int)d;
    if (g.units > kMaxUnits) return (int)cudaErrorInvalidValue;
    return run(std::integral_constant<int, 1>());
  };
  using bf16 = __nv_bfloat16;
  if (td_bf16) return ta_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.f);
  return ta_bf16 ? go(0.f, bf16()) : go(0.f, 0.f);
}
