// Device code that the segment_spmm kernels share: the forward's
// (segment_spmm.cu, "sum" and "gat") and the backward's
// (segment_spmm_bwd.cu, "sum_bwd" and "gat_bwd").  Vector loads and
// stores of float32 and bfloat16 rows, the rounding of a float to a
// tensor's type, the grid of lane groups and hub blocks, and the GAT
// lane's view of a row with its score, so that the backward recomputes
// each edge's score and weight with the forward's own roundings.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;    // values in one 16-byte vector (bf16)
constexpr int kMaxHeads = 2;  // heads one vector of a GAT row may touch
constexpr int kMaxUnits = 32; // vectors in one GAT row: one per lane
constexpr int kCache = 20;    // scores a GAT lane keeps in shared memory:
                              // with a hub block's partials, 48 KB a block

// VEC consecutive values at p as float (16-byte aligned when VEC > 1)
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* v);

template <>
__device__ __forceinline__ void load<float, 1>(const float* p, float* v) {
  v[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load<float, 4>(const float* p, float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
template <>
__device__ __forceinline__ void load<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* v) {
  v[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* v) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load<float, 8>(const float* p, float* v) {
  load<float, 4>(p, v);
  load<float, 4>(p + 4, v + 4);
}
template <>
__device__ __forceinline__ void load<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float* v) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const uint32_t w[2] = {x.x, x.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// VEC values of T as loaded (16-byte aligned when VEC > 1), unpacked to
// float one at a time: a row kept across a step takes 4 registers, not
// VEC
template <typename T, int VEC>
struct Packed;
template <>
struct Packed<float, 1> {
  float x;
  __device__ __forceinline__ void load(const float* p) { x = __ldg(p); }
  __device__ __forceinline__ float at(int) const { return x; }
};
template <>
struct Packed<float, 4> {
  float4 x;
  __device__ __forceinline__ void load(const float* p) {
    x = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float at(int k) const {
    return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
  }
};
template <>
struct Packed<__nv_bfloat16, 1> {
  float x;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    x = __bfloat162float(p[0]);
  }
  __device__ __forceinline__ float at(int) const { return x; }
};
template <>
struct Packed<__nv_bfloat16, 8> {
  uint4 x;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    x = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // value k is the low (even k) or high (odd k) half of word k / 2
  __device__ __forceinline__ float at(int k) const {
    const uint32_t w = k < 2 ? x.x : k < 4 ? x.y : k < 6 ? x.z : x.w;
    return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
  }
};

template <>
struct Packed<__nv_bfloat16, 4> {
  uint2 x;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    x = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ float at(int k) const {
    const uint32_t w = k < 2 ? x.x : x.y;
    return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
  }
};

// VEC values from a to p, rounded to p's type (VEC * sizeof(*p)-byte
// aligned)
template <int VEC>
__device__ __forceinline__ void store(float* p, const float* a) {
  if constexpr (VEC == 1) {
    p[0] = a[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
    }
  }
}
template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* a) {
  if constexpr (VEC == 1) {
    p[0] = __float2bfloat16_rn(a[0]);
  } else {
    static_assert(VEC == 4 || VEC == 8, "bf16 rows store 1, 4 or 8 values");
    uint32_t w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
  }
}

// x rounded to T and back: what storing a value in a T tensor does
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// lanes per row (log2) for a row of `units` vectors, and the grid: the
// hub rows' blocks, then the lane groups' blocks for the other rows
int lanes_log2(int units) {
  int l = 0;
  while (l < 5 && (1 << l) < units) ++l;
  return l;
}

long long grid_blocks(long long n, int lpr_log2, long long n_heavy) {
  const long long rows_per_block = (long long)(kThreads / 32)
                                   << (5 - lpr_log2);
  return n_heavy + (n - n_heavy + rows_per_block - 1) / rows_per_block;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TD>
struct GatArgs {
  const TD* hw;           // (N, H * dout)
  const TD* s_src;        // (N, H)
  const TD* s_dst;        // (N, H)
  const int32_t* src;     // (E,) edge_src[perm]
  const uint8_t* live;    // (E,) edge_mask[perm]
  int heads, dout, units;
};

// The forward's saved row statistics, (N, H) float32 each, or both
// null: m the max score, den the clamped denominator.
struct GatStats {
  float* m = nullptr;
  float* den = nullptr;
  // the (H,) slices of row `row` (null stays null)
  __device__ __forceinline__ GatStats row(long long row, int heads) const {
    return m == nullptr ? GatStats{}
                        : GatStats{m + row * heads, den + row * heads};
  }
};

// What one lane owns of a GAT row: vector c (values c*VEC .. c*VEC+VEC-1),
// which touches heads h0 .. h0 + nh - 1 (nh <= kMaxHeads; nh = 0 for a
// lane past the row's last vector); bit k of `second` is set where value
// k belongs to head h0 + 1; sd[j] is s_dst[v, h0 + j].
struct GatLane {
  int c, h0, nh;
  uint32_t second;
  float sd[kMaxHeads];
};

// The lane of vector c of row `row`, with sd[j] = scores[row, h0 + j]
// for the row's own per-node scores (s_dst of a destination row in the
// forward, s_src of a source row in the backward's walk by source).
template <typename TD, int VEC>
__device__ __forceinline__ GatLane lane_of(const TD* scores, long long row,
                                           int c, int heads, int dout,
                                           int units) {
  GatLane L;
  L.c = c;
  L.nh = 0;
  L.h0 = 0;
  L.second = 0;
  if (c < units) {
    const int first = c * VEC;
    L.h0 = first / dout;
    L.nh = (first + VEC - 1) / dout - L.h0 + 1;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if ((first + k) / dout != L.h0) L.second |= 1u << k;
  }
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j) {
    L.sd[j] = 0.f;
    if (j < L.nh) load<TD, 1>(scores + row * heads + L.h0 + j, &L.sd[j]);
  }
  return L;
}

template <typename TD, int VEC>
__device__ __forceinline__ GatLane gat_lane(const GatArgs<TD>& g, long long v,
                                            int c) {
  return lane_of<TD, VEC>(g.s_dst, v, c, g.heads, g.dout, g.units);
}

// Whether the lane holds the first value of head h0 + j: the one lane of
// the row that writes the head's per-row values.
template <int VEC>
__device__ __forceinline__ bool head_owner(const GatLane& L, int j,
                                           int dout) {
  return j < L.nh && (L.h0 + j) * dout >= L.c * VEC;
}

// leaky_relu(a + b, 0.2) in TD, as a float: the add and the negative
// branch's product round to TD, as PyTorch's elementwise ops do
template <typename TD>
__device__ __forceinline__ float gat_score(float a, float b) {
  const float x = round_to<TD>(__fadd_rn(a, b));
  return x > 0.f ? x : round_to<TD>(__fmul_rn(x, 0.2f));
}

// exp(score - max) rounded to the accumulation type TA, as float
template <typename TA>
__device__ __forceinline__ float gat_exp(float score, float m) {
  return round_to<TA>(expf(__fsub_rn(score, m)));
}

// The source ids of U edges e, e + step, ..., and whether each exists
// (below `end`) and is live; a lane that owns no vector (on = false)
// takes no edge
template <int U>
struct Edges {
  int id[U];
  bool ok[U];
};

template <typename TD, int U>
__device__ __forceinline__ void load_edges(const GatArgs<TD>& g, int e,
                                           int end, int step, bool on,
                                           Edges<U>& x) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int ee = e + u * step;
    const bool in = on && ee < end;
    x.id[u] = in ? __ldg(g.src + ee) : 0;
    x.ok[u] = in && __ldg(g.live + ee) != 0;
  }
}

// One pass over the edges e0, e0 + step, ... < end of a destination row,
// U edges a step, in order, the next step's ids loaded while this step's
// source rows load:
//   PASS 0: m[j]   = max of the live edges' scores;
//   PASS 1: den[j] = sum in f32 of TA(exp(score - m));
//   PASS 2: acc[k] = sum in f32 of TA(TD(alpha * hw[src, k])), with
//           alpha = TD(TA(exp(score - m)) / den)  (den final).
// Masked and missing edges add nothing.  PASS 0 keeps the scores of the
// lane's first kCache edges in shared memory (cache[(k * kMaxHeads + j)
// * kThreads] for its k-th edge and head h0 + j), and the later passes
// read them there instead of gathering s_src again.
template <int PASS, int U, typename TD, typename TA, int VEC>
__device__ __forceinline__ void gat_pass(const GatArgs<TD>& g,
                                         const GatLane& L, int e0, int end,
                                         int step, float* cache,
                                         float (&m)[kMaxHeads],
                                         float (&den)[kMaxHeads],
                                         float (&acc)[VEC]) {
  Edges<U> cur, nxt;
  load_edges<TD, U>(g, e0, end, step, L.nh > 0, cur);
  for (int e = e0, k0 = 0; e < end; e += U * step, k0 += U) {
    load_edges<TD, U>(g, e + U * step, end, step, L.nh > 0, nxt);
    float a[U][kMaxHeads];
    Packed<TD, VEC> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long s = cur.id[u];
      const bool gather = PASS == 0 || k0 + u >= kCache;
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j) {
        a[u][j] = 0.f;
        if (cur.ok[u] && j < L.nh && gather)
          load<TD, 1>(g.s_src + s * g.heads + L.h0 + j, &a[u][j]);
      }
      if (PASS == 2 && cur.ok[u])
        v[u].load(g.hw + s * ((long long)g.units * VEC) +
                  (long long)L.c * VEC);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!cur.ok[u]) continue;
      float alpha[kMaxHeads];
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j) {
        if (j >= L.nh) continue;
        float* slot = cache + ((k0 + u) * kMaxHeads + j) * kThreads;
        const float sc = PASS > 0 && k0 + u < kCache
                             ? *slot
                             : gat_score<TD>(a[u][j], L.sd[j]);
        if (PASS == 0 && k0 + u < kCache) *slot = sc;
        if (PASS == 0) m[j] = fmaxf(m[j], sc);
        if (PASS == 1) den[j] = __fadd_rn(den[j], gat_exp<TA>(sc, m[j]));
        if (PASS == 2)
          alpha[j] = round_to<TD>(__fdiv_rn(gat_exp<TA>(sc, m[j]), den[j]));
      }
      if (PASS == 2) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float w = (L.second >> k) & 1u ? alpha[1] : alpha[0];
          acc[k] = __fadd_rn(
              acc[k], round_to<TA>(round_to<TD>(__fmul_rn(w, v[u].at(k)))));
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

}  // namespace
