// Segment sum of edge messages by destination for Hopper (sm_90a):
//   out[v] = sum of msgs[e] over the edges e with dst[e] == v
// for msgs (E, D) float32 or bfloat16, summed in float32, written as
// float32 or bfloat16.  It is the GNN message aggregation of every
// `_seg_sum` in the model zoo (GraphCast, SchNet, PNA, GAT).
//
// Replaces the TPU kernel segment_spmm_pallas
// (src/repro/kernels/segment_spmm/kernel.py) with its function, not its
// form.  The TPU sorts edges into destination tiles on the host and turns
// each tile's scatter into one_hot(dst_local)^T @ msgs on the MXU: a
// product that multiplies by zero for (TN - 1)/TN of its work.  Here the
// edges come as a CSR plan built once per graph (ops.segment_plan): a
// stable sort of the edges by destination, `perm`, and `rowptr` (n + 1),
// so destination v owns the edges perm[rowptr[v] : rowptr[v + 1]].
//
// What bounds it: bytes.  A segment sum does one add per message element,
// so its work is reading each message once, perm and rowptr once, and
// writing each output row once: at GAT's first layer on ogbn-products'
// shape (E = 61,859,140, D = 64, f32 in and out, N = 2,449,029) that is
// 16.7 GB, about 5.0 ms at 3.35 TB/s.
//
// Design.  Each destination row belongs to a group of LPR lanes of one
// warp (LPR the smallest power of two >= the row's 16-byte vectors, at
// most 32), so narrow rows (D = 1, 8) pack several rows into a warp and no
// lane idles.  The lanes run across D with 16-byte loads (4 f32 or 8 bf16
// values) and gather each message row through perm, so the messages are
// never permuted into a copy; a row whose bytes are not a multiple of 16
// (PNA's D = 75) takes scalar loads, still coalesced across lanes.  Sums
// live in f32 registers, up to 8 edges are loaded ahead of the adds (and
// their ids one step earlier) to keep bytes in flight, and each output
// row is written once; an empty row writes 0.  The adds run in the plan's
// stable edge order, with no atomics, so a run repeats bit for bit.  Rows are not split by edge
// count: a power-law hub keeps its warp long after the others finish.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// VEC values from a to p (16-byte aligned when VEC > 1)
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
    static_assert(VEC == 8, "bf16 rows are stored 8 values at a time");
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One destination row per group of (1 << lpr_log2) lanes.  A row has
// `units` vectors of VEC values; lane `sub` of the group owns vectors
// sub, sub + LPR, ..., ITEMS of them per pass over the row's edges (a row
// wider than LPR * ITEMS vectors takes several passes).  UNROLL edges are
// loaded before they are added, in edge order: ITEMS * UNROLL = 8 keeps
// 8 loads of 16 bytes in flight per lane.
template <typename TIn, typename TOut, int VEC, int ITEMS, int UNROLL>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const TIn* __restrict__ msgs,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ rowptr, TOut* __restrict__ out,
                   long long n, int units, int lpr_log2) {
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long row = (warp << (5 - lpr_log2)) + (lane >> lpr_log2);
  if (row >= n) return;
  const int sub = lane & (lpr - 1);
  const long long D = (long long)units * VEC;
  const int beg = __ldg(rowptr + row), end = __ldg(rowptr + row + 1);
  TOut* orow = out + row * D;

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
int launch(const void* msgs, const void* perm, const void* rowptr, void* out,
           long long n, long long d, cudaStream_t stream) {
  const int units = (int)(d / VEC);
  int lpr_log2 = 0;
  while (lpr_log2 < 5 && (1 << lpr_log2) < units) ++lpr_log2;
  const int per_lane = (units + (1 << lpr_log2) - 1) >> lpr_log2;
  const long long rows_per_block = (long long)(kThreads / 32)
                                   << (5 - lpr_log2);
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const auto* m = static_cast<const TIn*>(msgs);
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* r = static_cast<const int32_t*>(rowptr);
  auto* o = static_cast<TOut*>(out);
  const dim3 grid((unsigned)blocks);
  if (per_lane <= 1) {
    segment_sum_kernel<TIn, TOut, VEC, 1, 8>
        <<<grid, kThreads, 0, stream>>>(m, p, r, o, n, units, lpr_log2);
  } else if (per_lane <= 2) {
    segment_sum_kernel<TIn, TOut, VEC, 2, 4>
        <<<grid, kThreads, 0, stream>>>(m, p, r, o, n, units, lpr_log2);
  } else if (per_lane <= 4) {
    segment_sum_kernel<TIn, TOut, VEC, 4, 2>
        <<<grid, kThreads, 0, stream>>>(m, p, r, o, n, units, lpr_log2);
  } else {
    segment_sum_kernel<TIn, TOut, VEC, 8, 1>
        <<<grid, kThreads, 0, stream>>>(m, p, r, o, n, units, lpr_log2);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// msgs (E, D) float32 (in_bf16 = 0) or bfloat16 (1); perm (E,) int32, the
// edges sorted stably by destination; rowptr (n + 1,) int32 with
// rowptr[0] = 0, rowptr[n] = E; out (n, D) float32 (out_bf16 = 0) or
// bfloat16 (1, only for bfloat16 messages).  All contiguous on the
// current device, n >= 1, D >= 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int segment_spmm_launch(const void* msgs, const void* perm,
                                   const void* rowptr, void* out, long long n,
                                   long long d, int in_bf16, int out_bf16,
                                   void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(msgs) && aligned16(out);
  if (!in_bf16) {
    if (out_bf16) return (int)cudaErrorInvalidValue;
    if (vec_ok && d % 4 == 0)
      return launch<float, float, 4>(msgs, perm, rowptr, out, n, d, s);
    return launch<float, float, 1>(msgs, perm, rowptr, out, n, d, s);
  }
  if (out_bf16) {
    if (vec_ok && d % 8 == 0)
      return launch<__nv_bfloat16, __nv_bfloat16, 8>(msgs, perm, rowptr, out,
                                                     n, d, s);
    return launch<__nv_bfloat16, __nv_bfloat16, 1>(msgs, perm, rowptr, out, n,
                                                   d, s);
  }
  if (vec_ok && d % 8 == 0)
    return launch<__nv_bfloat16, float, 8>(msgs, perm, rowptr, out, n, d, s);
  return launch<__nv_bfloat16, float, 1>(msgs, perm, rowptr, out, n, d, s);
}
