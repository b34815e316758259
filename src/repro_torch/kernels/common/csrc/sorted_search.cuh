// Sorted-row search shared by the membership and intersect kernels
// (sm_90a): a row sorted ascending, queries against it, and an answer per
// query.
//
// The fact the design rests on.  For a sorted row let last = row[M - 1]
// and L = lower_bound(row, last), the start of the row's final run.  Then
// v is in the row if v == last, is not if v > last or v < row[0], and
// otherwise is in it exactly when it is in row[0:L).  This holds for any
// sorted row, repeated values included, so the answer is the plain
// version's searchsorted/clamp/gather bit for bit.  In the engine the
// final run is the sentinel padding of an adjacency window and L is the
// vertex's degree, so nearly every query is answered by one compare.
//
// A block of kRowThreads threads takes one row at a time:
//   1. every thread issues the 16-byte loads of its first queries;
//   2. warp 0 reads row[0:32) and row[M - 1] in one round; when the final
//      run starts inside the first 32 ids (most adjacency windows) L is a
//      ballot away and the lanes write the live prefix to shared memory;
//      otherwise a 32-ary search over row[32:M - 1) finds L in
//      ceil(log32(M)) more rounds;
//   3. a longer live prefix is copied to shared memory with 16-byte loads
//      by the whole block, when it fits kStageBudget;
//   4. each thread answers four queries from its registers, searching
//      shared memory (global memory for a prefix above the budget), and
//      writes the four answers with one 32-bit store.  A scalar head and
//      tail cover a row whose queries are not 16-byte aligned.
//
// Shared-memory budget: kStageBudget = 4,096 ids (16 KB) of live prefix;
// a block asks for 4 * min(M, kStageBudget) bytes, 7,120 at the engine's
// max degree of 1,780, so 16 blocks (the thread limit) fit on an SM.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sorted_search {

constexpr int kStageBudget = 4096;   // ids of live prefix staged (16 KB)
constexpr int kRowThreads = 128;     // threads of a block that walks rows
constexpr int kVecPerThread = 4;     // 16-byte query groups held per thread

// First index of p[0, n) whose value is >= v (n if none), p in shared or
// (kGlobal) global memory; p[0] must be readable even when n == 0.  The
// steps depend on n alone, so the lanes of a warp searching rows of one
// length stay converged.
template <bool kGlobal>
__device__ __forceinline__ int lower_bound(const int32_t* p, int n,
                                           int32_t v) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    const int32_t x = kGlobal ? __ldg(p + base + half) : p[base + half];
    base = x < v ? base + half : base;
    n -= half;
  }
  const int32_t x = kGlobal ? __ldg(p + base) : p[base];
  return base + (n > 0 && x < v);
}

// What a block knows of its current row once warp 0 has read it.
struct RowHead {
  int32_t first;   // row[0]
  int32_t last;    // row[M - 1]
  int live;        // L, the start of the final run
};

// By the whole of warp 0: the row's head into *head and, when L <= 32,
// row[0:L) into stage.
__device__ __forceinline__ void find_final_run(const int32_t* row, int M,
                                               int32_t* stage,
                                               RowHead* head) {
  const int lane = threadIdx.x & 31;
  const int32_t last = __ldg(row + M - 1);
  const int32_t x = lane < M ? __ldg(row + lane) : last;
  int lo = __popc(__ballot_sync(0xffffffffu, x < last));
  if (lo == 32) {
    // row[32:hi) unknown, row[hi] >= last: each round probes 32 ids
    // evenly and keeps the gap where the ballot turns
    int hi = M - 1;
    while (hi > lo) {
      const int s = (hi - lo + 31) >> 5;
      const int idx = lo + (lane + 1) * s - 1;
      const bool less = idx < hi && __ldg(row + idx) < last;
      const int c = __popc(__ballot_sync(0xffffffffu, less));
      hi = min(lo + (c + 1) * s - 1, hi);
      lo += c * s;
    }
  }
  if (lo <= 32 && lane < lo) stage[lane] = x;
  if (lane == 0) *head = RowHead{x, last, lo};
}

// Copies row[0:live) to stage with the whole block: 16-byte loads when
// the row is 16-byte aligned and M % 4 == 0 (then 4 * ceil(live / 4) <= M
// stays inside the row), else 4-byte loads.
__device__ __forceinline__ void stage_prefix(const int32_t* row, int live,
                                             int32_t* stage, bool row_vec) {
  if (row_vec) {
    const int n = (live + 3) >> 2;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      reinterpret_cast<int4*>(stage)[j] =
          __ldg(reinterpret_cast<const int4*>(row) + j);
    }
  } else {
    for (int j = threadIdx.x; j < live; j += blockDim.x) {
      stage[j] = __ldg(row + j);
    }
  }
}

// A row as the answers see it: its head, and its live prefix in shared
// memory (s) or, above the budget, in global memory only (s == nullptr).
struct Row {
  const int32_t* g;
  const int32_t* s;
  RowHead h;
};

// One query's answer: membership, or (kExclude) membership of a value
// that is not the sentinel.  The row is taken by value, so that nothing
// of it needs an address (and a stack slot).
template <bool kExclude>
__device__ __forceinline__ bool answer(const Row r, int32_t v,
                                       int32_t sentinel) {
  if (kExclude && v == sentinel) return false;
  if (v >= r.h.last) return v == r.h.last;
  if (v < r.h.first) return false;
  if (r.s != nullptr) {
    const int i = lower_bound<false>(r.s, r.h.live, v);
    return i < r.h.live && r.s[i] == v;
  }
  const int i = lower_bound<true>(r.g, r.h.live, v);
  return i < r.h.live && __ldg(r.g + i) == v;
}

// The block answers the K queries q[0:K) against the sorted row[0:M) into
// out[0:K) (bytes 0/1) and returns the number of true answers of this
// thread.  vec: q is 4-byte aligned in a 16-byte-aligned tensor and out
// in a 4-byte-aligned one, so past a head of < 4 queries they go in
// groups of four.  stage holds min(M, kStageBudget) ids; the caller
// synchronises the block before it reuses stage or head.
template <bool kExclude>
__device__ __forceinline__ int answer_row(
    const int32_t* __restrict__ row, int M, const int32_t* __restrict__ q,
    uint8_t* __restrict__ out, int K, bool vec, bool row_vec,
    int32_t sentinel, int32_t* stage, RowHead* head) {
  constexpr int kChunk = kVecPerThread * kRowThreads;   // groups a pass
  const int t = threadIdx.x;
  int h = K;                                 // scalar head
  if (vec) {
    h = (int)(((16 - (reinterpret_cast<uintptr_t>(q) & 15)) & 15) >> 2);
    h = min(h, K);
  }
  const int n4 = (K - h) >> 2;
  const int4* q4 = reinterpret_cast<const int4*>(q + h);
  uint32_t* o4 = reinterpret_cast<uint32_t*>(out + h);
  int4 qv[kVecPerThread];
#pragma unroll
  for (int r = 0; r < kVecPerThread; ++r) {
    const int j = t + r * kRowThreads;
    if (j < n4) qv[r] = __ldg(q4 + j);       // in flight through the search
  }

  if (t < 32) find_final_run(row, M, stage, head);
  __syncthreads();
  const RowHead hd = *head;
  const bool staged = hd.live <= kStageBudget;
  if (hd.live > 32 && staged) {
    stage_prefix(row, hd.live, stage, row_vec);
    __syncthreads();
  }
  const Row view{row, staged ? stage : nullptr, hd};

  int hits = 0;
  for (int base = 0; base < n4; base += kChunk) {
    if (base > 0) {
#pragma unroll
      for (int r = 0; r < kVecPerThread; ++r) {
        const int j = base + t + r * kRowThreads;
        if (j < n4) qv[r] = __ldg(q4 + j);
      }
    }
#pragma unroll
    for (int r = 0; r < kVecPerThread; ++r) {
      const int j = base + t + r * kRowThreads;
      if (j < n4) {
        const uint32_t a0 = answer<kExclude>(view, qv[r].x, sentinel);
        const uint32_t a1 = answer<kExclude>(view, qv[r].y, sentinel);
        const uint32_t a2 = answer<kExclude>(view, qv[r].z, sentinel);
        const uint32_t a3 = answer<kExclude>(view, qv[r].w, sentinel);
        o4[j] = a0 | (a1 << 8) | (a2 << 16) | (a3 << 24);
        hits += a0 + a1 + a2 + a3;
      }
    }
  }
  for (int j = t; j < h; j += kRowThreads) {
    const bool a = answer<kExclude>(view, __ldg(q + j), sentinel);
    out[j] = a;
    hits += a;
  }
  for (int j = h + 4 * n4 + t; j < K; j += kRowThreads) {
    const bool a = answer<kExclude>(view, __ldg(q + j), sentinel);
    out[j] = a;
    hits += a;
  }
  return hits;
}

// Dynamic shared memory of a row-walking block: the stage of
// min(M, kStageBudget) ids, in whole 16-byte groups.
inline size_t stage_bytes(long long M) {
  const long long n = M < kStageBudget ? M : kStageBudget;
  return (size_t)((n + 3) / 4) * 16;
}

}  // namespace sorted_search
