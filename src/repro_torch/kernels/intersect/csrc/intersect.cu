// Batched sorted-list intersection for Hopper (sm_90a):
//   mask[r, j]  = a[r, j] in b[r, :M] and a[r, j] != sentinel
//   count[r]    = sum_j mask[r, j]
// for b sorted ascending per row.  It is the back-edge filter of the
// bucketed storage format (C(u) <- adj(piv) ∩ adj(f(u')), Alg. 1 line 6).
//
// Replaces the TPU kernel intersect_pallas
// (src/repro/kernels/intersect/kernel.py), which streams b through the
// vector unit in 128-lane chunks and OR-reduces an all-pairs compare:
// O(M^2) compares per row.  Its wrapper pads b with INT32_MIN, which
// breaks the sort order a binary search needs, so this kernel takes the
// unpadded rows.
//
// A block per row (sorted_search::answer_row, shared with membership):
// b's live prefix is staged in shared memory once, each thread answers
// four elements of a from one 16-byte load and writes their mask bytes
// with one 32-bit store.  A sentinel element answers false, and by the
// final-run rule any element at or above b's last value, or below b[0],
// is answered without a search: on the bucketed layout both windows are
// mostly sentinel padding.  The count is a block-wide reduction written
// with a plain store for every row, hits or not: no atomics, and the
// wrapper need not zero it.
//
// What bounds it: reading a once (4 B an element) and writing the mask
// (1 B) is 5 B an element, about 4.7 GB at the engine's shape
// (B = 524,288 rows, M = max degree 1,780): ~1.4 ms at 3.35 TB/s, plus of
// each b row the sectors of one search and its live prefix (all of it
// for full rows, 2.51 ms in all) — memory traffic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"

namespace {

using sorted_search::kRowThreads;

constexpr long long kMaxBlocks = 1LL << 20;  // grid-stride beyond this

__global__ void __launch_bounds__(kRowThreads)
intersect_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 uint8_t* __restrict__ mask, int32_t* __restrict__ count,
                 long long B, int M, int32_t sentinel, bool vec,
                 bool row_vec) {
  extern __shared__ int4 stage4[];
  __shared__ sorted_search::RowHead head;
  __shared__ int warp_hits[kRowThreads / 32];
  int32_t* stage = reinterpret_cast<int32_t*>(stage4);
  for (long long r = blockIdx.x; r < B; r += gridDim.x) {
    const long long off = r * M;
    int hits = sorted_search::answer_row<true>(b + off, M, a + off,
                                               mask + off, M, vec, row_vec,
                                               sentinel, stage, &head);
    hits = __reduce_add_sync(0xffffffffu, hits);
    if ((threadIdx.x & 31) == 0) warp_hits[threadIdx.x >> 5] = hits;
    __syncthreads();   // stage and head are the next row's
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kRowThreads / 32; ++w) total += warp_hits[w];
      count[r] = total;
    }
  }
}

}  // namespace

// a, b: (B, M) int32, mask: (B, M) bool, count: (B,) int32 (every entry
// written), all contiguous on the current device; M >= 1.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).  Does not
// synchronise.
extern "C" int intersect_launch(const void* a, const void* b, void* mask,
                                void* count, long long B, long long M,
                                int sentinel, void* stream) {
  if (B * M == 0) return 0;
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const bool row_vec = reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       M % 4 == 0;
  const long long blocks = B < kMaxBlocks ? B : kMaxBlocks;
  intersect_kernel<<<(unsigned)blocks, kRowThreads,
                     sorted_search::stage_bytes(M),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<uint8_t*>(mask), static_cast<int32_t*>(count), B, (int)M,
      (int32_t)sentinel, vec, row_vec);
  return (int)cudaGetLastError();
}
