// Batched sorted-set membership for Hopper (sm_90a):
//   out[b, k] = vals[b, k] in rows[b, :M]
// for rows sorted ascending and padded with the sentinel.
//
// Replaces the TPU kernel membership_pallas
// (src/repro/kernels/membership/kernel.py), which streams each row through
// the vector unit in 128-lane chunks and OR-reduces an all-pairs compare:
// O(M*K) compares per row, about 3.2 M at the engine's back-edge shape.
// Here the answer is the plain version's searchsorted/clamp/gather bit for
// bit, by the final-run rule of sorted_search.cuh: a query equal to the
// row's last value is present (so a sentinel query is "present" in a
// padded row), one above it or below row[0] is not, and any other is
// searched for in the live prefix row[0:L).
//
// Two paths, split by the constant row_min_k of the wrapper
// (ops.ROW_PATH_MIN_K):
// * K >= row_min_k, the back-edge filter (B = 524,288 windows of
//   M = K = 1,780 on the full cell): a block per row
//   (sorted_search::answer_row) stages the row's live prefix once and
//   answers four queries a thread from one 16-byte load.  Its queries are
//   sentinel-padded windows too, so nearly every answer is one compare and
//   the kernel streams: 4 bytes read and 1 written per query, about 4.7 GB
//   and 1.4 ms at 3.35 TB/s, plus ~log2(M) sectors and the live prefix of
//   each row.
// * K < row_min_k, verifyE (K = 1): one thread per row answers its K
//   queries with a search of the global row, which reads only the sectors
//   the search visits.  The row's last value is read beside the query, so
//   a query at or above it costs no search.
// No thread divides an index: the row path takes its row from the block,
// the query path its row from the thread.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"

namespace {

using sorted_search::kRowThreads;

constexpr int kQueryThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;  // grid-stride beyond this

__global__ void __launch_bounds__(kRowThreads)
membership_rows_kernel(const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ vals,
                       uint8_t* __restrict__ out, long long B, int M, int K,
                       bool vec, bool row_vec) {
  extern __shared__ int4 stage4[];
  __shared__ sorted_search::RowHead head;
  int32_t* stage = reinterpret_cast<int32_t*>(stage4);
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    sorted_search::answer_row<false>(rows + b * M, M, vals + b * K,
                                     out + b * K, K, vec, row_vec, 0, stage,
                                     &head);
    __syncthreads();   // stage and head are the next row's
  }
}

__global__ void __launch_bounds__(kQueryThreads)
membership_queries_kernel(const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ vals,
                          bool* __restrict__ out, long long B, int M,
                          int K) {
  const long long step = (long long)gridDim.x * kQueryThreads;
  for (long long b = (long long)blockIdx.x * kQueryThreads + threadIdx.x;
       b < B; b += step) {
    const int32_t* row = rows + b * M;
    const int32_t last = __ldg(row + M - 1);
    for (int k = 0; k < K; ++k) {
      const long long i = b * K + k;
      const int32_t v = __ldg(vals + i);
      bool hit = v == last;
      if (v < last) {   // row[M - 1] > v: the lower_bound is below M - 1
        hit = __ldg(row + sorted_search::lower_bound<true>(row, M - 1, v))
              == v;
      }
      out[i] = hit;
    }
  }
}

}  // namespace

// rows: (B, M) int32, vals: (B, K) int32, out: (B, K) bool, all
// contiguous on the current device; M >= 1.  Rows of K >= row_min_k go
// through the row path, others through the query path.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).  Does not
// synchronise.
extern "C" int membership_launch(const void* rows, const void* vals,
                                 void* out, long long B, long long M,
                                 long long K, long long row_min_k,
                                 void* stream) {
  if (B * K == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const int32_t* v = static_cast<const int32_t*>(vals);
  if (K >= row_min_k) {
    const bool vec = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
    const bool row_vec = reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                         M % 4 == 0;
    const long long blocks = B < kMaxBlocks ? B : kMaxBlocks;
    membership_rows_kernel<<<(unsigned)blocks, kRowThreads,
                             sorted_search::stage_bytes(M), s>>>(
        r, v, static_cast<uint8_t*>(out), B, (int)M, (int)K, vec, row_vec);
  } else {
    long long blocks = (B + kQueryThreads - 1) / kQueryThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    membership_queries_kernel<<<(unsigned)blocks, kQueryThreads, 0, s>>>(
        r, v, static_cast<bool*>(out), B, (int)M, (int)K);
  }
  return (int)cudaGetLastError();
}
