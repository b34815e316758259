// Batched sorted-set membership for Hopper (sm_90a):
//   out[b, k] = vals[b, k] in rows[b, :M]
// for rows sorted ascending and padded with the sentinel.
//
// Replaces the TPU kernel membership_pallas
// (src/repro/kernels/membership/kernel.py), which streams each row through
// the vector unit in 128-lane chunks and OR-reduces an all-pairs compare:
// O(M*K) compares per row, about 3.2 M at the engine's back-edge shape
// (M = K = max_degree = 1,796).  Here each (b, k) query is one thread that
// runs a lower_bound over rows[b] and compares
// rows[b, min(idx, M - 1)] == vals[b, k] — exactly the plain version's
// searchsorted/clamp/gather, so a sentinel query is "present" in a padded
// row and a full row without padding is handled with no special case.
//
// What bounds it: the back-edge call (B = 524,288 rows, K = M = the max
// degree, ~1,800 on a DBLP-sized graph) must read every row and query once
// and write one byte per query, about 8.4 GB, so at best ~2.5 ms at
// 3.35 TB/s — memory traffic.  Consecutive threads share a row
// (b = i / K), so a row is pulled into L1/L2 once per block and the
// searches hit cache.  The verifyE call (K = 1) needs only the ~log2(M)
// sectors its search visits per row (~0.19 GB at B = 524,288, ~0.06 ms);
// the row gather that feeds it in the engine is outside the kernel.
// Staging rows in shared memory for large K is left for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;  // grid-stride beyond this

__global__ void __launch_bounds__(kThreads)
membership_kernel(const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ vals,
                  bool* __restrict__ out, long long total, int M, int K) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += step) {
    const long long b = i / K;
    const int32_t v = __ldg(vals + i);
    const int32_t* row = rows + b * (long long)M;
    int lo = 0, hi = M;  // lower_bound: first index with row[idx] >= v
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(row + mid) < v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int idx = lo < M ? lo : M - 1;
    out[i] = __ldg(row + idx) == v;
  }
}

}  // namespace

// rows: (B, M) int32, vals: (B, K) int32, out: (B, K) bool, all
// contiguous on the current device; M >= 1.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int membership_launch(const void* rows, const void* vals,
                                 void* out, long long B, long long M,
                                 long long K, void* stream) {
  const long long total = B * K;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  membership_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(vals),
      static_cast<bool*>(out), total, (int)M, (int)K);
  return (int)cudaGetLastError();
}
