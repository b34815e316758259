// Fused delta + LEB128-size pass of the fetchV id wire codec for Hopper
// (sm_90a).  For each row of ids (sorted ascending among the valid
// entries, the sentinel marking holes):
//   delta[r, j] = ids[r, j] - (the previous valid id in the row), the
//                 first valid id absolute; 0 at holes,
//   vlen[r, j]  = LEB128 byte length of delta (1..5); 0 at holes.
//
// Replaces the TPU kernel delta_vlen_pallas
// (src/repro/kernels/varint/kernel.py), which carries the running maximum
// of the valid ids through 128-lane chunks of a row with a log-step
// shift/max ladder (_chunk_cummax).  Here one block owns one row and
// walks it in chunks of kThreads * kItems ids.  Each thread reduces its
// kItems consecutive ids to a maximum, the block turns those into an
// exclusive running maximum (warp shuffles, then one warp over the warps'
// totals in shared memory), and a carry holds the maximum of the earlier
// chunks.  The delta and the LEB128 ladder are then elementwise.
//
// What bounds it: one read of the ids (4 B) and two int32 writes (8 B) per
// element, 12 B in all — memory traffic; at the engine's shapes (64 lanes
// of fetch_cap = 4,096 .. 32,768 ids) that is 3–25 MB, a few microseconds
// at 3.35 TB/s, so a launch costs more than the traffic.  One block per
// row keeps the scan free of any pass across blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;

__device__ __forceinline__ int32_t varint_size(int32_t d) {
  return 1 + (d >= (1 << 7)) + (d >= (1 << 14)) + (d >= (1 << 21)) +
         (d >= (1 << 28));
}

__global__ void __launch_bounds__(kThreads)
delta_vlen_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ delta,
                  int32_t* __restrict__ vlen, int M, int32_t sentinel) {
  __shared__ int32_t warp_max[kWarps];
  const long long off = (long long)blockIdx.x * M;
  const int32_t* in = ids + off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t carry = -1;  // max valid id of the earlier chunks (-1: none yet)
  for (int base = 0; base < M; base += kChunk) {
    const int j0 = base + threadIdx.x * kItems;
    int32_t v[kItems];
    int32_t tmax = -1;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = j0 + k < M ? __ldg(in + j0 + k) : sentinel;
      if (v[k] < sentinel) tmax = max(tmax, v[k]);
    }
    // inclusive running max over the threads of the warp
    int32_t incl = tmax;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int32_t t = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl = max(incl, t);
    }
    if (lane == 31) warp_max[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // inclusive running max over the warps' totals
      int32_t w = lane < kWarps ? warp_max[lane] : -1;
#pragma unroll
      for (int s = 1; s < kWarps; s <<= 1) {
        const int32_t t = __shfl_up_sync(0xffffffffu, w, s);
        if (lane >= s) w = max(w, t);
      }
      if (lane < kWarps) warp_max[lane] = w;
    }
    __syncthreads();
    int32_t before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = -1;
    if (warp > 0) before = max(before, warp_max[warp - 1]);
    int32_t prev = max(carry, before);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = j0 + k;
      if (j < M) {
        const bool valid = v[k] < sentinel;
        int32_t d = prev >= 0 ? v[k] - prev : v[k];
        d = valid ? max(d, 0) : 0;
        delta[off + j] = d;
        vlen[off + j] = valid ? varint_size(d) : 0;
        if (valid) prev = max(prev, v[k]);
      }
    }
    carry = max(carry, warp_max[kWarps - 1]);
    __syncthreads();  // warp_max is rewritten by the next chunk
  }
}

}  // namespace

// ids, delta, vlen: (B, M) int32, contiguous on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Does not synchronise.
extern "C" int delta_vlen_launch(const void* ids, void* delta, void* vlen,
                                 long long B, long long M, int sentinel,
                                 void* stream) {
  if (B == 0 || M == 0) return 0;
  delta_vlen_kernel<<<(unsigned)B, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(delta),
      static_cast<int32_t*>(vlen), (int)M, (int32_t)sentinel);
  return (int)cudaGetLastError();
}
