// Grouped per-expert SwiGLU FFN for Hopper (sm_90a):
//   out[e] = (silu(x[e] @ wg[e]) * (x[e] @ wu[e])) @ wd[e]
// over the capacity-dispatched token buffer x (E, C, d), wg/wu (E, d, f),
// wd (E, f, d).
//
// Replaces the TPU kernel moe_gemm_pallas
// (src/repro/kernels/moe_gemm/kernel.py) with its semantics, not its
// tiling: g and u accumulate in f32, h = silu(g) * u is rounded to the
// input type before the down projection, and the output accumulates in
// f32 over the whole of f and is written once, rounded to the input
// type.  The Pallas kernel holds a (bc, d) f32 accumulator in VMEM across
// f-tiles (1 MB at bc = 128, d = 2,048); a block's shared memory cannot,
// so the work is two passes, launched back to back on one stream:
//   1. gate/up: per (C-tile, f-tile, expert), g and u over all of d, then
//      h = silu(g) * u rounded to T, written to the scratch h (E, C, f);
//   2. down: per (C-tile, d-tile, expert), out = h @ wd over all of f.
// h makes one round trip through device memory (E*C*f elements: 0.34 GB
// in bf16 at the serving prefill, ~0.2 ms of the 2.1 ms bound).
//
// What bounds it: at the serving prefill (E = 64, C = 2,560, d = 2,048,
// f = 1,024) the work is 6*E*C*d*f = 2.1 TFLOP against 1.5 GB of weights
// and tokens: bound by operations, 2.1 ms at the 989 TFLOP/s of the bf16
// tensor cores.  At decode (C = 1) only the weights count: 805 MB a
// layer in bf16, bound by bytes, 0.24 ms at 3.35 TB/s.  This first
// version computes on the CUDA cores in f32: each block stages a tile of
// the token rows and of each weight panel in shared memory as f32 and
// each thread keeps a TM x TN register tile of sums.  Large C uses
// 64 x 64 tiles; C <= 8 (decode) uses 4-row tiles 256 columns wide, so
// the weights stream once with little wasted arithmetic.  Consecutive
// blocks take consecutive C-tiles of one weight panel, which they share
// through L2.  wgmma with TMA-fed tiles is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One (BM x BN) tile of out_e = epilogue(A_e @ B_e) for expert
// e = blockIdx.z, A_e (M x K), B_e (K x N), row-major.  GATED: two B
// matrices (wg, wu) and out = silu(A B0) * (A B1); else out = A B0.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool GATED>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
tile_gemm(const T* __restrict__ a, const T* __restrict__ b0,
          const T* __restrict__ b1, T* __restrict__ out, int M, int N,
          int K) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kB = GATED ? 2 : 1;
  constexpr int kLdA = BM + 4;  // As is transposed; padding spreads banks
  __shared__ __align__(16) float As[BK * kLdA];
  __shared__ __align__(16) float Bs[kB][BK * BN];

  const long long e = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const T* A = a + e * M * K;
  const T* B0 = b0 + e * K * N;
  const T* B1 = GATED ? b1 + e * K * N : nullptr;
  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN), tm = tid / (BN / TN);

  float acc0[TM][TN], acc1[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c * kLdA + r] =
          (gm < M && gk < K) ? to_f(A[(long long)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      const long long off = (long long)gk * N + gn;
      Bs[0][i] = ok ? to_f(B0[off]) : 0.f;
      if (GATED) Bs[kB - 1][i] = ok ? to_f(B1[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv0[TN], bv1[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk * kLdA + tm * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bv0[j] = Bs[0][kk * BN + tn * TN + j];
        if (GATED) bv1[j] = Bs[kB - 1][kk * BN + tn * TN + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc0[i][j] = fmaf(av[i], bv0[j], acc0[i][j]);
          if (GATED) acc1[i][j] = fmaf(av[i], bv1[j], acc1[i][j]);
        }
    }
    __syncthreads();
  }

  T* O = out + e * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tm * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tn * TN + j;
      if (gn >= N) continue;
      float val = acc0[i][j];
      if (GATED) val = val / (1.f + expf(-val)) * acc1[i][j];
      O[(long long)gm * N + gn] = from_f<T>(val);
    }
  }
}

constexpr int kSmallC = 8;  // at most this many rows per expert: decode tiles

template <typename T, int BM, int BN, int BK, int TM, int TN>
int run(const T* x, const T* wg, const T* wu, const T* wd, T* h, T* out,
        int E, int C, int d, int f, cudaStream_t st) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  const dim3 g1((C + BM - 1) / BM, (f + BN - 1) / BN, E);
  tile_gemm<T, BM, BN, BK, TM, TN, true><<<g1, kThreads, 0, st>>>(
      x, wg, wu, h, C, f, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((C + BM - 1) / BM, (d + BN - 1) / BN, E);
  tile_gemm<T, BM, BN, BK, TM, TN, false><<<g2, kThreads, 0, st>>>(
      h, wd, nullptr, out, C, d, f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* h, void* out, int E, int C, int d, int f, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0) return 0;
  if (f < 0 || E > 65535 || (d > f ? d : f) / 64 >= 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f == 0) {  // an empty hidden layer: the sum over f is 0
    cudaMemsetAsync(out, 0, sizeof(T) * (size_t)E * C * d, st);
    return (int)cudaGetLastError();
  }
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(wg);
  const T* up = static_cast<const T*>(wu);
  const T* dp = static_cast<const T*>(wd);
  T* hp = static_cast<T*>(h);
  T* op = static_cast<T*>(out);
  if (C <= kSmallC)
    return run<T, 4, 256, 16, 4, 1>(xp, gp, up, dp, hp, op, E, C, d, f, st);
  return run<T, 64, 64, 16, 4, 4>(xp, gp, up, dp, hp, op, E, C, d, f, st);
}

}  // namespace

// x (E, C, d), wg/wu (E, d, f), wd (E, f, d), h (E, C, f) scratch,
// out (E, C, d), contiguous, on the current device; E <= 65535.  Launches
// the gate/up and the down pass on `stream` and returns
// cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int moe_gemm_launch_f32(const void* x, const void* wg,
                                   const void* wu, const void* wd, void* h,
                                   void* out, int E, int C, int d, int f,
                                   void* stream) {
  return launch<float>(x, wg, wu, wd, h, out, E, C, d, f, stream);
}

extern "C" int moe_gemm_launch_bf16(const void* x, const void* wg,
                                    const void* wu, const void* wd, void* h,
                                    void* out, int E, int C, int d, int f,
                                    void* stream) {
  return launch<__nv_bfloat16>(x, wg, wu, wd, h, out, E, C, d, f, stream);
}
