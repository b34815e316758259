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
// layer in bf16, bound by bytes, 0.24 ms at 3.35 TB/s.
//
// Three variants; ops.route picks one from dtype and shape before launch.
// "simt" (f32, and bf16 shapes the others do not take): the first
// version, on the CUDA cores in f32: each block stages a tile of the
// token rows and of each weight panel in shared memory as f32 and each
// thread keeps a TM x TN register tile of sums.  Large C uses 64 x 64
// tiles; C <= 8 uses 4-row tiles 256 columns wide.  Consecutive blocks
// take consecutive C-tiles of one weight panel, which they share through
// L2.
// "wgmma" (bf16, C > 8, d % 8 == 0, f % 8 == 0, 16-byte aligned): both
// passes on the tensor cores.  A CTA of three warpgroups per (128-row
// C-tile, N-tile, expert): the first issues TMA loads from one thread
// into a 4-stage mbarrier ring, each stage a 128 x 64 tile of A (x, or
// h) and two 64 x 128 panels of B; the other two each own 64 rows and
// keep two 64 x 128 f32 accumulators.  The gate/up pass pairs wg and wu
// over one N-tile of f (g and u share every A tile; the epilogue writes
// silu(g) * u rounded to bf16 into h); the down pass splits a 256-wide
// N-tile of d over the two accumulators.  Weights are read in their
// stored (E, K, N) layout through 3-D tensor maps as MN-major B operands,
// so nothing is transposed or copied; ragged C, d and f arrive as zeros
// and stores are guarded.  C-tiles are the fastest grid dimension, so
// the CTAs that share a weight panel run together and read it from L2.
// "stream" (bf16, C <= 8: decode): bound by the weight bytes.  A block
// of 256 threads per (64 columns, expert) streams its 64-column slice of
// each weight matrix once with 16-byte loads (8 columns a thread, 32
// rows of K in flight across the block), multiplies it by the C <= 8
// token rows in f32 registers, and sums the 32 partial rows through
// warp shuffles and shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// The checks the three variants share; `f == 0` is answered here.  Returns
// -1 to go on, else the result to return.
int precheck(int E, int C, int d, int f, size_t esize, void* out,
             cudaStream_t st) {
  if (E <= 0 || C <= 0 || d <= 0) return 0;
  if (f < 0 || E > 65535) return (int)cudaErrorInvalidValue;
  if (f == 0) {  // an empty hidden layer: the sum over f is 0
    cudaMemsetAsync(out, 0, esize * (size_t)E * C * d, st);
    return (int)cudaGetLastError();
  }
  return -1;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pre = precheck(E, C, d, f, sizeof(T), out, st);
  if (pre >= 0) return pre;
  if ((d > f ? d : f) / 64 >= 65535) return (int)cudaErrorInvalidValue;
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


namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBM = 128;       // C rows per CTA: two consumer warpgroups
constexpr int kBN = 128;       // columns per accumulator
constexpr int kBK = 64;        // depth per stage: one swizzled panel
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kTileA = kBM * kBK;   // elements
constexpr int kPanelB = kBK * 64;

struct Smem {
  bf16 a[kStages][kTileA];
  bf16 b[kStages][2][kBN / 64][kPanelB];  // [stage][accumulator][panel]
  uint64_t full[kStages], empty[kStages];
};

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// One (128 x 256) output tile of expert e = blockIdx.z: A (E, M, K) and
// the B matrices (E, K, N), row-major, through tensor maps ta, tb0, tb1.
// GATED: out = silu(A B0) * (A B1) over columns n0..n0+127 (B0 = wg,
// B1 = wu, out = h); else out = A B over columns n0..n0+255 (tb0 = tb1 =
// wd, the accumulators take the two halves).
template <bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
moe_gemm_wgmma(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb0,
               const __grid_constant__ CUtensorMap tb1,
               bf16* __restrict__ out, int M, int N, int K) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1k(smem_raw));
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * (GATED ? kBN : 2 * kBN);
  const int n_k = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {  // producer
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      // panels wholly past N are not loaded: their columns are never
      // stored, so what the stage held before does not matter
      int live = 0;
      for (int j = 0; j < 2; ++j)
        for (int p = 0; p < kBN / 64; ++p)
          live += (GATED ? n0 : n0 + kBN * j) + 64 * p < N;
      const uint32_t bytes = 2u * (kTileA + live * kPanelB);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&sm.empty[s], ((kt / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[s], bytes);
        tma_load_3d(sm.a[s], &ta, &sm.full[s], kt * kBK, m0, e);
        for (int j = 0; j < 2; ++j)
          for (int p = 0; p < kBN / 64; ++p) {
            const int n = (GATED ? n0 : n0 + kBN * j) + 64 * p;
            if (n < N)
              tma_load_3d(sm.b[s][j][p], j ? &tb1 : &tb0, &sm.full[s], n,
                          kt * kBK, e);
          }
      }
    }
  } else {  // consumers: warpgroup c owns rows m0 + 64c .. + 63
    regs_alloc<240>();
    const int c = wgi - 1;
    const int tid = threadIdx.x - 128 * wgi;
    const int lane = tid & 31;
    float acc0[kBN / 2], acc1[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc0[i] = acc1[i] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&sm.full[s], (kt / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da =
            desc_sw128(&sm.a[s][64 * c * kBK + kk * 16], 16, 1024);
        const uint64_t db0 =
            desc_sw128(&sm.b[s][0][0][kk * 16 * 64], kPanelB * 2, 1024);
        const uint64_t db1 =
            desc_sw128(&sm.b[s][1][0][kk * 16 * 64], kPanelB * 2, 1024);
        wgmma_m64n128k16_ss<1>(acc0, da, db0, 1);
        wgmma_m64n128k16_ss<1>(acc1, da, db1, 1);
      }
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(&sm.empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);

    bf16* O = out + (long long)e * M * N;
    const int row0 = m0 + 64 * c + 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= M) continue;
      bf16* orow = O + (long long)row * N;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane & 3);
        const float a0 = acc0[4 * i + 2 * hh], a1 = acc0[4 * i + 2 * hh + 1];
        const float b0 = acc1[4 * i + 2 * hh], b1 = acc1[4 * i + 2 * hh + 1];
        if (GATED) {
          if (col < N)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(silu(a0) * b0, silu(a1) * b1);
        } else {
          if (col < N)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(a0, a1);
          if (col + kBN < N)
            *reinterpret_cast<__nv_bfloat162*>(orow + col + kBN) =
                __floats2bfloat162_rn(b0, b1);
        }
      }
    }
  }
}

template <bool GATED>
int run_pass(const CUtensorMap& ta, const CUtensorMap& tb0,
             const CUtensorMap& tb1, bf16* out, int E, int M, int N, int K,
             cudaStream_t st) {
  const int smem = (int)sizeof(Smem) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_gemm_wgmma<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const int bn = GATED ? kBN : 2 * kBN;
  const dim3 grid((M + kBM - 1) / kBM, (N + bn - 1) / bn, E);
  moe_gemm_wgmma<GATED><<<grid, kThreads, smem, st>>>(ta, tb0, tb1, out, M,
                                                       N, K);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* h, void* out, int E, int C, int d, int f, cudaStream_t st) {
  if (d % 8 != 0 || f % 8 != 0) return (int)cudaErrorInvalidValue;
  if ((d > f ? d : f) / kBN >= 65535) return (int)cudaErrorInvalidValue;
  using hopper::map_3d_bf16;
  CUtensorMap tx, tg, tu, th, td;
  int err = map_3d_bf16(&tx, x, E, C, d, kBM);
  if (!err) err = map_3d_bf16(&tg, wg, E, d, f, kBK);
  if (!err) err = map_3d_bf16(&tu, wu, E, d, f, kBK);
  if (!err) err = map_3d_bf16(&th, h, E, C, f, kBM);
  if (!err) err = map_3d_bf16(&td, wd, E, f, d, kBK);
  if (err) return err;
  err = run_pass<true>(tx, tg, tu, static_cast<bf16*>(h), E, C, f, d, st);
  if (err) return err;
  return run_pass<false>(th, td, td, static_cast<bf16*>(out), E, C, d, f,
                         st);
}

}  // namespace tc

namespace streaming {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;   // 8 column groups x 32 rows of K
constexpr int kCols = 64;       // columns per block
constexpr int kUnroll = 4;      // rows of K each thread has in flight

// out[e, c, n0 + j] for the block's 64 columns of expert e = blockIdx.y:
// GATED: silu(a b0) * (a b1) (a = x, b = wg/wu, out = h); else a b0
// (a = h, b = wd).  a (E, kC, K), b (E, K, N), out (E, kC, N).  VEC: N %
// 8 == 0 and b 16-byte aligned, so each thread loads its 8 columns of a
// row as one 16-byte vector.
template <int kC, bool GATED, bool VEC>
__global__ void __launch_bounds__(kThreads)
moe_gemm_stream(const bf16* __restrict__ a, const bf16* __restrict__ b0,
                const bf16* __restrict__ b1, bf16* __restrict__ out, int K,
                int N) {
  constexpr int kB = GATED ? 2 : 1;
  __shared__ float red[kThreads / 32][kB][kC][kCols];
  const int e = blockIdx.y;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int n = blockIdx.x * kCols + 8 * tx;
  const bf16* A = a + (long long)e * kC * K;
  const bf16* B[2] = {b0 + (long long)e * K * N,
                      GATED ? b1 + (long long)e * K * N : nullptr};

  float acc[kB][kC][8];
#pragma unroll
  for (int j = 0; j < kB; ++j)
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[j][c][q] = 0.f;

  auto load8 = [&](const bf16* row, float (&w)[8]) {
    if (VEC) {
      if (n < N) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + n));
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f2 = __bfloat1622float2(v2[q]);
          w[2 * q] = f2.x;
          w[2 * q + 1] = f2.y;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = 0.f;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        w[q] = n + q < N ? __bfloat162float(row[n + q]) : 0.f;
    }
  };

  for (int k = ty; k < K; k += 32 * kUnroll) {
    float w[kUnroll][kB][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kr = k + 32 * u;
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        if (kr < K) {
          load8(B[j] + (long long)kr * N, w[u][j]);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q) w[u][j][q] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kr = k + 32 * u;
      if (kr >= K) break;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float av = __bfloat162float(A[(long long)c * K + kr]);
#pragma unroll
        for (int j = 0; j < kB; ++j)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[j][c][q] = fmaf(av, w[u][j][q], acc[j][c][q]);
      }
    }
  }

  // the 4 rows of K a warp holds per column group (lanes tx, tx+8, ...)
#pragma unroll
  for (int j = 0; j < kB; ++j)
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float v = acc[j][c][q];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[j][c][q] = v;
      }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) < 8) {
#pragma unroll
    for (int j = 0; j < kB; ++j)
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int q = 0; q < 8; ++q) red[warp][j][c][8 * tx + q] = acc[j][c][q];
  }
  __syncthreads();
  bf16* O = out + (long long)e * kC * N;
  for (int i = threadIdx.x; i < kC * kCols; i += kThreads) {
    const int c = i / kCols, col = i % kCols;
    const int gn = blockIdx.x * kCols + col;
    if (gn >= N) continue;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      s0 += red[w][0][c][col];
      if (GATED) s1 += red[w][kB - 1][c][col];
    }
    const float val = GATED ? s0 / (1.f + expf(-s0)) * s1 : s0;
    O[(long long)c * N + gn] = __float2bfloat16_rn(val);
  }
}

template <int kC, bool GATED>
int run_pass(const bf16* a, const bf16* b0, const bf16* b1, bf16* out,
             int E, int K, int N, cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols, E);
  const bool vec = N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(b0) % 16 == 0 &&
                   (!GATED || reinterpret_cast<uintptr_t>(b1) % 16 == 0);
  if (vec)
    moe_gemm_stream<kC, GATED, true><<<grid, kThreads, 0, st>>>(a, b0, b1,
                                                                out, K, N);
  else
    moe_gemm_stream<kC, GATED, false><<<grid, kThreads, 0, st>>>(a, b0, b1,
                                                                 out, K, N);
  return (int)cudaGetLastError();
}

template <int kC>
int run(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd,
        bf16* h, bf16* out, int E, int d, int f, cudaStream_t st) {
  const int err = run_pass<kC, true>(x, wg, wu, h, E, d, f, st);
  if (err) return err;
  return run_pass<kC, false>(h, wd, nullptr, out, E, f, d, st);
}

int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* h, void* out, int E, int C, int d, int f, cudaStream_t st) {
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* gp = static_cast<const bf16*>(wg);
  const bf16* up = static_cast<const bf16*>(wu);
  const bf16* dp = static_cast<const bf16*>(wd);
  bf16* hp = static_cast<bf16*>(h);
  bf16* op = static_cast<bf16*>(out);
  switch (C) {
    case 1: return run<1>(xp, gp, up, dp, hp, op, E, d, f, st);
    case 2: return run<2>(xp, gp, up, dp, hp, op, E, d, f, st);
    case 3: return run<3>(xp, gp, up, dp, hp, op, E, d, f, st);
    case 4: return run<4>(xp, gp, up, dp, hp, op, E, d, f, st);
    case 5: return run<5>(xp, gp, up, dp, hp, op, E, d, f, st);
    case 6: return run<6>(xp, gp, up, dp, hp, op, E, d, f, st);
    case 7: return run<7>(xp, gp, up, dp, hp, op, E, d, f, st);
    case 8: return run<8>(xp, gp, up, dp, hp, op, E, d, f, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace streaming

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

// The wgmma variant (bf16, C > 8, d % 8 == 0, f % 8 == 0, every pointer
// 16-byte aligned) and the stream variant (bf16, C <= 8): the same
// arguments and contract as moe_gemm_launch_bf16.
extern "C" int moe_gemm_launch_bf16_wgmma(const void* x, const void* wg,
                                          const void* wu, const void* wd,
                                          void* h, void* out, int E, int C,
                                          int d, int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pre = precheck(E, C, d, f, 2, out, st);
  if (pre >= 0) return pre;
  return tc::launch(x, wg, wu, wd, h, out, E, C, d, f, st);
}

extern "C" int moe_gemm_launch_bf16_stream(const void* x, const void* wg,
                                           const void* wu, const void* wd,
                                           void* h, void* out, int E, int C,
                                           int d, int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pre = precheck(E, C, d, f, 2, out, st);
  if (pre >= 0) return pre;
  return streaming::launch(x, wg, wu, wd, h, out, E, C, d, f, st);
}
