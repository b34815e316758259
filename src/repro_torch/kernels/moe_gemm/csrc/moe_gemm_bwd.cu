// Backward of the grouped per-expert SwiGLU FFN (moe_gemm.cu) for Hopper
// (sm_90a): per expert e, with a = x wg and b = x wu (the forward's gate
// and up products),
//   h  = silu(a) * b                    (the value the forward rounded)
//   dh = dy wd^T
//   da = dh * b * silu'(a),   db = dh * silu(a)
// with silu'(a) = sigmoid(a) * (1 + a * (1 - sigmoid(a))).  The three
// products are summed in f32 over all of d, and da, db and h are written
// once, rounded to x's type.  The four weight-sized products that remain
// (dwd = h^T dy, dx = da wg^T + db wu^T, dwg = x^T da, dwu = x^T db) are
// plain grouped matrix products: the wrapper (ops.moe_gemm_bwd_k) leaves
// them to torch.bmm, as the JAX package leaves them to XLA.  The
// recompute and the SwiGLU derivative are this kernel's own work.
//
// Replaces no TPU kernel: the JAX package differentiates moe_block's three
// expert einsums by autodiff, and moe_gemm_pallas
// (src/repro/kernels/moe_gemm/kernel.py) has no backward.
//
// What bounds it: at the training shape (E = 64, C = 2,560, d = 2,048,
// f = 1,024) the three products are 6*E*C*d*f = 2.06 TFLOP against 3.1 GB
// of x, dy, the three weight stacks and the three outputs in bf16, so it
// is bound by operations: 2.08 ms at the bf16 tensor cores' 989 TFLOP/s.
//
// Two variants; ops.route_bwd picks one from dtype, shape and alignment.
// Both write every output element from exactly one block with a plain
// store (no atomics), and take consecutive C tiles of one weight panel in
// consecutive blocks, which share it through L2.
// "simt" (f32, and bf16 shapes "wgmma" does not take): the first version,
// on the CUDA cores in f32 (one FMA a multiply-add), the simt forward's
// tiling: one block of 256 threads (16 x 16) per (64-row C tile, 64-column
// f tile, expert), each thread a 4 x 4 tile of all three sums.  Each
// 32-deep step of d stages x and dy (transposed), wg and wu (as stored)
// and wd (transposed from its (f, d) rows) in shared memory as f32.
// "wgmma" (bf16, d and f multiples of 8, 16-byte aligned): the three
// products on the tensor cores, fed by TMA, on the forward "wgmma"
// gate/up mainloop (moe_gemm.cu) with a second A tile (dy) and a third
// accumulator.  A CTA of three warpgroups per (128-row C tile, 64-column
// f tile, expert): the first issues TMA loads from one thread into a
// 4-stage mbarrier ring, each 56 KB stage 64 values of d of x and dy (128
// rows each), wg and wu (64 x 64) and wd (64 x 64); the other two each own
// 64 C rows and keep the three 64 x 64 f32 sums a, b and dh in registers
// (96 a thread).  x and dy are K-major A operands; wg and wu are MN-major
// B operands read in their stored (E, d, f) layout, as the forward reads
// them; wd (E, f, d), read as stored, is the K-major B operand of
// dh = dy wd^T (d is contiguous), so nothing is transposed or copied.
// Ragged C, d and f arrive as zeros and stores are guarded.  C tiles are
// the fastest grid dimension.  The epilogue is "simt"'s, on the
// accumulator layout, with bf16x2 stores.  What holds it from the bound
// is the rate at which L2 feeds the SMs: every CTA streams 1.8 MB of x, dy
// and weight panels (37.6 GB a call at the training shape, all of it L2
// hits).  A 128-column f tile reads 26.8 GB, but its three 64 x 128 sums
// leave room for two 80 KB stages only (or five 40 KB stages of 32 values
// of d, 64-byte swizzled), and both ran slower on the H100 (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;   // 16 x 16: rows ty + 16 i, columns tx + 16 j

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_bwd_hidden(const T* __restrict__ x, const T* __restrict__ wg,
               const T* __restrict__ wu, const T* __restrict__ wd,
               const T* __restrict__ dy, T* __restrict__ da,
               T* __restrict__ db, T* __restrict__ h, int C, int d, int f) {
  __shared__ float Xs[kBK][kBM + 1];   // x tile, k-major
  __shared__ float Ys[kBK][kBM + 1];   // dy tile, k-major
  __shared__ float Gs[kBK][kBN];       // wg tile
  __shared__ float Us[kBK][kBN];       // wu tile
  __shared__ float Ws[kBK][kBN + 1];   // wd tile, transposed to k-major

  const int e = blockIdx.z;
  const int c0 = blockIdx.x * kBM, f0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* xe = x + (long long)e * C * d;
  const T* ye = dy + (long long)e * C * d;
  const T* ge = wg + (long long)e * d * f;
  const T* ue = wu + (long long)e * d * f;
  const T* we = wd + (long long)e * f * d;

  float sa[4][4], sb[4][4], sh[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sa[i][j] = sb[i][j] = sh[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // x and dy: kBM rows of kBK consecutive values of d
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const int gr = c0 + r, gc = k0 + c;
      float xv = 0.f, yv = 0.f;
      if (gr < C && gc < d) {
        xv = to_f(xe[(long long)gr * d + gc]);
        yv = to_f(ye[(long long)gr * d + gc]);
      }
      Xs[c][r] = xv;
      Ys[c][r] = yv;
    }
    // wg and wu: kBK rows of d, kBN consecutive columns of f
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i - r * kBN;
      const int gr = k0 + r, gc = f0 + c;
      float gv = 0.f, uv = 0.f;
      if (gr < d && gc < f) {
        gv = to_f(ge[(long long)gr * f + gc]);
        uv = to_f(ue[(long long)gr * f + gc]);
      }
      Gs[r][c] = gv;
      Us[r][c] = uv;
    }
    // wd: kBN rows of f, kBK consecutive values of d
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const int gr = f0 + r, gc = k0 + c;
      Ws[c][r] = (gr < f && gc < d) ? to_f(we[(long long)gr * d + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float xr[4], yr[4], gv[4], uv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xr[i] = Xs[kk][ty + 16 * i];
        yr[i] = Ys[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[j] = Gs[kk][tx + 16 * j];
        uv[j] = Us[kk][tx + 16 * j];
        wv[j] = Ws[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sa[i][j] = fmaf(xr[i], gv[j], sa[i][j]);
          sb[i][j] = fmaf(xr[i], uv[j], sb[i][j]);
          sh[i][j] = fmaf(yr[i], wv[j], sh[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = c0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + tx + 16 * j;
      if (col >= f) continue;
      const float a = sa[i][j], bv = sb[i][j], dh = sh[i][j];
      const float ex = expf(-a);
      const float sig = 1.f / (1.f + ex);
      const float s = a / (1.f + ex);      // silu(a), as the forward has it
      const long long idx = ((long long)e * C + r) * f + col;
      h[idx] = from_f<T>(s * bv);
      da[idx] = from_f<T>(dh * bv * (sig * (1.f + a * (1.f - sig))));
      db[idx] = from_f<T>(dh * s);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           const void* dy, void* da, void* db, void* h, int E, int C, int d,
           int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || f <= 0) return 0;
  if (d < 0 || E > 65535 || (f + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 0) {  // a = b = dh = 0: every output is 0
    const size_t n = sizeof(T) * (size_t)E * C * f;
    cudaMemsetAsync(da, 0, n, st);
    cudaMemsetAsync(db, 0, n, st);
    cudaMemsetAsync(h, 0, n, st);
    return (int)cudaGetLastError();
  }
  const dim3 grid((C + kBM - 1) / kBM, (f + kBN - 1) / kBN, E);
  moe_bwd_hidden<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<const T*>(dy), static_cast<T*>(da), static_cast<T*>(db),
      static_cast<T*>(h), C, d, f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "wgmma": bf16 on the tensor cores, TMA-fed, warp-specialised
// ---------------------------------------------------------------------------
namespace warpgroup {

using bf16 = __nv_bfloat16;
constexpr int kBM = 128;       // C rows per CTA: two consumer warpgroups
constexpr int kBN = 64;        // f columns per CTA: one 64-column panel
constexpr int kBK = 64;        // depth per stage: one swizzled panel
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kTileA = kBM * kBK;   // elements of x's or dy's stage tile
constexpr int kPanel = kBK * kBN;   // elements of wg's, wu's or wd's

// Four 56 KB stages: 64 values of d of x and dy (128 rows each), wg and wu
// (64 x 64, MN-major) and wd (64 x 64, K-major).
struct Smem {
  bf16 x[kStages][kTileA];
  bf16 dy[kStages][kTileA];
  bf16 g[kStages][kPanel];
  bf16 u[kStages][kPanel];
  bf16 w[kStages][kPanel];
  uint64_t full[kStages], empty[kStages];
};

// da, db and h for rows m0 .. m0 + 127 and columns n0 .. n0 + 63 of
// expert e = blockIdx.z, through the maps of x and dy (d, C, E), wg and wu
// (f, d, E) and wd (d, f, E).
__global__ void __launch_bounds__(kThreads, 1)
moe_bwd_hidden_wgmma(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tdy,
                     const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap tu,
                     const __grid_constant__ CUtensorMap tw,
                     bf16* __restrict__ da, bf16* __restrict__ db,
                     bf16* __restrict__ h, int C, int d, int f) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1k(smem_raw));
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int n_k = (d + kBK - 1) / kBK;

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
      const uint32_t bytes = 2u * (2 * kTileA + 3 * kPanel);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&sm.empty[s], ((kt / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[s], bytes);
        tma_load_3d(sm.x[s], &tx, &sm.full[s], kt * kBK, m0, e);
        tma_load_3d(sm.dy[s], &tdy, &sm.full[s], kt * kBK, m0, e);
        tma_load_3d(sm.g[s], &tg, &sm.full[s], n0, kt * kBK, e);
        tma_load_3d(sm.u[s], &tu, &sm.full[s], n0, kt * kBK, e);
        tma_load_3d(sm.w[s], &tw, &sm.full[s], kt * kBK, n0, e);
      }
    }
  } else {  // consumers: warpgroup c owns rows m0 + 64c .. + 63
    regs_alloc<240>();
    const int c = wgi - 1;
    const int tid = threadIdx.x - 128 * wgi;
    const int lane = tid & 31;
    float acc_a[kBN / 2], acc_b[kBN / 2], acc_h[kBN / 2];   // a, b, dh
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc_a[i] = acc_b[i] = acc_h[i] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&sm.full[s], (kt / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // K-major: a k16 step is 32 bytes along the row; MN-major: 16 rows
        const uint64_t dx =
            desc_sw128(&sm.x[s][64 * c * kBK + kk * 16], 16, 1024);
        const uint64_t ddy =
            desc_sw128(&sm.dy[s][64 * c * kBK + kk * 16], 16, 1024);
        const uint64_t dg =
            desc_sw128(&sm.g[s][kk * 16 * 64], kPanel * 2, 1024);
        const uint64_t du =
            desc_sw128(&sm.u[s][kk * 16 * 64], kPanel * 2, 1024);
        const uint64_t dw = desc_sw128(&sm.w[s][kk * 16], 16, 1024);
        wgmma_m64n64k16_ss<1>(acc_a, dx, dg, 1);
        wgmma_m64n64k16_ss<1>(acc_b, dx, du, 1);
        wgmma_m64n64k16_ss<0>(acc_h, ddy, dw, 1);
      }
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(&sm.empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc_a);
    fence_regs(acc_b);
    fence_regs(acc_h);

    const int row0 = m0 + 64 * c + 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= C) continue;
      const long long base = ((long long)e * C + row) * f;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane & 3);
        if (col >= f) continue;
        float hv[2], dav[2], dbv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float a = acc_a[4 * i + 2 * hh + q];
          const float bv = acc_b[4 * i + 2 * hh + q];
          const float dh = acc_h[4 * i + 2 * hh + q];
          const float ex = expf(-a);
          const float sig = 1.f / (1.f + ex);
          const float sa = a / (1.f + ex);   // silu(a), as the forward has it
          hv[q] = sa * bv;
          dav[q] = dh * bv * (sig * (1.f + a * (1.f - sig)));
          dbv[q] = dh * sa;
        }
        *reinterpret_cast<__nv_bfloat162*>(h + base + col) =
            __floats2bfloat162_rn(hv[0], hv[1]);
        *reinterpret_cast<__nv_bfloat162*>(da + base + col) =
            __floats2bfloat162_rn(dav[0], dav[1]);
        *reinterpret_cast<__nv_bfloat162*>(db + base + col) =
            __floats2bfloat162_rn(dbv[0], dbv[1]);
      }
    }
  }
}

int launch(const void* x, const void* wg, const void* wu, const void* wd,
           const void* dy, void* da, void* db, void* h, int E, int C, int d,
           int f, void* stream) {
  using hopper::map_3d_bf16;
  if (E <= 0 || C <= 0 || f <= 0) return 0;
  if (d <= 0 || d % 8 || f % 8 || E > 65535 || (f + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tdy, tg, tu, tw;
  int err = map_3d_bf16(&tx, x, E, C, d, kBM);
  if (!err) err = map_3d_bf16(&tdy, dy, E, C, d, kBM);
  if (!err) err = map_3d_bf16(&tg, wg, E, d, f, kBK);
  if (!err) err = map_3d_bf16(&tu, wu, E, d, f, kBK);
  if (!err) err = map_3d_bf16(&tw, wd, E, f, d, kBN);
  if (err) return err;
  const int smem = (int)sizeof(Smem) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_bwd_hidden_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((C + kBM - 1) / kBM, (f + kBN - 1) / kBN, E);
  moe_bwd_hidden_wgmma<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      tx, tdy, tg, tu, tw, static_cast<bf16*>(da), static_cast<bf16*>(db),
      static_cast<bf16*>(h), C, d, f);
  return (int)cudaGetLastError();
}

}  // namespace warpgroup

}  // namespace

// The "wgmma" variant: bf16, d % 8 == 0, f % 8 == 0, every pointer
// 16-byte aligned; otherwise as below.
extern "C" int moe_gemm_bwd_launch_bf16_wgmma(const void* x, const void* wg,
                                              const void* wu, const void* wd,
                                              const void* dy, void* da,
                                              void* db, void* h, int E,
                                              int C, int d, int f,
                                              void* stream) {
  return warpgroup::launch(x, wg, wu, wd, dy, da, db, h, E, C, d, f, stream);
}

// x, dy (E, C, d); wg, wu (E, d, f); wd (E, f, d); da, db, h (E, C, f); all
// contiguous, of one dtype, on the current device, E <= 65535.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).  Does not
// synchronise.
extern "C" int moe_gemm_bwd_launch_f32(const void* x, const void* wg,
                                       const void* wu, const void* wd,
                                       const void* dy, void* da, void* db,
                                       void* h, int E, int C, int d, int f,
                                       void* stream) {
  return launch<float>(x, wg, wu, wd, dy, da, db, h, E, C, d, f, stream);
}

extern "C" int moe_gemm_bwd_launch_bf16(const void* x, const void* wg,
                                        const void* wu, const void* wd,
                                        const void* dy, void* da, void* db,
                                        void* h, int E, int C, int d, int f,
                                        void* stream) {
  return launch<__nv_bfloat16>(x, wg, wu, wd, dy, da, db, h, E, C, d, f,
                               stream);
}
