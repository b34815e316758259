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
// "simt" (f32, and bf16 shapes "mma" does not take): the first version,
// on the CUDA cores in f32 (one FMA a multiply-add), the simt forward's
// tiling: one block of 256 threads (16 x 16) per (64-row C tile, 64-column
// f tile, expert), each thread a 4 x 4 tile of all three sums.  Each
// 32-deep step of d stages x and dy (transposed), wg and wu (as stored)
// and wd (transposed from its (f, d) rows) in shared memory as f32.
// "mma" (bf16, d and f multiples of 8): the three products on the tensor
// cores through warp-level mma.sync (m16n8k16, bf16 in, f32 sums): one
// block of 8 warps per (128-row C tile, 64-column f tile, expert), each
// warp 32 x 32 of all three sums; operands staged in shared memory as bf16
// with d contiguous, one step of 32 at a time, no pipelining.  wgmma with
// TMA (the forward's "wgmma" mainloop, which already computes x wg and
// x wu) is the redesign (ROADMAP.md queue A item 9).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// "mma": bf16 on the tensor cores through mma.sync (m16n8k16, f32 sums)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBM = 128, kBN = 64, kBK = 32;
constexpr int kPitch = kBK + 8;   // 80-byte rows: fragment loads miss no bank

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One block of 256 threads (8 warps as 4 x 2, each 32 x 32 of all three
// sums) per (128-row C tile, 64-column f tile, expert).  Each 32-deep step
// of d stages, as bf16 in shared memory with k contiguous: x and dy rows;
// wd rows (f, d) as stored; wg and wu transposed to (f, d).  16-byte loads,
// zeros past C and f (d and f are multiples of 8, so a chunk of 8 is
// wholly in or out).
__global__ void __launch_bounds__(256)
moe_bwd_hidden_mma(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                   const bf16* __restrict__ dy, bf16* __restrict__ da,
                   bf16* __restrict__ db, bf16* __restrict__ h, int C, int d,
                   int f) {
  __shared__ __align__(16) bf16 Xs[kBM][kPitch];
  __shared__ __align__(16) bf16 Ys[kBM][kPitch];
  __shared__ __align__(16) bf16 Gt[kBN][kPitch];
  __shared__ __align__(16) bf16 Ut[kBN][kPitch];
  __shared__ __align__(16) bf16 Ws[kBN][kPitch];

  const int e = blockIdx.z;
  const int c0 = blockIdx.x * kBM, f0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const bf16* xe = x + (long long)e * C * d;
  const bf16* ye = dy + (long long)e * C * d;
  const bf16* ge = wg + (long long)e * d * f;
  const bf16* ue = wu + (long long)e * d * f;
  const bf16* we = wd + (long long)e * f * d;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float acc[3][2][4][4];   // (a, b, dh) x m16 tile x n8 tile x fragment
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[q][i][j][r] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // x and dy: 128 rows x 4 chunks of 8; 2 chunks a thread each
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = tid + 256 * it;
      const int r = i >> 2, c8 = (i & 3) * 8;
      const bool ok = c0 + r < C && k0 + c8 < d;
      const long long off = (long long)(c0 + r) * d + k0 + c8;
      *reinterpret_cast<uint4*>(&Xs[r][c8]) =
          ok ? *reinterpret_cast<const uint4*>(xe + off) : zero;
      *reinterpret_cast<uint4*>(&Ys[r][c8]) =
          ok ? *reinterpret_cast<const uint4*>(ye + off) : zero;
    }
    {  // wd: 64 rows of f x 4 chunks of d
      const int r = tid >> 2, c8 = (tid & 3) * 8;
      const bool ok = f0 + r < f && k0 + c8 < d;
      *reinterpret_cast<uint4*>(&Ws[r][c8]) =
          ok ? *reinterpret_cast<const uint4*>(
                   we + (long long)(f0 + r) * d + k0 + c8)
             : zero;
    }
    {  // wg, wu: 32 rows of d x 8 chunks of f, stored transposed; a warp
       // takes 32 consecutive rows of one chunk, so its 2-byte stores fill
       // one row of Gt and Ut without a bank conflict
      const int kr = tid & 31, n8 = (tid >> 5) * 8;
      const bool ok = k0 + kr < d && f0 + n8 < f;
      const long long off = (long long)(k0 + kr) * f + f0 + n8;
      uint4 gv = ok ? *reinterpret_cast<const uint4*>(ge + off) : zero;
      uint4 uv = ok ? *reinterpret_cast<const uint4*>(ue + off) : zero;
      const bf16* gp = reinterpret_cast<const bf16*>(&gv);
      const bf16* up = reinterpret_cast<const bf16*>(&uv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Gt[n8 + j][kr] = gp[j];
        Ut[n8 + j][kr] = up[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t ax[2][4], ay[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        ax[i][0] = ld32(&Xs[r][ks + 2 * t]);
        ax[i][1] = ld32(&Xs[r + 8][ks + 2 * t]);
        ax[i][2] = ld32(&Xs[r][ks + 2 * t + 8]);
        ax[i][3] = ld32(&Xs[r + 8][ks + 2 * t + 8]);
        ay[i][0] = ld32(&Ys[r][ks + 2 * t]);
        ay[i][1] = ld32(&Ys[r + 8][ks + 2 * t]);
        ay[i][2] = ld32(&Ys[r][ks + 2 * t + 8]);
        ay[i][3] = ld32(&Ys[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + g;
        const uint32_t g0 = ld32(&Gt[n][ks + 2 * t]);
        const uint32_t g1 = ld32(&Gt[n][ks + 2 * t + 8]);
        const uint32_t u0 = ld32(&Ut[n][ks + 2 * t]);
        const uint32_t u1 = ld32(&Ut[n][ks + 2 * t + 8]);
        const uint32_t w0 = ld32(&Ws[n][ks + 2 * t]);
        const uint32_t w1 = ld32(&Ws[n][ks + 2 * t + 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[0][i][j], ax[i], g0, g1);
          mma(acc[1][i][j], ax[i], u0, u1);
          mma(acc[2][i][j], ay[i], w0, w1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = c0 + wm + 16 * i + g + 8 * hh;
        const int col = f0 + wn + 8 * j + 2 * t;
        if (r >= C || col >= f) continue;
        float hv[2], dav[2], dbv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float a = acc[0][i][j][2 * hh + q];
          const float bv = acc[1][i][j][2 * hh + q];
          const float dh = acc[2][i][j][2 * hh + q];
          const float ex = expf(-a);
          const float sig = 1.f / (1.f + ex);
          const float s = a / (1.f + ex);
          hv[q] = s * bv;
          dav[q] = dh * bv * (sig * (1.f + a * (1.f - sig)));
          dbv[q] = dh * s;
        }
        const long long idx = ((long long)e * C + r) * f + col;
        *reinterpret_cast<__nv_bfloat162*>(h + idx) =
            __floats2bfloat162_rn(hv[0], hv[1]);
        *reinterpret_cast<__nv_bfloat162*>(da + idx) =
            __floats2bfloat162_rn(dav[0], dav[1]);
        *reinterpret_cast<__nv_bfloat162*>(db + idx) =
            __floats2bfloat162_rn(dbv[0], dbv[1]);
      }
}

int launch(const void* x, const void* wg, const void* wu, const void* wd,
           const void* dy, void* da, void* db, void* h, int E, int C, int d,
           int f, void* stream) {
  if (E <= 0 || C <= 0 || f <= 0) return 0;
  if (d <= 0 || d % 8 || f % 8 || E > 65535 || (f + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kBM - 1) / kBM, (f + kBN - 1) / kBN, E);
  moe_bwd_hidden_mma<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
      static_cast<const bf16*>(dy), static_cast<bf16*>(da),
      static_cast<bf16*>(db), static_cast<bf16*>(h), C, d, f);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The "mma" variant: bf16, d % 8 == 0, f % 8 == 0, every pointer 16-byte
// aligned; otherwise as below.
extern "C" int moe_gemm_bwd_launch_bf16_mma(const void* x, const void* wg,
                                            const void* wu, const void* wd,
                                            const void* dy, void* da,
                                            void* db, void* h, int E, int C,
                                            int d, int f, void* stream) {
  return tc::launch(x, wg, wu, wd, dy, da, db, h, E, C, d, f, stream);
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
