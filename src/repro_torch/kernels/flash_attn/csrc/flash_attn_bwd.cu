// Backward of softmax attention for Hopper (sm_90a), in FlashAttention-2's
// form: three kernels, launched back to back on one stream by the wrapper
// (ops.flash_attention_bwd_k):
//   1. flash_bwd_delta: delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]
//      in f32, one warp a row;
//   2. flash_bwd_dkdv: one block per (64-key tile, b, kv head).  For each
//      query head of the kv head's group (GQA's dK and dV are sums over
//      them) and each 64-query tile that the causal mask lets see the key
//      tile, it recomputes s = q . k * D^-0.5 and P = exp(s - lse), then
//      dV += P^T dO, dP = dO V^T, dS = P * (dP - delta), dK += dS^T Q;
//   3. flash_bwd_dq: one block per (64-query tile, b, h).  Over the key
//      tiles its queries see: the same P and dS, dQ += dS K.
// dK and dQ are scaled by D^-0.5 once, at the end.  Each output element is
// written by exactly one block, once, with a plain store: no atomics, so
// two calls give the same bits (the trainer's replay needs that).
// Key tiles above the diagonal are skipped in dq (the forward's rule, from
// the tile's last query), and query tiles below it in dkdv (the first query
// tile with q_offset + i >= the tile's first key); the diagonal tiles, and
// rows past Sq or keys past Skv, are masked per element.
//
// Replaces no TPU kernel: the JAX package differentiates its attention by
// autodiff of plain JAX, and flash_attention_pallas
// (src/repro/kernels/flash_attn/kernel.py) has no backward.  It is the
// gradient of this port's flash_attn.cu, whose forward writes lse from the
// same running max and denominator that scaled its output, so the P
// recomputed here sums to 1.
//
// What bounds it: at the training shape (B*H = 64, S = 4,096, D = 128,
// causal) the work is 14*D flops per kept (query, key) pair, 8 in dkdv (S,
// dP, dV, dK) and 6 in dq (S, dP, dQ): 0.96 TFLOP against 0.54 GB of q, k,
// v, o, dO, lse and the three gradients in bf16, so it is bound by
// operations: 0.97 ms at the bf16 tensor cores' 989 TFLOP/s.
//
// Design: the first version, on the CUDA cores in f32 for both dtypes (one
// FMA a multiply-add), on the simt forward's skeleton: 256 threads as
// 16 x 16, 64-row tiles staged in shared memory as f32 with odd row pitches
// (the 16 rows a half-warp reads in one column fall in 16 banks), each
// thread a 4 x 4 tile of S and dP and a 4 x ceil(D/16) tile of each
// accumulator.  The tensor cores (wgmma, as the forward's "wgmma" variant)
// are the redesign (ROADMAP.md queue A item 9).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // rows of a query or key tile
constexpr int kThreads = 256;   // 16 x 16: rows ty + 16 i, columns tx + 16 j
constexpr int kMaxD = 128;
constexpr int kDPer = kMaxD / 16;  // accumulator columns per thread

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

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), one warp per (b, s, h) row in memory order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int H, int Sq, int D,
                long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* op = o + row * D;
  const T* dp = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int s = (int)(bs % Sq);
    const long long b = bs / Sq;
    delta[(b * H + h) * Sq + s] = acc;
  }
}

// Stage rows r0 .. r0 + 63 of two (B, S, heads, D) tensors at one head as
// f32 (rows past S as zeros): a and b point at the head's row 0.
template <typename T>
__device__ __forceinline__ void stage2(float* As, float* Bs, const T* a,
                                       const T* b, long long stride, int r0,
                                       int S, int D, int ld) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int s = r0 + r;
    float av = 0.f, bv = 0.f;
    if (s < S) {
      av = to_f(a[s * stride + c]);
      bv = to_f(b[s * stride + c]);
    }
    As[r * ld + c] = av;
    Bs[r * ld + c] = bv;
  }
}

// Shared memory of both gradient kernels: four kB x (D + 1) tiles, `np`
// kB x (kB + 1) tiles of P or dS, and lse and delta of kB queries.
size_t smem_bytes(int D, int np) {
  return sizeof(float) * (4 * (size_t)kB * (D + 1) +
                          (size_t)np * kB * (kB + 1) + 2 * kB);
}

// ---------------------------------------------------------------------------
// 2. dK, dV: one block per (key tile, b, kv head)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int Hk, int Sq,
               int Skv, int D, int causal, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1, ldp = kB + 1;
  float* Ks = smem;             // kB keys x ld
  float* Vs = Ks + kB * ld;
  float* Qs = Vs + kB * ld;     // kB queries x ld
  float* dOs = Qs + kB * ld;
  float* Ps = dOs + kB * ld;    // P^T: key x query
  float* dSs = Ps + kB * ldp;   // dS^T
  float* Ls = dSs + kB * ldp;   // lse of the tile's queries
  float* Ds = Ls + kB;          // delta of the tile's queries

  const int hk = blockIdx.y % Hk, b = blockIdx.y / Hk;
  const int rep = H / Hk;
  const int k0 = blockIdx.x * kB;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long q_stride = (long long)H * D;   // between positions
  const long long kv_stride = (long long)Hk * D;
  stage2(Ks, Vs, k + ((long long)b * Skv * Hk + hk) * D,
         v + ((long long)b * Skv * Hk + hk) * D, kv_stride, k0, Skv, D, ld);

  float adk[4][kDPer], adv[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) adk[i][jj] = adv[i][jj] = 0.f;

  // the first query tile with a query that sees this tile's first key
  const int t_first = causal ? max(0, k0 - q_offset) / kB : 0;
  const int n_qt = (Sq + kB - 1) / kB;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const long long head = (long long)b * Sq * H + h;
    const float* lb = lse + ((long long)b * H + h) * Sq;
    const float* db = delta + ((long long)b * H + h) * Sq;
    for (int t = t_first; t < n_qt; ++t) {
      const int q0 = t * kB;
      __syncthreads();  // the previous tile's readers are done
      stage2(Qs, dOs, q + head * D, dout + head * D, q_stride, q0, Sq, D, ld);
      if (tid < kB) {
        const int s = q0 + tid;
        Ls[tid] = s < Sq ? lb[s] : 0.f;
        Ds[tid] = s < Sq ? db[s] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty + 16 i and queries tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < D; ++c) {
        float kk[4], vv[4], qq[4], oo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = Ks[(ty + 16 * i) * ld + c];
          vv[i] = Vs[(ty + 16 * i) * ld + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qq[j] = Qs[(tx + 16 * j) * ld + c];
          oo[j] = dOs[(tx + 16 * j) * ld + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(kk[i], qq[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty + 16 * i, key = k0 + kr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j, qrow = q0 + qi;
          float p = 0.f;
          if (key < Skv && qrow < Sq && !(causal && key > qrow + q_offset))
            p = expf(sc[i][j] * scale - Ls[qi]);
          Ps[kr * ldp + qi] = p;
          dSs[kr * ldp + qi] = p * (dp[i][j] - Ds[qi]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's queries
      for (int j = 0; j < kB; ++j) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * ldp + j];
          sv[i] = dSs[(ty + 16 * i) * ldp + j];
        }
#pragma unroll
        for (int jj = 0; jj < kDPer; ++jj) {
          const int c = tx + 16 * jj;
          const float od = c < D ? dOs[j * ld + c] : 0.f;
          const float qd = c < D ? Qs[j * ld + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][jj] = fmaf(pv[i], od, adv[i][jj]);
            adk[i][jj] = fmaf(sv[i], qd, adk[i][jj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Skv) continue;
    const long long base = (((long long)b * Skv + key) * Hk + hk) * D;
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) {
        dk[base + c] = from_f<T>(adk[i][jj] * scale);
        dv[base + c] = from_f<T>(adv[i][jj]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (query tile, b, h)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int H, int Hk, int Sq, int Skv, int D,
             int causal, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1, ldp = kB + 1;
  float* Qs = smem;             // kB queries x ld
  float* dOs = Qs + kB * ld;
  float* Ks = dOs + kB * ld;    // kB keys x ld
  float* Vs = Ks + kB * ld;
  float* dSs = Vs + kB * ld;    // dS: query x key
  float* Ls = dSs + kB * ldp;
  float* Ds = Ls + kB;

  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * kB;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hk * D;
  const long long head = (long long)b * Sq * H + h;
  stage2(Qs, dOs, q + head * D, dout + head * D, q_stride, q0, Sq, D, ld);
  if (tid < kB) {
    const int s = q0 + tid;
    const long long lrow = ((long long)b * H + h) * Sq;
    Ls[tid] = s < Sq ? lse[lrow + s] : 0.f;
    Ds[tid] = s < Sq ? delta[lrow + s] : 0.f;
  }
  const T* kb = k + ((long long)b * Skv * Hk + hk) * D;
  const T* vb = v + ((long long)b * Skv * Hk + hk) * D;

  float adq[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) adq[i][jj] = 0.f;

  int n_tiles = (Skv + kB - 1) / kB;
  if (causal)  // the block's last query sees keys up to its position
    n_tiles = min(n_tiles, (min(q0 + kB, Sq) - 1 + q_offset) / kB + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's readers are done
    stage2(Ks, Vs, kb, vb, kv_stride, k0, Skv, D, ld);
    __syncthreads();

    // S and dP for queries ty + 16 i and keys tx + 16 j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qq[4], oo[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qq[i] = Qs[(ty + 16 * i) * ld + c];
        oo[i] = dOs[(ty + 16 * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = Ks[(tx + 16 * j) * ld + c];
        vv[j] = Vs[(tx + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qq[i], kk[j], sc[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty + 16 * i, qrow = q0 + qi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j, key = k0 + kc;
        float ds = 0.f;
        if (key < Skv && qrow < Sq && !(causal && key > qrow + q_offset))
          ds = expf(sc[i][j] * scale - Ls[qi]) * (dp[i][j] - Ds[qi]);
        dSs[qi * ldp + kc] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's keys
    for (int j = 0; j < kB; ++j) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * ldp + j];
#pragma unroll
      for (int jj = 0; jj < kDPer; ++jj) {
        const int c = tx + 16 * jj;
        const float kd = c < D ? Ks[j * ld + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) adq[i][jj] = fmaf(sv[i], kd, adq[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const long long base = (head + (long long)s * H) * D;
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) dq[base + c] = from_f<T>(adq[i][jj] * scale);
    }
  }
}

bool bad_shape(int B, int H, int Hk, int Sq, int Skv, int D, int q_offset) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || D < 1 || D > kMaxD || Hk < 1 ||
         H % Hk != 0 || q_offset < 0;
}

template <typename T>
int launch_delta(const void* o, const void* dout, void* delta, int B, int H,
                 int Sq, int D, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || D < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * Sq * H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_bwd_delta<T><<<(unsigned)blocks, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), H, Sq, D, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int H, int Hk, int Sq, int Skv,
                int D, int causal, int q_offset, void* stream) {
  if (bad_shape(B, H, Hk, Sq, Skv, D, q_offset) || B * Hk > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD, 2));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Skv + kB - 1) / kB, B * Hk);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_bwd_dkdv<T><<<grid, kThreads, smem_bytes(D, 2),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hk, Sq, Skv, D, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Hk, int Sq, int Skv, int D, int causal, int q_offset,
              void* stream) {
  if (bad_shape(B, H, Hk, Sq, Skv, D, q_offset) || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD, 1));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + kB - 1) / kB, B * H);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_bwd_dq<T><<<grid, kThreads, smem_bytes(D, 1),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Hk, Sq, Skv, D, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "mma": dkdv and dq in bf16 on the tensor cores through mma.sync
// (m16n8k16, bf16 in, f32 sums)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;          // a warp owns 16 rows of the block's 64
constexpr int kTcThreads = 32 * kWarps;
constexpr int kPT = kB + 8;        // pitch of a transposed (D x 64) tile

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

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (16 rows x 16 columns) of rows r0 .. r0 + 15 and columns
// c0 .. c0 + 15 of a row-major bf16 tile with pitch `ld`.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int ld,
                                       int r0, int c0, int g, int t) {
  a[0] = ld32(tile + (r0 + g) * ld + c0 + 2 * t);
  a[1] = ld32(tile + (r0 + g + 8) * ld + c0 + 2 * t);
  a[2] = ld32(tile + (r0 + g) * ld + c0 + 2 * t + 8);
  a[3] = ld32(tile + (r0 + g + 8) * ld + c0 + 2 * t + 8);
}

// The A fragments of a 16 x 32 block held as four n8 accumulator tiles
// (the C layout of m16n8 is the A layout of m16k16, two tiles a step).
__device__ __forceinline__ void acc_to_a(uint32_t (*a)[4], float (*c)[4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    a[s][0] = pack2(c[2 * s][0], c[2 * s][1]);
    a[s][1] = pack2(c[2 * s][2], c[2 * s][3]);
    a[s][2] = pack2(c[2 * s + 1][0], c[2 * s + 1][1]);
    a[s][3] = pack2(c[2 * s + 1][2], c[2 * s + 1][3]);
  }
}

// Stage rows r0 .. r0 + 63 of a (B, S, heads, D) bf16 tensor at one head
// (`a` points at the head's row 0) into As (64 x (kD + 8), row-major) and,
// when At is not null, its transpose At (kD x kPT); zeros past S and D.
// A warp takes 32 consecutive rows of one 8-column chunk, so its 2-byte
// stores into At fill one row without a bank conflict.
template <int kD>
__device__ __forceinline__ void stage(bf16* As, bf16* At, const bf16* a,
                                      long long stride, int r0, int S,
                                      int D) {
  constexpr int P = kD + 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kB * (kD / 8); i += kTcThreads) {
    const int r = i % kB, c8 = (i / kB) * 8;
    const uint4 v = (r0 + r < S && c8 < D)
                        ? *reinterpret_cast<const uint4*>(
                              a + (r0 + r) * stride + c8)
                        : zero;
    *reinterpret_cast<uint4*>(As + r * P + c8) = v;
    if (At != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) At[(c8 + j) * kPT + r] = e[j];
    }
  }
}

template <int kD>
size_t smem_bytes_tc() {   // four 64-row tiles, two transposed, lse, delta
  return sizeof(bf16) * (4 * (size_t)kB * (kD + 8) + 2 * (size_t)kD * kPT) +
         sizeof(float) * 2 * kB;
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int H, int Hk, int Sq, int Skv,
                   int D, int causal, int q_offset, float scale) {
  constexpr int P = kD + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kB * P;
  bf16* Qs = Vs + kB * P;
  bf16* dOs = Qs + kB * P;
  bf16* Qt = dOs + kB * P;          // kD x kPT
  bf16* dOt = Qt + kD * kPT;
  float* Ls = reinterpret_cast<float*>(dOt + kD * kPT);
  float* Ds = Ls + kB;

  const int hk = blockIdx.y % Hk, b = blockIdx.y / Hk;
  const int rep = H / Hk;
  const int k0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = 16 * warp;            // the warp's first key in the tile
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hk * D;
  stage<kD>(Ks, nullptr, k + ((long long)b * Skv * Hk + hk) * D, kv_stride,
            k0, Skv, D);
  stage<kD>(Vs, nullptr, v + ((long long)b * Skv * Hk + hk) * D, kv_stride,
            k0, Skv, D);

  float adk[kD / 8][4], adv[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  const int t_first = causal ? max(0, k0 - q_offset) / kB : 0;
  const int n_qt = (Sq + kB - 1) / kB;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const long long head = (long long)b * Sq * H + h;
    const float* lb = lse + ((long long)b * H + h) * Sq;
    const float* db = delta + ((long long)b * H + h) * Sq;
    for (int tq = t_first; tq < n_qt; ++tq) {
      const int q0 = tq * kB;
      __syncthreads();  // the previous tile's readers are done
      stage<kD>(Qs, Qt, q + head * D, q_stride, q0, Sq, D);
      stage<kD>(dOs, dOt, dout + head * D, q_stride, q0, Sq, D);
      if (threadIdx.x < kB) {
        const int s = q0 + threadIdx.x;
        Ls[threadIdx.x] = s < Sq ? lb[s] : 0.f;
        Ds[threadIdx.x] = s < Sq ? db[s] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int qh = 0; qh < kB; qh += 32) {   // 32 queries at a time
        float st[4][4], dpt[4][4];   // S^T, dP^T: 16 keys x 4 x 8 queries
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kD; kk += 16) {
          uint32_t ak[4], av[4];
          load_a(ak, Ks, P, w0, kk, g, t);
          load_a(av, Vs, P, w0, kk, g, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = qh + 8 * j + g;
            mma(st[j], ak, ld32(Qs + n * P + kk + 2 * t),
                ld32(Qs + n * P + kk + 2 * t + 8));
            mma(dpt[j], av, ld32(dOs + n * P + kk + 2 * t),
                ld32(dOs + n * P + kk + 2 * t + 8));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + w0 + g + 8 * (e >> 1);
            const int qi = qh + 8 * j + 2 * t + (e & 1), qrow = q0 + qi;
            float p = 0.f;
            if (key < Skv && qrow < Sq && !(causal && key > qrow + q_offset))
              p = expf(st[j][e] * scale - Ls[qi]);
            dpt[j][e] = p * (dpt[j][e] - Ds[qi]);
            st[j][e] = p;
          }
        uint32_t pa[2][4], sa[2][4];
        acc_to_a(pa, st);
        acc_to_a(sa, dpt);
        // dV += P^T dO and dK += dS^T Q over these 32 queries
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          const int kq = qh + 16 * s2;
#pragma unroll
          for (int jd = 0; jd < kD / 8; ++jd) {
            const int n = 8 * jd + g;
            mma(adv[jd], pa[s2], ld32(dOt + n * kPT + kq + 2 * t),
                ld32(dOt + n * kPT + kq + 2 * t + 8));
            mma(adk[jd], sa[s2], ld32(Qt + n * kPT + kq + 2 * t),
                ld32(Qt + n * kPT + kq + 2 * t + 8));
          }
        }
      }
    }
  }

#pragma unroll
  for (int jd = 0; jd < kD / 8; ++jd)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int key = k0 + w0 + g + 8 * h2;
      const int col = 8 * jd + 2 * t;
      if (key >= Skv || col >= D) continue;
      const long long at = (((long long)b * Skv + key) * Hk + hk) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          adk[jd][2 * h2] * scale, adk[jd][2 * h2 + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(adv[jd][2 * h2], adv[jd][2 * h2 + 1]);
    }
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int H, int Hk, int Sq, int Skv, int D, int causal,
                 int q_offset, float scale) {
  constexpr int P = kD + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kB * P;
  bf16* Ks = dOs + kB * P;
  bf16* Vs = Ks + kB * P;
  bf16* Kt = Vs + kB * P;           // kD x kPT
  float* Ls = reinterpret_cast<float*>(Kt + 2 * kD * kPT);
  float* Ds = Ls + kB;

  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = 16 * warp;            // the warp's first query in the tile
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hk * D;
  const long long head = (long long)b * Sq * H + h;
  stage<kD>(Qs, nullptr, q + head * D, q_stride, q0, Sq, D);
  stage<kD>(dOs, nullptr, dout + head * D, q_stride, q0, Sq, D);
  if (threadIdx.x < kB) {
    const int s = q0 + threadIdx.x;
    const long long lrow = ((long long)b * H + h) * Sq;
    Ls[threadIdx.x] = s < Sq ? lse[lrow + s] : 0.f;
    Ds[threadIdx.x] = s < Sq ? delta[lrow + s] : 0.f;
  }
  const bf16* kb = k + ((long long)b * Skv * Hk + hk) * D;
  const bf16* vb = v + ((long long)b * Skv * Hk + hk) * D;

  float adq[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[j][e] = 0.f;

  int n_tiles = (Skv + kB - 1) / kB;
  if (causal)  // the block's last query sees keys up to its position
    n_tiles = min(n_tiles, (min(q0 + kB, Sq) - 1 + q_offset) / kB + 1);
  for (int tk = 0; tk < n_tiles; ++tk) {
    const int k0 = tk * kB;
    __syncthreads();  // the previous tile's readers are done
    stage<kD>(Ks, Kt, kb, kv_stride, k0, Skv, D);
    stage<kD>(Vs, nullptr, vb, kv_stride, k0, Skv, D);
    __syncthreads();
    uint32_t aq[kD / 16][4], ao[kD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      load_a(aq[kk], Qs, P, w0, 16 * kk, g, t);
      load_a(ao[kk], dOs, P, w0, 16 * kk, g, t);
    }
#pragma unroll 1
    for (int kh = 0; kh < kB; kh += 32) {   // 32 keys at a time
      float s[4][4], dp[4][4];   // S, dP: 16 queries x 4 x 8 keys
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = kh + 8 * j + g;
          mma(s[j], aq[kk], ld32(Ks + n * P + 16 * kk + 2 * t),
              ld32(Ks + n * P + 16 * kk + 2 * t + 8));
          mma(dp[j], ao[kk], ld32(Vs + n * P + 16 * kk + 2 * t),
              ld32(Vs + n * P + 16 * kk + 2 * t + 8));
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = w0 + g + 8 * (e >> 1), qrow = q0 + qi;
          const int key = k0 + kh + 8 * j + 2 * t + (e & 1);
          float ds = 0.f;
          if (key < Skv && qrow < Sq && !(causal && key > qrow + q_offset))
            ds = expf(s[j][e] * scale - Ls[qi]) * (dp[j][e] - Ds[qi]);
          s[j][e] = ds;
        }
      uint32_t sa[2][4];
      acc_to_a(sa, s);
      // dQ += dS K over these 32 keys
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        const int kq = kh + 16 * s2;
#pragma unroll
        for (int jd = 0; jd < kD / 8; ++jd) {
          const int n = 8 * jd + g;
          mma(adq[jd], sa[s2], ld32(Kt + n * kPT + kq + 2 * t),
              ld32(Kt + n * kPT + kq + 2 * t + 8));
        }
      }
    }
  }

#pragma unroll
  for (int jd = 0; jd < kD / 8; ++jd)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = q0 + w0 + g + 8 * h2;
      const int col = 8 * jd + 2 * t;
      if (row >= Sq || col >= D) continue;
      const long long at = (head + (long long)row * H) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dq + at) = __floats2bfloat162_rn(
          adq[jd][2 * h2] * scale, adq[jd][2 * h2 + 1] * scale);
    }
}

bool bad_tc_shape(int B, int H, int Hk, int Sq, int Skv, int D,
                  int q_offset) {
  return bad_shape(B, H, Hk, Sq, Skv, D, q_offset) || D % 16 != 0;
}

template <int kD>
int run_dkdv(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int B,
             int H, int Hk, int Sq, int Skv, int D, int causal, int q_offset,
             cudaStream_t st) {
  const int smem = (int)smem_bytes_tc<kD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Skv + kB - 1) / kB, B * Hk);
  flash_bwd_dkdv_mma<kD><<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hk, Sq, Skv, D,
      causal, q_offset, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int kD>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int H, int Hk,
           int Sq, int Skv, int D, int causal, int q_offset,
           cudaStream_t st) {
  const int smem = (int)smem_bytes_tc<kD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_mma<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + kB - 1) / kB, B * H);
  flash_bwd_dq_mma<kD><<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Hk, Sq, Skv, D, causal, q_offset,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The "mma" variant of dkdv and dq: bf16, D % 16 == 0 and D <= 128, every
// pointer 16-byte aligned; otherwise as the others below.
extern "C" int flash_attn_bwd_dkdv_bf16_mma(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int B, int H, int Hk,
                                            int Sq, int Skv, int D,
                                            int causal, int q_offset,
                                            void* stream) {
  if (tc::bad_tc_shape(B, H, Hk, Sq, Skv, D, q_offset) || B * Hk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? tc::run_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    Hk, Sq, Skv, D, causal, q_offset, st)
                 : tc::run_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                     Hk, Sq, Skv, D, causal, q_offset, st);
}

extern "C" int flash_attn_bwd_dq_bf16_mma(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, int B, int H, int Hk,
                                          int Sq, int Skv, int D, int causal,
                                          int q_offset, void* stream) {
  if (tc::bad_tc_shape(B, H, Hk, Sq, Skv, D, q_offset) || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? tc::run_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hk,
                                  Sq, Skv, D, causal, q_offset, st)
                 : tc::run_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hk,
                                   Sq, Skv, D, causal, q_offset, st);
}

// The three kernels' entry points, each in f32 and bf16.  q, o, dO, dq
// (B, Sq, H, D); k, v, dk, dv (B, Skv, Hk, D); lse and delta (B, H, Sq)
// float32; all contiguous, on the current device, D <= 128, H % Hk == 0,
// q_offset >= 0.  delta is written by the first and read by the other two.
// Each launches on `stream` and returns cudaGetLastError() (0 on success);
// none synchronises.
extern "C" int flash_attn_bwd_delta_f32(const void* o, const void* dout,
                                        void* delta, int B, int H, int Sq,
                                        int D, void* stream) {
  return launch_delta<float>(o, dout, delta, B, H, Sq, D, stream);
}

extern "C" int flash_attn_bwd_delta_bf16(const void* o, const void* dout,
                                         void* delta, int B, int H, int Sq,
                                         int D, void* stream) {
  return launch_delta<__nv_bfloat16>(o, dout, delta, B, H, Sq, D, stream);
}

extern "C" int flash_attn_bwd_dkdv_f32(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Hk, int Sq, int Skv, int D,
                                       int causal, int q_offset,
                                       void* stream) {
  return launch_dkdv<float>(q, k, v, dout, lse, delta, dk, dv, B, H, Hk, Sq,
                            Skv, D, causal, q_offset, stream);
}

extern "C" int flash_attn_bwd_dkdv_bf16(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int H,
                                        int Hk, int Sq, int Skv, int D,
                                        int causal, int q_offset,
                                        void* stream) {
  return launch_dkdv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    Hk, Sq, Skv, D, causal, q_offset, stream);
}

extern "C" int flash_attn_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int B, int H, int Hk, int Sq,
                                     int Skv, int D, int causal, int q_offset,
                                     void* stream) {
  return launch_dq<float>(q, k, v, dout, lse, delta, dq, B, H, Hk, Sq, Skv,
                          D, causal, q_offset, stream);
}

extern "C" int flash_attn_bwd_dq_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int Hk, int Sq,
                                      int Skv, int D, int causal,
                                      int q_offset, void* stream) {
  return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H, Hk,
                                  Sq, Skv, D, causal, q_offset, stream);
}
