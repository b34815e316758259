// Backward of softmax attention for Hopper (sm_90a), in FlashAttention-2's
// form: three kernels, launched back to back on one stream by the wrapper
// (ops.flash_attention_bwd_k).  q and k share the head width D <= 192; v,
// o and dO have their own, Dv <= 128 (MLA trains with D = 128 + 64 = 192
// and Dv = 128); dq and dk come back D wide, dv Dv wide.
//   1. flash_bwd_delta: delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]
//      over Dv in f32, one warp a row;
//   2. flash_bwd_dkdv: one block per (key tile, b, kv head).  For each
//      query head of the kv head's group (GQA's dK and dV are sums over
//      them) and each 64-query tile that the causal mask lets see the key
//      tile, it recomputes s = q . k * D^-0.5 and P = exp(s - lse), then
//      dV += P^T dO, dP = dO V^T, dS = P * (dP - delta), dK += dS^T Q;
//   3. flash_bwd_dq: one block per (query tile, b, h).  Over the key
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
// operations: 0.97 ms at the bf16 tensor cores' 989 TFLOP/s.  At D != Dv
// a kept pair costs 4*D + 4*Dv flops in dkdv (S and dK over D, dP and dV
// over Dv) and 4*D + 2*Dv in dq: at DeepSeek-V3's training shape (B*H =
// 256, S = 4,096, D = 192, Dv = 128, causal) 2.75 TFLOP (2.78 ms) and
// 2.20 TFLOP (2.23 ms); delta reads O and dO once, 0.54 GB (0.16 ms).
//
// Two variants of dkdv and dq; ops.route_bwd picks one from dtype, head
// width and alignment ("delta" has one).
// "simt" (f32, and bf16 shapes "wgmma" does not take): the first version,
// on the CUDA cores in f32 for both dtypes (one FMA a multiply-add), on the
// simt forward's skeleton: 256 threads as 16 x 16, 64-row tiles staged in
// shared memory as f32 with odd row pitches (the 16 rows a half-warp reads
// in one column fall in 16 banks), each thread a 4 x 4 tile of S and dP
// and a 4 x ceil(D/16) tile of dK or dQ and 4 x ceil(Dv/16) of dV.  Q and
// K are staged at D, V and dO at Dv: 194 KB at (192, 128), where four
// tiles at D would take 231 KB, over the 227 KB a block may have.
// "wgmma" (bf16, D and Dv multiples of 16, D <= 192, Dv <= 128, 16-byte
// aligned): every product on the tensor cores, fed by TMA.  dkdv works in
// the transposed form: its rows are keys, so S^T = K Q^T and dP^T = V dO^T
// come from 128-byte-swizzled shared memory with both operands K-major
// over D, P^T and dS^T sit in registers in the A layout (rows = keys,
// k = queries), and dV += P^T dO and dK += dS^T Q are register-A wgmmas
// with dO and Q as MN-major B; each stage is a 64-query tile of Q and dO
// with its lse and delta (a flat f32 map of (B, H, Sq)).  dq owns 128
// queries and streams 64-key tiles of K and V: S = Q K^T and dP = dO V^T
// from shared memory, dQ += dS K with K as MN-major B.  S and S^T contract
// over D's panels, dP and dP^T over Dv's; dK and dQ are m64nDk16 products
// (N = 192 at MLA's width), dV m64nDvk16.  q, k, v and dO are read in
// place through 4-D (D or Dv, H, S, B) maps; rows and columns past S, D
// and Dv arrive as zeros and stores are guarded.  (D, Dv) is padded to
// 64-column panels, one of three instantiations: (64, 64), (128, 128) or
// (192, 128); a panel wholly past D or Dv arrives as zeros too.
//
// The design, chosen by timing variants on the H100 at (192, 128) and at
// D = 128 (PERF.md §6):
// - Tile: a CTA of two consumer warpgroups and nothing else, each owning
//   64 rows (wgmma's M) of the CTA's 128 keys (dkdv) or queries (dq); the
//   streamed tiles are 64 wide.  A wider S or dP tile (N = 128) would
//   double those accumulators, and a third consumer would leave each 168
//   registers: a dkdv consumer holds dK and dV (96 + 64 f32 a thread at
//   (192, 128)) beside S^T and dP^T (32 + 32).
// - No producer warpgroup: with 256 threads each consumer may hold 255
//   registers, and the (192, 128) dkdv spills nothing (with a producer
//   warpgroup and setmaxnreg a consumer gets 240 and spilled 44 bytes).
//   Thread 0 issues the resident tiles and the first stages; after that a
//   consumer done with a stage meets its own four warps on a named barrier
//   and counts itself in with an atomic add, and the second to count
//   issues the stage's refill (`release`), so neither consumer waits for
//   the other (a refill that did, from consumer 1's first thread after
//   an empty barrier, was slower in trial builds).
// - No ping-pong: the two consumers issue their products whenever they
//   are ready.  FA3's turns (named barriers ordering the consumers' S/dP
//   and dK/dV phases) made dkdv 9.5 ms against 7.8 at (192, 128): the S
//   and dP chains are m64n64 products, 12 and 8 deep, each step depending
//   on the last, and one consumer's chains alone do not keep the tensor
//   cores busy; two consumers' concurrent chains do.  Issuing the next
//   tile's S under this tile's elementwise pass, or the next tile's
//   products behind this tile's dK/dV or dQ, was slower too.
// - Ring: 4 stages, 3 at (192, 128) (a stage of five 8 KB panels; the
//   resident tiles take 80 KB, three stages 120 KB: 203 KB with the
//   lse/delta slots, barriers and alignment).
// - Elementwise pass: exp2 on the special-function unit (ex2.approx.ftz),
//   the scale and lse folded into one FMA, P and dS packed into A
//   registers column group by column group, a column's lse and delta read
//   once for both of the thread's rows; masks only on tiles that a ragged
//   edge or the diagonal crosses.  The S and dP chains are issued
//   interleaved, dV's before dK's.
// dkdv runs the low key tiles (the most queries under the causal mask)
// first, dq the high query tiles.  The rounding points are the first
// tensor-core version's: P and dS are rounded to bf16 as A operands, dK
// and dQ scaled once at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kB = 64;          // rows of a query or key tile
constexpr int kThreads = 256;   // 16 x 16: rows ty + 16 i, columns tx + 16 j
constexpr int kMaxD = 192;      // q/k head width
constexpr int kMaxDv = 128;     // v head width
constexpr int kDPer = kMaxD / 16;    // dK or dQ columns per thread
constexpr int kDvPer = kMaxDv / 16;  // dV columns per thread

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
// 1. delta = rowsum(dO * O), one warp per (b, s, h) row in memory order;
// Dv is the rows' width
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int H, int Sq, int Dv,
                long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* op = o + row * Dv;
  const T* dp = dout + row * Dv;
  float acc = 0.f;
  for (int c = lane; c < Dv; c += 32)
    acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
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

// Stage rows r0 .. r0 + 63 of a (B, S, heads, W) tensor at one head as f32
// (rows past S as zeros) with row pitch ld: a points at the head's row 0.
template <typename T>
__device__ __forceinline__ void stage(float* As, const T* a, long long stride,
                                      int r0, int S, int W, int ld) {
  for (int e = threadIdx.x; e < kB * W; e += kThreads) {
    const int r = e / W, c = e - r * W;
    const int s = r0 + r;
    As[r * ld + c] = s < S ? to_f(a[s * stride + c]) : 0.f;
  }
}

// Shared memory of both gradient kernels: two kB x (D + 1) tiles (Q and
// K), two kB x (Dv + 1) tiles (dO and V), `np` kB x (kB + 1) tiles of P or
// dS, and lse and delta of kB queries: 194 KB at D = 192, Dv = 128.
size_t smem_bytes(int D, int Dv, int np) {
  return sizeof(float) * (2 * (size_t)kB * (D + 1) + 2 * (size_t)kB * (Dv + 1) +
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
               int Skv, int D, int Dv, int causal, int q_offset,
               float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1, ldv = Dv + 1, ldp = kB + 1;
  float* Ks = smem;             // kB keys x ld
  float* Vs = Ks + kB * ld;     // kB keys x ldv
  float* Qs = Vs + kB * ldv;    // kB queries x ld
  float* dOs = Qs + kB * ld;    // kB queries x ldv
  float* Ps = dOs + kB * ldv;   // P^T: key x query
  float* dSs = Ps + kB * ldp;   // dS^T
  float* Ls = dSs + kB * ldp;   // lse of the tile's queries
  float* Ds = Ls + kB;          // delta of the tile's queries

  const int hk = blockIdx.y % Hk, b = blockIdx.y / Hk;
  const int rep = H / Hk;
  const int k0 = blockIdx.x * kB;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // between positions
  const long long q_stride = (long long)H * D, o_stride = (long long)H * Dv;
  const long long k_stride = (long long)Hk * D, v_stride = (long long)Hk * Dv;
  const long long kv_head = (long long)b * Skv * Hk + hk;
  stage(Ks, k + kv_head * D, k_stride, k0, Skv, D, ld);
  stage(Vs, v + kv_head * Dv, v_stride, k0, Skv, Dv, ldv);

  float adk[4][kDPer], adv[4][kDvPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) adk[i][jj] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kDvPer; ++jj) adv[i][jj] = 0.f;
  }

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
      stage(Qs, q + head * D, q_stride, q0, Sq, D, ld);
      stage(dOs, dout + head * Dv, o_stride, q0, Sq, Dv, ldv);
      if (tid < kB) {
        const int s = q0 + tid;
        Ls[tid] = s < Sq ? lb[s] : 0.f;
        Ds[tid] = s < Sq ? db[s] : 0.f;
      }
      __syncthreads();

      // S^T (over D) and dP^T (over Dv) for keys ty + 16 i and queries
      // tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < D; ++c) {
        float kk[4], qq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kk[i] = Ks[(ty + 16 * i) * ld + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) qq[j] = Qs[(tx + 16 * j) * ld + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(kk[i], qq[j], sc[i][j]);
      }
      for (int c = 0; c < Dv; ++c) {
        float vv[4], oo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) vv[i] = Vs[(ty + 16 * i) * ldv + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) oo[j] = dOs[(tx + 16 * j) * ldv + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
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
        for (int jj = 0; jj < kDvPer; ++jj) {
          const int c = tx + 16 * jj;
          const float od = c < Dv ? dOs[j * ldv + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) adv[i][jj] = fmaf(pv[i], od, adv[i][jj]);
        }
#pragma unroll
        for (int jj = 0; jj < kDPer; ++jj) {
          const int c = tx + 16 * jj;
          const float qd = c < D ? Qs[j * ld + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) adk[i][jj] = fmaf(sv[i], qd, adk[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Skv) continue;
    const long long at = ((long long)b * Skv + key) * Hk + hk;
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) dk[at * D + c] = from_f<T>(adk[i][jj] * scale);
    }
#pragma unroll
    for (int jj = 0; jj < kDvPer; ++jj) {
      const int c = tx + 16 * jj;
      if (c < Dv) dv[at * Dv + c] = from_f<T>(adv[i][jj]);
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
             int Dv, int causal, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1, ldv = Dv + 1, ldp = kB + 1;
  float* Qs = smem;             // kB queries x ld
  float* dOs = Qs + kB * ld;    // kB queries x ldv
  float* Ks = dOs + kB * ldv;   // kB keys x ld
  float* Vs = Ks + kB * ld;     // kB keys x ldv
  float* dSs = Vs + kB * ldv;   // dS: query x key
  float* Ls = dSs + kB * ldp;
  float* Ds = Ls + kB;

  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * kB;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long q_stride = (long long)H * D, o_stride = (long long)H * Dv;
  const long long k_stride = (long long)Hk * D, v_stride = (long long)Hk * Dv;
  const long long head = (long long)b * Sq * H + h;
  stage(Qs, q + head * D, q_stride, q0, Sq, D, ld);
  stage(dOs, dout + head * Dv, o_stride, q0, Sq, Dv, ldv);
  if (tid < kB) {
    const int s = q0 + tid;
    const long long lrow = ((long long)b * H + h) * Sq;
    Ls[tid] = s < Sq ? lse[lrow + s] : 0.f;
    Ds[tid] = s < Sq ? delta[lrow + s] : 0.f;
  }
  const long long kv_head = (long long)b * Skv * Hk + hk;
  const T* kb = k + kv_head * D;
  const T* vb = v + kv_head * Dv;

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
    stage(Ks, kb, k_stride, k0, Skv, D, ld);
    stage(Vs, vb, v_stride, k0, Skv, Dv, ldv);
    __syncthreads();

    // S (over D) and dP (over Dv) for queries ty + 16 i and keys tx + 16 j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qq[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qq[i] = Qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qq[i], kk[j], sc[i][j]);
    }
    for (int c = 0; c < Dv; ++c) {
      float oo[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) oo[i] = dOs[(ty + 16 * i) * ldv + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 16 * j) * ldv + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
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

bool bad_shape(int B, int H, int Hk, int Sq, int Skv, int D, int Dv,
               int q_offset) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || D < 1 || D > kMaxD || Dv < 1 ||
         Dv > kMaxDv || Hk < 1 || H % Hk != 0 || q_offset < 0;
}

template <typename T>
int launch_delta(const void* o, const void* dout, void* delta, int B, int H,
                 int Sq, int Dv, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Dv < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * Sq * H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_bwd_delta<T><<<(unsigned)blocks, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), H, Sq, Dv, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int H, int Hk, int Sq, int Skv,
                int D, int Dv, int causal, int q_offset, void* stream) {
  if (bad_shape(B, H, Hk, Sq, Skv, D, Dv, q_offset) || B * Hk > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD, kMaxDv, 2));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Skv + kB - 1) / kB, B * Hk);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_bwd_dkdv<T><<<grid, kThreads, smem_bytes(D, Dv, 2),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hk, Sq, Skv, D, Dv,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Hk, int Sq, int Skv, int D, int Dv, int causal,
              int q_offset, void* stream) {
  if (bad_shape(B, H, Hk, Sq, Skv, D, Dv, q_offset) || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD, kMaxDv, 1));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + kB - 1) / kB, B * H);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_bwd_dq<T><<<grid, kThreads, smem_bytes(D, Dv, 1),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Hk, Sq, Skv, D, Dv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "wgmma": dkdv and dq in bf16 on the tensor cores, TMA-fed, two
// consumer warpgroups that refill the ring themselves
// ---------------------------------------------------------------------------
namespace warpgroup {

using bf16 = __nv_bfloat16;
constexpr int kT = 64;            // rows of a streamed tile, and of a consumer
constexpr int kThreads = 256;     // two consumer warpgroups, no producer's
constexpr int kPanel = kT * 64;   // elements of a 64-row, 64-column panel
constexpr int kPanelBytes = kPanel * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBarDone = 1;       // named barriers 1 and 2: a consumer's own

// lse and delta of a 64-query tile come through a flat f32 map of
// (B, H, Sq) in boxes of kRowsBox rows that start at the 16-byte boundary
// at or below the tile's first row (a TMA box must), in slots of kRowsSlot.
constexpr int kRowsBox = kT + 4;
constexpr int kRowsSlot = 96;   // 384 bytes: slots stay 128-byte aligned

// Stages of the streamed ring: 4 while a stage's two tiles span at most
// four panels, 3 at (192, 128), whose five panels (40 KB) a stage would
// take 240 KB in four.
template <int kD, int kDv>
constexpr int stages() {
  return kD + kDv <= 256 ? 4 : 3;
}

// dkdv: the CTA's 128 keys of K and V (two 64-row blocks per panel), a
// ring of 64-query tiles of Q and dO, and each tile's lse and delta.  kD,
// kDv: the q/k and the v head widths padded to 64-column panels.
// `done` counts, per stage, the consumers that have finished with it.
template <int kD, int kDv>
struct SmemKV {
  static constexpr int kStages = stages<kD, kDv>();
  bf16 k[kD / 64][2][kPanel];
  bf16 v[kDv / 64][2][kPanel];
  bf16 q[kStages][kD / 64][kPanel];
  bf16 o[kStages][kDv / 64][kPanel];   // dO
  float lse[kStages][kRowsSlot], delta[kStages][kRowsSlot];
  uint64_t kv_full, full[kStages];
  int done[kStages];
};

// dq: the CTA's 128 queries of Q and dO, a ring of 64-key tiles of K and V.
template <int kD, int kDv>
struct SmemQ {
  static constexpr int kStages = stages<kD, kDv>();
  bf16 q[kD / 64][2][kPanel];
  bf16 o[kDv / 64][2][kPanel];
  bf16 k[kStages][kD / 64][kPanel];
  bf16 v[kStages][kDv / 64][kPanel];
  uint64_t q_full, full[kStages];
  int done[kStages];
};

// Consumer c (thread `tid` of it) is done with tile `it`'s stage: its
// four warps meet on its own named barrier (every wgmma of theirs that
// read the stage has been waited for), then its first thread counts it
// in, and the second consumer to count refills the stage with tile it +
// kStages through `load`.  Neither consumer waits for the other.
// The invariant that makes the refill safe: every read of the stage, by
// wgmma or by a plain load (lse, delta), is complete before the reading
// consumer's barrier.  The count is an acquire-release add, so the first
// consumer's reads happen before the second's add, and the proxy fence
// orders them before the TMA write that refills the stage.
template <int kStages, typename Load>
__device__ __forceinline__ void release(int* done, int it, int n, int c,
                                        int tid, Load load) {
  hopper::named_sync<128>(kBarDone + c);
  if (tid == 0 && (hopper::atom_add_acq_rel(&done[it % kStages], 1) & 1) &&
      it + kStages < n) {
    hopper::fence_proxy_async();
    load(it + kStages);
  }
  __syncwarp();   // the loading thread's warp converges before its wgmma
}

// S (or S^T) = A B^T over kD and dP (dP^T) over kDv, both operands
// K-major in shared memory, 64 columns a panel: `a`/`av` the resident
// rows (panels `a_panel` elements apart), `b`/`bv` a stage's (`b_panel`
// apart).  The two accumulation chains are issued interleaved.
template <int kD, int kDv>
__device__ __forceinline__ void issue_s_dp(float (&s)[32], float (&dp)[32],
                                           const bf16* a, const bf16* av,
                                           int a_panel, const bf16* b,
                                           const bf16* bv, int b_panel) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int at = (kk / 4) * a_panel + (kk % 4) * 16;
    const int bt = (kk / 4) * b_panel + (kk % 4) * 16;
    wgmma_ss<0>(s, desc_sw128(a + at, 16, 1024),
                desc_sw128(b + bt, 16, 1024), kk > 0);
    if (kk < kDv / 16)
      wgmma_ss<0>(dp, desc_sw128(av + at, 16, 1024),
                  desc_sw128(bv + bt, 16, 1024), kk > 0);
  }
}

// Store a consumer's 64 rows of an accumulator of width kW (kW / 2 floats
// a thread) as bf16, times `scale`: rows row0 and row0 + 8 of the thread,
// each at `at(row)` elements, columns below W, rows below `rows`.
template <int kW, typename At>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[kW / 2],
                                           int row0, int rows, int W,
                                           int quad, float scale, At at) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= rows) continue;
    bf16* p = out + at(row);
#pragma unroll
    for (int i = 0; i < kW / 8; ++i) {
      const int col = 8 * i + 2 * quad;
      if (col < W)
        *reinterpret_cast<__nv_bfloat162*>(p + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * hh] * scale,
                                  acc[4 * i + 2 * hh + 1] * scale);
    }
  }
}

__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(a[kk]);
}

// The A-operand register of column group i (8 columns), row half hh, of a
// 64 x 64 accumulator: the m64n64 accumulator layout is the A layout, a
// k16 step spanning two groups.
__device__ __forceinline__ uint32_t& a_reg(uint32_t (&a)[4][4], int i,
                                           int hh) {
  return a[i / 2][2 * (i % 2) + hh];
}

// dK, dV: one CTA per (128-key tile, b, kv head), keys k0 + 64c .. + 63 to
// consumer c.  In the transposed form, rows are keys and columns queries:
// S^T = K Q^T over kD and dP^T = V dO^T over kDv (K and V K-major A, Q and
// dO K-major B), P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T -
// delta) in registers, then dV += P^T dO (width kDv) and dK += dS^T Q
// (width kD) with P^T and dS^T as register A and dO and Q as MN-major B.
// Query tiles run over the kv head's query heads (GQA) and, per head,
// from the first tile the causal mask lets see the CTA's first key.
template <int kD, int kDv>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tlse,
                     const __grid_constant__ CUtensorMap tdelta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                     int Hk, int Sq, int Skv, int D, int Dv, int causal,
                     int q_offset, float scale, float scale_log2) {
  using namespace hopper;
  using Smem = SmemKV<kD, kDv>;
  constexpr int kP = kD / 64, kPv = kDv / 64, kStages = Smem::kStages;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1k(smem_raw));

  const int hk = blockIdx.x % Hk, b = blockIdx.x / Hk;
  const int rep = H / Hk;
  const int k0 = blockIdx.y * 2 * kT;   // low key tiles, the longest, first
  const int t_first = causal ? max(0, k0 - q_offset) / kT : 0;
  const int nt = max(0, (Sq + kT - 1) / kT - t_first);
  const int n_it = rep * nt;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      sm.done[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();

  // query tile `it` (head it / nt) into its stage, from one thread
  const auto load = [&](int it) {
    const int s = it % kStages;
    mbar_arrive_expect_tx(&sm.full[s],
                          (kP + kPv) * kPanelBytes + 2 * kRowsBox * 4);
    const int h = hk * rep + it / nt;
    const int q0 = (t_first + it % nt) * kT;
    for (int p = 0; p < kP; ++p)
      tma_load_4d(sm.q[s][p], &tq, &sm.full[s], 64 * p, h, q0, b);
    for (int p = 0; p < kPv; ++p)
      tma_load_4d(sm.o[s][p], &tdo, &sm.full[s], 64 * p, h, q0, b);
    // rows past Sq (the next head's, or zeros) are masked below
    const int row = ((b * H + h) * Sq + q0) & ~3;
    tma_load_1d(sm.lse[s], &tlse, &sm.full[s], row);
    tma_load_1d(sm.delta[s], &tdelta, &sm.full[s], row);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&sm.kv_full, 2 * (kP + kPv) * kPanelBytes);
    for (int r = 0; r < 2; ++r) {
      for (int p = 0; p < kP; ++p)
        tma_load_4d(sm.k[p][r], &tk, &sm.kv_full, 64 * p, hk, k0 + kT * r,
                    b);
      for (int p = 0; p < kPv; ++p)
        tma_load_4d(sm.v[p][r], &tv, &sm.kv_full, 64 * p, hk, k0 + kT * r,
                    b);
    }
    for (int it = 0; it < min(n_it, kStages); ++it) load(it);
  }
  __syncwarp();

  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid & 31, quad = lane & 3;
  const int key_first = k0 + kT * c;                 // the WG's first key
  const int key0 = key_first + 16 * (tid >> 5) + (lane >> 2);   // and + 8

  float adk[kD / 2], adv[kDv / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) adk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kDv / 2; ++i) adv[i] = 0.f;

  mbar_wait(&sm.kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = (t_first + it % nt) * kT;
    // where the tile's first row sits in its lse and delta box
    const int r0 = ((b * H + hk * rep + it / nt) * Sq + q0) & 3;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    // every query of the tile precedes the WG's first key, or the WG has
    // no key: nothing to add
    const bool skip = key_first >= Skv ||
                      (causal && q0 + kT - 1 + q_offset < key_first);
    if (!skip) {
      float st[32], dpt[32];
      wgmma_fence();
      issue_s_dp<kD, kDv>(st, dpt, &sm.k[0][c][0], &sm.v[0][c][0],
                          2 * kPanel, &sm.q[s][0][0], &sm.o[s][0][0],
                          kPanel);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T, packed into A registers column group by column
      // group; a column's lse and delta are read once for both of the
      // thread's rows.  Only tiles a ragged edge or the diagonal crosses
      // are masked.
      const bool edge = q0 + kT > Sq || key_first + kT > Skv ||
                        (causal && q0 + q_offset < key_first + kT - 1);
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * i + 2 * quad + j;
          const int query = q0 + col;
          const float l2 = sm.lse[s][r0 + col] * kLog2e;
          const float dl = sm.delta[s][r0 + col];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 4 * i + 2 * hh + j, key = key0 + 8 * hh;
            float p = exp2_approx(fmaf(st[e], scale_log2, -l2));
            if (edge && (key >= Skv || query >= Sq ||
                         (causal && key > query + q_offset)))
              p = 0.f;
            dpt[e] = p * (dpt[e] - dl);
            st[e] = p;
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 4 * i + 2 * hh;
          a_reg(pa, i, hh) = pack_bf16(st[e], st[e + 1]);
          a_reg(sa, i, hh) = pack_bf16(dpt[e], dpt[e + 1]);
        }
      }
      fence_a(pa);
      fence_a(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(adv, pa[kk],
                    desc_sw128(&sm.o[s][0][kk * 16 * 64], kPanelBytes, 1024),
                    1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(adk, sa[kk],
                    desc_sw128(&sm.q[s][0][kk * 16 * 64], kPanelBytes, 1024),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_a(pa);
      fence_a(sa);
      fence_regs(adv);
      fence_regs(adk);
    }
    release<kStages>(sm.done, it, n_it, c, tid, load);
  }

  const auto at = [&](int W) {
    return [=](int key) {
      return (((long long)b * Skv + key) * Hk + hk) * W;
    };
  };
  store_rows<kD>(dk, adk, key0, Skv, D, quad, scale, at(D));
  store_rows<kDv>(dv, adv, key0, Skv, Dv, quad, 1.f, at(Dv));
}

// dQ: one CTA per (128-query tile, b, h), queries q0 + 64c .. + 63 to
// consumer c: S = Q K^T over kD and dP = dO V^T over kDv (Q and dO K-major
// A, K and V K-major B), P and dS in registers, dQ += dS K (width kD) with
// K as MN-major B, over the 64-key tiles up to the forward's last.
template <int kD, int kDv>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int H, int Hk, int Sq, int Skv, int D, int causal,
                   int q_offset, float scale, float scale_log2) {
  using namespace hopper;
  using Smem = SmemQ<kD, kDv>;
  constexpr int kP = kD / 64, kPv = kDv / 64, kStages = Smem::kStages;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1k(smem_raw));

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int hk = h / (H / Hk);
  // causal grids run the high query tiles, the longest, first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * 2 * kT;
  int n_tiles = (Skv + kT - 1) / kT;
  if (causal)  // the CTA's last query sees keys up to its position
    n_tiles = min(n_tiles, (min(q0 + 2 * kT, Sq) - 1 + q_offset) / kT + 1);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      sm.done[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();

  // key tile t into its stage, from one thread
  const auto load = [&](int t) {
    const int s = t % kStages;
    mbar_arrive_expect_tx(&sm.full[s], (kP + kPv) * kPanelBytes);
    for (int p = 0; p < kP; ++p)
      tma_load_4d(sm.k[s][p], &tk, &sm.full[s], 64 * p, hk, t * kT, b);
    for (int p = 0; p < kPv; ++p)
      tma_load_4d(sm.v[s][p], &tv, &sm.full[s], 64 * p, hk, t * kT, b);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&sm.q_full, 2 * (kP + kPv) * kPanelBytes);
    for (int r = 0; r < 2; ++r) {
      for (int p = 0; p < kP; ++p)
        tma_load_4d(sm.q[p][r], &tq, &sm.q_full, 64 * p, h, q0 + kT * r, b);
      for (int p = 0; p < kPv; ++p)
        tma_load_4d(sm.o[p][r], &tdo, &sm.q_full, 64 * p, h, q0 + kT * r,
                    b);
    }
    for (int t = 0; t < min(n_tiles, kStages); ++t) load(t);
  }
  __syncwarp();

  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid & 31, quad = lane & 3;
  const int q_first = q0 + kT * c;                   // the WG's first query
  const int row0 = q_first + 16 * (tid >> 5) + (lane >> 2);   // and + 8
  // the WG's last query position (none when q_first >= Sq)
  const int last_pos = min(q_first + kT, Sq) - 1 + q_offset;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const long long at = ((long long)b * H + h) * Sq + row;
    lse2[hh] = row < Sq ? lse[at] * kLog2e : 0.f;
    dl[hh] = row < Sq ? delta[at] : 0.f;
  }

  float adq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) adq[i] = 0.f;

  mbar_wait(&sm.q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kT;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const bool skip = q_first >= Sq || (causal && k0 > last_pos);
    if (!skip) {
      float sc[32], dp[32];
      wgmma_fence();
      issue_s_dp<kD, kDv>(sc, dp, &sm.q[0][c][0], &sm.o[0][c][0],
                          2 * kPanel, &sm.k[s][0][0], &sm.v[s][0][0],
                          kPanel);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = k0 + kT > Skv || q_first + kT > Sq ||
                        (causal && k0 + kT - 1 > q_first + q_offset);
      uint32_t sa[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, x = 4 * i + e;
          const int key = k0 + 8 * i + 2 * quad + (e & 1);
          const int row = row0 + 8 * hh;
          float p = exp2_approx(fmaf(sc[x], scale_log2, -lse2[hh]));
          if (edge && (key >= Skv || row >= Sq ||
                       (causal && key > row + q_offset)))
            p = 0.f;
          sc[x] = p * (dp[x] - dl[hh]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          a_reg(sa, i, hh) =
              pack_bf16(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]);
      }
      fence_a(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(adq, sa[kk],
                    desc_sw128(&sm.k[s][0][kk * 16 * 64], kPanelBytes, 1024),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_a(sa);
      fence_regs(adq);
    }
    release<kStages>(sm.done, t, n_tiles, c, tid, load);
  }

  store_rows<kD>(dq, adq, row0, Sq, D, quad, scale, [=](int row) {
    return (((long long)b * Sq + row) * H + h) * D;
  });
}

// The flat map of a float32 (B, H, Sq) tensor, boxes of kRowsBox rows.
int map_rows_f32(CUtensorMap* m, const void* p, long long n) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4 * (cuuint64_t)n};   // unused at rank 1
  const cuuint32_t box[1] = {kRowsBox};
  return hopper::make_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          CU_TENSOR_MAP_SWIZZLE_NONE, p, 1, dims, strides,
                          box);
}

// The (W, heads, S, B) map of a (B, S, heads, W) bf16 tensor, boxes of 64
// columns of one head at 64 positions.
int map_bshd(CUtensorMap* m, const void* p, int B, int S, int heads, int W) {
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {e * W, e * W * heads, e * W * heads * S};
  const cuuint32_t box[4] = {64, 1, kT, 1};
  return hopper::make_map_bf16(m, p, 4, dims, strides, box);
}

bool bad_wgmma_shape(int B, int H, int Hk, int Sq, int Skv, int D, int Dv,
                     int q_offset) {
  return bad_shape(B, H, Hk, Sq, Skv, D, Dv, q_offset) || D % 16 != 0 ||
         Dv % 16 != 0 || (long long)B * H * Sq > INT_MAX;
}

// The four bf16 maps of q, k, v and dO, which both kernels read: q and k
// at D, v and dO at Dv.
int map_qkvo(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
             const void* dout, int B, int H, int Hk, int Sq, int Skv, int D,
             int Dv) {
  int err = map_bshd(&m[0], q, B, Sq, H, D);
  if (!err) err = map_bshd(&m[1], k, B, Skv, Hk, D);
  if (!err) err = map_bshd(&m[2], v, B, Skv, Hk, Dv);
  if (!err) err = map_bshd(&m[3], dout, B, Sq, H, Dv);
  return err;
}

template <int kD, int kDv>
int run_dkdv(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int B,
             int H, int Hk, int Sq, int Skv, int D, int Dv, int causal,
             int q_offset, cudaStream_t st) {
  CUtensorMap t[4], tl, td;
  int err = map_qkvo(t, q, k, v, dout, B, H, Hk, Sq, Skv, D, Dv);
  if (!err) err = map_rows_f32(&tl, lse, (long long)B * H * Sq);
  if (!err) err = map_rows_f32(&td, delta, (long long)B * H * Sq);
  if (err) return err;
  const int smem = (int)sizeof(SmemKV<kD, kDv>) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<kD, kDv>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * Hk, (Skv + 2 * kT - 1) / (2 * kT));
  const double scale = 1.0 / sqrt((double)D);
  flash_bwd_dkdv_wgmma<kD, kDv><<<grid, kThreads, smem, st>>>(
      t[0], t[1], t[2], t[3], tl, td, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Hk, Sq, Skv, D, Dv, causal, q_offset,
      (float)scale, (float)(scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}

template <int kD, int kDv>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int H, int Hk,
           int Sq, int Skv, int D, int Dv, int causal, int q_offset,
           cudaStream_t st) {
  CUtensorMap t[4];
  const int err = map_qkvo(t, q, k, v, dout, B, H, Hk, Sq, Skv, D, Dv);
  if (err) return err;
  const int smem = (int)sizeof(SmemQ<kD, kDv>) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<kD, kDv>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (Sq + 2 * kT - 1) / (2 * kT));
  const double scale = 1.0 / sqrt((double)D);
  flash_bwd_dq_wgmma<kD, kDv><<<grid, kThreads, smem, st>>>(
      t[0], t[1], t[2], t[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Hk, Sq,
      Skv, D, causal, q_offset, (float)scale,
      (float)(scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}

}  // namespace warpgroup

}  // namespace

// The "wgmma" variant of dkdv and dq: bf16, D and Dv multiples of 16 with
// D <= 192 and Dv <= 128, every pointer 16-byte aligned; otherwise as the
// others below.  (D, Dv) is padded to one of three instantiations: (64,
// 64), (128, 128) or (192, 128).
extern "C" int flash_attn_bwd_dkdv_bf16_wgmma(const void* q, const void* k,
                                              const void* v, const void* dout,
                                              const void* lse,
                                              const void* delta, void* dk,
                                              void* dv, int B, int H, int Hk,
                                              int Sq, int Skv, int D, int Dv,
                                              int causal, int q_offset,
                                              void* stream) {
  using namespace warpgroup;
  if (bad_wgmma_shape(B, H, Hk, Sq, Skv, D, Dv, q_offset) ||
      (Skv + 2 * kT - 1) / (2 * kT) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64 && Dv <= 64)
    return run_dkdv<64, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hk, Sq,
                            Skv, D, Dv, causal, q_offset, st);
  if (D <= 128)
    return run_dkdv<128, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hk,
                              Sq, Skv, D, Dv, causal, q_offset, st);
  return run_dkdv<192, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hk, Sq,
                            Skv, D, Dv, causal, q_offset, st);
}

extern "C" int flash_attn_bwd_dq_bf16_wgmma(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse, const void* delta,
                                            void* dq, int B, int H, int Hk,
                                            int Sq, int Skv, int D, int Dv,
                                            int causal, int q_offset,
                                            void* stream) {
  using namespace warpgroup;
  if (bad_wgmma_shape(B, H, Hk, Sq, Skv, D, Dv, q_offset) ||
      (Sq + 2 * kT - 1) / (2 * kT) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64 && Dv <= 64)
    return run_dq<64, 64>(q, k, v, dout, lse, delta, dq, B, H, Hk, Sq, Skv,
                          D, Dv, causal, q_offset, st);
  if (D <= 128)
    return run_dq<128, 128>(q, k, v, dout, lse, delta, dq, B, H, Hk, Sq, Skv,
                            D, Dv, causal, q_offset, st);
  return run_dq<192, 128>(q, k, v, dout, lse, delta, dq, B, H, Hk, Sq, Skv, D,
                          Dv, causal, q_offset, st);
}

// The three kernels' entry points, each in f32 and bf16.  q, dq (B, Sq, H,
// D); o, dO (B, Sq, H, Dv); k, dk (B, Skv, Hk, D); v, dv (B, Skv, Hk, Dv);
// lse and delta (B, H, Sq) float32; all contiguous, on the current device,
// D <= 192, Dv <= 128, H % Hk == 0, q_offset >= 0.  delta is written by
// the first (whose rows are Dv wide) and read by the other two.  Each
// launches on `stream` and returns cudaGetLastError() (0 on success); none
// synchronises.
extern "C" int flash_attn_bwd_delta_f32(const void* o, const void* dout,
                                        void* delta, int B, int H, int Sq,
                                        int Dv, void* stream) {
  return launch_delta<float>(o, dout, delta, B, H, Sq, Dv, stream);
}

extern "C" int flash_attn_bwd_delta_bf16(const void* o, const void* dout,
                                         void* delta, int B, int H, int Sq,
                                         int Dv, void* stream) {
  return launch_delta<__nv_bfloat16>(o, dout, delta, B, H, Sq, Dv, stream);
}

extern "C" int flash_attn_bwd_dkdv_f32(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Hk, int Sq, int Skv, int D, int Dv,
                                       int causal, int q_offset,
                                       void* stream) {
  return launch_dkdv<float>(q, k, v, dout, lse, delta, dk, dv, B, H, Hk, Sq,
                            Skv, D, Dv, causal, q_offset, stream);
}

extern "C" int flash_attn_bwd_dkdv_bf16(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int H,
                                        int Hk, int Sq, int Skv, int D,
                                        int Dv, int causal, int q_offset,
                                        void* stream) {
  return launch_dkdv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    Hk, Sq, Skv, D, Dv, causal, q_offset,
                                    stream);
}

extern "C" int flash_attn_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int B, int H, int Hk, int Sq,
                                     int Skv, int D, int Dv, int causal,
                                     int q_offset, void* stream) {
  return launch_dq<float>(q, k, v, dout, lse, delta, dq, B, H, Hk, Sq, Skv,
                          D, Dv, causal, q_offset, stream);
}

extern "C" int flash_attn_bwd_dq_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int Hk, int Sq,
                                      int Skv, int D, int Dv, int causal,
                                      int q_offset, void* stream) {
  return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H, Hk,
                                  Sq, Skv, D, Dv, causal, q_offset, stream);
}
