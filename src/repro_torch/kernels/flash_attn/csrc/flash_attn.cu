// Causal or non-causal softmax attention for Hopper (sm_90a), one pass
// with an online softmax:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, hk] * D^-0.5) v[b, j, hk]
// over the keys j the mask keeps (j < Skv, and q_offset + i >= j when
// causal), with hk = h / (H / Hk) (GQA without materialising the repeat).
// q and k share the head width D <= 192; v and o have their own, Dv <=
// 128 (MLA attends with D = 128 + 64 = 192 and Dv = 128).
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/kernel.py) with its semantics, not its
// tiling: q is scaled in f32 before the dot, scores, running max,
// denominator and accumulator stay in f32, masked scores are -1e30, key
// tiles wholly above the diagonal are skipped (the Pallas n_iter), and
// the output is acc / max(l, 1e-30) rounded to the input type.  Unlike
// the Pallas wrapper it takes any Sq and Skv (ragged tiles are masked)
// and reads the model's (B, S, H, D) layout in place.
//
// Two variants; ops.route picks one from dtype and shape before launch.
// Either can also write each row's log-sum-exp (lse, (B, H, Sq) f32) from
// the running max and denominator that scaled its output: the training
// path's forward asks for it, and flash_attn_bwd.cu recomputes P from it.
// Serving passes a null pointer and writes nothing more.
//
// What bounds it: at the serving prefill (B*H = 64, S = 4,096, D = 128,
// causal) the work is 4*BH*S^2*D/2 = 0.27 TFLOP against 0.2 GB of q, k,
// v and o, so it is bound by operations: 0.28 ms at the 989 TFLOP/s of
// the bf16 tensor cores.  MLA's prefill (B*H = 512, S = 4,096, D = 192,
// Dv = 128) does 2*BH*(S^2/2)*(D + Dv) = 2.75 TFLOP: 2.78 ms.
//
// "simt" (f32, and bf16 shapes the wgmma variant does not take): the
// first version, on the CUDA cores in f32 (one FMA per multiply-add): one
// block of 256 threads per (64-query tile, b, h); the Q tile and each
// 64-key K tile are staged in shared memory as f32 at D, the V tile at
// Dv, each thread holds a 4 x 4 tile of scores and a 4 x ceil(Dv/16)
// tile of the accumulator (148 KB of shared memory at D = 192, Dv = 128).
//
// "wgmma" (bf16, D and Dv multiples of 16, D <= 192, Dv <= 128): both
// products on the tensor cores.  One CTA of three warpgroups per
// (128-query tile, b, h): the first issues TMA loads from one thread (the
// Q tile once, then 128-key K and V tiles through a 2-stage ring of
// mbarriers), the other two each own 64 queries.  Per key tile a
// consumer computes S = Q K^T as one wgmma chain over D (both operands
// from 128-byte-swizzled shared memory, f32 accumulators), applies
// D^-0.5 * log2(e) to S in f32, masks only diagonal and ragged tiles,
// runs the online softmax in registers
// (row max and sum by quad shuffles over the accumulator layout, exp2f),
// rounds P to bf16 in registers and feeds it as the register A operand
// of O += P V, with V read from shared memory as an MN-major B operand.
// q, k, v are read in place through 4-D tensor maps (D or Dv, H, S, B);
// rows and columns past Sq, Skv, D and Dv arrive as zeros, and stores are
// guarded.  Causal grids run the longest query tiles first.  The head
// widths are padded to 64-column panels, (D, Dv) to one of three
// instantiations: (64, 64), (128, 128) or (192, 128); a panel wholly past
// D or Dv arrives as zeros too.  At (192, 128) Q takes 48 KB of shared
// memory, the 2-stage K ring 96 KB and V's 64 KB: 209 KB with the
// barriers and the 1 KB of alignment.  The S and O accumulators stay at
// 64 f32 registers a thread each, as at (128, 128).  Against the
// simt variant two rounding points move: P is rounded to bf16 before
// P V, and the scale is applied to S after the product (as the plain
// version does); both stay far inside the bf16 tolerance of 2e-2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;          // queries per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: rows ty + 16 i, keys tx + 16 j
constexpr int kMaxD = 192;         // q/k head width
constexpr int kMaxDv = 128;        // v head width
constexpr int kDPer = kMaxDv / 16;  // accumulator columns per thread
constexpr float kNegInf = -1e30f;

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

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * Dv + (size_t)kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int H, int Hk, int Sq, int Skv, int D,
          int Dv, int causal, int q_offset, float scale) {
  extern __shared__ float smem[];
  // padded rows: the 16 rows a half-warp reads in one column fall in 16
  // banks (D + 1 is odd for even D)
  const int ldq = D + 1, ldk = D + 1, ldp = kBK + 1;
  float* Qs = smem;               // kBQ x ldq
  float* Ks = Qs + kBQ * ldq;     // kBK x ldk
  float* Vs = Ks + kBK * ldk;     // kBK x Dv
  float* Ps = Vs + kBK * Dv;      // kBQ x ldp

  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long q_stride = (long long)H * D;    // between positions
  const long long k_stride = (long long)Hk * D;
  const long long v_stride = (long long)Hk * Dv;
  const long long o_stride = (long long)H * Dv;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Skv * Hk + hk) * D;
  const T* vb = v + ((long long)b * Skv * Hk + hk) * Dv;
  T* ob = o + ((long long)b * Sq * H + h) * Dv;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int s = q0 + r;
    Qs[r * ldq + c] = s < Sq ? to_f(qb[s * q_stride + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) acc[i][jj] = 0.f;
  }

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) {  // the block's last query sees keys up to its position
    const int last = min(q0 + kBQ, Sq) - 1 + q_offset;
    n_tiles = min(n_tiles, last / kBK + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const int s = k0 + r;
      Ks[r * ldk + c] = s < Skv ? to_f(kb[s * k_stride + c]) : 0.f;
    }
    for (int e = tid; e < kBK * Dv; e += kThreads) {
      const int r = e / Dv, c = e - r * Dv;
      const int s = k0 + r;
      Vs[r * Dv + c] = s < Skv ? to_f(vb[s * v_stride + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * ldq + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * ldk + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row + q_offset;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key >= Skv || (causal && key > qpos)) sc[i][j] = kNegInf;
        mt = fmaxf(mt, sc[i][j]);
      }
      // the row's 64 scores lie in the 16 lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[row * ldp + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kDPer; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * ldp + j];
#pragma unroll
      for (int jj = 0; jj < kDPer; ++jj) {
        const int c = tx + 16 * jj;
        const float vv = c < Dv ? Vs[j * Dv + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // the row's log-sum-exp of its scaled scores, from the m and l that
    // scaled o: the backward recomputes P = exp(s - lse) from it
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + s] = m[i] + logf(denom);
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) {
      const int c = tx + 16 * jj;
      if (c < Dv) ob[s * o_stride + c] = from_f<T>(acc[i][jj] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hk, int Sq, int Skv, int D, int Dv, int causal,
           int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (D < 1 || D > kMaxD || Dv < 1 || Dv > kMaxDv || Hk < 1 ||
      H % Hk != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD, kMaxDv));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd<T><<<grid, kThreads, smem_bytes(D, Dv),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hk, Sq, Skv, D, Dv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}


namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 128;        // queries per CTA: two consumer warpgroups
constexpr int kBK = 128;        // keys per K/V tile
constexpr int kStages = 2;
constexpr int kThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kPanelQ = kBQ * 64;   // elements of one 64-column panel
constexpr int kPanelK = kBK * 64;

// kD, kDv: the q/k and the v head widths padded to 64-column panels
template <int kD, int kDv>
struct Smem {
  bf16 q[kD / 64][kPanelQ];
  bf16 k[kStages][kD / 64][kPanelK];
  bf16 v[kStages][kDv / 64][kPanelK];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

template <int kD, int kDv>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ lse, int H, int Hk, int Sq, int Skv,
                int Dv, int causal, int q_offset, float scale_log2) {
  using namespace hopper;
  constexpr int kP = kD / 64, kPv = kDv / 64;
  static_assert(kDv == 64 || kDv == 128, "P V runs as one n64 or n128 wgmma");
  extern __shared__ uint8_t smem_raw[];
  Smem<kD, kDv>& sm = *reinterpret_cast<Smem<kD, kDv>*>(align_1k(smem_raw));

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int hk = h / (H / Hk);
  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal)  // the CTA's last query sees keys up to its position
    n_tiles = min(n_tiles, (min(q0 + kBQ, Sq) - 1 + q_offset) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {  // producer
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kP * kPanelQ * 2);
      for (int p = 0; p < kP; ++p)
        tma_load_4d(sm.q[p], &tq, &sm.q_full, 64 * p, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&sm.empty[s], ((t / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&sm.k_full[s], kP * kPanelK * 2);
        for (int p = 0; p < kP; ++p)
          tma_load_4d(sm.k[s][p], &tk, &sm.k_full[s], 64 * p, hk, t * kBK, b);
        mbar_arrive_expect_tx(&sm.v_full[s], kPv * kPanelK * 2);
        for (int p = 0; p < kPv; ++p)
          tma_load_4d(sm.v[s][p], &tv, &sm.v_full[s], 64 * p, hk, t * kBK, b);
      }
    }
  } else {  // consumers: warpgroup c owns queries q0 + 64c .. + 63
    regs_alloc<240>();
    const int c = wgi - 1;
    const int tid = threadIdx.x - 128 * wgi;
    const int lane = tid & 31, quad = lane & 3;
    const int row0 = q0 + 64 * c + 16 * (tid >> 5) + (lane >> 2);  // and +8
    const int first_pos = q0 + 64 * c + q_offset;  // the WG's first query

    float acc[kDv / 2];
#pragma unroll
    for (int i = 0; i < kDv / 2; ++i) acc[i] = 0.f;
    float sc[kBK / 2];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(&sm.q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int k0 = t * kBK;
      mbar_wait(&sm.k_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint64_t da = desc_sw128(
            &sm.q[kk / 4][64 * c * 64 + (kk % 4) * 16], 16, 1024);
        const uint64_t db =
            desc_sw128(&sm.k[s][kk / 4][(kk % 4) * 16], 16, 1024);
        wgmma_m64n128k16_ss<0>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale into the log2 domain; mask only diagonal and ragged tiles
      const bool edge =
          k0 + kBK > Skv || (causal && k0 + kBK - 1 > first_pos);
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * i + e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * i + 2 * quad + (e & 1);
            const int qpos = row0 + 8 * (e >> 1) + q_offset;
            if (key >= Skv || (causal && key > qpos)) x = -INFINITY;
          }
          sc[4 * i + e] = x;
        }
      float corr[2], base[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i)
          mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        base[hh] = m_new == -INFINITY ? 0.f : m_new;
        corr[hh] = exp2f(m[hh] - base[hh]);
        m[hh] = m_new;
        l[hh] *= corr[hh];
      }
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[4 * i + e] - base[e >> 1]);
          sc[4 * i + e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < kDv / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * i + e] *= corr[e >> 1];
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      mbar_wait(&sm.v_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db =
            desc_sw128(&sm.v[s][0][kk * 16 * 64], kPanelK * 2, 1024);
        if constexpr (kDv == 128)
          wgmma_m64n128k16_rs<1>(acc, pa[kk], db, 1);
        else
          wgmma_m64n64k16_rs<1>(acc, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&sm.empty[s]);
    }

    const long long o_stride = (long long)H * Dv;  // between positions
    bf16* ob = o + ((long long)b * Sq * H + h) * Dv;
    float denom[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // the row's sum over its quad
      float lt = l[hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      denom[hh] = fmaxf(lt, 1e-30f);
      // the row's natural log-sum-exp of its scaled scores, from the m
      // (log2 domain) and l that scaled o
      const int row = row0 + 8 * hh;
      if (lse != nullptr && quad == 0 && row < Sq)
        lse[((long long)b * H + h) * Sq + row] =
            (m[hh] + log2f(denom[hh])) * 0.6931471805599453f;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= Sq) continue;
#pragma unroll
      for (int i = 0; i < kDv / 8; ++i) {
        const int col = 8 * i + 2 * quad;
        if (col < Dv)
          *reinterpret_cast<__nv_bfloat162*>(ob + row * o_stride + col) =
              __floats2bfloat162_rn(acc[4 * i + 2 * hh] / denom[hh],
                                    acc[4 * i + 2 * hh + 1] / denom[hh]);
      }
    }
  }
}

template <int kD, int kDv>
int run(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
        void* o, void* lse, int B, int H, int Hk, int Sq, int Skv, int D,
        int Dv, int causal, int q_offset, cudaStream_t st) {
  const int smem = (int)sizeof(Smem<kD, kDv>) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<kD, kDv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_fwd_wgmma<kD, kDv><<<grid, kThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, Hk, Sq,
      Skv, Dv, causal, q_offset, scale_log2);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hk, int Sq, int Skv, int D, int Dv, int causal,
           int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (D < 16 || D > 192 || D % 16 != 0 || Dv < 16 || Dv > 128 ||
      Dv % 16 != 0 || Hk < 1 || H % Hk != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  // (D, H, S, B), innermost first; boxes of 64 columns x one head x a
  // tile of positions
  CUtensorMap tq, tk, tv;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t qd[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Sq,
                            (cuuint64_t)B};
  const cuuint64_t qs[3] = {e * D, e * D * H, e * D * H * Sq};
  const cuuint64_t kd[4] = {(cuuint64_t)D, (cuuint64_t)Hk, (cuuint64_t)Skv,
                            (cuuint64_t)B};
  const cuuint64_t ks[3] = {e * D, e * D * Hk, e * D * Hk * Skv};
  const cuuint64_t vd[4] = {(cuuint64_t)Dv, (cuuint64_t)Hk, (cuuint64_t)Skv,
                            (cuuint64_t)B};
  const cuuint64_t vs[3] = {e * Dv, e * Dv * Hk, e * Dv * Hk * Skv};
  const cuuint32_t qbox[4] = {64, 1, kBQ, 1}, kbox[4] = {64, 1, kBK, 1};
  int err = hopper::make_map_bf16(&tq, q, 4, qd, qs, qbox);
  if (!err) err = hopper::make_map_bf16(&tk, k, 4, kd, ks, kbox);
  if (!err) err = hopper::make_map_bf16(&tv, v, 4, vd, vs, kbox);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64 && Dv <= 64)
    return run<64, 64>(tq, tk, tv, o, lse, B, H, Hk, Sq, Skv, D, Dv, causal,
                       q_offset, st);
  if (D <= 128)
    return run<128, 128>(tq, tk, tv, o, lse, B, H, Hk, Sq, Skv, D, Dv,
                         causal, q_offset, st);
  return run<192, 128>(tq, tk, tv, o, lse, B, H, Hk, Sq, Skv, D, Dv, causal,
                       q_offset, st);
}

}  // namespace tc

}  // namespace

// q (B, Sq, H, D), k (B, Skv, Hk, D), v (B, Skv, Hk, Dv), o (B, Sq, H,
// Dv), contiguous, on the current device; D <= 192, Dv <= 128, H % Hk ==
// 0, B * H <= 65535.  lse, when not null, receives each row's natural
// log-sum-exp of its scaled scores as (B, H, Sq) float32 (the backward's
// input).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.
extern "C" int flash_attn_launch_f32(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int H, int Hk, int Sq, int Skv,
                                     int D, int Dv, int causal, int q_offset,
                                     void* stream) {
  return launch<float>(q, k, v, o, lse, B, H, Hk, Sq, Skv, D, Dv, causal,
                       q_offset, stream);
}

extern "C" int flash_attn_launch_bf16(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int H, int Hk, int Sq, int Skv,
                                      int D, int Dv, int causal, int q_offset,
                                      void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, H, Hk, Sq, Skv, D, Dv,
                               causal, q_offset, stream);
}

// The wgmma variant: bf16 q (B, Sq, H, D), k (B, Skv, Hk, D), v (B, Skv,
// Hk, Dv), o (B, Sq, H, Dv), contiguous, 16-byte aligned, D and Dv
// multiples of 16 with D <= 192 and Dv <= 128, H % Hk == 0, B * H <=
// 65535; lse as above.  Launches on `stream` and returns a cudaError_t (0
// on success).  Does not synchronise.
extern "C" int flash_attn_launch_bf16_wgmma(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int B, int H, int Hk, int Sq,
                                            int Skv, int D, int Dv,
                                            int causal, int q_offset,
                                            void* stream) {
  return tc::launch(q, k, v, o, lse, B, H, Hk, Sq, Skv, D, Dv, causal,
                    q_offset, stream);
}
