// Causal or non-causal softmax attention for Hopper (sm_90a), one pass
// with an online softmax:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, hk] * D^-0.5) v[b, j, hk]
// over the keys j the mask keeps (j < Skv, and q_offset + i >= j when
// causal), with hk = h / (H / Hk) (GQA without materialising the repeat).
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
// What bounds it: at the serving prefill (B*H = 64, S = 4,096, D = 128,
// causal) the work is 4*BH*S^2*D/2 = 0.27 TFLOP against 0.2 GB of q, k,
// v and o, so it is bound by operations: 0.28 ms at the 989 TFLOP/s of
// the bf16 tensor cores.  This first version computes on the CUDA cores
// in f32 (one FMA per multiply-add, no tensor cores): one block of 256
// threads per (64-query tile, b, h); the Q tile and each 64-key K/V tile
// are staged in shared memory as f32, each thread holds a 4 x 4 tile of
// scores and a 4 x ceil(D/16) tile of the accumulator.  Moving the two
// products onto wgmma with TMA-fed tiles is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // queries per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: rows ty + 16 i, keys tx + 16 j
constexpr int kMaxD = 128;
constexpr int kDPer = kMaxD / 16;  // accumulator columns per thread
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

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int Hk, int Sq,
          int Skv, int D, int causal, int q_offset, float scale) {
  extern __shared__ float smem[];
  // padded rows: the 16 rows a half-warp reads in one column fall in 16
  // banks (D + 1 is odd for even D)
  const int ldq = D + 1, ldk = D + 1, ldp = kBK + 1;
  float* Qs = smem;               // kBQ x ldq
  float* Ks = Qs + kBQ * ldq;     // kBK x ldk
  float* Vs = Ks + kBK * ldk;     // kBK x D
  float* Ps = Vs + kBK * D;       // kBQ x ldp

  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long q_stride = (long long)H * D;    // between positions
  const long long kv_stride = (long long)Hk * D;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Skv * Hk + hk) * D;
  const T* vb = v + ((long long)b * Skv * Hk + hk) * D;
  T* ob = o + ((long long)b * Sq * H + h) * D;

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
      float kv = 0.f, vv = 0.f;
      if (s < Skv) {
        kv = to_f(kb[s * kv_stride + c]);
        vv = to_f(vb[s * kv_stride + c]);
      }
      Ks[r * ldk + c] = kv;
      Vs[r * D + c] = vv;
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
        const float vv = c < D ? Vs[j * D + c] : 0.f;
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
#pragma unroll
    for (int jj = 0; jj < kDPer; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) ob[s * q_stride + c] = from_f<T>(acc[i][jj] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hk, int Sq, int Skv, int D, int causal, int q_offset,
           void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (D < 1 || D > kMaxD || Hk < 1 || H % Hk != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd<T><<<grid, kThreads, smem_bytes(D),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hk, Sq, Skv, D, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, Hk, D), o (B, Sq, H, D), contiguous, on
// the current device; D <= 128, H % Hk == 0, B * H <= 65535.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).  Does not
// synchronise.
extern "C" int flash_attn_launch_f32(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Hk, int Sq, int Skv, int D,
                                     int causal, int q_offset, void* stream) {
  return launch<float>(q, k, v, o, B, H, Hk, Sq, Skv, D, causal, q_offset,
                       stream);
}

extern "C" int flash_attn_launch_bf16(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hk, int Sq, int Skv, int D,
                                      int causal, int q_offset,
                                      void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Hk, Sq, Skv, D, causal,
                               q_offset, stream);
}
