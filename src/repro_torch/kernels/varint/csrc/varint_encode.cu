// The varint fetch codec's encoders for Hopper (sm_90a): varint_encode.
//
// Replaces the TPU kernel delta_vlen_pallas
// (src/repro/kernels/varint/kernel.py), which sizes the request ids of
// one lane (the delta to the running maximum of the valid ids, the first
// absolute, and its LEB128 length) and leaves the byte scatter to jnp.
// Here the whole encoder of each stream is one call, over every lane of
// an exchange at once, and folds in the plain PyTorch code that used to
// surround the sizing pass (kernels/varint/ref.py):
//   "ids"  — encode_ids_ref: request ids (L, M) with sentinel holes ->
//            LEB128 deltas (or the compacted valid ids as raw int32 when
//            that is shorter or the code does not fit `cap`), length,
//            raw and overflow flags, the modeled size (varints capped at
//            4 B); with `delta`/`vlen` given it writes delta_vlen_ref's
//            two outputs instead and stops (ops.delta_vlen);
//   "rows" — encode_rows_ref: adjacency windows (L, m, D) with a valid
//            flag per row -> a degree stream (one varint per valid row:
//            the count of entries below the sentinel) and an id stream
//            (per valid row, the first `deg` columns: column 0 absolute,
//            then consecutive differences, clamped at 0), or the valid
//            rows compacted as raw int32 (degree stream empty).
// Both zero their streams past the bytes they write, as the plain
// versions' zeroed buffers are.
//
// What bounds them: bytes.  The streams are sized for the worst case
// (4 B an id; 4 * D B a row), and the engine's rows are mostly dead: on
// the full q1 cell one responder chunk is 16 lanes x 32,768 slots of
// 1,780 ids, 3.73 GB of stream capacity to zero, while the live rows and
// bytes are a few MB.  So the design reads only what is live and writes
// each byte of the streams once:
//   - every lane is cut into tiles (1,024 ids; 64 rows) spread over the
//     card, never one block per lane;
//   - a size pass writes per-tile sums (the running maximum's carry and
//     the valid count for ids; byte counts and valid counts for rows),
//     reading a row only if it is valid; each later tile finds its
//     carries from the sums of the tiles before it, so the write pass
//     knows every byte offset and the lane's raw/coded choice;
//   - the write pass re-reads the live ids or rows (from L2 mostly),
//     writes their bytes, and each tile zeroes its share of the lane's
//     stream past the written end with 16-byte stores.
// Arithmetic follows PyTorch's int32 rules: differences and sums wrap.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kItems = 4;                        // ids a thread, consecutive
constexpr int kIdTile = kThreads * kItems;       // ids a tile
constexpr int kRowTile = 64;                     // rows a tile
constexpr int kRowsPerWarp = kRowTile / kWarps;

__device__ __forceinline__ int32_t varint_size(int32_t d) {
  return 1 + (d >= (1 << 7)) + (d >= (1 << 14)) + (d >= (1 << 21)) +
         (d >= (1 << 28));
}

__device__ __forceinline__ int32_t sub_wrap(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int s = 16; s > 0; s >>= 1) v = max(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ uint32_t warp_incl_sum(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, v, s);
    if (lane >= s) v += t;
  }
  return v;
}

__device__ __forceinline__ int32_t warp_incl_max(int32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int32_t t = __shfl_up_sync(kFull, v, s);
    if (lane >= s) v = max(v, t);
  }
  return v;
}

// Exclusive sum over the block (wrapping); every thread calls it.
// `total` (may be null) receives the block's sum.
__device__ uint32_t block_excl_sum(uint32_t v, uint32_t* total) {
  __shared__ uint32_t part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t incl = warp_incl_sum(v);
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? part[lane] : 0u;
    w = warp_incl_sum(w);
    if (lane < kWarps) part[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp ? part[warp - 1] : 0u;
  if (total) *total = part[kWarps - 1];
  __syncthreads();  // part is rewritten by the next call
  return before + incl - v;
}

// Exclusive running maximum over the block, -1 before the first thread.
__device__ int32_t block_excl_max(int32_t v, int32_t* total) {
  __shared__ int32_t part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t incl = warp_incl_max(v);
  int32_t excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? part[lane] : -1;
    w = warp_incl_max(w);
    if (lane < kWarps) part[lane] = w;
  }
  __syncthreads();
  const int32_t before = warp ? part[warp - 1] : -1;
  if (total) *total = part[kWarps - 1];
  __syncthreads();
  return max(before, excl);
}

// The LEB128 bytes of d >= 0 (vl of them) at out[pos..], those at or past
// cap dropped.
__device__ __forceinline__ void put_varint(uint8_t* out, long long pos,
                                           int32_t d, int vl,
                                           long long cap) {
  for (int b = 0; b < vl; ++b) {
    const long long p = pos + b;
    if (p < cap)
      out[p] = (uint8_t)(((d >> (7 * b)) & 0x7F) | (b + 1 < vl ? 0x80 : 0));
  }
}

// The little-endian bytes of v at out[pos..pos+4), those past cap dropped.
__device__ __forceinline__ void put_word(uint8_t* out, long long pos,
                                         int32_t v, long long cap) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (pos + b < cap) out[pos + b] = (uint8_t)(((uint32_t)v >> (8 * b)) & 0xFF);
}

// Zero out[from, to) with the whole block: 16-byte stores between the
// aligned ends, single bytes at the edges.
__device__ void zero_bytes(uint8_t* out, long long from, long long to) {
  if (from >= to) return;
  uint8_t* p = out + from;
  uint8_t* e = out + to;
  uint8_t* a = (uint8_t*)(((uintptr_t)p + 15) & ~(uintptr_t)15);
  if (a > e) a = e;
  uint8_t* z = (uint8_t*)((uintptr_t)e & ~(uintptr_t)15);
  if (z < a) z = a;
  for (uint8_t* q = p + threadIdx.x; q < a; q += blockDim.x) *q = 0;
  uint4* v = reinterpret_cast<uint4*>(a);
  const long long nv = (z - a) / 16;
  for (long long i = threadIdx.x; i < nv; i += blockDim.x)
    v[i] = make_uint4(0u, 0u, 0u, 0u);
  for (uint8_t* q = z + threadIdx.x; q < e; q += blockDim.x) *q = 0;
}

// ---------------------------------------------------------------------- ids

// Size pass 1: per tile the maximum valid id (-1: none) and the valid count.
__global__ void __launch_bounds__(kThreads)
varint_ids_tiles(const int32_t* __restrict__ ids, long long M, int ntiles,
                 int32_t sentinel, int32_t* __restrict__ tile_max,
                 int32_t* __restrict__ tile_cnt) {
  const long long l = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int32_t* in = ids + l * M;
  int32_t tmax = -1;
  uint32_t cnt = 0;
  for (int k = 0; k < kItems; ++k) {  // coalesced: order does not matter
    const long long j = (long long)tile * kIdTile + k * kThreads + threadIdx.x;
    if (j < M) {
      const int32_t v = __ldg(in + j);
      if (v < sentinel) {
        tmax = max(tmax, v);
        ++cnt;
      }
    }
  }
  uint32_t total;
  block_excl_sum(cnt, &total);
  int32_t bmax;
  block_excl_max(tmax, &bmax);
  if (threadIdx.x == 0) {
    tile_max[l * ntiles + tile] = bmax;
    tile_cnt[l * ntiles + tile] = (int32_t)total;
  }
}

// The maximum of the lane's tile maxima before `tile` (warp 0's value).
__device__ __forceinline__ int32_t carry_max(const int32_t* tile_max,
                                             long long l, int ntiles,
                                             int tile) {
  int32_t c = -1;
  for (int t = threadIdx.x & 31; t < tile; t += 32)
    c = max(c, tile_max[l * ntiles + t]);
  return warp_max(c);
}

// This thread's kItems consecutive ids, their deltas and sizes, given the
// running maximum `carry` of the earlier tiles (delta_vlen_ref's rule).
struct IdItems {
  int32_t v[kItems], d[kItems], vl[kItems];
};

__device__ __forceinline__ void id_items(const int32_t* in, long long M,
                                         long long j0, int32_t sentinel,
                                         int32_t carry, IdItems& it) {
  int32_t tmax = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    it.v[k] = j0 + k < M ? __ldg(in + j0 + k) : sentinel;
    if (it.v[k] < sentinel) tmax = max(tmax, it.v[k]);
  }
  int32_t prev = max(carry, block_excl_max(tmax, nullptr));
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = it.v[k] < sentinel;
    int32_t d = prev >= 0 ? sub_wrap(it.v[k], prev) : it.v[k];
    d = valid ? max(d, 0) : 0;
    it.d[k] = d;
    it.vl[k] = valid ? varint_size(d) : 0;
    if (valid) prev = max(prev, it.v[k]);
  }
}

// Size pass 2: per tile the byte count and the modeled count; or, for
// ops.delta_vlen, the deltas and sizes themselves.
__global__ void __launch_bounds__(kThreads)
varint_ids_sizes(const int32_t* __restrict__ ids, long long M, int ntiles,
                 int32_t sentinel, const int32_t* __restrict__ tile_max,
                 int32_t* __restrict__ delta, int32_t* __restrict__ vlen,
                 int32_t* __restrict__ tile_bytes,
                 int32_t* __restrict__ tile_model) {
  __shared__ int32_t s_carry;
  const long long l = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  if (threadIdx.x < 32) {
    const int32_t c = carry_max(tile_max, l, ntiles, tile);
    if (threadIdx.x == 0) s_carry = c;
  }
  __syncthreads();
  const long long j0 = (long long)tile * kIdTile + threadIdx.x * kItems;
  IdItems it;
  id_items(ids + l * M, M, j0, sentinel, s_carry, it);
  if (delta != nullptr) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (j0 + k < M) {
        delta[l * M + j0 + k] = it.d[k];
        vlen[l * M + j0 + k] = it.vl[k];
      }
    }
    return;
  }
  uint32_t bytes = 0, model = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    bytes += it.vl[k];
    model += min(it.vl[k], 4);
  }
  uint32_t tb, tm;
  block_excl_sum(bytes, &tb);
  block_excl_sum(model, &tm);
  if (threadIdx.x == 0) {
    tile_bytes[l * ntiles + tile] = (int32_t)tb;
    tile_model[l * ntiles + tile] = (int32_t)tm;
  }
}

// Write pass: the lane's choice from the tile sums, the bytes of this
// tile's ids, its share of the zeroed tail; tile 0 writes the lane's
// length, raw, overflow and model.
__global__ void __launch_bounds__(kThreads)
varint_ids_write(const int32_t* __restrict__ ids, long long M, int ntiles,
                 int32_t sentinel, long long cap, long long zshare,
                 const int32_t* __restrict__ tile_max,
                 const int32_t* __restrict__ tile_cnt,
                 const int32_t* __restrict__ tile_bytes,
                 const int32_t* __restrict__ tile_model,
                 uint8_t* __restrict__ stream, int32_t* __restrict__ length,
                 uint8_t* __restrict__ raw, uint8_t* __restrict__ overflow,
                 int32_t* __restrict__ model) {
  __shared__ int32_t s_carry;
  __shared__ uint32_t s_sum[5];  // bytes before, valid before, totals x3
  const long long l = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  if (threadIdx.x < 32) {
    uint32_t pb = 0, pc = 0, tb = 0, tc = 0, tm = 0;
    for (int t = threadIdx.x; t < ntiles; t += 32) {
      const long long i = l * ntiles + t;
      const uint32_t b = (uint32_t)tile_bytes[i], c = (uint32_t)tile_cnt[i];
      tb += b;
      tc += c;
      tm += (uint32_t)tile_model[i];
      if (t < tile) {
        pb += b;
        pc += c;
      }
    }
    pb = warp_sum(pb);
    pc = warp_sum(pc);
    tb = warp_sum(tb);
    tc = warp_sum(tc);
    tm = warp_sum(tm);
    const int32_t c = carry_max(tile_max, l, ntiles, tile);
    if (threadIdx.x == 0) {
      s_carry = c;
      s_sum[0] = pb;
      s_sum[1] = pc;
      s_sum[2] = tb;
      s_sum[3] = tc;
      s_sum[4] = tm;
    }
  }
  __syncthreads();
  const int32_t total = (int32_t)s_sum[2], count = (int32_t)s_sum[3];
  const int32_t raw_len = (int32_t)(4u * (uint32_t)count);
  const bool use_raw = total > raw_len || (long long)total > cap;
  if (tile == 0 && threadIdx.x == 0) {
    const int32_t len = use_raw ? raw_len : total;
    length[l] = len;
    raw[l] = use_raw;
    overflow[l] = (long long)len > cap;
    model[l] = (int32_t)s_sum[4];
  }
  const long long j0 = (long long)tile * kIdTile + threadIdx.x * kItems;
  IdItems it;
  id_items(ids + l * M, M, j0, sentinel, s_carry, it);
  uint32_t bytes = 0, cnt = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    bytes += it.vl[k];
    cnt += it.vl[k] > 0;
  }
  long long pos = s_sum[0] + block_excl_sum(bytes, nullptr);
  long long rank = s_sum[1] + block_excl_sum(cnt, nullptr);
  uint8_t* out = stream + l * cap;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (it.vl[k] == 0) continue;
    if (use_raw) {
      put_word(out, 4 * rank, it.v[k], cap);
      ++rank;
    } else {
      put_varint(out, pos, it.d[k], it.vl[k], cap);
      pos += it.vl[k];
    }
  }
  const long long written =
      use_raw ? min(4LL * (long long)(uint32_t)count, cap) : (long long)total;
  zero_bytes(out, max(written, tile * zshare), min(cap, (tile + 1) * zshare));
}

// --------------------------------------------------------------------- rows

// Size pass: per valid row its degree (entries below the sentinel) and
// id-stream bytes; per tile the byte, degree-byte and valid counts.
__global__ void __launch_bounds__(kThreads)
varint_rows_sizes(const int32_t* __restrict__ rows,
                  const uint8_t* __restrict__ valid, long long m, long long D,
                  int ntiles, int32_t sentinel, int32_t* __restrict__ row_deg,
                  int32_t* __restrict__ row_bytes,
                  int32_t* __restrict__ tile_sum) {
  __shared__ uint32_t s_part[3][kWarps];
  const long long l = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t wb = 0, wd = 0, wc = 0;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long r = (long long)tile * kRowTile + warp * kRowsPerWarp + i;
    if (r >= m) break;
    if (!valid[l * m + r]) continue;
    const int32_t* row = rows + (l * m + r) * D;
    uint32_t deg = 0;
    for (long long c = lane; c < D; c += 32) deg += __ldg(row + c) < sentinel;
    deg = warp_sum(deg);
    uint32_t bytes = 0;
    for (long long c = lane; c < (long long)deg; c += 32) {
      const int32_t x = __ldg(row + c);
      const int32_t d = c ? sub_wrap(x, __ldg(row + c - 1)) : x;
      bytes += varint_size(max(d, 0));
    }
    bytes = warp_sum(bytes);
    if (lane == 0) {
      row_deg[l * m + r] = (int32_t)deg;
      row_bytes[l * m + r] = (int32_t)bytes;
      wb += bytes;
      wd += varint_size((int32_t)deg);
      wc += 1;
    }
  }
  if (lane == 0) {
    s_part[0][warp] = wb;
    s_part[1][warp] = wd;
    s_part[2][warp] = wc;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    uint32_t s = 0;
    for (int w = 0; w < kWarps; ++w) s += s_part[threadIdx.x][w];
    tile_sum[(l * ntiles + tile) * 3 + threadIdx.x] = (int32_t)s;
  }
}

// Per lane: the exclusive prefix of the tile sums (in place), the lane's
// raw/coded choice and its outputs; lane_info gets (raw, ids bytes
// written, degree bytes written).
__global__ void __launch_bounds__(kThreads)
varint_rows_scan(int ntiles, long long D, long long dcap, long long icap,
                 int32_t* __restrict__ tile_sum,
                 long long* __restrict__ lane_info,
                 int32_t* __restrict__ degs_len, int32_t* __restrict__ ids_len,
                 uint8_t* __restrict__ raw, uint8_t* __restrict__ overflow) {
  const long long l = blockIdx.x;
  int32_t* ts = tile_sum + l * ntiles * 3;
  uint32_t run[3] = {0u, 0u, 0u};
  for (int base = 0; base < ntiles; base += kThreads) {
    const int t = base + threadIdx.x;
    for (int q = 0; q < 3; ++q) {
      const uint32_t v = t < ntiles ? (uint32_t)ts[t * 3 + q] : 0u;
      uint32_t tot;
      const uint32_t ex = block_excl_sum(v, &tot);
      if (t < ntiles) ts[t * 3 + q] = (int32_t)(run[q] + ex);
      run[q] += tot;
    }
  }
  if (threadIdx.x == 0) {
    const int32_t ids_total = (int32_t)run[0], degs_total = (int32_t)run[1];
    const uint32_t count = run[2];
    const int32_t raw_len = (int32_t)(4u * (uint32_t)D * count);
    const int32_t both = (int32_t)(run[0] + run[1]);
    const bool use_raw = both > raw_len || (long long)ids_total > icap ||
                         (long long)degs_total > dcap;
    const int32_t il = use_raw ? raw_len : ids_total;
    const int32_t dl = use_raw ? 0 : degs_total;
    ids_len[l] = il;
    degs_len[l] = dl;
    raw[l] = use_raw;
    overflow[l] = (long long)il > icap || (long long)dl > dcap;
    lane_info[l * 3 + 0] = use_raw;
    lane_info[l * 3 + 1] =
        use_raw ? min(4LL * D * (long long)count, icap) : (long long)ids_total;
    lane_info[l * 3 + 2] = use_raw ? 0 : (long long)degs_total;
  }
}

// Write pass: each valid row's degree and id bytes (or its raw words at
// its rank), then this tile's share of both zeroed tails.
__global__ void __launch_bounds__(kThreads)
varint_rows_write(const int32_t* __restrict__ rows,
                  const uint8_t* __restrict__ valid, long long m, long long D,
                  int ntiles, long long dcap, long long icap,
                  long long zshare_d, long long zshare_i,
                  const int32_t* __restrict__ row_deg,
                  const int32_t* __restrict__ row_bytes,
                  const int32_t* __restrict__ tile_sum,
                  const long long* __restrict__ lane_info,
                  uint8_t* __restrict__ degs_s, uint8_t* __restrict__ ids_s) {
  __shared__ long long s_off[kRowTile], s_doff[kRowTile], s_rank[kRowTile];
  __shared__ int32_t s_deg[kRowTile];
  const long long l = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool use_raw = lane_info[l * 3] != 0;
  const int32_t* pre = tile_sum + (l * ntiles + tile) * 3;
  const long long r0 = (long long)tile * kRowTile;
  const long long r = r0 + threadIdx.x;
  const bool live = threadIdx.x < kRowTile && r < m && valid[l * m + r];
  const int32_t dg = live ? row_deg[l * m + r] : 0;
  const uint32_t eb = block_excl_sum(live ? row_bytes[l * m + r] : 0, nullptr);
  const uint32_t ed = block_excl_sum(live ? varint_size(dg) : 0, nullptr);
  const uint32_t ec = block_excl_sum(live ? 1u : 0u, nullptr);
  if (threadIdx.x < kRowTile) {
    s_off[threadIdx.x] = (uint32_t)pre[0] + eb;
    s_doff[threadIdx.x] = (uint32_t)pre[1] + ed;
    s_rank[threadIdx.x] = (uint32_t)pre[2] + ec;
    s_deg[threadIdx.x] = live ? dg : -1;
  }
  __syncthreads();
  uint8_t* dout = degs_s + l * dcap;
  uint8_t* iout = ids_s + l * icap;
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int i = warp * kRowsPerWarp + k;
    const int32_t deg = s_deg[i];
    if (deg < 0) continue;
    const int32_t* row = rows + (l * m + r0 + i) * D;
    if (use_raw) {
      const long long base = 4 * D * s_rank[i];
      for (long long c = lane; c < D; c += 32)
        put_word(iout, base + 4 * c, __ldg(row + c), icap);
      continue;
    }
    if (lane == 0) put_varint(dout, s_doff[i], deg, varint_size(deg), dcap);
    long long pos = s_off[i];
    for (long long c0 = 0; c0 < deg; c0 += 32) {
      const long long c = c0 + lane;
      int32_t d = 0, vl = 0;
      if (c < deg) {
        const int32_t x = __ldg(row + c);
        d = max(c ? sub_wrap(x, __ldg(row + c - 1)) : x, 0);
        vl = varint_size(d);
      }
      const uint32_t incl = warp_incl_sum((uint32_t)vl);
      if (vl) put_varint(iout, pos + incl - vl, d, vl, icap);
      pos += __shfl_sync(kFull, incl, 31);
    }
  }
  zero_bytes(iout, max(lane_info[l * 3 + 1], tile * zshare_i),
             min(icap, (tile + 1) * zshare_i));
  zero_bytes(dout, max(lane_info[l * 3 + 2], tile * zshare_d),
             min(dcap, (tile + 1) * zshare_d));
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Each tile's share of a lane's stream, in whole 16-byte words.
long long share(long long cap, long long ntiles) {
  return ceil_div(ceil_div(cap, ntiles), 16) * 16;
}

long long id_tiles(long long M) { return M > 0 ? ceil_div(M, kIdTile) : 1; }
long long row_tiles(long long m) { return m > 0 ? ceil_div(m, kRowTile) : 1; }

}  // namespace

// Scratch bytes the "ids" variant needs (four int32 per tile).
extern "C" long long varint_encode_ids_scratch(long long L, long long M) {
  return 4 * 4 * L * id_tiles(M);
}

// ids (L, M) int32.  With delta and vlen (L, M) int32 non-null: writes the
// sizing pass only (ops.delta_vlen).  Else stream (L, cap) u8, length,
// model (L,) int32, raw, overflow (L,) u8.  Returns cudaGetLastError().
extern "C" int varint_encode_ids_launch(
    const void* ids, long long L, long long M, int sentinel, long long cap,
    void* delta, void* vlen, void* stream, void* length, void* raw,
    void* overflow, void* model, void* scratch, void* cuda_stream) {
  if (L == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  const long long nt = id_tiles(M);
  int32_t* tile_max = static_cast<int32_t*>(scratch);
  int32_t* tile_cnt = tile_max + L * nt;
  int32_t* tile_bytes = tile_cnt + L * nt;
  int32_t* tile_model = tile_bytes + L * nt;
  const int32_t* in = static_cast<const int32_t*>(ids);
  const unsigned blocks = (unsigned)(L * nt);
  varint_ids_tiles<<<blocks, kThreads, 0, st>>>(in, M, (int)nt, sentinel,
                                                tile_max, tile_cnt);
  varint_ids_sizes<<<blocks, kThreads, 0, st>>>(
      in, M, (int)nt, sentinel, tile_max, static_cast<int32_t*>(delta),
      static_cast<int32_t*>(vlen), tile_bytes, tile_model);
  if (delta == nullptr)
    varint_ids_write<<<blocks, kThreads, 0, st>>>(
        in, M, (int)nt, sentinel, cap, share(cap, nt), tile_max, tile_cnt,
        tile_bytes, tile_model, static_cast<uint8_t*>(stream),
        static_cast<int32_t*>(length), static_cast<uint8_t*>(raw),
        static_cast<uint8_t*>(overflow), static_cast<int32_t*>(model));
  return (int)cudaGetLastError();
}

// Scratch bytes the "rows" variant needs.
extern "C" long long varint_encode_rows_scratch(long long L, long long m) {
  return 8 * 3 * L + 4 * 3 * L * row_tiles(m) + 4 * 2 * L * m;
}

// rows (L, m, D) int32, valid (L, m) u8 -> degs_s (L, dcap) u8, ids_s
// (L, icap) u8, degs_len, ids_len (L,) int32, raw, overflow (L,) u8.
extern "C" int varint_encode_rows_launch(
    const void* rows, const void* valid, long long L, long long m,
    long long D, int sentinel, long long dcap, long long icap, void* degs_s,
    void* degs_len, void* ids_s, void* ids_len, void* raw, void* overflow,
    void* scratch, void* cuda_stream) {
  if (L == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  const long long nt = row_tiles(m);
  long long* lane_info = static_cast<long long*>(scratch);
  int32_t* tile_sum = reinterpret_cast<int32_t*>(lane_info + 3 * L);
  int32_t* row_deg = tile_sum + 3 * L * nt;
  int32_t* row_bytes = row_deg + L * m;
  const int32_t* in = static_cast<const int32_t*>(rows);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  const unsigned blocks = (unsigned)(L * nt);
  varint_rows_sizes<<<blocks, kThreads, 0, st>>>(
      in, ok, m, D, (int)nt, sentinel, row_deg, row_bytes, tile_sum);
  varint_rows_scan<<<(unsigned)L, kThreads, 0, st>>>(
      (int)nt, D, dcap, icap, tile_sum, lane_info,
      static_cast<int32_t*>(degs_len), static_cast<int32_t*>(ids_len),
      static_cast<uint8_t*>(raw), static_cast<uint8_t*>(overflow));
  varint_rows_write<<<blocks, kThreads, 0, st>>>(
      in, ok, m, D, (int)nt, dcap, icap, share(dcap, nt), share(icap, nt),
      row_deg, row_bytes, tile_sum, lane_info, static_cast<uint8_t*>(degs_s),
      static_cast<uint8_t*>(ids_s));
  return (int)cudaGetLastError();
}
