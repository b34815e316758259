// The varint fetch codec's row decoder for Hopper (sm_90a): varint_decode.
//
// Part of the redesign of the TPU kernel delta_vlen_pallas
// (src/repro/kernels/varint/kernel.py), whose codec the reference and the
// first port left in plain array code around it.  This is the inverse of
// varint_encode's "rows" variant and folds in two plain PyTorch functions
// (kernels/varint/ref.py): decode_rows_ref, and scatter_compacted_ref
// when the requester's slot mask is given (the r-th decoded row goes
// straight to the slot of the r-th valid request; the other slots get
// sentinel rows).  Per lane, with the reference's rules:
//   - a byte's value index is the number of terminators (high bit clear)
//     before it; its place is the run of continuation bytes right before
//     it, capped at 4; contributions (b & 0x7F) << 7*place add in int32
//     with wrap-around; only bytes in [0, min(len, cap)) count;
//   - degrees are the degree stream's values; row starts their exclusive
//     running sum; output (r, c), c < deg[r] and r < the degree count, is
//     the in-row running sum of flat[min(rstart[r] + c, m*D - 1)], flat
//     the id stream's values; everything else is the sentinel;
//   - raw lanes read little-endian words (byte min(4w + b, cap - 1)), and
//     rows r < len / (4 D) are live.
//
// What bounds it: bytes.  It writes the (lanes, m, D) rows once, 3.73 GB
// for one responder chunk of the full q1 cell, while the live bytes of
// the streams are a few MB (none at all on q1, which fetches no row).
// The plain version parses every byte of both streams and materializes
// the whole (lanes, m*D) value array.  So this reads only the live
// bytes and never builds that array:
//   1. count pass: per 256-byte chunk of each id stream's live bytes, its
//      terminators (a warp a chunk, the chunks of a lane spread over
//      several blocks);
//   2. lane pass (a block per lane, small data): the chunk counts'
//      exclusive prefix, the degree stream parsed into degrees, the row
//      starts, the valid slots' ranks, the value after the last
//      terminator;
//   3. write pass, a warp per output row: a sentinel row with 16-byte
//      stores, or the row's first value found from the chunk prefix (a
//      binary search, then one ballot a 32 bytes), its bytes parsed with
//      ballots and warp scans 32 at a time.
// The streams and the output may be strided over a (T, S) lane grid, so
// the exchange's transpose and the requester's slice of the fetch buffer
// are read and written in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneThreads = 1024;
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;  // bytes of an id stream a terminator count covers
constexpr int kInfo = 8;     // int32 per lane of lane_info, below
// lane_info: raw, live id bytes, id terminators, value after the last
// terminator, live coded rows, live raw rows, live chunks
enum { kRaw, kLen, kCount, kTail, kRows, kRawRows, kChunks };

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
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

// Exclusive sum over a block of W warps (wrapping); every thread calls.
template <int W>
__device__ uint32_t block_excl_sum(uint32_t v, uint32_t* total) {
  __shared__ uint32_t part[W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t incl = warp_incl_sum(v);
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < W ? part[lane] : 0u;
    w = warp_incl_sum(w);
    if (lane < W) part[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp ? part[warp - 1] : 0u;
  *total = part[W - 1];
  __syncthreads();
  return before + incl - v;
}

__device__ __forceinline__ long long clamp_len(int32_t len, long long cap) {
  return len < 0 ? 0 : min((long long)len, cap);
}

// The value of the bytes s[start..end] (a value's bytes: place = offset
// from start, capped at 4).
__device__ __forceinline__ uint32_t value_of(const uint8_t* s, long long start,
                                             long long end) {
  uint32_t v = 0;
  for (long long q = start; q <= end; ++q)
    v += (uint32_t)(s[q] & 0x7F) << (7 * (int)min(q - start, 4LL));
  return v;
}

// The value that ends at terminator s[i]: its bytes start after the
// previous terminator.
__device__ __forceinline__ uint32_t value_ending_at(const uint8_t* s,
                                                    long long i) {
  long long p = i - 1;
  while (p >= 0 && s[p] >= 0x80) --p;
  return value_of(s, p + 1, i);
}

// Position of the k-th terminator (k below the lane's count): the chunk by
// binary search over the chunks' exclusive prefix, then a scan of it.
// Warp version (all lanes agree), and one for a single thread.
__device__ long long term_pos_warp(const uint8_t* s, long long len,
                                   const int32_t* pref, long long nchunks,
                                   uint32_t k) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = nchunks - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if ((uint32_t)pref[mid] <= k) lo = mid; else hi = mid - 1;
  }
  uint32_t rem = k - (uint32_t)pref[lo];
  for (int i = 0; i < kChunk / 32; ++i) {
    const long long q = lo * kChunk + i * 32 + lane;
    unsigned mask = __ballot_sync(kFull, q < len && s[q] < 0x80);
    const uint32_t n = __popc(mask);
    if (rem < n) {
      for (uint32_t t = 0; t < rem; ++t) mask &= mask - 1;
      return lo * kChunk + i * 32 + __ffs(mask) - 1;
    }
    rem -= n;
  }
  return len;
}

__device__ long long term_pos_thread(const uint8_t* s, long long len,
                                     const int32_t* pref, long long nchunks,
                                     uint32_t k) {
  long long lo = 0, hi = nchunks - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if ((uint32_t)pref[mid] <= k) lo = mid; else hi = mid - 1;
  }
  uint32_t rem = k - (uint32_t)pref[lo];
  const long long end = min((lo + 1) * kChunk, len);
  for (long long q = lo * kChunk; q < end; ++q) {
    if (s[q] < 0x80) {
      if (rem == 0) return q;
      --rem;
    }
  }
  return len;
}

// flat[f] of the reference: the f-th value, the partial value after the
// last terminator at f == count, 0 past it.
__device__ uint32_t value_at(const uint8_t* s, long long len,
                             const int32_t* pref, long long nchunks,
                             uint32_t count, uint32_t tail, long long f) {
  if (f > (long long)count) return 0;
  if (f == (long long)count) return tail;
  const long long start =
      f == 0 ? 0 : term_pos_thread(s, len, pref, nchunks, (uint32_t)f - 1) + 1;
  return value_of(s, start, term_pos_thread(s, len, pref, nchunks, (uint32_t)f));
}

// row[from, D) = v, the warp's stores 16 bytes wide where aligned.
__device__ void fill_row(int32_t* row, long long from, long long D, int32_t v) {
  const int lane = threadIdx.x & 31;
  int32_t* p = row + from;
  int32_t* e = row + D;
  int32_t* a = (int32_t*)(((uintptr_t)p + 15) & ~(uintptr_t)15);
  if (a > e) a = e;
  int32_t* z = (int32_t*)((uintptr_t)e & ~(uintptr_t)15);
  if (z < a) z = a;
  for (int32_t* q = p + lane; q < a; q += 32) *q = v;
  int4* vp = reinterpret_cast<int4*>(a);
  const long long nv = (z - a) / 4;
  const int4 w = make_int4(v, v, v, v);
  for (long long i = lane; i < nv; i += 32) vp[i] = w;
  for (int32_t* q = z + lane; q < e; q += 32) *q = v;
}

// Count pass: terminators per chunk of each coded lane's live id bytes.
__global__ void __launch_bounds__(kThreads)
varint_decode_count(const uint8_t* __restrict__ ids_s, long long ids_st,
                    long long ids_ss, long long icap,
                    const int32_t* __restrict__ ids_len,
                    const uint8_t* __restrict__ raw, long long S, int G,
                    long long nchunk, int32_t* __restrict__ chunk) {
  const long long l = blockIdx.x / G;
  const int g = blockIdx.x % G;
  if (raw[l]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long len = clamp_len(ids_len[l], icap);
  const long long nlive = (len + kChunk - 1) / kChunk;
  const uint8_t* s = ids_s + (l / S) * ids_st + (l % S) * ids_ss;
  for (long long c = (long long)g * kWarps + warp; c < nlive;
       c += (long long)G * kWarps) {
    uint32_t n = 0;
    for (int i = 0; i < kChunk / 32; ++i) {
      const long long q = c * kChunk + i * 32 + lane;
      n += q < len && s[q] < 0x80;
    }
    n = warp_sum(n);
    if (lane == 0) chunk[l * nchunk + c] = (int32_t)n;
  }
}

// Lane pass: a block per lane over its small data.
__global__ void __launch_bounds__(kLaneThreads)
varint_decode_lane(const uint8_t* __restrict__ degs_s, long long degs_st,
                   long long degs_ss, long long dcap,
                   const int32_t* __restrict__ degs_len,
                   const uint8_t* __restrict__ ids_s, long long ids_st,
                   long long ids_ss, long long icap,
                   const int32_t* __restrict__ ids_len,
                   const uint8_t* __restrict__ raw,
                   const uint8_t* __restrict__ valid, long long S, long long m,
                   long long D, long long nchunk, int32_t* __restrict__ chunk,
                   int32_t* __restrict__ degs_val, int32_t* __restrict__ rstart,
                   int32_t* __restrict__ src_row, int32_t* __restrict__ info) {
  const long long l = blockIdx.x;
  int32_t* inf = info + l * kInfo;
  uint32_t tot;
  if (valid != nullptr) {  // slot j takes decoded row "valid slots before j"
    uint32_t run = 0;
    for (long long base = 0; base < m; base += kLaneThreads) {
      const long long j = base + threadIdx.x;
      const uint32_t v = j < m && valid[l * m + j];
      const uint32_t ex = block_excl_sum<kLaneWarps>(v, &tot);
      if (j < m) src_row[l * m + j] = v ? (int32_t)(run + ex) : -1;
      run += tot;
    }
  }
  if (raw[l]) {
    if (threadIdx.x == 0) {
      const long long len = ids_len[l], q = 4 * D;
      long long rows = len / q;
      if (len % q != 0 && len < 0) --rows;  // floor, as PyTorch's //
      inf[kRaw] = 1;
      inf[kRawRows] = (int32_t)rows;
    }
    return;
  }
  const long long len = clamp_len(ids_len[l], icap);
  const long long nlive = (len + kChunk - 1) / kChunk;
  int32_t* ch = chunk + l * nchunk;
  uint32_t count = 0;
  for (long long base = 0; base < nlive; base += kLaneThreads) {
    const long long c = base + threadIdx.x;
    const uint32_t v = c < nlive ? (uint32_t)ch[c] : 0u;
    const uint32_t ex = block_excl_sum<kLaneWarps>(v, &tot);
    if (c < nlive) ch[c] = (int32_t)(count + ex);
    count += tot;
  }
  // the degree stream, each terminator's value at its index
  const uint8_t* ds = degs_s + (l / S) * degs_st + (l % S) * degs_ss;
  const long long dlen = clamp_len(degs_len[l], dcap);
  uint32_t ndeg = 0;
  for (long long base = 0; base < dlen; base += kLaneThreads) {
    const long long i = base + threadIdx.x;
    const bool term = i < dlen && ds[i] < 0x80;
    const uint32_t k = ndeg + block_excl_sum<kLaneWarps>(term, &tot);
    if (term && k < m) degs_val[l * m + k] = (int32_t)value_ending_at(ds, i);
    ndeg += tot;
  }
  __syncthreads();  // degs_val, written above by any thread, is read below
  const long long nrows = min((long long)ndeg, m);
  uint32_t start = 0;
  for (long long base = 0; base < nrows; base += kLaneThreads) {
    const long long r = base + threadIdx.x;
    const uint32_t v = r < nrows ? (uint32_t)degs_val[l * m + r] : 0u;
    const uint32_t ex = block_excl_sum<kLaneWarps>(v, &tot);
    if (r < nrows) rstart[l * m + r] = (int32_t)(start + ex);
    start += tot;
  }
  if (threadIdx.x == 0) {
    const uint8_t* s = ids_s + (l / S) * ids_st + (l % S) * ids_ss;
    long long p = len - 1;  // the bytes after the last terminator
    while (p >= 0 && s[p] >= 0x80) --p;
    inf[kRaw] = 0;
    inf[kLen] = (int32_t)len;
    inf[kCount] = (int32_t)count;
    inf[kTail] = (int32_t)(p + 1 < len ? value_of(s, p + 1, len - 1) : 0u);
    inf[kRows] = (int32_t)nrows;
    inf[kChunks] = (int32_t)nlive;
  }
}

// A live coded row whose value indices rs .. rs + ndeg - 1 need no clamp:
// parse its bytes from its first value on, 32 a step.
__device__ void decode_run(int32_t* row, const uint8_t* s, long long len,
                                const int32_t* pref, long long nchunks,
                                uint32_t count, int32_t rs, long long ndeg) {
  const int lane = threadIdx.x & 31;
  long long p;  // the first byte of value rs
  if (rs == 0) p = 0;
  else if ((uint32_t)rs <= count)
    p = term_pos_warp(s, len, pref, nchunks, (uint32_t)rs - 1) + 1;
  else p = len;  // past the last value: every value reads 0
  uint32_t run = 0;   // the row's running sum
  uint32_t csum = 0;  // the open value's sum so far, and its bytes
  long long clen = 0, done = 0;
  while (done < ndeg && p < len) {
    const long long q = p + lane;
    const bool present = q < len;
    const uint32_t b = present ? s[q] : 0u;
    const bool term = present && b < 0x80;
    const unsigned tmask = __ballot_sync(kFull, term);
    const unsigned lower = tmask & ((1u << lane) - 1u);
    const int ltb = lower ? 31 - __clz(lower) : -1;  // terminator below
    const long long j = ltb >= 0 ? lane - ltb - 1 : clen + lane;
    const uint32_t contrib =
        present ? (b & 0x7Fu) << (7 * (int)min(j, 4LL)) : 0u;
    const uint32_t S = warp_incl_sum(contrib);
    const uint32_t s_ltb = __shfl_sync(kFull, S, ltb >= 0 ? ltb : 0);
    const uint32_t val = ltb >= 0 ? S - s_ltb : S + csum;
    const uint32_t R = warp_incl_sum(term ? val : 0u);
    const long long vi = done + __popc(lower);
    if (term && vi < ndeg) row[vi] = (int32_t)(run + R);
    run += __shfl_sync(kFull, R, 31);
    done += __popc(tmask);
    const int npres = (int)min(32LL, len - p);
    const int last = tmask ? 31 - __clz(tmask) : -1;
    const uint32_t s_end = __shfl_sync(kFull, S, npres - 1);
    const uint32_t s_last = __shfl_sync(kFull, S, last >= 0 ? last : 0);
    if (last == npres - 1) {
      csum = 0;
      clen = 0;
    } else if (last >= 0) {
      csum = s_end - s_last;
      clen = npres - 1 - last;
    } else {
      csum += s_end;
      clen += npres;
    }
    p += 32;
  }
  // out of bytes: the open value is the partial one after the last
  // terminator, every later value 0
  for (long long c = done + lane; c < ndeg; c += 32)
    row[c] = (int32_t)(run + csum);
}

// A live coded row whose indices wrap or clamp: each value looked up.
__device__ void decode_clamped(int32_t* row, const uint8_t* s, long long len,
                               const int32_t* pref, long long nchunks,
                               uint32_t count, uint32_t tail, int32_t rs,
                               long long ndeg, long long last) {
  const int lane = threadIdx.x & 31;
  uint32_t run = 0;
  for (long long c0 = 0; c0 < ndeg; c0 += 32) {
    const long long c = c0 + lane;
    uint32_t v = 0;
    if (c < ndeg) {
      long long f = (int32_t)((uint32_t)rs + (uint32_t)c);
      f = f < 0 ? 0 : (f > last ? last : f);
      v = value_at(s, len, pref, nchunks, count, tail, f);
    }
    const uint32_t R = warp_incl_sum(v);
    if (c < ndeg) row[c] = (int32_t)(run + R);
    run += __shfl_sync(kFull, R, 31);
  }
}

// Write pass: a warp per output row.
__global__ void __launch_bounds__(kThreads)
varint_decode_write(const uint8_t* __restrict__ ids_s, long long ids_st,
                    long long ids_ss, long long icap, long long L, long long S,
                    long long m, long long D, int32_t sentinel,
                    long long nchunk, const int32_t* __restrict__ chunk,
                    const int32_t* __restrict__ degs_val,
                    const int32_t* __restrict__ rstart,
                    const int32_t* __restrict__ src_row,
                    const int32_t* __restrict__ info, int32_t* __restrict__ out,
                    long long out_st, long long out_ss) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= L * m) return;
  const long long l = g / m, j = g % m;
  int32_t* row = out + (l / S) * out_st + (l % S) * out_ss + j * D;
  const int32_t* inf = info + l * kInfo;
  const long long r = src_row != nullptr ? src_row[l * m + j] : j;
  const uint8_t* s = ids_s + (l / S) * ids_st + (l % S) * ids_ss;
  if (inf[kRaw]) {
    if (r < 0 || r >= inf[kRawRows] || icap == 0) {
      fill_row(row, 0, D, sentinel);
      return;
    }
    for (long long c = lane; c < D; c += 32) {
      const long long w = r * D + c;
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v |= (uint32_t)s[min(4 * w + b, icap - 1)] << (8 * b);
      row[c] = (int32_t)v;
    }
    return;
  }
  long long ndeg = 0;
  if (r >= 0 && r < inf[kRows]) {
    const int32_t deg = degs_val[l * m + r], rs = rstart[l * m + r];
    ndeg = deg <= 0 ? 0 : min((long long)deg, D);
    const int32_t* pref = chunk + l * nchunk;
    const uint32_t count = (uint32_t)inf[kCount];
    if (rs >= 0 && (long long)rs + ndeg <= m * D) {
      decode_run(row, s, inf[kLen], pref, inf[kChunks], count, rs, ndeg);
    } else if (ndeg > 0) {
      decode_clamped(row, s, inf[kLen], pref, inf[kChunks], count,
                     (uint32_t)inf[kTail], rs, ndeg, m * D - 1);
    }
  }
  fill_row(row, ndeg, D, sentinel);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
long long n_chunks(long long icap) { return icap > 0 ? ceil_div(icap, kChunk) : 1; }

}  // namespace

// Scratch bytes: lane info, chunk counts, degrees, row starts, slot ranks.
extern "C" long long varint_decode_rows_scratch(long long L, long long m,
                                                long long icap) {
  return 4 * L * (kInfo + n_chunks(icap) + 3 * m);
}

// Lanes l = t * S + s of a (T, S) grid.  degs_s, ids_s: u8, lane (t, s) at
// element t * st + s * ss, its cap bytes contiguous; degs_len, ids_len
// (T*S,) int32, raw (T*S,) u8, valid (T*S, m) u8 or null, all contiguous;
// out: int32, lane (t, s) at t * out_st + s * out_ss, its (m, D) rows
// contiguous.  Returns cudaGetLastError().
extern "C" int varint_decode_rows_launch(
    const void* degs_s, long long degs_st, long long degs_ss, long long dcap,
    const void* degs_len, const void* ids_s, long long ids_st,
    long long ids_ss, long long icap, const void* ids_len, const void* raw,
    const void* valid, long long T, long long S, long long m, long long D,
    int sentinel, void* out, long long out_st, long long out_ss,
    void* scratch, void* cuda_stream) {
  const long long L = T * S;
  if (L == 0 || m == 0 || D == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  const long long nchunk = n_chunks(icap);
  int32_t* info = static_cast<int32_t*>(scratch);
  int32_t* chunk = info + kInfo * L;
  int32_t* degs_val = chunk + nchunk * L;
  int32_t* rstart = degs_val + m * L;
  int32_t* src_row = valid != nullptr ? rstart + m * L : nullptr;
  const uint8_t* ds = static_cast<const uint8_t*>(degs_s);
  const uint8_t* is = static_cast<const uint8_t*>(ids_s);
  const int32_t* dl = static_cast<const int32_t*>(degs_len);
  const int32_t* il = static_cast<const int32_t*>(ids_len);
  const uint8_t* rw = static_cast<const uint8_t*>(raw);
  const int G = (int)max(1LL, min(ceil_div(nchunk, kWarps), 2048 / L));
  varint_decode_count<<<(unsigned)(G * L), kThreads, 0, st>>>(
      is, ids_st, ids_ss, icap, il, rw, S, G, nchunk, chunk);
  varint_decode_lane<<<(unsigned)L, kLaneThreads, 0, st>>>(
      ds, degs_st, degs_ss, dcap, dl, is, ids_st, ids_ss, icap, il, rw,
      static_cast<const uint8_t*>(valid), S, m, D, nchunk, chunk, degs_val,
      rstart, src_row, info);
  varint_decode_write<<<(unsigned)ceil_div(L * m, kWarps), kThreads, 0, st>>>(
      is, ids_st, ids_ss, icap, L, S, m, D, sentinel, nchunk, chunk, degs_val,
      rstart, src_row, info, static_cast<int32_t*>(out), out_st, out_ss);
  return (int)cudaGetLastError();
}
