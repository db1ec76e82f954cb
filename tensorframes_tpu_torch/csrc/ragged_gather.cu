// Ragged row gather for Hopper (sm_90a): stage the shape groups of a ragged
// map_rows column from one flat device buffer into dense [g_i, length_i]
// batches, every group of a call in one launch.
//
// Replaces the Pallas TPU kernel tensorframes_tpu/kernels/ragged_gather.py
// (ragged_gather_rows), which walks one group's rows on a sequential grid
// and DMAs each row's slice out of HBM at a scalar-prefetched int32 start
// offset. Padding rows carry offset 0 and re-read the first cell.
//
// What bounds it on the H100: bytes. Pure data movement: each output byte is
// written once (sum_i g_i * length_i * elem bytes, padding rows included),
// each distinct source byte is read once (the union of the rows' spans:
// padding rows re-read the first row's), plus the int32 starts; over
// 3.35 TB/s.
//
// Design. The threads map onto the OUTPUT's 16-byte chunks, not onto rows,
// so every lane is busy whatever the row length:
// - The launch's groups lie back to back in one output buffer, each at a
//   16-byte aligned offset (chunk0 * 16). A device table holds, per group,
//   {chunk0, offset of its starts, rows, row bytes}; chunk0 is the prefix
//   sum of the groups' chunks. A block owns kDepth * kThreads consecutive
//   chunks; its first warp finds the groups of the block's first and last
//   chunk by a 32-way search of chunk0 (two table reads for up to 1,024
//   groups), and a thread searches between those two (nearly always one).
// - A thread moves kDepth chunks (stride kThreads, so a warp's stores are 512
//   contiguous bytes) in phases: the loads of all its chunks' row starts,
//   then the loads of all their sources, then the stores, so at least four
//   16-byte loads are in flight per thread before the first store.
// - A chunk inside one row reads its 16 source bytes with one aligned
//   16-byte load when the source is 16-byte aligned, else with the two
//   aligned 16-byte loads that cover it, shifted into place by
//   __funnelshift_r: full width at any element width and offset (a bf16 row
//   at an odd start, an int8 row at any byte). Both aligned blocks hold a
//   byte of the row, so no load leaves the buffer's 16-byte span.
// - A chunk that crosses a row end (rows whose bytes are not a multiple of
//   16) takes a tail path. Elements of 1 or 2 bytes in rows of 16 bytes or
//   more: the end of row r and the start of row r + 1, each read by the
//   aligned 16-byte loads that cover it (never a block without a byte of
//   the row), shifted and merged into one 16-byte store; the next row's
//   start loads with the others in the first phase. Wider elements (at most
//   four a chunk), and rows shorter than 16 bytes: element-width loads,
//   walking row and column without a division (an A/B on an H100, PERF.md:
//   the merge paid for bf16 rows and cost f32 ones). Only 1-byte
//   dtypes load single bytes, in rows shorter than 16 bytes, and even they
//   store 16 bytes.
// - Every store is one aligned 16-byte store of the output; the bytes past a
//   group's end in its last chunk are written as zeros (padding between
//   groups in the buffer).
// - Bulk copies (cp.async.bulk through shared memory) were measured against
//   this vector path on rows of 1-4 KB on an H100 and not kept (PERF.md).
// Bit-exact for every dtype. A row whose start falls outside the buffer is
// written as zeros (the Python wrapper validates host offsets before they
// get here).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 4;                           // chunks in flight per thread
constexpr int kChunksPerBlock = kThreads * kDepth;  // 16 KB of output per block
constexpr int kCols = 4;                            // int64 columns of the group table

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// Largest group index whose chunk0 <= c, by a 32-way search over all groups
// (table[0] = 0 <= c holds). Called by a whole warp; every lane returns it.
__device__ __forceinline__ int warp_find_group(const int64_t* __restrict__ table, int groups,
                                               int64_t c) {
  const int lane = threadIdx.x & 31;
  int lo = 0, n = groups;
  while (n > 1) {
    const int step = (n + 31) / 32;
    const int i = lo + lane * step;
    const bool le = lane * step < n && ld64(table + static_cast<int64_t>(i) * kCols) <= c;
    const unsigned mask = __ballot_sync(0xffffffffu, le);
    const int last = 31 - __clz(mask);  // lane 0 always holds
    lo += last * step;
    n = min(step, n - last * step);
  }
  return lo;
}

// Largest i in [lo, hi] with chunk0[i] <= c, by one thread.
__device__ __forceinline__ int find_group(const int64_t* __restrict__ table, int lo, int hi,
                                          int64_t c) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ld64(table + static_cast<int64_t>(mid) * kCols) <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The 16 bytes at byte offset mis (1..15) into the 32 bytes a:b.
__device__ __forceinline__ uint4 shifted(uint4 a, uint4 b, int mis) {
  uint32_t w0, w1, w2, w3, w4;
  switch (mis >> 2) {
    case 0: w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = b.x; break;
    case 1: w0 = a.y; w1 = a.z; w2 = a.w; w3 = b.x; w4 = b.y; break;
    case 2: w0 = a.z; w1 = a.w; w2 = b.x; w3 = b.y; w4 = b.z; break;
    default: w0 = a.w; w1 = b.x; w2 = b.y; w3 = b.z; w4 = b.w; break;
  }
  const unsigned sh = 8u * static_cast<unsigned>(mis & 3);
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

template <int ES>
__device__ __forceinline__ void load_element(const uint8_t* p, uint32_t (&w)[4], int j) {
  if constexpr (ES == 1) {
    w[j >> 2] |= static_cast<uint32_t>(__ldg(p)) << (8 * (j & 3));
  } else if constexpr (ES == 2) {
    w[j >> 1] |= static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                 << (16 * (j & 1));
  } else if constexpr (ES == 4) {
    w[j] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (ES == 8) {
    const unsigned long long v = __ldg(reinterpret_cast<const unsigned long long*>(p));
    w[2 * j] = static_cast<uint32_t>(v);
    w[2 * j + 1] = static_cast<uint32_t>(v >> 32);
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
}

// The element tail path: the 16/ES elements of the chunk at group element
// e0, row by row (zeros past the group's end and for out-of-range rows).
template <int ES>
__device__ __forceinline__ uint4 tail_chunk(const uint8_t* __restrict__ flat, int64_t flat_bytes,
                                            const int32_t* __restrict__ st, int64_t rows,
                                            int64_t length, int64_t e0) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  int64_t r = e0 / length;
  int64_t col = e0 - r * length;
#pragma unroll
  for (int j = 0; j < 16 / ES; ++j) {
    if (r < rows) {
      const int64_t s = static_cast<int64_t>(__ldg(st + r)) * ES;
      if (s >= 0 && s + length * ES <= flat_bytes) load_element<ES>(flat + s + col * ES, w, j);
    }
    if (++col == length) {
      col = 0;
      ++r;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The n bytes (1..16) at src in bytes 0..n-1 of the result (the rest
// unspecified), from the aligned 16-byte blocks that hold them: a block is
// read only if one of the n bytes lies in it.
__device__ __forceinline__ uint4 load_span(const uint8_t* src, int n) {
  const int m = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const uint4* p = reinterpret_cast<const uint4*>(src - m);
  const uint4 a = __ldg(p);
  if (m == 0) return a;
  const uint4 b = m + n > 16 ? __ldg(p + 1) : make_uint4(0u, 0u, 0u, 0u);
  return shifted(a, b, m);
}

// Bytes 0..n-1 of lo, then bytes 0..15-n of hi (n in 1..15).
__device__ __forceinline__ uint4 merge(uint4 lo, uint4 hi, int n) {
  const uint4 up = shifted(make_uint4(0u, 0u, 0u, 0u), hi, 16 - n);  // hi moved up n bytes
  const uint32_t lw[4] = {lo.x, lo.y, lo.z, lo.w};
  const uint32_t uw[4] = {up.x, up.y, up.z, up.w};
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int keep = n - 4 * i;  // bytes of lo in this word
    const uint32_t mask = keep >= 4 ? 0xffffffffu : keep <= 0 ? 0u : (1u << (8 * keep)) - 1u;
    w[i] = (lw[i] & mask) | (uw[i] & ~mask);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int ES>
__global__ void __launch_bounds__(kThreads)
ragged_gather_kernel(const uint8_t* __restrict__ flat, int64_t flat_bytes,
                     const int32_t* __restrict__ starts, const int64_t* __restrict__ table,
                     int groups, int64_t chunks, uint4* __restrict__ out) {
  __shared__ int s_range[2];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunksPerBlock;
  const int64_t end = base + kChunksPerBlock < chunks ? base + kChunksPerBlock : chunks;
  if (threadIdx.x < 32) {
    const int lo = warp_find_group(table, groups, base);
    const int hi = warp_find_group(table, groups, end - 1);
    if (threadIdx.x == 0) {
      s_range[0] = lo;
      s_range[1] = hi;
    }
  }
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];

  // Phase 1: each chunk's group, row and byte offset, and the loads of its
  // row's start (and of the next row's, for a chunk that crosses a row end),
  // for all kDepth chunks before any of those loads is used.
  int64_t ob[kDepth];          // byte offset in its group's output; -1: past the block
  int64_t row[kDepth];
  const int64_t* tr[kDepth];  // its group's table row
  int32_t sv[kDepth], sn[kDepth];  // its row's start, the next row's (-1: none)
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const int64_t c = base + k * kThreads + threadIdx.x;
    ob[k] = -1;
    row[k] = 0;
    tr[k] = table;
    sv[k] = 0;
    sn[k] = -1;
    if (c >= end) continue;
    tr[k] = table + static_cast<int64_t>(lo == hi ? lo : find_group(table, lo, hi, c)) * kCols;
    ob[k] = (c - ld64(tr[k])) * 16;
    const int64_t row_bytes = ld64(tr[k] + 3);
    if (((ob[k] | row_bytes) >> 32) == 0) {
      row[k] = static_cast<uint32_t>(ob[k]) / static_cast<uint32_t>(row_bytes);
    } else {
      row[k] = ob[k] / row_bytes;
    }
    const int32_t* st = starts + ld64(tr[k] + 1);
    sv[k] = __ldg(st + row[k]);
    if (ES <= 2 && row_bytes >= 16 && ob[k] - row[k] * row_bytes + 16 > row_bytes &&
        row[k] + 1 < ld64(tr[k] + 2)) {
      sn[k] = __ldg(st + row[k] + 1);
    }
  }
  // Phase 2: the source loads of all kDepth chunks.
  uint4 a[kDepth], b[kDepth];
  int mis[kDepth];  // byte misalignment of a one-row chunk's source; 0: a holds the chunk
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    mis[k] = 0;
    a[k] = make_uint4(0u, 0u, 0u, 0u);
    b[k] = a[k];
    if (ob[k] < 0) continue;
    const int64_t row_bytes = ld64(tr[k] + 3);
    const int64_t col = ob[k] - row[k] * row_bytes;
    const int64_t s = static_cast<int64_t>(sv[k]) * ES;
    const bool in = s >= 0 && s + row_bytes <= flat_bytes;
    if (col + 16 <= row_bytes) {  // one row
      if (!in) continue;  // zeros
      const uint8_t* src = flat + s + col;
      const int m = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
      const uint4* p = reinterpret_cast<const uint4*>(src - m);
      a[k] = __ldg(p);
      if (m != 0) b[k] = __ldg(p + 1);
      mis[k] = m;
    } else if (ES <= 2 && row_bytes >= 16) {  // the end of row r, then the start of row r + 1
      const int n = static_cast<int>(row_bytes - col);
      const int64_t s2 = static_cast<int64_t>(sn[k]) * ES;
      const uint4 lo_part = in ? load_span(flat + s + col, n) : make_uint4(0u, 0u, 0u, 0u);
      const uint4 hi_part = sn[k] >= 0 && s2 + row_bytes <= flat_bytes
                                ? load_span(flat + s2, 16 - n)
                                : make_uint4(0u, 0u, 0u, 0u);
      a[k] = merge(lo_part, hi_part, n);
    } else {  // wider elements, or rows shorter than 16 bytes
      a[k] = tail_chunk<ES>(flat, flat_bytes, starts + ld64(tr[k] + 1), ld64(tr[k] + 2),
                            row_bytes / ES, ob[k] / ES);
    }
  }
  // Phase 3: the stores
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    if (ob[k] < 0) continue;
    out[base + k * kThreads + threadIdx.x] = mis[k] == 0 ? a[k] : shifted(a[k], b[k], mis[k]);
  }
}

template <int ES>
cudaError_t launch(const void* flat, int64_t flat_bytes, const int32_t* starts,
                   const int64_t* table, int groups, int64_t chunks, void* out,
                   cudaStream_t stream) {
  const int64_t blocks = (chunks + kChunksPerBlock - 1) / kChunksPerBlock;
  ragged_gather_kernel<ES><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(flat), flat_bytes, starts, table, groups, chunks,
      static_cast<uint4*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// flat: flat_bytes bytes of elements elem_size wide; starts: int32 element
// offsets of every group's rows; table: [groups, 4] int64 {chunk0, offset of
// the group's first start in starts, rows, row bytes}, chunk0 ascending from
// 0, every group with rows > 0; out: chunks * 16 bytes, 16-byte aligned.
int tft_ragged_gather(const void* flat, int64_t flat_bytes, const int32_t* starts,
                      const int64_t* table, int groups, int64_t chunks, int elem_size,
                      void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups < 0 || chunks < 0 || (groups == 0) != (chunks == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (chunks == 0) return static_cast<int>(cudaSuccess);
  if ((chunks + kChunksPerBlock - 1) / kChunksPerBlock > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1: err = launch<1>(flat, flat_bytes, starts, table, groups, chunks, out, s); break;
    case 2: err = launch<2>(flat, flat_bytes, starts, table, groups, chunks, out, s); break;
    case 4: err = launch<4>(flat, flat_bytes, starts, table, groups, chunks, out, s); break;
    case 8: err = launch<8>(flat, flat_bytes, starts, table, groups, chunks, out, s); break;
    case 16: err = launch<16>(flat, flat_bytes, starts, table, groups, chunks, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
