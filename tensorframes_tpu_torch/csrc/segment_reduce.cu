// Keyed segment reduction for Hopper (sm_90a): every (column, op) of an
// aggregate in one call, plus the single-op segment sum.
//
// Replaces the Pallas TPU kernels tensorframes_tpu/kernels/segment_reduce.py
// (segment_reduce_pallas) and tensorframes_tpu/ops/segment.py
// (segment_sum_pallas). The TPU kernels walk row tiles on a sequential grid
// and contract a [tile, segments] one-hot against the values on the MXU,
// carrying the partial table across grid steps. None of that carries over:
// blocks run in parallel here, and the one-hot product is an MXU trick.
//
// What bounds it on the H100: bytes. Each input byte is read once (ids, all
// value columns) and the [S, lanes] table written once; at 10M rows that is
// ~440 MB, ~131 us at 3.35 TB/s. The work per row is a handful of adds.
//
// Design (deterministic per feed: no float atomics anywhere). The rows are
// put in a stable order by segment with a counting sort, and each segment
// then folds its rows in that order:
//  1. seg_hist: per row chunk, a histogram of segment ids in shared memory
//     (integer atomics, so the counts are exact whatever the order).
//  2. seg_chunk_prefix: for every segment, the exclusive prefix of its
//     counts over the chunks, and its total.
//  3. seg_starts: the exclusive prefix of the totals — each segment's first
//     slot in the sorted order.
//  4. seg_scatter: one warp per chunk walks its rows in order, 32 at a time;
//     __match_any_sync ranks equal ids by lane, so every row lands at a
//     slot given by (segment start, earlier chunks, earlier rows): a stable
//     sort, the same permutation on every run.
//  5. seg_fold: one warp per segment folds its sorted rows — lane l takes
//     rows l, l+32, ... in order, then a fixed shuffle tree combines the
//     lanes. The count of a segment is its slot range.
//  Float sums accumulate in f32, integer sums in wrapping 32-bit integer
//  arithmetic (the TPU kernel's i32 accumulator), min/max exactly with the
//  dtype identities, and counts in i32. Every table entry is one 32-bit
//  word; the wrapper reinterprets lanes as f32 or i32 and applies the mean
//  division and final casts in PyTorch (as the TPU path does outside its
//  kernel). The fold gathers rows through the permutation, one 32-byte
//  sector per 4-byte value, which keeps this design above its byte bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxSegments = 4096;  // shared-memory histogram / counters
constexpr int kMaxCols = 16;
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kI32 = 2, kI16 = 3, kI8 = 4, kU8 = 5, kBool = 6 };
enum Op { kSum = 0, kMean = 1, kMin = 2, kMax = 3 };

struct Col {
  const void* vals;  // [n, d] row-major
  int dtype;
  int op;
  int d;
  int lane;  // first lane of this column in a table entry
};

struct Cols {
  Col c[kMaxCols];
  int ncols;
  int lanes;       // words per table entry
  int count_lane;  // -1 when no count is kept
};

__device__ __forceinline__ bool is_float(int dt) { return dt == kF32 || dt == kBF16; }

// One element as a 32-bit word: f32 bits for float columns, i32 otherwise.
__device__ __forceinline__ uint32_t load_word(const Col& c, int64_t i) {
  switch (c.dtype) {
    case kF32: return __float_as_uint(static_cast<const float*>(c.vals)[i]);
    case kBF16:
      return __float_as_uint(__bfloat162float(static_cast<const __nv_bfloat16*>(c.vals)[i]));
    case kI32: return static_cast<uint32_t>(static_cast<const int32_t*>(c.vals)[i]);
    case kI16: return static_cast<uint32_t>(static_cast<int32_t>(static_cast<const int16_t*>(c.vals)[i]));
    case kI8: return static_cast<uint32_t>(static_cast<int32_t>(static_cast<const int8_t*>(c.vals)[i]));
    case kU8: return static_cast<uint32_t>(static_cast<const uint8_t*>(c.vals)[i]);
    default: return static_cast<const uint8_t*>(c.vals)[i] != 0 ? 1u : 0u;  // bool
  }
}

__device__ __forceinline__ uint32_t identity(int dt, int op) {
  if (op == kSum || op == kMean) return 0u;  // 0.0f and 0 share their bits
  const bool mn = op == kMin;
  if (is_float(dt)) return __float_as_uint(mn ? INFINITY : -INFINITY);
  int32_t v;
  switch (dt) {
    case kI32: v = mn ? INT32_MAX : INT32_MIN; break;
    case kI16: v = mn ? 32767 : -32768; break;
    case kI8: v = mn ? 127 : -128; break;
    case kU8: v = mn ? 255 : 0; break;
    default: v = mn ? 1 : 0; break;  // bool
  }
  return static_cast<uint32_t>(v);
}

// acc (op) x, both 32-bit words of the column's accumulator type. Float
// min/max propagate NaN, like jnp.minimum / jnp.maximum.
__device__ __forceinline__ uint32_t combine(uint32_t acc, uint32_t x, int dt, int op) {
  if (is_float(dt)) {
    const float a = __uint_as_float(acc), b = __uint_as_float(x);
    if (op == kSum || op == kMean) return __float_as_uint(a + b);
    if (isnan(a)) return acc;
    if (isnan(b)) return x;
    if (op == kMin) return b < a ? x : acc;
    return b > a ? x : acc;
  }
  if (op == kSum || op == kMean) return acc + x;  // wraps mod 2^32, no UB
  const int32_t a = static_cast<int32_t>(acc), b = static_cast<int32_t>(x);
  if (op == kMin) return b < a ? x : acc;
  return b > a ? x : acc;
}

__device__ __forceinline__ int64_t chunk_lo(int64_t n, int num_chunks, int c) {
  return n * c / num_chunks;
}

// 1. counts[c * S + s] = rows of chunk c with segment s
__global__ void __launch_bounds__(256)
seg_hist(const int32_t* __restrict__ ids, int64_t n, int num_segments, int num_chunks,
         int32_t* __restrict__ counts) {
  __shared__ int32_t hist[kMaxSegments];
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x) hist[s] = 0;
  __syncthreads();
  const int64_t lo = chunk_lo(n, num_chunks, blockIdx.x);
  const int64_t hi = chunk_lo(n, num_chunks, blockIdx.x + 1);
  for (int64_t r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const int s = ids[r];
    if (static_cast<unsigned>(s) < static_cast<unsigned>(num_segments)) atomicAdd(&hist[s], 1);
  }
  __syncthreads();
  int32_t* out = counts + static_cast<int64_t>(blockIdx.x) * num_segments;
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x) out[s] = hist[s];
}

// 2. counts -> exclusive prefix over chunks (in place), totals[s] = sum.
// Block (32, 32): x picks one of 32 segments, y one of 32 chunk groups.
__global__ void __launch_bounds__(1024)
seg_chunk_prefix(int32_t* __restrict__ counts, int num_segments, int num_chunks,
                 int32_t* __restrict__ totals) {
  __shared__ int32_t group_sum[32][33];
  const int s = blockIdx.x * 32 + threadIdx.x;
  const int g = threadIdx.y;
  const int c0 = static_cast<int>(static_cast<int64_t>(num_chunks) * g / 32);
  const int c1 = static_cast<int>(static_cast<int64_t>(num_chunks) * (g + 1) / 32);
  int32_t sum = 0;
  if (s < num_segments)
    for (int c = c0; c < c1; ++c) sum += counts[static_cast<int64_t>(c) * num_segments + s];
  group_sum[g][threadIdx.x] = sum;
  __syncthreads();
  if (s >= num_segments) return;
  int32_t run = 0;
  for (int h = 0; h < g; ++h) run += group_sum[h][threadIdx.x];
  for (int c = c0; c < c1; ++c) {
    const int64_t i = static_cast<int64_t>(c) * num_segments + s;
    const int32_t t = counts[i];
    counts[i] = run;
    run += t;
  }
  if (g == 31) totals[s] = run;
}

// 3. starts[s] = exclusive prefix of totals; starts[S] = rows kept.
// One block of 1024 threads, each owning up to four consecutive segments.
__global__ void __launch_bounds__(1024)
seg_starts(const int32_t* __restrict__ totals, int num_segments, int32_t* __restrict__ starts) {
  __shared__ int32_t warp_sum[32];
  const int per = (num_segments + 1023) / 1024;
  const int base = threadIdx.x * per;
  int32_t local = 0;
  for (int i = 0; i < per; ++i)
    if (base + i < num_segments) local += totals[base + i];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int32_t x = local;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int32_t w = warp_sum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int32_t run = x - local + (wid > 0 ? warp_sum[wid - 1] : 0);
  for (int i = 0; i < per; ++i) {
    if (base + i < num_segments) {
      starts[base + i] = run;
      run += totals[base + i];
    }
  }
  if (threadIdx.x == 1023) starts[num_segments] = warp_sum[31];
}

// 4. perm[slot] = row, stable by segment. One warp per chunk.
__global__ void __launch_bounds__(32)
seg_scatter(const int32_t* __restrict__ ids, int64_t n, int num_segments, int num_chunks,
            const int32_t* __restrict__ chunk_prefix, const int32_t* __restrict__ starts,
            int32_t* __restrict__ perm) {
  __shared__ int32_t next[kMaxSegments];
  const int lane = threadIdx.x;
  const int32_t* pre = chunk_prefix + static_cast<int64_t>(blockIdx.x) * num_segments;
  for (int s = lane; s < num_segments; s += 32) next[s] = starts[s] + pre[s];
  __syncwarp();
  const int64_t lo = chunk_lo(n, num_chunks, blockIdx.x);
  const int64_t hi = chunk_lo(n, num_chunks, blockIdx.x + 1);
  const unsigned below = (1u << lane) - 1u;
  int s_next = lo + lane < hi ? ids[lo + lane] : -1;
  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t r = base + lane;
    const int s = s_next;
    s_next = r + 32 < hi ? ids[r + 32] : -1;  // the next 32 ids load while these scatter
    const bool keep = static_cast<unsigned>(s) < static_cast<unsigned>(num_segments);
    const unsigned kept = __ballot_sync(kFull, keep);
    const unsigned peers = __match_any_sync(kFull, keep ? s : -1) & kept;
    int32_t slot = 0;
    if (keep) slot = next[s] + __popc(peers & below);
    __syncwarp();
    if (keep) {
      perm[slot] = static_cast<int32_t>(r);
      if ((peers & below) == 0) next[s] += __popc(peers);  // the group's lowest lane
    }
    __syncwarp();
  }
}

// 5. out[s, lane] = fold of segment s's rows in sorted order. One warp per
// segment; lane l folds rows l, l+32, ... in order, up to kFoldLanes lanes
// of a column per pass so that one row's values come in one sector, then a
// fixed shuffle tree combines the 32 lane partials.
constexpr int kFoldLanes = 8;

__global__ void __launch_bounds__(256)
seg_fold(const int32_t* __restrict__ perm, const int32_t* __restrict__ starts, int num_segments,
         Cols cols, uint32_t* __restrict__ out) {
  const int s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= num_segments) return;  // whole warps leave together
  const int32_t b = starts[s], e = starts[s + 1];
  uint32_t* o = out + static_cast<int64_t>(s) * cols.lanes;
  for (int k = 0; k < cols.ncols; ++k) {
    const Col c = cols.c[k];
    for (int j0 = 0; j0 < c.d; j0 += kFoldLanes) {
      const int jn = c.d - j0 < kFoldLanes ? c.d - j0 : kFoldLanes;
      uint32_t acc[kFoldLanes];
#pragma unroll
      for (int jj = 0; jj < kFoldLanes; ++jj) acc[jj] = identity(c.dtype, c.op);
      int32_t i = b + lane;
      for (; i + 32 < e; i += 64) {  // two rows' gathers in flight
        const int64_t r0 = static_cast<int64_t>(perm[i]) * c.d + j0;
        const int64_t r1 = static_cast<int64_t>(perm[i + 32]) * c.d + j0;
        uint32_t x0[kFoldLanes], x1[kFoldLanes];
#pragma unroll
        for (int jj = 0; jj < kFoldLanes; ++jj) {
          if (jj < jn) {
            x0[jj] = load_word(c, r0 + jj);
            x1[jj] = load_word(c, r1 + jj);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kFoldLanes; ++jj) {
          if (jj < jn) {
            acc[jj] = combine(acc[jj], x0[jj], c.dtype, c.op);
            acc[jj] = combine(acc[jj], x1[jj], c.dtype, c.op);
          }
        }
      }
      if (i < e) {
        const int64_t r0 = static_cast<int64_t>(perm[i]) * c.d + j0;
#pragma unroll
        for (int jj = 0; jj < kFoldLanes; ++jj)
          if (jj < jn) acc[jj] = combine(acc[jj], load_word(c, r0 + jj), c.dtype, c.op);
      }
#pragma unroll
      for (int jj = 0; jj < kFoldLanes; ++jj) {
        for (int off = 16; off > 0; off >>= 1)
          acc[jj] = combine(acc[jj], __shfl_down_sync(kFull, acc[jj], off), c.dtype, c.op);
        if (lane == 0 && jj < jn) o[c.lane + j0 + jj] = acc[jj];
      }
    }
  }
  if (cols.count_lane >= 0 && lane == 0) o[cols.count_lane] = static_cast<uint32_t>(e - b);
}

// scratch: num_chunks * S (chunk counts) + S (totals) + S + 1 (starts) + n (perm)
cudaError_t launch(const int32_t* ids, int64_t n, int num_segments, const Cols& cols,
                   int num_chunks, int32_t* scratch, uint32_t* out, int device,
                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (num_chunks < 1 || num_segments < 1 || num_segments > kMaxSegments || cols.ncols < 1 ||
      cols.ncols > kMaxCols || n < 0 || n > INT32_MAX)
    return cudaErrorInvalidValue;
  int32_t* counts = scratch;
  int32_t* totals = counts + static_cast<int64_t>(num_chunks) * num_segments;
  int32_t* starts = totals + num_segments;
  int32_t* perm = starts + num_segments + 1;
  seg_hist<<<num_chunks, 256, 0, stream>>>(ids, n, num_segments, num_chunks, counts);
  seg_chunk_prefix<<<(num_segments + 31) / 32, dim3(32, 32), 0, stream>>>(
      counts, num_segments, num_chunks, totals);
  seg_starts<<<1, 1024, 0, stream>>>(totals, num_segments, starts);
  seg_scatter<<<num_chunks, 32, 0, stream>>>(ids, n, num_segments, num_chunks, counts, starts,
                                              perm);
  const int64_t threads = static_cast<int64_t>(num_segments) * 32;
  seg_fold<<<static_cast<int>((threads + 255) / 256), 256, 0, stream>>>(perm, starts,
                                                                        num_segments, cols, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All (column, op) pairs of one keyed aggregate. vals/dtypes/ops/ds are
// host arrays of ncols entries; scratch holds num_chunks * S + 2 * S + 1 + n
// int32; out is [S, lanes] 32-bit words, lanes = sum(ds) + (need_counts ? 1 : 0).
int tft_segment_reduce(const int32_t* ids, int64_t n, int num_segments, int ncols,
                       const void* const* vals, const int* dtypes, const int* ops, const int* ds,
                       int need_counts, int num_chunks, int32_t* scratch, uint32_t* out,
                       int device, void* stream) {
  if (ncols < 1 || ncols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  Cols cols{};
  int lane = 0;
  for (int k = 0; k < ncols; ++k) {
    cols.c[k] = Col{vals[k], dtypes[k], ops[k], ds[k], lane};
    lane += ds[k];
  }
  cols.ncols = ncols;
  cols.count_lane = need_counts ? lane : -1;
  cols.lanes = lane + (need_counts ? 1 : 0);
  return static_cast<int>(launch(ids, n, num_segments, cols, num_chunks, scratch, out, device,
                                 static_cast<cudaStream_t>(stream)));
}

// Single-op segment sum: f32/bf16 values [n, d] -> f32 [S, d].
int tft_segment_sum(const int32_t* ids, int64_t n, int num_segments, const void* vals, int dtype,
                    int d, int num_chunks, int32_t* scratch, float* out, int device,
                    void* stream) {
  if (dtype != kF32 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  Cols cols{};
  cols.c[0] = Col{vals, dtype, kSum, d, 0};
  cols.ncols = 1;
  cols.count_lane = -1;
  cols.lanes = d;
  return static_cast<int>(launch(ids, n, num_segments, cols, num_chunks, scratch,
                                 reinterpret_cast<uint32_t*>(out), device,
                                 static_cast<cudaStream_t>(stream)));
}

const char* tft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
