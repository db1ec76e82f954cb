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
// Design: one coalesced pass over the rows, no sort, no gather through a
// permutation, no float atomics, two launches.
//  1. seg_fold. The rows are cut into C chunks whose bounds depend on n and
//     C alone (multiples of 16 rows, chunk_lo); the wrapper picks C from
//     (n, S, lanes). The table's lanes (one 32-bit word per column element)
//     are cut into groups of one load class (4-, 2- or 1-byte elements)
//     whose [S, lanes] table fits in 128 KB of shared memory; a column wider
//     than a group runs in slices. A work item is (chunk, group); persistent
//     blocks of 16 warps loop over the items, one group after another. A
//     block streams its chunk in tiles of up to 1,024 rows (as many as its
//     shared memory holds): thread 0 keeps the ids and the group's
//     columns of the next tiles in flight as bulk copies (cp.async.bulk) into
//     a 2-stage ring, one mbarrier per stage; every read of device memory is
//     one of these sequential copies. Per tile:
//     a. each segment's rows in the tile are counted in shared memory
//        (integer atomics: the counts do not depend on their order);
//     b. a row that is its segment's only row in the tile is folded into
//        the table at once by its own thread (a whole row per thread);
//     c. the other rows are listed in row order, and warp w takes those
//        whose segment s has s % 16 == w, in row order. It folds them 32 at
//        a time: a batch of one segment folds into an accumulator that stays
//        in registers across batches (a thread per table lane); otherwise
//        rows of one segment find each other (a bit per row OR-ed into the
//        segment's word: the same word in any order) and the first of them
//        folds its segment's rows, in row order, itself or with a slot of
//        threads, one per lane. A group whose lanes fold alike folds with
//        that fold compiled in; a mixed group picks each lane's by selects.
//     A segment is folded by one thread or one warp at a time, and a tile's
//     rows of a segment by exactly one of b or c, so no table word is ever
//     written by two threads at once. Group 0 also counts each segment's
//     rows (the count of means). The table goes to the
//     chunk's partial ([C, S, lanes] words; the output itself when C == 1).
//  2. seg_merge. One thread per output word folds the C partials in chunk
//     order.
//  The order of every float sum: within a chunk, each segment's rows are
//  added one by one in row order to an f32 accumulator that starts at 0;
//  the chunks' partials are then added in chunk order, starting from chunk
//  0's. It depends on (n, C) only — not on the card, its SM count, the
//  tiles, the groups, or which block ran which item — so a relaunch gives
//  the same bits on any card, and a CPU loop over chunks of index_add_
//  (which adds in index order) reproduces it bit for bit
//  (kernels/segment_reduce.py::segment_sum_in_kernel_order).
//  Float sums accumulate in f32, integer sums in wrapping 32-bit integer
//  arithmetic (the TPU kernel's i32 accumulator), min/max exactly with the
//  dtype identities, and counts in i32. Every table entry is one 32-bit
//  word; the wrapper reinterprets lanes as f32 or i32 and applies the mean
//  division and final casts in PyTorch (as the TPU path does outside its
//  kernel). Columns whose base is off a 16-byte boundary, sliced columns
//  and the feed's last tile when n is not a multiple of 16 are read by
//  threads from device memory instead, in the same order.
//  What holds it back (per-warp clock64 phases on the H100, segment_sum at
//  10M x 8 over 4,096 groups): no phase dominates — folding the single rows
//  (their 128-bit table accesses meet in shared-memory banks) ~30%, each
//  warp's walk over the listed rows and its ordered fold ~15% each, the four
//  block barriers of a tile ~15%, the counting ~8%. With one hot segment,
//  the one warp that owns it folds half the rows in order while the others
//  wait at the barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int kMaxSegments = 4096;
constexpr int kMaxCols = 16;
constexpr int kWarps = 16;  // owners of the segments, s % kWarps
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;
constexpr int kMaxTile = 1024;              // rows per tile: 32 windows of 32
constexpr int kRows = kMaxTile / kThreads;  // rows of a tile per thread
constexpr int kTableWords = 32768;          // a group's [S, lanes] table, at most 128 KB
constexpr int kMaxGroupLanes = 32;          // one per thread of a slot
constexpr int kRingCap = 96 * 1024;  // bytes of staging (and row lists) a launch asks for, at most
constexpr int kSmemMax = 232448;     // what one block may use on the H100 (227 KB)
constexpr int kUnroll = 8;           // rows folded per step: their loads in flight together
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kI32 = 2, kI16 = 3, kI8 = 4, kU8 = 5, kBool = 6 };
enum Op { kSum = 0, kMean = 1, kMin = 2, kMax = 3 };
// how a lane reads an element, and how it folds it in (kCbAny: each lane's own)
enum Ld { kLdW32 = 0, kLdBF16, kLdI16, kLdI8, kLdU8, kLdBool };
enum Cb { kCbFSum = 0, kCbFMin, kCbFMax, kCbISum, kCbIMin, kCbIMax, kCbAny, kCbSums };

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

// lanes [j0, j0 + jn) of column col
struct Piece {
  int col, j0, jn;
};

struct Group {
  Piece p[kMaxCols];
  int np;      // pieces
  int lanes;   // table lanes, the pieces' in order
  int sliced;  // one slice of a column wider than a group
};

__host__ __device__ __forceinline__ int esize(int dt) {
  return (dt == kF32 || dt == kI32) ? 4 : (dt == kBF16 || dt == kI16) ? 2 : 1;
}

__host__ __device__ __forceinline__ bool is_float(int dt) { return dt == kF32 || dt == kBF16; }

__host__ __device__ __forceinline__ int ld_of(int dt) {
  return (dt == kF32 || dt == kI32) ? kLdW32 : dt == kBF16 ? kLdBF16 : dt == kI16 ? kLdI16
         : dt == kI8 ? kLdI8 : dt == kU8 ? kLdU8 : kLdBool;
}

__host__ __device__ __forceinline__ int cb_of(int dt, int op) {
  return (is_float(dt) ? kCbFSum : kCbISum) + (op == kMin ? 1 : op == kMax ? 2 : 0);
}

__host__ __device__ __forceinline__ int group_lanes_max(int S) {
  const int l = kTableWords / S;
  return l < 1 ? 1 : (l > kMaxGroupLanes ? kMaxGroupLanes : l);
}

// Group `want` of the lane partition, or (want < 0) the number of groups.
// Columns narrower than a group are packed first-fit in column order with
// the columns whose elements they read alike (one load class per group); a
// wider column is cut into slices of a group's width. The count of means is
// no lane of any group: group 0 counts the rows.
__host__ __device__ int group_at(const Cols& cols, int S, int want, Group* out) {
  const int lmax = group_lanes_max(S);
  unsigned done = 0;
  int g = 0;
  for (int k = 0; k < cols.ncols; ++k) {
    if (done & (1u << k)) continue;
    done |= 1u << k;
    const int d = cols.c[k].d;
    if (d > lmax) {
      const int slices = (d + lmax - 1) / lmax;
      if (want >= g && want < g + slices) {
        const int j0 = (want - g) * lmax;
        out->p[0] = Piece{k, j0, d - j0 < lmax ? d - j0 : lmax};
        out->np = 1;
        out->lanes = out->p[0].jn;
        out->sliced = 1;
        return want;
      }
      g += slices;
      continue;
    }
    int lanes = d;
    if (want == g) {
      out->p[0] = Piece{k, 0, d};
      out->np = 1;
      out->sliced = 0;
    }
    for (int k2 = k + 1; k2 < cols.ncols; ++k2) {
      const int d2 = cols.c[k2].d;
      if ((done & (1u << k2)) || d2 > lmax || lanes + d2 > lmax ||
          ld_of(cols.c[k2].dtype) != ld_of(cols.c[k].dtype))
        continue;
      done |= 1u << k2;
      if (want == g) out->p[out->np++] = Piece{k2, 0, d2};
      lanes += d2;
    }
    if (want == g) {
      out->lanes = lanes;
      return want;
    }
    ++g;
  }
  return g;
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

// 32-bit word of one element: f32 bits for float columns (bf16 widened
// exactly), i32 otherwise
template <int LD>
__device__ __forceinline__ uint32_t ld(const unsigned char* p) {
  if (LD == kLdW32) return *reinterpret_cast<const uint32_t*>(p);
  if (LD == kLdBF16) return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16;
  if (LD == kLdI16) return static_cast<uint32_t>(static_cast<int32_t>(*reinterpret_cast<const int16_t*>(p)));
  if (LD == kLdI8) return static_cast<uint32_t>(static_cast<int32_t>(*reinterpret_cast<const int8_t*>(p)));
  if (LD == kLdU8) return *p;
  return *p != 0 ? 1u : 0u;  // bool
}

// acc (op) x, both 32-bit words of the lane's accumulator type. Float
// min/max propagate NaN, like jnp.minimum / jnp.maximum. kCbAny: the lane's
// own code, chosen by selects (no branch); kCbSums: the same among sums.
template <int CB>
__device__ __forceinline__ uint32_t cb(uint32_t acc, uint32_t x, int code) {
  if (CB == kCbFSum) return __float_as_uint(__uint_as_float(acc) + __uint_as_float(x));
  if (CB == kCbISum) return acc + x;  // wraps mod 2^32, no UB
  if (CB == kCbSums)
    return code == kCbFSum ? __float_as_uint(__uint_as_float(acc) + __uint_as_float(x)) : acc + x;
  const float a = __uint_as_float(acc), b = __uint_as_float(x);
  const int32_t ia = static_cast<int32_t>(acc), ib = static_cast<int32_t>(x);
  if (CB == kCbFMin || CB == kCbFMax) {
    const bool take = CB == kCbFMin ? b < a : b > a;
    return isnan(a) ? acc : (isnan(b) || take) ? x : acc;
  }
  if (CB == kCbIMin) return ib < ia ? x : acc;
  if (CB == kCbIMax) return ib > ia ? x : acc;
  const bool fl = code < kCbISum;
  const int op = fl ? code : code - kCbISum;  // 0 sum, 1 min, 2 max
  const uint32_t sum = fl ? __float_as_uint(a + b) : acc + x;
  const bool take = op == 1 ? (fl ? b < a : ib < ia) : (fl ? b > a : ib > ia);
  const uint32_t pick = (fl && isnan(a)) ? acc : ((fl && isnan(b)) || take) ? x : acc;
  return op == 0 ? sum : pick;
}

// acc folded with the rows of the peers in pm, in row order (lst: the
// batch's rows; base + row * stride: a row's element of this lane)
template <int LD, int CB>
__device__ __forceinline__ uint32_t fold_peers(uint32_t acc, int code, unsigned pm,
                                               const uint16_t* lst, const unsigned char* base,
                                               int64_t stride) {
  while (pm) {
    int r[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = pm != 0;
      r[u] = lst[ok[u] ? __ffs(pm) - 1 : 0];  // entry 0 is a row of the batch: a safe read
      pm &= pm - 1u;
    }
    uint32_t x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = ld<LD>(base + r[u] * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (ok[u]) acc = cb<CB>(acc, x[u], code);
  }
  return acc;
}

// acc folded with rows lst[0], ..., lst[n - 1], in that order (n <= 32),
// 16 rows' elements loaded before the first of them is folded in
template <int LD, int CB>
__device__ __forceinline__ uint32_t fold_run(uint32_t acc, int code, int n, const uint16_t* lst,
                                             const unsigned char* base, int64_t stride) {
  const int st = static_cast<int>(stride);
  for (int p0 = 0; p0 < n; p0 += 16) {
    uint32_t x[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) x[u] = ld<LD>(base + lst[p0 + u < n ? p0 + u : 0] * st);
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (p0 + u < n) acc = cb<CB>(acc, x[u], code);
  }
  return acc;
}

// V words of table row a combined with V words of a staged row x
template <int CB, int V>
__device__ __forceinline__ void fold_vec(uint32_t* a, const unsigned char* x, int code) {
  uint32_t t[V], y[V];
  if (V == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(a), w = *reinterpret_cast<const uint4*>(x);
    t[0] = u.x, t[1] = u.y, t[2] = u.z, t[3] = u.w;
    y[0] = w.x, y[1] = w.y, y[2] = w.z, y[3] = w.w;
  } else if (V == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(a), w = *reinterpret_cast<const uint2*>(x);
    t[0] = u.x, t[1] = u.y;
    y[0] = w.x, y[1] = w.y;
  } else {
    t[0] = *a;
    y[0] = *reinterpret_cast<const uint32_t*>(x);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) t[v] = cb<CB>(t[v], y[v], code);
  if (V == 4) *reinterpret_cast<uint4*>(a) = make_uint4(t[0], t[1], t[2], t[3]);
  else if (V == 2) *reinterpret_cast<uint2*>(a) = make_uint2(t[0], t[1]);
  else *a = t[0];
}

// f(ld, cb) with the group's (ld, cb) as compile-time constants; uncommon
// classes fold with kCbAny
template <class F>
__device__ __forceinline__ void with_kind(int ldc, int cbc, F&& f) {
  using std::integral_constant;
  switch (ldc) {
    case kLdW32:
      if (cbc == kCbFSum) f(integral_constant<int, kLdW32>{}, integral_constant<int, kCbFSum>{});
      else if (cbc == kCbFMax) f(integral_constant<int, kLdW32>{}, integral_constant<int, kCbFMax>{});
      else if (cbc == kCbSums) f(integral_constant<int, kLdW32>{}, integral_constant<int, kCbSums>{});
      else f(integral_constant<int, kLdW32>{}, integral_constant<int, kCbAny>{});
      break;
    case kLdBF16:
      if (cbc == kCbFSum) f(integral_constant<int, kLdBF16>{}, integral_constant<int, kCbFSum>{});
      else f(integral_constant<int, kLdBF16>{}, integral_constant<int, kCbAny>{});
      break;
    case kLdI16: f(integral_constant<int, kLdI16>{}, integral_constant<int, kCbAny>{}); break;
    case kLdI8: f(integral_constant<int, kLdI8>{}, integral_constant<int, kCbAny>{}); break;
    case kLdU8: f(integral_constant<int, kLdU8>{}, integral_constant<int, kCbAny>{}); break;
    default: f(integral_constant<int, kLdBool>{}, integral_constant<int, kCbAny>{}); break;
  }
}

// first row of chunk c of C: a multiple of 16, a function of (n, C) alone
__host__ __device__ __forceinline__ int64_t chunk_lo(int64_t n, int C, int c) {
  const int64_t lo = 16 * (((n + 15) / 16) * c / C);
  return lo < n ? lo : n;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// fold code of output lane l (the count lane: an integer sum)
__device__ __forceinline__ int lane_cb(const Cols& cols, int l) {
  int code = kCbISum;
  for (int k = 0; k < cols.ncols; ++k)
    if (l >= cols.c[k].lane && l < cols.c[k].lane + cols.c[k].d) code = cb_of(cols.c[k].dtype, cols.c[k].op);
  return code;
}

// where a table lane finds its element of a row
struct LaneSrc {
  const unsigned char* col;  // the column in device memory
  int64_t stride;            // bytes per row
  int jes;                   // byte offset of the element within the row
  int soff;                  // byte offset of the column within a stage
  int code;                  // how it folds (Cb)
};

struct Meta {
  uint64_t bar[kStages];           // one per stage: the tile's bulk copies landed
  Group grp;                       // the item's lane group
  LaneSrc src[kMaxGroupLanes];     // per table lane
  int lane_out[kMaxGroupLanes];    // output lane of each table lane
  uint32_t ident[kMaxGroupLanes];  // and its identity
  int lead[kWarps][32];            // a batch's leaders in lane order, per warp
  int wcnt[32];                    // marked rows per 32-row window of a tile
  int cb_all;                      // the lanes' common Cb, or kCbSums (all sums), or kCbAny
};
constexpr int kMetaBytes = (static_cast<int>(sizeof(Meta)) + 127) / 128 * 128;

__global__ void __launch_bounds__(kThreads, 1)
seg_fold(const int32_t* __restrict__ ids, int64_t n, int S, Cols cols, int C, int G,
         int smem_bytes, uint32_t* __restrict__ dest) {
  extern __shared__ __align__(128) unsigned char smem[];
  Meta& M = *reinterpret_cast<Meta*>(smem);
  // rows of each segment in the current tile, which then serve the ordered
  // path as a word of peer bits per segment (0 between tiles); then the
  // item's table (and the counting item's rows of each segment in the chunk)
  int* cnt = reinterpret_cast<int*>(smem + kMetaBytes);
  uint32_t* peer_bits = reinterpret_cast<uint32_t*>(cnt);
  const int counts_bytes = (4 * S + 127) / 128 * 128;
  uint32_t* table = reinterpret_cast<uint32_t*>(smem + kMetaBytes + counts_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  if (tid < kStages) mbar_init(smem_addr(&M.bar[tid]));
  for (int i = tid; i < S; i += kThreads) cnt[i] = 0;
  __syncthreads();
  uint32_t seq = 0;  // staged tiles this block has consumed: stage seq % kStages

  // item = g * C + c: a block's items come from different groups, so the
  // groups' unequal costs even out over the blocks
  for (int item = blockIdx.x; item < C * G; item += gridDim.x) {
    const int c = item % C, g = item / C;
    const bool counting = g == 0 && cols.count_lane >= 0;  // this item counts the rows
    if (tid == 0) group_at(cols, S, g, &M.grp);
    __syncthreads();
    const Group& grp = M.grp;
    const int Lg = grp.lanes;
    const int ldc = ld_of(cols.c[grp.p[0].col].dtype);
    // staged through the ring when every column is whole and 16-byte aligned
    bool staged = !grp.sliced && aligned16(ids);
    int rb = 4;  // staged bytes per row
    for (int i = 0; i < grp.np; ++i) {
      const Piece p = grp.p[i];
      staged = staged && aligned16(cols.c[p.col].vals);
      rb += p.jn * esize(cols.c[p.col].dtype);
    }
    // one whole column of 4-byte elements: rows fold as vectors into a
    // segment-major table; otherwise the table is lane-major
    const bool vec = grp.np == 1 && !grp.sliced && ldc == kLdW32;
    const int ts = vec ? Lg : 1, tl = vec ? 1 : S;  // word (s, l) of the table: s * ts + l * tl
    const int table_bytes = (S * Lg * 4 + 127) / 128 * 128 + (counting ? (4 * S + 127) / 128 * 128 : 0);
    int* rows_of = reinterpret_cast<int*>(table + S * Lg);  // the counting item's
    const int room = smem_bytes - kMetaBytes - counts_bytes - table_bytes;  // ring and lists
    int R = room / (kStages * rb + (kWarps + 1) * 2);
    R = (R > kMaxTile ? kMaxTile : R) & ~31;
    if (R < 32 || !staged) {  // read device memory; all the room for the lists
      staged = false;
      R = room / ((kWarps + 1) * 2);
      R = (R > kMaxTile ? kMaxTile : R) & ~31;
    }
    unsigned char* ring = reinterpret_cast<unsigned char*>(table) + table_bytes;
    const int stage_bytes = staged ? R * rb : 0;
    uint16_t* marked = reinterpret_cast<uint16_t*>(ring + kStages * stage_bytes);  // [R]
    uint16_t* list = marked + R + warp * R;  // this warp's [R]

    if (tid < Lg) {  // table lane tid: where it reads, how it folds, where it goes
      int start = 0, soff = R * 4;
      for (int i = 0; i < grp.np; ++i) {
        const Piece p = grp.p[i];
        const Col& cc = cols.c[p.col];
        const int es = esize(cc.dtype);
        if (tid >= start && tid < start + p.jn) {
          const int j = p.j0 + tid - start;
          M.src[tid] = LaneSrc{static_cast<const unsigned char*>(cc.vals),
                               static_cast<int64_t>(cc.d) * es, j * es, soff + j * es,
                               cb_of(cc.dtype, cc.op)};
          M.lane_out[tid] = cc.lane + j;
          M.ident[tid] = identity(cc.dtype, cc.op);
        }
        soff += R * p.jn * es;
        start += p.jn;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int all = M.src[0].code;
      bool sums = true;
      for (int l = 0; l < Lg; ++l) {
        sums = sums && (M.src[l].code == kCbFSum || M.src[l].code == kCbISum);
        if (M.src[l].code != all) all = kCbAny;
      }
      M.cb_all = all == kCbAny && sums ? kCbSums : all;
    }
    for (int i = tid; i < S * Lg; i += kThreads) table[i] = M.ident[vec ? i % Lg : i / S];
    if (counting)
      for (int i = tid; i < S; i += kThreads) rows_of[i] = 0;
    __syncthreads();
    // this thread's lane when a segment's rows are folded lanes across threads:
    // slot `slot` of Tl threads, lane q
    int Tl = 1;
    while (Tl < Lg) Tl <<= 1;
    const int Tr = 32 / Tl, slot = lane / Tl, q = lane % Tl;
    const LaneSrc mine = M.src[q < Lg ? q : 0];

    const int64_t lo = chunk_lo(n, C, c), hi = chunk_lo(n, C, c + 1);
    const int nt = static_cast<int>((hi - lo + R - 1) / R);
    const int64_t last_rows = hi - lo - static_cast<int64_t>(nt - 1) * R;
    const int ns = staged ? nt - ((nt > 0 && (last_rows & 15)) ? 1 : 0) : 0;  // staged tiles

    // the copies of tile t into stage st, counted on its barrier
    auto issue = [&](int t, int st) {
      const int64_t t0 = lo + static_cast<int64_t>(t) * R;
      const int rows = static_cast<int>(hi - t0 < R ? hi - t0 : R);
      unsigned char* dst = ring + st * stage_bytes;
      const uint32_t bar = smem_addr(&M.bar[st]);
      mbar_expect_tx(bar, rows * rb);
      bulk_copy(smem_addr(dst), ids + t0, rows * 4, bar);
      int off = R * 4;
      for (int i = 0; i < grp.np; ++i) {
        const Col& cc = cols.c[grp.p[i].col];
        const int w = cc.d * esize(cc.dtype);
        bulk_copy(smem_addr(dst + off), static_cast<const unsigned char*>(cc.vals) + t0 * w,
                  rows * w, bar);
        off += R * w;
      }
    };
    if (tid == 0)
      for (int t = 0; t < ns && t < kStages; ++t) issue(t, (seq + t) % kStages);

    // One tile. SH: read from its stage (pointers into `smem`, so the loads
    // are shared-memory loads) and fold as the group's (LD, CB); else read
    // from device memory, each lane folding by its own code.
    auto run_tile = [&](auto sh, auto ldk, auto cbk, int64_t t0, int rows, int st) {
      constexpr bool SH = decltype(sh)::value;
      constexpr int LD = decltype(ldk)::value, CB = decltype(cbk)::value;
      const unsigned char* tile = SH ? smem + static_cast<int>(ring - smem) + st * stage_bytes
                                     : static_cast<const unsigned char*>(nullptr);
      const int32_t* idt = SH ? reinterpret_cast<const int32_t*>(tile) : ids + t0;
      auto elem0 = [&](const LaneSrc& ls) -> const unsigned char* {  // the lane's element of row 0
        return SH ? tile + ls.soff : ls.col + t0 * ls.stride + ls.jes;
      };
      // every table lane of a segment folded with row r
      auto fold_row = [&](int seg, int r) {
        if (SH && vec) {
          const unsigned char* b = tile + M.src[0].soff + r * M.src[0].stride;
          uint32_t* tw = table + seg * Lg;
          const int code = M.src[0].code;
          if (Lg % 4 == 0) for (int l = 0; l < Lg; l += 4) fold_vec<CB, 4>(tw + l, b + 4 * l, code);
          else if (Lg % 2 == 0) for (int l = 0; l < Lg; l += 2) fold_vec<CB, 2>(tw + l, b + 4 * l, code);
          else for (int l = 0; l < Lg; ++l) fold_vec<CB, 1>(tw + l, b + 4 * l, code);
          return;
        }
        for (int l = 0; l < Lg; ++l) {
          const LaneSrc& ls = M.src[l];
          uint32_t* tw = table + seg * ts + l * tl;
          *tw = cb<CB>(*tw, ld<LD>(elem0(ls) + r * ls.stride), ls.code);
        }
      };
      const unsigned char* mb = elem0(mine);

      // 1. count each segment's rows (thread tid takes rows tid + k * kThreads)
      int sr[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = tid + k * kThreads;
        sr[k] = r < rows ? idt[r] : -1;
        if (static_cast<unsigned>(sr[k]) >= static_cast<unsigned>(S)) sr[k] = -1;
        if (sr[k] >= 0) atomicAdd(&cnt[sr[k]], 1);
      }
      __syncthreads();
      // 2. a row alone in its segment in this tile folds at once; the others
      // are marked, and each window counts its marked rows
      const int nwin = (rows + 31) / 32;
      unsigned mk[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int c1 = sr[k] >= 0 ? cnt[sr[k]] : 0;
        if (c1 == 1) fold_row(sr[k], tid + k * kThreads);
        if (counting && c1 == 1) rows_of[sr[k]] += 1;  // no other row of it in the tile
        if (counting && c1 > 1) atomicAdd(&rows_of[sr[k]], 1);
        mk[k] = __ballot_sync(kFull, c1 > 1);
        if (lane == 0) M.wcnt[warp + k * kWarps] = __popc(mk[k]);
      }
      __syncthreads();
      // 3. the marked rows, in row order
      const int wc = lane < nwin ? M.wcnt[lane] : 0;
      int wat = wc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, wat, o);
        if (lane >= o) wat += y;
      }
      const int nm = __shfl_sync(kFull, wat, 31);
      wat -= wc;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int at = __shfl_sync(kFull, wat, (warp + k * kWarps) & 31);
        if (mk[k] & (1u << lane)) marked[at + __popc(mk[k] & below)] = static_cast<uint16_t>(tid + k * kThreads);
        if (sr[k] >= 0) cnt[sr[k]] = 0;  // no one reads the counts of this tile again
      }
      __syncthreads();

      // 4. the warp's marked rows (s % kWarps == warp) in row order: lane w
      // takes the ballot of the w-th 32 marked rows, then each lane writes
      // its rows at the prefix of the counts before it
      const int nmw = (nm + 31) / 32;
      unsigned mine_w = 0;
      for (int w0 = 0; w0 < nmw; w0 += 4) {
        int sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = (w0 + u) * 32 + lane;
          sv[u] = e < nm ? idt[marked[e]] : -1;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned m = __ballot_sync(kFull, sv[u] >= 0 && sv[u] % kWarps == warp);
          if (lane == w0 + u) mine_w = m;
        }
      }
      const int cw = __popc(mine_w);
      int at = cw;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, at, o);
        if (lane >= o) at += y;
      }
      const int count = __shfl_sync(kFull, at, 31);
      at -= cw;
      for (unsigned m = mine_w; m; m &= m - 1u) list[at++] = marked[lane * 32 + __ffs(m) - 1];
      __syncwarp();

      // 5. fold them, 32 at a time. A batch of one segment folds lanes across
      // threads (lane q < Lg) into an accumulator that stays in registers
      // while the next batches hold the same segment. Otherwise rows of one
      // segment find each other (a bit per row OR-ed into the segment's word:
      // the same word in any order) and the first of them leads. Few peers:
      // each leader folds its segment's rows itself. Many: the leaders take
      // turns, Tr at a time, a slot of Tl threads each, every thread one lane
      // over the peers.
      int carry = -1;  // the segment held in `acc`
      uint32_t acc = 0u;
      auto flush = [&]() {
        if (carry >= 0 && lane < Lg) table[carry * ts + lane * tl] = acc;
        carry = -1;
      };
      for (int e0 = 0; e0 < count; e0 += 32) {
        const bool valid = e0 + lane < count;
        const int row = valid ? list[e0 + lane] : 0;
        const int s = valid ? idt[row] : -1;
        const int s0 = __shfl_sync(kFull, s, 0);
        if (__all_sync(kFull, !valid || s == s0)) {
          if (s0 != carry) {
            flush();
            carry = s0;
            if (lane < Lg) acc = table[s0 * ts + lane * tl];
          }
          if (lane < Lg)
            acc = fold_run<LD, CB>(acc, mine.code, count - e0 < 32 ? count - e0 : 32, list + e0,
                                   mb, mine.stride);
          continue;
        }
        flush();
        __syncwarp();
        uint32_t* bits = peer_bits + (valid ? s : 0);  // 0 since step 3
        if (valid) atomicOr(bits, 1u << lane);
        __syncwarp();
        const unsigned peers = valid ? *bits : 0u;
        __syncwarp();
        if (valid) *bits = 0u;  // the counts are 0 again for the next tile
        const bool leader = valid && (peers & below) == 0;
        const int np = leader ? __popc(peers) : 0;
        if (__reduce_max_sync(kFull, np) <= 2) {
          if (leader) {
            fold_row(s, row);
            const unsigned other = peers & ~(1u << lane);
            if (other) fold_row(s, list[e0 + __ffs(other) - 1]);
          }
        } else {
          const unsigned leaders = __ballot_sync(kFull, leader);
          const int nl = __popc(leaders);
          if (leader) M.lead[warp][__popc(leaders & below)] = lane;
          __syncwarp();
          for (int k = 0; k < nl; k += Tr) {
            const int ent = k + slot < nl ? M.lead[warp][k + slot] : -1;
            const int from = ent < 0 ? 0 : ent;
            const int seg = __shfl_sync(kFull, s, from);
            const unsigned pm = __shfl_sync(kFull, peers, from);
            if (ent >= 0 && q < Lg) {
              uint32_t* tw = table + seg * ts + q * tl;
              *tw = fold_peers<LD, CB>(*tw, mine.code, pm, list + e0, mb, mine.stride);
            }
          }
        }
        __syncwarp();  // the segment's next rows may lead on another lane or slot
      }
      flush();
    };

    with_kind(ldc, M.cb_all, [&](auto ldk, auto cbk) {
      for (int t = 0; t < nt; ++t) {
        const int64_t t0 = lo + static_cast<int64_t>(t) * R;
        const int rows = static_cast<int>(hi - t0 < R ? hi - t0 : R);
        const int st = static_cast<int>((seq + t) % kStages);
        if (t < ns) {
          mbar_wait(smem_addr(&M.bar[st]), static_cast<int>(((seq + t) / kStages) & 1));
          run_tile(std::true_type{}, ldk, cbk, t0, rows, st);
        } else {
          run_tile(std::false_type{}, ldk, std::integral_constant<int, kCbAny>{}, t0, rows, st);
        }
        fence_proxy_async();  // this thread's reads of the stage come before the next copy into it
        __syncthreads();      // the stage is free again
        if (tid == 0 && t + kStages < ns) issue(t + kStages, st);
      }
    });
    seq += ns;

    uint32_t* part = dest + static_cast<int64_t>(c) * S * cols.lanes;
    for (int i = tid; i < S * Lg; i += kThreads)
      part[static_cast<int64_t>(i / Lg) * cols.lanes + M.lane_out[i % Lg]] =
          table[(i / Lg) * ts + (i % Lg) * tl];
    if (counting)
      for (int i = tid; i < S; i += kThreads)
        part[static_cast<int64_t>(i) * cols.lanes + cols.count_lane] = rows_of[i];
    fence_proxy_async();  // the next item's ring may cover this table
    __syncthreads();
  }
}

// out[w] = part[0][w] (op) part[1][w] (op) ... in chunk order
__global__ void __launch_bounds__(256)
seg_merge(const uint32_t* __restrict__ part, int C, int64_t words, Cols cols,
          uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= words) return;
  const int code = lane_cb(cols, static_cast<int>(i % cols.lanes));
  uint32_t acc = part[i];
  int c = 1;
  for (; c + 8 <= C; c += 8) {
    uint32_t x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = part[static_cast<int64_t>(c + u) * words + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = cb<kCbAny>(acc, x[u], code);
  }
  for (; c < C; ++c) acc = cb<kCbAny>(acc, part[static_cast<int64_t>(c) * words + i], code);
  out[i] = acc;
}

// The shared memory a launch asks for: the widest group's table, the
// metadata, and a staging ring and the warps' row lists of up to kRingCap
// bytes.
int smem_for(const Cols& cols, int S) {
  const int lanes = group_lanes_max(S) < cols.lanes ? group_lanes_max(S) : cols.lanes;
  const int table = (S * lanes * 4 + 127) / 128 * 128;
  long ring = static_cast<long>(kMaxTile) * (kStages * (4 + 4 * lanes) + (kWarps + 1) * 2);
  if (ring > kRingCap) ring = kRingCap;
  const long need = kMetaBytes + 2 * ((4 * S + 127) / 128 * 128) + table + ring;
  return static_cast<int>(need < kSmemMax ? need : kSmemMax);
}

// scratch: num_chunks * S * lanes words of chunk partials (unused when num_chunks == 1)
cudaError_t launch(const int32_t* ids, int64_t n, int num_segments, const Cols& cols,
                   int num_chunks, uint32_t* scratch, uint32_t* out, int device,
                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (num_chunks < 1 || num_segments < 1 || num_segments > kMaxSegments || cols.ncols < 1 ||
      cols.ncols > kMaxCols || n < 0 || n > INT32_MAX || cols.lanes < 1)
    return cudaErrorInvalidValue;
  Group unused;
  const int G = group_at(cols, num_segments, -1, &unused);  // the count is no lane of a group
  const int64_t items = static_cast<int64_t>(num_chunks) * G;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const int smem = smem_for(cols, num_segments);
  err = cudaFuncSetAttribute(seg_fold, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_fold, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm < 1 ? 1 : per_sm);
  const int grid = static_cast<int>(items < resident ? items : resident);
  uint32_t* dest = num_chunks == 1 ? out : scratch;
  seg_fold<<<grid, kThreads, smem, stream>>>(ids, n, num_segments, cols, num_chunks, G, smem,
                                             dest);
  if (num_chunks > 1) {
    const int64_t words = static_cast<int64_t>(num_segments) * cols.lanes;
    seg_merge<<<static_cast<unsigned>((words + 255) / 256), 256, 0, stream>>>(
        scratch, num_chunks, words, cols, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All (column, op) pairs of one keyed aggregate. vals/dtypes/ops/ds are
// host arrays of ncols entries; scratch holds num_chunks * S * lanes 32-bit
// words (num_chunks > 1); out is [S, lanes] 32-bit words, lanes = sum(ds) +
// (need_counts ? 1 : 0).
int tft_segment_reduce(const int32_t* ids, int64_t n, int num_segments, int ncols,
                       const void* const* vals, const int* dtypes, const int* ops, const int* ds,
                       int need_counts, int num_chunks, uint32_t* scratch, uint32_t* out,
                       int device, void* stream) {
  if (ncols < 1 || ncols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  Cols cols{};
  int lane = 0;
  for (int k = 0; k < ncols; ++k) {
    if (dtypes[k] < kF32 || dtypes[k] > kBool || ops[k] < kSum || ops[k] > kMax || ds[k] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
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
                    int d, int num_chunks, uint32_t* scratch, float* out, int device,
                    void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || d < 1) return static_cast<int>(cudaErrorInvalidValue);
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
