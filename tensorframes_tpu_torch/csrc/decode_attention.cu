// Paged int8-KV decode attention for Hopper (sm_90a): one layer, one new token
// per slot, attending that slot's whole cached sequence through its page table.
//
// Replaces the Pallas TPU kernel tensorframes_tpu/kernels/decode_attention.py
// (paged_decode_attention). The TPU kernel walks a (slot, page-table entry)
// grid, streams each page HBM->VMEM as int8 through a scalar-prefetched index
// map, and on a slot's last page runs dequantize, scores, masking, softmax and
// context in VMEM: nothing gathered ever goes back to HBM. This kernel keeps
// that property: a block reads its slot's int8 rows straight from the pool and
// keeps K, V, scores and weights in shared memory.
//
// What bounds it on the H100: bytes, and at the decode server's contexts (at
// most 192 positions) the latency of getting them. Per slot and head it reads
// each valid position's int8 K and V row (2 x head_dim bytes) and two f32
// scales once, and does ~4 x head_dim flops per position, far below the
// card's ratio of flops to bytes; a design that waits on one position's bytes
// at a time waits ~150 times per block.
//
// Design: one block of 128 threads per (head, slot), no carried state. The
// block loads its own page-table row (there is no scalar prefetch), then
// issues every valid position's K and V rows at once as one bulk copy per
// page on Hopper's copy engine (TMA; one page of one head is page x head_dim
// contiguous bytes in the [P, L, nh, page, hd] pool), counted on one
// mbarrier, and loads the K and V scales beside them, so it waits on memory
// about once. Scores: a group of G lanes
// per position, each lane a 16-byte K chunk against its 16 q values in
// registers, a fixed xor tree over the group. Then a block max and a block
// sum (fixed per-thread strides and trees: deterministic). P.V: thread
// (lane group, position slice) sums its slice's positions in order over its
// 16 head_dim lanes, and the slices' partials are added in slice order. A
// context longer than the staging buffer (kStageRows positions) runs chunk
// by chunk: the scores of every chunk first (f32 in shared memory), then the
// weights, then P.V chunk by chunk. head_dim not a multiple of 16, or pages
// off a 16-byte boundary, stage byte by byte instead.
// The reference's order of roundings is kept: K widened (exactly) before an
// f32-accumulated q.K, the 1/sqrt(hd) division before the K scale, softmax
// as exp(s - max) / sum, the weight multiplied by the V scale and rounded to
// q's dtype BEFORE the context product, which accumulates in f32 and rounds
// once to q's dtype. Each (slot, head) depends only on its own inputs, so a
// slot's output does not change with the batch around it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kStageRows = 256;  // positions of K and of V staged at once

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// round to T's precision, kept in an f32 register
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the 16 int8 of a 16-byte chunk, widened exactly to f32
__device__ __forceinline__ void widen16(const int4 raw, float (&f)[16]) {
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                         static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t[4];
    widen_s8x4(w[i], t);
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = t[j];
  }
}

// VEC: head_dim a multiple of 16 and 16-byte aligned pages (16-byte copies
// and reads); else byte by byte. G lanes per position (16 G >= hd, a power of
// two), so kThreads / G positions a round.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const T* __restrict__ q, int64_t q_ss, int64_t q_sh,
                              const int8_t* __restrict__ k_pages,
                              const int8_t* __restrict__ v_pages,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int32_t* __restrict__ tables, const int32_t* __restrict__ pos,
                              T* __restrict__ out, int nh, int hd, int page, int maxp, int layer,
                              int num_layers, int num_pages, float sqrt_hd, int G, int rows) {
  const int C = maxp * page;
  const int NS = kThreads / G;  // positions a round, and P.V's position slices
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;              // [C] K scales, then scores, then weights
  float* vsc = sc + C;           // [C] V scales
  float* part = vsc + C;         // [NS][hd] P.V partials
  float* red = part + NS * hd;   // [32] block reductions
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + 32);  // the bulk copies' barrier
  int32_t* tbl = reinterpret_cast<int32_t*>(bar + 1);     // [maxp]
  int8_t* ks = reinterpret_cast<int8_t*>(smem) +
               ((static_cast<size_t>(2 * C + NS * hd + 32 + 2 + maxp) * 4 + 15) / 16) * 16;
  int8_t* vs = ks + rows * hd;   // [rows][hd] each

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gi = tid % G, d0 = 16 * gi;  // the thread's 16 head_dim lanes
  const int sl = tid / G;                // its position within a round

  const int p = pos[s];
  const int L = p < 0 ? 0 : (p + 1 < C ? p + 1 : C);  // valid positions j <= pos
  const uint32_t bar_addr = smem_addr(bar);
  int phase = 0;  // of the barrier: one per staging of K and/or V
  if (VEC && tid == 0) mbar_init(bar_addr);
  for (int i = tid; i < maxp; i += kThreads) {
    int pg = tables[static_cast<int64_t>(s) * maxp + i];
    tbl[i] = pg < 0 ? 0 : (pg >= num_pages ? num_pages - 1 : pg);  // gather clamps, as XLA's
  }
  __syncthreads();

  // row index of position j in the [P, layers, heads, page] pool layout
  auto row_of = [&](int j) -> int64_t {
    const int64_t pg = tbl[j / page];
    return ((pg * num_layers + layer) * nh + h) * page + (j % page);
  };
  // positions c0 .. c0 + cn - 1 of a pool into a [rows][hd] staging buffer:
  // one bulk copy per page (a page of one head is page x hd contiguous
  // bytes), counted on the barrier, or byte by byte
  auto stage = [&](int8_t* dst, const int8_t* pages, int c0, int cn) {
    if (VEC) {
      if (cn > 0) fence_proxy_async();  // the buffer may hold a chunk threads read
      for (int i = c0 / page + tid; cn > 0 && i <= (c0 + cn - 1) / page; i += kThreads) {
        const int lo = max(c0, i * page), hi = min(c0 + cn, (i + 1) * page);
        bulk_copy(smem_addr(dst + (lo - c0) * hd), pages + row_of(lo) * hd, (hi - lo) * hd,
                  bar_addr);
      }
    } else {
      for (int e = tid; e < cn * hd; e += kThreads) {
        const int j = e / hd, d = e % hd;
        dst[j * hd + d] = pages[row_of(c0 + j) * hd + d];
      }
    }
  };

  // the first chunk's K and V in flight, then the scales and q while they land
  if (VEC && tid == 0 && L > 0) mbar_expect_tx(bar_addr, 2 * min(L, rows) * hd);
  stage(ks, k_pages, 0, min(L, rows));
  stage(vs, v_pages, 0, min(L, rows));
  for (int j = tid; j < L; j += kThreads) {
    const int64_t r = row_of(j);
    sc[j] = k_scale[r];
    vsc[j] = v_scale[r];
  }
  float qr[16];
  const T* qrow = q + s * q_ss + h * q_sh;
#pragma unroll
  for (int i = 0; i < 16; ++i) qr[i] = d0 + i < hd ? widen(qrow[d0 + i]) : 0.0f;

  // scores, chunk by chunk: G lanes per position, a fixed xor tree over them
  for (int c0 = 0; c0 < L; c0 += rows) {
    const int cn = min(rows, L - c0);
    if (c0 > 0) {
      if (VEC && tid == 0) mbar_expect_tx(bar_addr, cn * hd);
      stage(ks, k_pages, c0, cn);
    }
    if (VEC) mbar_wait(bar_addr, phase++ & 1);
    __syncthreads();
    for (int base = 0; base < cn; base += NS) {
      const int j = base + sl;
      float acc = 0.0f;
      if (j < cn) {
        const int8_t* krow = ks + j * hd;
        if (VEC) {
          if (d0 < hd) {
            float kv[16];
            widen16(*reinterpret_cast<const int4*>(krow + d0), kv);
#pragma unroll
            for (int i = 0; i < 16; ++i) acc = fmaf(qr[i], kv[i], acc);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            if (d0 + i < hd) acc = fmaf(qr[i], static_cast<float>(krow[d0 + i]), acc);
          }
        }
      }
      for (int o = G >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (j < cn && gi == 0) sc[c0 + j] = (acc / sqrt_hd) * sc[c0 + j];
    }
    __syncthreads();  // the K buffer is free, and every score is written
  }

  // block max
  float mx = __int_as_float(0xff800000);  // -inf
  for (int j = tid; j < L; j += kThreads) mx = fmaxf(mx, sc[j]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();

  // exp and block sum (per-thread strided sums, xor tree, warps in order)
  float sum = 0.0f;
  for (int j = tid; j < L; j += kThreads) {
    const float e = expf(sc[j] - mx);
    sc[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = red[0];
  for (int w = 1; w < kWarps; ++w) sum += red[w];

  // weights: softmax, times the V scale, rounded to q's dtype
  for (int j = tid; j < L; j += kThreads) {
    sc[j] = round_to((sc[j] / sum) * vsc[j], static_cast<T*>(nullptr));
  }
  __syncthreads();

  // context: thread (sl, gi) sums positions sl, sl + NS, ... in order, chunk by chunk
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  for (int c0 = 0; c0 < L; c0 += rows) {
    const int cn = min(rows, L - c0);
    if (c0 > 0) {  // the first chunk's V landed with its K
      __syncthreads();
      if (VEC && tid == 0) mbar_expect_tx(bar_addr, cn * hd);
      stage(vs, v_pages, c0, cn);
      if (VEC) mbar_wait(bar_addr, phase++ & 1);
      __syncthreads();
    }
    if (d0 >= hd) continue;
    for (int j = sl; j < cn; j += NS) {
      const float w = sc[c0 + j];
      const int8_t* vrow = vs + j * hd;
      if (VEC) {
        float vv[16];
        widen16(*reinterpret_cast<const int4*>(vrow + d0), vv);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = fmaf(w, vv[i], acc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (d0 + i < hd) acc[i] = fmaf(w, static_cast<float>(vrow[d0 + i]), acc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (d0 + i < hd) part[sl * hd + d0 + i] = acc[i];
  }
  __syncthreads();
  if (tid < hd) {
    float o = part[tid];
    for (int i = 1; i < NS; ++i) o += part[i * hd + tid];
    out[(static_cast<int64_t>(s) * nh + h) * hd + tid] = narrow<T>(o);
  }
}

template <typename T, bool VEC>
cudaError_t launch(const T* q, int64_t q_ss, int64_t q_sh, const int8_t* kp, const int8_t* vp,
                   const float* ks, const float* vs, const int32_t* tb, const int32_t* ps, T* out,
                   int S, int nh, int hd, int page, int maxp, int layer, int num_layers,
                   int num_pages, float sqrt_hd, int G, int rows, size_t smem, cudaStream_t st) {
  auto kern = paged_decode_attention_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(nh, S), kThreads, smem, st>>>(q, q_ss, q_sh, kp, vp, ks, vs, tb, ps, out, nh, hd,
                                            page, maxp, layer, num_layers, num_pages, sqrt_hd, G,
                                            rows);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// q: [S, nh, hd] (bf16 when q_bf16 else f32) with strides (q_ss, q_sh, 1) in
// elements; out: [S, nh, hd] contiguous, q's dtype; k_pages/v_pages: int8
// [num_pages, num_layers, nh, page, hd]; k_scale/v_scale: f32
// [num_pages, num_layers, nh, page]; tables: int32 [S, maxp]; pos: int32 [S].
int tft_paged_decode_attention(const void* q, int64_t q_ss, int64_t q_sh, const void* k_pages,
                               const void* v_pages, const void* k_scale, const void* v_scale,
                               const void* tables, const void* pos, void* out, int S, int nh,
                               int hd, int page, int maxp, int layer, int num_layers,
                               int num_pages, float sqrt_hd, int q_bf16, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S < 0 || nh < 1 || hd < 1 || hd > kMaxHeadDim || page < 1 || maxp < 1 || layer < 0 ||
      layer >= num_layers || num_pages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0) return static_cast<int>(cudaSuccess);
  int G = 1;
  while (16 * G < hd) G *= 2;
  const int C = maxp * page;
  const int rows = C < kStageRows ? C : kStageRows;
  const size_t floats = 2 * static_cast<size_t>(C) + (kThreads / G) * hd + 32 + 2 + maxp;
  const size_t smem = (floats * 4 + 15) / 16 * 16 + 2 * static_cast<size_t>(rows) * hd;
  const bool vec = hd % 16 == 0 && reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k_pages);
  const int8_t* vp = static_cast<const int8_t*>(v_pages);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  if (q_bf16) {
    const auto* qq = static_cast<const __nv_bfloat16*>(q);
    auto* oo = static_cast<__nv_bfloat16*>(out);
    err = vec ? launch<__nv_bfloat16, true>(qq, q_ss, q_sh, kp, vp, ks, vs, tb, ps, oo, S, nh,
                                            hd, page, maxp, layer, num_layers, num_pages,
                                            sqrt_hd, G, rows, smem, st)
              : launch<__nv_bfloat16, false>(qq, q_ss, q_sh, kp, vp, ks, vs, tb, ps, oo, S, nh,
                                             hd, page, maxp, layer, num_layers, num_pages,
                                             sqrt_hd, G, rows, smem, st);
  } else {
    const auto* qq = static_cast<const float*>(q);
    auto* oo = static_cast<float*>(out);
    err = vec ? launch<float, true>(qq, q_ss, q_sh, kp, vp, ks, vs, tb, ps, oo, S, nh, hd, page,
                                    maxp, layer, num_layers, num_pages, sqrt_hd, G, rows, smem,
                                    st)
              : launch<float, false>(qq, q_ss, q_sh, kp, vp, ks, vs, tb, ps, oo, S, nh, hd,
                                     page, maxp, layer, num_layers, num_pages, sqrt_hd, G, rows,
                                     smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
