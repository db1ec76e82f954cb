// Paged int8-KV decode attention for Hopper (sm_90a): one layer, one new token
// per slot, attending that slot's whole cached sequence through its page table.
//
// Replaces the Pallas TPU kernel tensorframes_tpu/kernels/decode_attention.py
// (paged_decode_attention). The TPU kernel walks a (slot, page-table entry)
// grid, streams each page HBM->VMEM as int8 through a scalar-prefetched index
// map, and on a slot's last page runs dequantize, scores, masking, softmax and
// context in VMEM: nothing gathered ever goes back to HBM. This kernel keeps
// that property: a block reads its slot's int8 rows straight from the pool and
// keeps scores and weights in shared memory.
//
// What bounds it on the H100: bytes. Per slot and head it reads each valid
// position's int8 K and V row (2 x head_dim bytes) and two f32 scales once,
// and does ~4 x head_dim flops per position, far below the card's ratio of
// flops to bytes.
//
// Design: one block of 128 threads per (head, slot), no carried state. The
// block loads its own page-table row (there is no scalar prefetch) and q. It
// computes only the valid positions j <= pos (masked positions contribute an
// exact 0 weight in the reference): one warp per position, lanes split
// head_dim and reduce with a fixed xor tree. Then a block max and a block sum
// (fixed per-thread strides and trees: deterministic), and the P.V pass with
// threads on consecutive head_dim lanes (coalesced int8 reads) and a fixed
// split over positions. The reference's order of roundings is kept: K widened
// (exactly) before an f32-accumulated q.K, the 1/sqrt(hd) division before the
// K scale, softmax as exp(s - max) / sum, the weight multiplied by the V scale
// and rounded to q's dtype BEFORE the context product, which accumulates in
// f32 and rounds once to q's dtype. Each (slot, head) depends only on its own
// inputs, so a slot's output does not change with the batch around it.
// Simple first: no split-k over long contexts and no TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                              const int8_t* __restrict__ v_pages,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int32_t* __restrict__ tables, const int32_t* __restrict__ pos,
                              T* __restrict__ out, int nh, int hd, int page, int maxp, int layer,
                              int num_layers, int num_pages, float sqrt_hd) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kMaxHeadDim]
  float* part = qs + kMaxHeadDim;        // [kThreads] context partials
  float* red = part + kThreads;          // [kWarps] block reductions
  float* sc = red + 32;                  // [C] scores, then weights
  const int C = maxp * page;
  int32_t* tbl = reinterpret_cast<int32_t*>(sc + C);  // [maxp]

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  const int p = pos[s];
  const int L = p < 0 ? 0 : (p + 1 < C ? p + 1 : C);  // valid positions j <= pos
  for (int i = tid; i < maxp; i += kThreads) {
    int pg = tables[static_cast<int64_t>(s) * maxp + i];
    tbl[i] = pg < 0 ? 0 : (pg >= num_pages ? num_pages - 1 : pg);  // gather clamps, as XLA's
  }
  const T* qrow = q + (static_cast<int64_t>(s) * nh + h) * hd;
  for (int d = tid; d < hd; d += kThreads) qs[d] = widen(qrow[d]);
  __syncthreads();

  // row index of position j in the [P, layers, heads, page] pool layout
  auto row_of = [&](int j) -> int64_t {
    const int64_t pg = tbl[j / page];
    return ((pg * num_layers + layer) * nh + h) * page + (j % page);
  };

  // scores: one warp per position, lanes over head_dim, fixed xor tree
  for (int j = warp; j < L; j += kWarps) {
    const int64_t r = row_of(j);
    const int8_t* krow = k_pages + r * hd;
    float acc = 0.0f;
    for (int d = lane; d < hd; d += 32) acc = fmaf(qs[d], static_cast<float>(krow[d]), acc);
    acc = warp_sum(acc);
    if (lane == 0) sc[j] = (acc / sqrt_hd) * k_scale[r];
  }
  __syncthreads();

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
    sc[j] = round_to((sc[j] / sum) * v_scale[row_of(j)], static_cast<T*>(nullptr));
  }
  __syncthreads();

  // context: thread (part, d) sums positions part, part + nparts, ... in order
  const int nparts = kThreads / hd;
  const int d = tid % hd, pi = tid / hd;
  if (pi < nparts) {
    float acc = 0.0f;
    for (int j = pi; j < L; j += nparts) {
      acc = fmaf(sc[j], static_cast<float>(v_pages[row_of(j) * hd + d]), acc);
    }
    part[pi * hd + d] = acc;
  }
  __syncthreads();
  if (tid < hd) {
    float acc = part[tid];
    for (int i = 1; i < nparts; ++i) acc += part[i * hd + tid];
    out[(static_cast<int64_t>(s) * nh + h) * hd + tid] = narrow<T>(acc);
  }
}

}  // namespace

extern "C" {

// q/out: [S, nh, hd] (bf16 when q_bf16 else f32); k_pages/v_pages: int8
// [num_pages, num_layers, nh, page, hd]; k_scale/v_scale: f32
// [num_pages, num_layers, nh, page]; tables: int32 [S, maxp]; pos: int32 [S].
int tft_paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                               const void* k_scale, const void* v_scale, const void* tables,
                               const void* pos, void* out, int S, int nh, int hd, int page,
                               int maxp, int layer, int num_layers, int num_pages, float sqrt_hd,
                               int q_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S < 0 || nh < 1 || hd < 1 || hd > kMaxHeadDim || page < 1 || maxp < 1 || layer < 0 ||
      layer >= num_layers || num_pages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = (kMaxHeadDim + kThreads + 32 + static_cast<size_t>(maxp) * page) *
                          sizeof(float) +
                      static_cast<size_t>(maxp) * sizeof(int32_t);
  const dim3 grid(nh, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k_pages);
  const int8_t* vp = static_cast<const int8_t*>(v_pages);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  if (q_bf16) {
    auto kern = paged_decode_attention_kernel<__nv_bfloat16>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<grid, kThreads, smem, st>>>(static_cast<const __nv_bfloat16*>(q), kp, vp, ks, vs, tb,
                                       ps, static_cast<__nv_bfloat16*>(out), nh, hd, page, maxp,
                                       layer, num_layers, num_pages, sqrt_hd);
  } else {
    auto kern = paged_decode_attention_kernel<float>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<grid, kThreads, smem, st>>>(static_cast<const float*>(q), kp, vp, ks, vs, tb, ps,
                                       static_cast<float*>(out), nh, hd, page, maxp, layer,
                                       num_layers, num_pages, sqrt_hd);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
