// Int8-weight matmul for Hopper (sm_90a): out[m, n] = (x[m, k] @ q[k, n]) * scale[n],
// x in bf16 or f32, q int8, scale f32 per output channel, out in x's dtype.
//
// Replaces the Pallas TPU kernel tensorframes_tpu/ops/quantize.py
// (matmul_pallas_int8), which streams each int8 weight tile HBM->VMEM, widens it
// on chip right before the MXU dot, accumulates over k in f32 and applies the
// per-output-channel scale on the last k step. The TPU kernel pads x and q to
// 256-multiples and broadcasts the scale to 8 rows; those are TPU layout
// artefacts: this kernel masks its own ragged edges and makes no padded copies.
//
// What bounds it on the H100: bytes. At the serving path's shapes (m = 8..128
// rows, k x n = 768 x 2304 .. 3072 x 768) the int8 weight is 0.6-2.4 MB and is
// read once per call, while the arithmetic is at most 0.3 GFLOP; the weight
// read at 3.35 TB/s is the least time the card could take.
//
// Design: a 16 x 64 output tile per block of 256 threads; k advances in 64-deep
// tiles. Each tile of x is widened to f32 in shared memory; each int8 weight
// tile is loaded with 16-byte vector loads (bytes at a ragged or unaligned
// edge) and widened to f32 in shared memory, so the weight crosses HBM as int8.
// Every thread owns 4 rows x 1 column of f32 accumulators in registers and
// walks k in one fixed order (0, 1, ..., k-1) with fmaf. An output row's bits
// therefore depend on neither m, nor the row's index, nor the other rows: the
// decode engine's batched-equals-solo contract rests on that. The scale
// multiplies the f32 sum once at the end, then one rounding to x's dtype.
// Simple first: no tensor cores (wgmma), TMA or split-k yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 16;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kBM * kBN / kThreads;  // 4

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ out, int m, int k, int n,
                   bool vec_w) {
  __shared__ float sx[kBM][kBK];
  __shared__ float sw[kBK][kBN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int col = tid % kBN;
  const int r0 = (tid / kBN) * kRowsPerThread;

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x tile: kBM x kBK elements, 4 per thread, consecutive threads on
    // consecutive k (coalesced); rows past m and k past the edge read as 0
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, kk = e % kBK;
      const int gr = m0 + r, gk = k0 + kk;
      sx[r][kk] = (gr < m && gk < k) ? widen(x[static_cast<int64_t>(gr) * k + gk]) : 0.0f;
    }
    // weight tile: kBK x kBN int8 = 4096 bytes, 16 bytes per thread
    {
      const int row = tid / (kBN / 16);
      const int c16 = (tid % (kBN / 16)) * 16;
      const int gk = k0 + row;
      const int gc = n0 + c16;
      float* dst = &sw[row][c16];
      if (gk < k && vec_w && gc + 16 <= n) {
        const int4 raw = *reinterpret_cast<const int4*>(q + static_cast<int64_t>(gk) * n + gc);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 16; ++j) dst[j] = static_cast<float>(b[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          dst[j] = (gk < k && gc + j < n)
                       ? static_cast<float>(q[static_cast<int64_t>(gk) * n + gc + j])
                       : 0.0f;
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float w = sw[kk][col];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[i] = fmaf(sx[r0 + i][kk], w, acc[i]);
    }
    __syncthreads();
  }

  const int gc = n0 + col;
  if (gc >= n) return;
  const float s = scale[gc];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gr = m0 + r0 + i;
    if (gr < m) out[static_cast<int64_t>(gr) * n + gc] = narrow<T>(acc[i] * s);
  }
}

}  // namespace

extern "C" {

// x: [m, k] (bf16 when x_bf16 else f32), q: [k, n] int8, scale: [n] f32,
// out: [m, n] in x's dtype. All row-major and contiguous.
int tft_int8_matmul(const void* x, const void* q, const void* scale, void* out, int m, int k,
                    int n, int x_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 0 || k < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const bool vec_w = (n % 16 == 0) && (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(scale);
  if (x_bf16) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qq, ss, static_cast<__nv_bfloat16*>(out), m, k, n,
        vec_w);
  } else {
    int8_matmul_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), qq, ss,
                                                         static_cast<float*>(out), m, k, n, vec_w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
