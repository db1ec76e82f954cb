// Flash-attention forward for Hopper (sm_90a): softmax(q.k^T * sm_scale).v over
// [batch, heads, seq, head_dim], optionally causal, never materializing the
// [seq_q, seq_k] score matrix in device memory.
//
// Replaces the Pallas TPU kernel that tensorframes_tpu/ops/attention.py
// (flash_attention) sends q/k/v to on a TPU: upstream JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py, whose forward walks a
// (batch, head, q block, k block) grid in order on one core and carries the
// running max m, denominator l and accumulator in VMEM scratch from one k block
// to the next. Here blocks run in parallel in no order, so nothing is carried
// between blocks: one block owns one (batch*head, q tile) and walks the key
// tiles itself in a loop. The TPU layout's 128-lane m/l scratch and its
// block_k_major tiling have no counterpart.
//
// This is the scalar build of the forward. bf16 inputs whose rows can be
// copied 16 bytes at a time (head_dim a multiple of 8, 16-byte aligned rows),
// the encoder's and the training path's among them, go to the tensor-core
// kernel in flash_attention_mma.cu instead; this one serves f32 inputs (the
// tensor cores would need TF32) and the other bf16 ones
// (kernels/flash_attention.py::forward_build chooses). It runs its two
// contractions as scalar f32 FMAs out of shared memory and is bound by its FMA
// rate, far from the bytes (at s = 128) or operations (at long sequences) that
// bound the function.
//
// Design: 256 threads per block; a 64-row q tile and 64-key K/V tiles staged
// in shared memory as f32 (rows padded to head_dim + 1 floats, so the S loop
// reads without bank conflicts). Thread (tx, ty) = (lane % 16, 2 * warp +
// lane / 16) owns score rows ty + 16 i and columns tx + 16 j (i, j < 4), and
// output rows ty + 16 i, columns tx + 16 jj: a row's 16 owners are one half
// warp, so its max and sum reduce with a fixed xor butterfly (every owner
// gets the same bits) and no block-wide reduction. The order of roundings is
// upstream's: s = (q.k in f32) * sm_scale; masked columns (past the last key,
// or col > row when causal) get weight exactly 0; f32 running max and
// denominator (l = sum(p) + alpha * l); p rounded to v's dtype before the P.V
// product, which accumulates in f32; the f32 result times 1/l (1 where l is
// 0) rounded once to q's dtype. The accumulator is rescaled by alpha and
// divided by l once at the end, where upstream normalises each step; p is
// taken against the running max, as upstream's is. Key tiles wholly above the
// diagonal are skipped when causal; q tiles run last-first, so the longest
// causal rows start first. Any sequence length (tile edges are masked), any
// head_dim up to 128, bf16 or f32, q/k/v/o at any strides whose last one is 1.
// When given l and m buffers ([batch * heads, sq] f32), the kernel also writes
// each row's final denominator l and its final running max m, the residuals of
// upstream's forward (l taken against that m): the backward kernels
// (flash_attention_bwd.cu) rebuild p = exp(s - m) / l from them. The row's
// half warp holds both with the same bits, and its first lane writes them.
// Writing them is a compile-time choice (the STATS template flag): null
// buffers select the build without the stores, so the inference path runs
// the same code as before the statistics existed, and o does not depend on
// the choice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 128;
constexpr int kLdP = kBK + 1;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// round to T's precision, kept in an f32 register
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
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

// reductions over the 16 lanes of a half warp; every lane ends with the same bits
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {
  int64_t b, h, s;  // elements; the head_dim stride is 1
};

template <int DMAX>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kBQ + 2 * kBK) * (DMAX + 1) + static_cast<size_t>(kBQ) * kLdP) *
         sizeof(float);
}

template <typename T, int DMAX, bool STATS>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ l_out, float* __restrict__ m_out, int heads,
                           int sq, int sk, int d, Strides qs, Strides ks, Strides vs, Strides os,
                           float sm_scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int DJ = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;    // [kBK][LD]
  float* Vs = Ks + kBK * LD;    // [kBK][LD]
  float* Ps = Vs + kBK * LD;    // [kBQ][kLdP], p rounded to T

  const int ntq = (sq + kBQ - 1) / kBQ;
  const int qt = ntq - 1 - static_cast<int>(blockIdx.x % ntq);
  const int bh = static_cast<int>(blockIdx.x / ntq);
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;
  const int ty = (tid >> 5) * 2 + (lane >> 4);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  for (int e = tid; e < kBQ * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    Qs[r * LD + c] = (q0 + r < sq && c < d) ? widen(qb[(q0 + r) * qs.s + c]) : 0.0f;
  }

  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.0f;
  }

  // keys this tile's rows can see: all of them, or col <= last row when causal
  const int q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  const int k_end = causal ? (q_last + 1 < sk ? q_last + 1 : sk) : sk;
  const int ntk = (k_end + kBK - 1) / kBK;

  for (int t = 0; t < ntk; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done with Ks, Vs, Ps
    for (int e = tid; e < kBK * DMAX; e += kThreads) {
      const int r = e / DMAX, c = e % DMAX;
      const bool in = k0 + r < sk && c < d;
      Ks[r * LD + c] = in ? widen(kb[(k0 + r) * ks.s + c]) : 0.0f;
      Vs[r * LD + c] = in ? widen(vb[(k0 + r) * vs.s + c]) : 0.0f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 16 j, summed over head_dim in order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // online softmax, one row per (i, half warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool valid[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        valid[j] = col < sk && (!causal || col <= row);
        s[i][j] *= sm_scale;
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // nothing seen yet
      const float alpha = expf(m_i[i] - m_use);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_use) : 0.0f;
        psum += p;
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = round_to(p, static_cast<const T*>(nullptr));
      }
      psum = half_warp_sum(psum);
      l_i[i] = psum + alpha * l_i[i];
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncwarp();  // a row of Ps is written and read by the same half warp

    // O += P V over this tile's keys, in order
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = Vs[j * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float inv = l_i[i] == 0.0f ? 1.0f : 1.0f / l_i[i];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d) ob[row * os.s + c] = narrow<T>(acc[i][jj] * inv);
    }
  }
  if constexpr (STATS) {
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row < sq) {
          l_out[static_cast<int64_t>(bh) * sq + row] = l_i[i];
          m_out[static_cast<int64_t>(bh) * sq + row] = m_i[i];
        }
      }
    }
  }
}

template <typename T, int DMAX, bool STATS>
cudaError_t launch_with(const void* q, const void* k, const void* v, void* out, float* l_out,
                        float* m_out, int batch, int heads, int sq, int sk, int d, Strides qs,
                        Strides ks, Strides vs, Strides os, float sm_scale, int causal,
                        cudaStream_t stream) {
  auto kern = flash_attention_fwd_kernel<T, DMAX, STATS>;
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(batch) * heads * ((sq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), l_out, m_out, heads, sq, sk, d, qs, ks, vs, os, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* l_out,
                   float* m_out, int batch, int heads, int sq, int sk, int d, Strides qs,
                   Strides ks, Strides vs, Strides os, float sm_scale, int causal,
                   cudaStream_t stream) {
  return l_out != nullptr
             ? launch_with<T, DMAX, true>(q, k, v, out, l_out, m_out, batch, heads, sq, sk, d, qs,
                                          ks, vs, os, sm_scale, causal, stream)
             : launch_with<T, DMAX, false>(q, k, v, out, l_out, m_out, batch, heads, sq, sk, d,
                                           qs, ks, vs, os, sm_scale, causal, stream);
}

}  // namespace

extern "C" {

// q/o: [batch, heads, sq, d], k/v: [batch, heads, sk, d], each given by its
// batch, head and sequence strides in elements (the head_dim stride is 1);
// bf16 when is_bf16 else f32. l_out/m_out: null, or both [batch * heads, sq]
// f32, contiguous. Launches on `stream`, allocates nothing.
int tft_flash_attention(const void* q, const void* k, const void* v, void* out, float* l_out,
                        float* m_out, int batch, int heads, int sq, int sk, int d, int64_t q_sb,
                        int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                        int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                        int64_t o_ss, float sm_scale, int causal, int is_bf16, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 0 || heads < 1 || sq < 0 || sk < 1 || d < 1 || d > kMaxHeadDim ||
      (l_out == nullptr) != (m_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    err = d <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, out, l_out, m_out, batch, heads, sq, sk, d,
                                              qs, ks, vs, os, sm_scale, causal, st)
                  : launch<__nv_bfloat16, 128>(q, k, v, out, l_out, m_out, batch, heads, sq, sk,
                                               d, qs, ks, vs, os, sm_scale, causal, st);
  } else {
    err = d <= 64 ? launch<float, 64>(q, k, v, out, l_out, m_out, batch, heads, sq, sk, d, qs, ks,
                                      vs, os, sm_scale, causal, st)
                  : launch<float, 128>(q, k, v, out, l_out, m_out, batch, heads, sq, sk, d, qs,
                                       ks, vs, os, sm_scale, causal, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
