// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ of
// o = softmax(q.k^T * sm_scale).v over [batch, heads, seq, head_dim], optionally
// causal, from the forward's residuals l and m, never materializing the
// [seq_q, seq_k] score matrix in device memory.
//
// Replaces the two Pallas TPU kernels of upstream JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py that jax.grad reaches
// through the flash custom_vjp (_flash_attention_bwd): _flash_attention_bwd_dkv
// (kernel _flash_attention_dkv_kernel) and _flash_attention_bwd_dq (kernel
// _flash_attention_dq_kernel). Upstream walks a grid in order on one core and
// carries the dK/dV (or dQ) sums in VMEM scratch from one grid step to the
// next. Here blocks run in parallel in no order, so each block owns its output
// tile and loops over the other axis itself:
//   dK/dV: one block per (batch * head, 64-key tile); it loops over the 64-row q
//          tiles, from the diagonal tile down when causal;
//   dQ:    one block per (batch * head, 64-row q tile); it loops over the key
//          tiles up to the diagonal.
// Every sum runs in a fixed order and no float atomics are used, so two launches
// give the same bits. The TPU layout's 128-lane l/m/di tiles and its
// block_*_major tiling have no counterpart.
//
// The arithmetic is upstream's, in its order of roundings:
//   s  = (q.k^T in f32) * sm_scale; causal positions col > row, keys past the
//        last one and rows past the last one get weight exactly 0;
//   p  = exp(s - m) * (1 / l) in f32;
//   dV += p^T rounded to dO's dtype . dO, accumulated in f32;
//   dP = dO . v^T in f32;  dS = (dP - di) * p * sm_scale;
//   dK += dS rounded to dO's dtype ^T . q;  dQ += dS rounded to k's dtype . k,
//        accumulated in f32 and rounded once to the input's dtype.
// di = sum_d o * dO (f32) comes from the caller, as upstream computes it outside
// its kernels. The scale and the dS products use __fmul_rn, so the compiler
// fuses none of them into an FMA with a neighbouring add.
//
// What bounds it on the H100: at the training shape ([8, 12, 1024, 64] bf16,
// causal) operations: the dK/dV kernel does four products of sq x sk x d per
// (batch, head), dQ three, halved by the causal mask, against ~8 bytes of
// input per (row, column). This simple version runs them as scalar f32 FMAs out
// of shared memory, like the forward, far from either bound; tensor cores
// (mma.sync / wgmma) on bf16 tiles, TMA loads and one fused pass are a later
// step.
//
// Design: 256 threads per block; 64 x head_dim tiles of q, dO, k and v staged in
// shared memory as f32 (rows padded to head_dim + 1 floats, so the products
// read without bank conflicts), in dynamic shared memory (166 KB for the dK/dV
// kernel at head_dim 128). Thread (tx, ty) = (lane % 16, 2 * warp + lane / 16)
// computes the 4 x 4 entries (rows ty + 16 i, columns tx + 16 j) of each 64 x 64
// product, and owns rows ty + 16 i, columns tx + 16 jj of its output tile(s).
// Any sequence lengths (tile edges are masked), any head_dim up to 128, bf16 or
// f32, every input and output at any strides whose last one is 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kB = 64;  // rows of a q tile, keys of a k/v tile
constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 128;
constexpr int kLdT = kB + 1;  // row stride of a [kB][kB] p or dS tile

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

struct Strides {
  int64_t b, h, s;  // elements; the head_dim stride is 1
};

// Everything one launch reads and writes. q/k/v/dout/dq/dk/dv: [batch, heads,
// seq, d] at their strides; l, m, di: [batch * heads, sq] f32, contiguous.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* l;
  const float* m;
  const float* di;
  void* dq;
  void* dk;
  void* dv;
  int heads, sq, sk, d;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float sm_scale;
  int causal;
};

// rows r0 .. r0 + kB - 1 of a [n, d] matrix at row stride `stride` into an f32
// [kB][DMAX + 1] tile, zero past row n and column d
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t stride, int r0, int n,
                                          int d) {
  constexpr int LD = DMAX + 1;
  for (int e = threadIdx.x; e < kB * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    dst[r * LD + c] = (r0 + r < n && c < d) ? widen(src[(r0 + r) * stride + c]) : 0.0f;
  }
}

// s[i][j] = sum_c A[ty + 16 i][c] * B[tx + 16 j][c], in order of c
template <int LD>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int d, int tx, int ty,
                                         float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
  for (int c = 0; c < d; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// p and dS of one (row, col) entry from its raw q.k and dO.v sums
struct PdS {
  float p, ds;
};

__device__ __forceinline__ PdS p_and_ds(float qk, float dp, float m, float inv_l, float di,
                                        float sm_scale, bool valid) {
  if (!valid) return {0.0f, 0.0f};
  const float p = __fmul_rn(expf(__fmul_rn(qk, sm_scale) - m), inv_l);
  return {p, __fmul_rn(__fmul_rn(dp - di, p), sm_scale)};
}

template <int DMAX>
constexpr size_t dkv_smem_bytes() {
  return (static_cast<size_t>(4 * kB) * (DMAX + 1) + 2 * kB * kLdT + 3 * kB) * sizeof(float);
}

template <int DMAX>
constexpr size_t dq_smem_bytes() {
  return (static_cast<size_t>(4 * kB) * (DMAX + 1) + kB * kLdT) * sizeof(float);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkv_kernel(Args a) {
  constexpr int LD = DMAX + 1;
  constexpr int DJ = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;              // [kB][LD]
  float* Vs = Ks + kB * LD;      // [kB][LD]
  float* Qs = Vs + kB * LD;      // [kB][LD]
  float* dOs = Qs + kB * LD;     // [kB][LD]
  float* Ps = dOs + kB * LD;     // [kB][kLdT], q row x key, p rounded to T
  float* dSs = Ps + kB * kLdT;   // [kB][kLdT], q row x key, dS rounded to T
  float* invL = dSs + kB * kLdT;  // [kB] per q row: 1 / l, m, di
  float* Ms = invL + kB;
  float* Di = Ms + kB;

  const int ntk = (a.sk + kB - 1) / kB;
  const int kt = static_cast<int>(blockIdx.x % ntk);  // causal: the longest loops start first
  const int bh = static_cast<int>(blockIdx.x / ntk);
  const int b = bh / a.heads, h = bh % a.heads;
  const int k0 = kt * kB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;
  const int ty = (tid >> 5) * 2 + (lane >> 4);

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const int64_t stat0 = static_cast<int64_t>(bh) * a.sq;

  load_tile<T, DMAX>(Ks, kb, a.ks.s, k0, a.sk, a.d);
  load_tile<T, DMAX>(Vs, vb, a.vs.s, k0, a.sk, a.d);

  float dk[4][DJ], dv[4][DJ];  // keys k0 + ty + 16 i, columns tx + 16 jj
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk[i][jj] = dv[i][jj] = 0.0f;

  // the first q tile with a row that sees key k0 (row >= k0) when causal
  const int ntq = (a.sq + kB - 1) / kB;
  for (int qt = a.causal ? k0 / kB : 0; qt < ntq; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // the previous tile's readers are done with Qs, dOs, Ps, dSs
    load_tile<T, DMAX>(Qs, qb, a.qs.s, q0, a.sq, a.d);
    load_tile<T, DMAX>(dOs, dob, a.dos.s, q0, a.sq, a.d);
    if (tid < kB) {
      const bool in = q0 + tid < a.sq;
      invL[tid] = in ? 1.0f / a.l[stat0 + q0 + tid] : 0.0f;
      Ms[tid] = in ? a.m[stat0 + q0 + tid] : 0.0f;
      Di[tid] = in ? a.di[stat0 + q0 + tid] : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<LD>(Qs, Ks, a.d, tx, ty, s);
    tile_dot<LD>(dOs, Vs, a.d, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        const bool valid = row < a.sq && col < a.sk && (!a.causal || col <= row);
        const PdS e = p_and_ds(s[i][j], dp[i][j], Ms[r], invL[r], Di[r], a.sm_scale, valid);
        Ps[r * kLdT + c] = round_to(e.p, static_cast<const T*>(nullptr));
        dSs[r * kLdT + c] = round_to(e.ds, static_cast<const T*>(nullptr));
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over this tile's rows, in order
    const int nr = a.sq - q0 < kB ? a.sq - q0 : kB;
    for (int r = 0; r < nr; ++r) {
      float pv[4], dsv[4], dov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * kLdT + ty + 16 * i];
        dsv[i] = dSs[r * kLdT + ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        dov[jj] = dOs[r * LD + tx + 16 * jj];
        qv[jj] = Qs[r * LD + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          dv[i][jj] = fmaf(pv[i], dov[jj], dv[i][jj]);
          dk[i][jj] = fmaf(dsv[i], qv[jj], dk[i][jj]);
        }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.dks.b + h * a.dks.h;
  T* dvb = static_cast<T*>(a.dv) + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.sk) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < a.d) {
        dkb[key * a.dks.s + c] = narrow<T>(dk[i][jj]);
        dvb[key * a.dvs.s + c] = narrow<T>(dv[i][jj]);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_kernel(Args a) {
  constexpr int LD = DMAX + 1;
  constexpr int DJ = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [kB][LD]
  float* dOs = Qs + kB * LD;    // [kB][LD]
  float* Ks = dOs + kB * LD;    // [kB][LD]
  float* Vs = Ks + kB * LD;     // [kB][LD]
  float* dSs = Vs + kB * LD;    // [kB][kLdT], q row x key, dS rounded to T

  const int ntq = (a.sq + kB - 1) / kB;
  const int qt = ntq - 1 - static_cast<int>(blockIdx.x % ntq);  // causal: longest first
  const int bh = static_cast<int>(blockIdx.x / ntq);
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = qt * kB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;
  const int ty = (tid >> 5) * 2 + (lane >> 4);

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const int64_t stat0 = static_cast<int64_t>(bh) * a.sq;

  load_tile<T, DMAX>(Qs, qb, a.qs.s, q0, a.sq, a.d);
  load_tile<T, DMAX>(dOs, dob, a.dos.s, q0, a.sq, a.d);
  float inv_l[4], m[4], di[4];  // rows q0 + ty + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < a.sq;
    inv_l[i] = in ? 1.0f / a.l[stat0 + row] : 0.0f;
    m[i] = in ? a.m[stat0 + row] : 0.0f;
    di[i] = in ? a.di[stat0 + row] : 0.0f;
  }

  float dq[4][DJ];  // rows q0 + ty + 16 i, columns tx + 16 jj
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq[i][jj] = 0.0f;

  // keys this tile's rows can see: all of them, or col <= last row when causal
  const int q_last = (q0 + kB < a.sq ? q0 + kB : a.sq) - 1;
  const int k_end = a.causal ? (q_last + 1 < a.sk ? q_last + 1 : a.sk) : a.sk;
  const int ntk = (k_end + kB - 1) / kB;
  for (int t = 0; t < ntk; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's readers are done with Ks, Vs
    load_tile<T, DMAX>(Ks, kb, a.ks.s, k0, a.sk, a.d);
    load_tile<T, DMAX>(Vs, vb, a.vs.s, k0, a.sk, a.d);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<LD>(Qs, Ks, a.d, tx, ty, s);
    tile_dot<LD>(dOs, Vs, a.d, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        const bool valid = row < a.sq && col < a.sk && (!a.causal || col <= row);
        const PdS e = p_and_ds(s[i][j], dp[i][j], m[i], inv_l[i], di[i], a.sm_scale, valid);
        dSs[r * kLdT + c] = round_to(e.ds, static_cast<const T*>(nullptr));
      }
    }
    __syncwarp();  // a row of dSs is written and read by the same half warp

    // dQ += dS K over this tile's keys, in order
    const int nk = a.sk - k0 < kB ? a.sk - k0 : kB;
    for (int j = 0; j < nk; ++j) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * kLdT + j];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kv[jj] = Ks[j * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) dq[i][jj] = fmaf(dsv[i], kv[jj], dq[i][jj]);
    }
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < a.d) dqb[row * a.dqs.s + c] = narrow<T>(dq[i][jj]);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kern, size_t smem, int64_t blocks, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Args& a, int batch, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(batch) * a.heads * ((a.sk + kB - 1) / kB);
  return launch(flash_attention_bwd_dkv_kernel<T, DMAX>, dkv_smem_bytes<DMAX>(), blocks, a,
                stream);
}

template <typename T, int DMAX>
cudaError_t launch_dq(const Args& a, int batch, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(batch) * a.heads * ((a.sq + kB - 1) / kB);
  return launch(flash_attention_bwd_dq_kernel<T, DMAX>, dq_smem_bytes<DMAX>(), blocks, a, stream);
}

int check_shape(int batch, int heads, int sq, int sk, int d) {
  return batch < 0 || heads < 1 || sq < 0 || sk < 1 || d < 1 || d > kMaxHeadDim;
}

}  // namespace

extern "C" {

// dK and dV. q/dout: [batch, heads, sq, d], k/v/dk/dv: [batch, heads, sk, d],
// each given by its batch, head and sequence strides in elements (the head_dim
// stride is 1); l, m, di: [batch * heads, sq] f32, contiguous; bf16 when is_bf16
// else f32. Every key's row of dk and dv is written (zero where no query sees
// it). Launches on `stream`, allocates nothing.
int tft_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* l, const float* m, const float* di, void* dk,
                                void* dv, int batch, int heads, int sq, int sk, int d,
                                int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                int64_t v_ss, int64_t do_sb, int64_t do_sh, int64_t do_ss,
                                int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb,
                                int64_t dv_sh, int64_t dv_ss, float sm_scale, int causal,
                                int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (check_shape(batch, heads, sq, sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, l, m, di, nullptr, dk, dv, heads, sq, sk, d,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {do_sb, do_sh, do_ss}, {0, 0, 0}, {dk_sb, dk_sh, dk_ss}, {dv_sb, dv_sh, dv_ss},
               sm_scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    err = d <= 64 ? launch_dkv<__nv_bfloat16, 64>(a, batch, st)
                  : launch_dkv<__nv_bfloat16, 128>(a, batch, st);
  } else {
    err = d <= 64 ? launch_dkv<float, 64>(a, batch, st) : launch_dkv<float, 128>(a, batch, st);
  }
  return static_cast<int>(err);
}

// dQ. Shapes, strides and types as tft_flash_attention_bwd_dkv; dq like q.
int tft_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* l, const float* m, const float* di, void* dq,
                               int batch, int heads, int sq, int sk, int d, int64_t q_sb,
                               int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                               int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                               int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb,
                               int64_t dq_sh, int64_t dq_ss, float sm_scale, int causal,
                               int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (check_shape(batch, heads, sq, sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, l, m, di, dq, nullptr, nullptr, heads, sq, sk, d,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {do_sb, do_sh, do_ss}, {dq_sb, dq_sh, dq_ss}, {0, 0, 0}, {0, 0, 0},
               sm_scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    err = d <= 64 ? launch_dq<__nv_bfloat16, 64>(a, batch, st)
                  : launch_dq<__nv_bfloat16, 128>(a, batch, st);
  } else {
    err = d <= 64 ? launch_dq<float, 64>(a, batch, st) : launch_dq<float, 128>(a, batch, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
