// Flash-attention forward on Hopper's tensor cores (sm_90a), for bf16 q/k/v:
// softmax(q.k^T * sm_scale).v over [batch, heads, seq, head_dim], optionally
// causal, without the [seq_q, seq_k] scores in device memory.
//
// Replaces the same TPU kernel as flash_attention.cu: upstream JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py forward (_flash_attention_kernel
// :589, its pallas_call :758), which tensorframes_tpu/ops/attention.py
// (flash_attention) reaches on a TPU. Upstream walks a (batch, head, q block,
// k block) grid in order on one core and carries m, l and the accumulator in
// VMEM scratch; here one block owns one (batch*head, q tile) and loops
// over the key tiles itself, so nothing is carried between blocks, no atomics
// are needed, and two launches give the same bits. flash_attention.cu keeps the
// scalar f32 kernel: f32 inputs (the tensor cores would need TF32, whose 10-bit
// mantissa the f32 gate does not allow), and bf16 inputs this kernel cannot
// copy 16 bytes at a time (head_dim not a multiple of 8, a row start not
// 16-byte aligned); kernels/flash_attention.py::forward_build chooses.
//
// What bounds it on the H100: at BERT-base's shape ([1024, 12, 128, 64], 128
// keys) bytes: q, k, v read once and o written once, 0.24 ms at 3.35 TB/s
// against 0.05 ms of bf16 operations. At the training path's ([8, 12, 1024,
// 64] causal) the two nearly tie: 0.015 ms of bytes, 0.013 ms for 12.9 GFLOP at
// 989 TFLOP/s. The scalar kernel ran both products as f32 FMAs out of f32
// shared tiles and was bound by its FMA rate (2.37 ms and 0.72 ms). This kernel
// runs them on the tensor cores, at 1.3x the bound at BERT's shape and 6x at
// the training shape: what is left is latency that the resident warps do not
// hide (fewer warps with more rows each ran slower).
//
// - Each warp owns 16 rows of the block's q tile: 8 warps and 128 rows at
//   head_dim 64 (at most 128 registers, 2 blocks an SM), 4 warps and 64 rows at
//   head_dim 128 (8 warps would spill). At head_dim 64 the 128-row tile on 8
//   warps measured faster than 64 rows on 4 warps and than 32 rows on each of 4
//   warps (252 registers, half the warps resident; PERF.md §6).
// - Q, K and V are staged in shared memory as bf16 with 16-byte cp.async copies,
//   rows padded by 16 bytes so that the eight row addresses of an ldmatrix fall
//   in distinct banks. Columns past head_dim and rows past the sequence are
//   zero-filled by the copy, so head_dim is padded with zeros to D = 64 or 128
//   (zero columns of q and k add nothing to s; padded columns of o are not
//   stored) and masked keys meet zero rows of V.
// - K and V are double-buffered: tile t + 1 is copied while tile t computes.
// - Q is loaded once into registers as mma A-fragments (ldmatrix.x4). S = Q.K^T
//   is mma.sync m16n8k16 bf16 with f32 accumulators, K's rows read by ldmatrix
//   as the col-major B operand.
// - The online softmax runs in the accumulator layout: a lane holds rows g and
//   g + 8 of its warp's 16 (g = lane / 4), and a row's 64 scores lie on the
//   quad of 4 lanes that share g, so its max and sum reduce with a fixed xor
//   butterfly (1, 2) and every lane of the quad holds the same bits.
// - P's rounded values are repacked in registers into the A-fragments of the
//   P.V mma (the m16n8 accumulator layout of two adjacent key blocks is the
//   m16n8k16 A layout); V is read with ldmatrix.trans. Nothing of P goes
//   through shared memory.
// - o is staged through the warp's own rows of the Q tile and written with
//   16-byte stores.
//
// The order of roundings is upstream's, as in flash_attention.cu: s = (q.k in
// f32) * sm_scale; masked columns (past the last key, or col > row when causal)
// get weight exactly 0; f32 running max and denominator (l = sum(p) + alpha *
// l, from the unrounded p); p taken against the running max and rounded to
// bf16 before the P.V product, which accumulates in f32; the accumulator
// rescaled by alpha each tile and multiplied by 1/l (1 where l is 0) once at
// the end, rounded once to bf16. The order of the f32 additions inside one mma
// instruction is the hardware's (PTX leaves it unspecified), so the plain
// version is held to a rounding bound, not to bits. Key tiles wholly above the
// diagonal are skipped when causal, and only tiles that reach past the last key
// or the diagonal evaluate the mask; q tiles run last-first. The STATS template
// flag chooses at compile time whether each row's final l and m are written
// ([batch * heads, sq] f32, the backward's residuals, by the quad's first
// lane); o does not depend on it. The copies, fragment loads, mma and repack
// are mma_common.cuh's, shared with the backward (flash_attention_bwd_mma.cu).

#include "mma_common.cuh"

namespace {

constexpr int kBK = 64;  // keys per tile
constexpr int kMaxHeadDim = 128;

// the block's shape at head_dim D (the kernel's template argument)
template <int D>
struct Block {
  static constexpr int kWarps = D <= 64 ? 8 : 4;
  static constexpr int kBQ = 16 * kWarps;  // query rows, 16 per warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;  // per SM: caps the registers
  static constexpr size_t kSmem =  // Q, then K and V twice each
      static_cast<size_t>(kBQ + 4 * kBK) * (D + kPad) * sizeof(bf16);
};

template <int D, bool STATS>
__global__ void __launch_bounds__(Block<D>::kThreads, Block<D>::kMinBlocks)
flash_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, bf16* __restrict__ out,
                               float* __restrict__ l_out, float* __restrict__ m_out, int heads,
                               int sq, int sk, int d, Strides qs, Strides ks, Strides vs,
                               Strides os, float sm_scale, int causal) {
  constexpr int kBQ = Block<D>::kBQ;
  constexpr int LD = D + kPad;   // bf16 per shared row
  constexpr int TILE = kBK * LD;  // bf16 per K or V tile
  constexpr int KD = D / 16;     // 16-wide head_dim steps of the S product
  constexpr int NS = kBK / 8;    // 8-key column blocks of S
  constexpr int NO = D / 8;      // 8-wide column blocks of o
  constexpr int NT = Block<D>::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]; o's staging at the end
  bf16* Ks = Qs + kBQ * LD;                       // [2][kBK][LD]
  bf16* Vs = Ks + 2 * TILE;                       // [2][kBK][LD]

  const int ntq = (sq + kBQ - 1) / kBQ;
  const int qt = ntq - 1 - static_cast<int>(blockIdx.x % ntq);
  const int bh = static_cast<int>(blockIdx.x / ntq);
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16;       // the warp's first row in the tile
  const int g = lane >> 2, tg = lane & 3;  // accumulator rows g, g + 8; columns 2 tg, 2 tg + 1
  // the row (of 8) and the 8-element half whose address this lane gives ldmatrix.x4
  const int lr = lane & 7, lh = (lane >> 3) & 1, lq = lane >> 4;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  // keys this tile's rows can see: all of them, or col <= last row when causal
  const int q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  const int k_end = causal ? (q_last + 1 < sk ? q_last + 1 : sk) : sk;
  const int ntk = (k_end + kBK - 1) / kBK;

  stage_tile<D, kBQ, NT>(Qs, qb, qs.s, q0, sq, d, tid);
  stage_tile<D, kBK, NT>(Ks, kb, ks.s, 0, sk, d, tid);
  stage_tile<D, kBK, NT>(Vs, vb, vs.s, 0, sk, d, tid);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.0f, 0.0f};

  for (int t = 0; t < ntk; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntk) {  // the next tile's copies run while this one computes
      stage_tile<D, kBK, NT>(Ks + (cur ^ 1) * TILE, kb, ks.s, (t + 1) * kBK, sk, d, tid);
      stage_tile<D, kBK, NT>(Vs + (cur ^ 1) * TILE, vb, vs.s, (t + 1) * kBK, sk, d, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], smem_addr(Qs + (wr + lr + 8 * lh) * LD + kd * 16 + 8 * lq));
    }
    const bf16* Kt = Ks + cur * TILE;
    const bf16* Vt = Vs + cur * TILE;

    // S = Q K^T: the warp's 16 rows against the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kf[4];  // B-fragments of key blocks j and j + 1
        ldmatrix_x4(kf, smem_addr(Kt + (j * 8 + lr + 8 * lq) * LD + kd * 16 + 8 * lh));
        mma_bf16(s[j], qf[kd], kf[0], kf[1]);
        mma_bf16(s[j + 1], qf[kd], kf[2], kf[3]);
      }
    }

    // online softmax on rows g (i = 0) and g + 8 (i = 1)
    const int k0 = t * kBK;
    const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wr + g + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * i + e] * sm_scale;
          if (masked) {
            const int col = k0 + j * 8 + 2 * tg + e;
            if (col >= sk || (causal && col > row)) x = -INFINITY;  // weight exactly 0
          }
          s[j][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // nothing seen yet
      const float alpha = __expf(m_i[i] - m_use);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = __expf(s[j][2 * i + e] - m_use);  // exp(-inf) = 0
          psum += p;
          s[j][2 * i + e] = p;
        }
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_i[i] = psum + alpha * l_i[i];
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }

    // O += P V: P rounded to bf16 and repacked as A-fragments, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t vf[4];  // B-fragments of column blocks j and j + 1
        ldmatrix_x4_trans(vf, smem_addr(Vt + (kk * 16 + lr + 8 * lh) * LD + j * 8 + 8 * lq));
        mma_bf16(acc[j], pa, vf[0], vf[1]);
        mma_bf16(acc[j + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this tile's buffers before they refill
  }

  // o = acc / l, rounded once, through the warp's own 16 rows of Qs
  bf16* Os = Qs + wr * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = l_i[i] == 0.0f ? 1.0f : 1.0f / l_i[i];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8 * i) * LD + j * 8 + 2 * tg) =
          __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    }
  }
  __syncwarp();
  bf16* ob = out + b * os.b + h * os.h;
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e / kChunks, c = e % kChunks;
    const int row = q0 + wr + r;
    if (row < sq && c * 8 < d) {
      *reinterpret_cast<uint4*>(ob + row * os.s + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c * 8);
    }
  }
  if constexpr (STATS) {
    if (tg == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + wr + g + 8 * i;
        if (row < sq) {
          l_out[static_cast<int64_t>(bh) * sq + row] = l_i[i];
          m_out[static_cast<int64_t>(bh) * sq + row] = m_i[i];
        }
      }
    }
  }
}

template <int D, bool STATS>
cudaError_t launch_with(const void* q, const void* k, const void* v, void* out, float* l_out,
                        float* m_out, int batch, int heads, int sq, int sk, int d, Strides qs,
                        Strides ks, Strides vs, Strides os, float sm_scale, int causal,
                        cudaStream_t stream) {
  using Blk = Block<D>;
  auto kern = flash_attention_fwd_mma_kernel<D, STATS>;
  constexpr size_t smem = Blk::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(batch) * heads * ((sq + Blk::kBQ - 1) / Blk::kBQ);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), Blk::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), l_out, m_out, heads, sq, sk, d, qs, ks, vs, os, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* l_out,
                   float* m_out, int batch, int heads, int sq, int sk, int d, Strides qs,
                   Strides ks, Strides vs, Strides os, float sm_scale, int causal,
                   cudaStream_t stream) {
  return l_out != nullptr
             ? launch_with<D, true>(q, k, v, out, l_out, m_out, batch, heads, sq, sk, d, qs, ks,
                                    vs, os, sm_scale, causal, stream)
             : launch_with<D, false>(q, k, v, out, l_out, m_out, batch, heads, sq, sk, d, qs,
                                     ks, vs, os, sm_scale, causal, stream);
}

}  // namespace

extern "C" {

// bf16 q/o: [batch, heads, sq, d], k/v: [batch, heads, sk, d], each given by
// its batch, head and sequence strides in elements (the head_dim stride is 1);
// d a multiple of 8 up to 128 and every row 16-byte aligned, else
// cudaErrorInvalidValue. l_out/m_out: null, or both [batch * heads, sq] f32,
// contiguous. Launches on `stream`, allocates nothing.
int tft_flash_attention_mma(const void* q, const void* k, const void* v, void* out,
                            float* l_out, float* m_out, int batch, int heads, int sq, int sk,
                            int d, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                            int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                            int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale, int causal,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  if (batch < 0 || heads < 1 || sq < 0 || sk < 1 || d < 8 || d > kMaxHeadDim || d % 8 != 0 ||
      (l_out == nullptr) != (m_out == nullptr) || !rows_aligned(q, qs, batch, heads, sq) ||
      !rows_aligned(k, ks, batch, heads, sk) || !rows_aligned(v, vs, batch, heads, sk) ||
      !rows_aligned(out, os, batch, heads, sq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = d <= 64 ? launch<64>(q, k, v, out, l_out, m_out, batch, heads, sq, sk, d, qs, ks, vs, os,
                             sm_scale, causal, st)
                : launch<128>(q, k, v, out, l_out, m_out, batch, heads, sq, sk, d, qs, ks, vs,
                              os, sm_scale, causal, st);
  return static_cast<int>(err);
}

}  // extern "C"
