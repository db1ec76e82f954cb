// Flash-attention backward on Hopper's tensor cores (sm_90a), for bf16 q/k/v/dO:
// dK/dV and dQ of o = softmax(q.k^T * sm_scale).v over [batch, heads, seq,
// head_dim], optionally causal, from the forward's residuals l and m, without
// the [seq_q, seq_k] scores in device memory.
//
// Replaces the same two TPU kernels as flash_attention_bwd.cu: upstream JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py _flash_attention_bwd_dkv
// (:941, its pallas_call :1121) and _flash_attention_bwd_dq (:1287, call :1456),
// which jax.grad reaches through the flash custom_vjp. Upstream walks a grid in
// order on one core and carries the dK/dV (or dQ) sums in VMEM scratch; here
// each block owns its output tile and loops over the other axis itself:
//   dK/dV: one block per (batch * head, 64-key tile), 16 keys per warp; it loops
//          over the 64-row q tiles, from the diagonal down when causal;
//   dQ:    one block per (batch * head, 64-row q tile), 16 rows per warp; it
//          loops over the key tiles up to the diagonal.
// Nothing is carried between blocks and no float atomics are used, so two
// launches give the same bits. flash_attention_bwd.cu keeps the scalar f32
// kernels for f32 inputs and the bf16 inputs this one cannot copy 16 bytes at a
// time; kernels/flash_attention.py::backward_build chooses.
//
// What bounds it on the H100: at the training shape ([8, 12, 1024, 64] bf16,
// causal) operations. dK/dV does four products of 16 x 16 x head_dim per (key,
// row) pair that the mask keeps, dQ three, against ~8 bytes of input per row
// and key: 0.026 ms and 0.020 ms at 989 TFLOP/s, against 0.005 ms of bytes. The
// scalar kernels ran every product as f32 FMAs out of f32 shared tiles (1.28
// and 1.03 ms). Here every product is mma.sync m16n8k16 bf16 with f32
// accumulators, fed by ldmatrix from bf16 tiles: 0.146 and 0.113 ms, 5.6x and
// 5.8x the bound (PERF.md §6). Each warp reads its B fragments (the other
// axis's tile) from shared memory for every product, so shared-memory traffic,
// not the tensor cores, is the next limit.
//
// Per q tile of the dK/dV kernel, on the warp's 16 keys and each 16-row chunk:
//   1. S^T = K.Q^T (K's A fragments held in registers, Q read as the col-major B);
//   2. P^T = exp(S^T * sm_scale - m) * (1/l) in the accumulator layout, with the
//      causal and edge masks; l, m and di staged per tile in shared memory;
//   3. P^T rounded to bf16 and repacked as A fragments, as the forward repacks P;
//   4. dV += P^T.dO, dO read by ldmatrix.trans;
//   5. dP^T = V.dO^T (V's A fragments in registers);
//   6. dS^T = (dP^T - di) * P^T * sm_scale, rounded to bf16 and repacked;
//   7. dK += dS^T.Q, Q read by ldmatrix.trans.
// Q and dO tiles are double-buffered by cp.async. The dQ kernel holds its
// rows' Q and dO A fragments and their l, m, di in registers and, per 16-key
// chunk of each key tile, computes S = Q.K^T, P, dP = dO.V^T, dS, then
// dQ += dS.K (K read by ldmatrix.trans); K and V tiles are double-buffered.
// Chunks that the causal mask or the sequence ends empty are skipped whole;
// a skipped chunk adds exact zeros, so nothing changes but the time.
//
// The order of roundings is upstream's, as the scalar kernels and the plain
// versions (kernels/flash_attention.py:_p_ds): s = (q.k in f32) * sm_scale; p =
// exp(s - m) * (1/l) in f32; p rounded to bf16 before P^T.dO; dS = (dP - di) *
// p * sm_scale in f32 (each product rounded, __fmul_rn, so none fuses into an
// FMA), rounded to bf16 before dS^T.Q and dS.K; every gradient accumulated in
// f32 and rounded once. Masked entries (col > row when causal, rows past sq,
// keys past sk) get p and dS exactly 0. The order of the f32 additions inside
// an mma is the hardware's: the gate holds this kernel to the plain version
// within FLASH_BWD_RTOL * (|ref| + A) + E, E being the term dP's summation
// order adds (kernels/flash_attention.py::flash_attention_bwd_order_bound).
//
// Columns past head_dim and rows past the sequence are zero-filled by the
// copies, so head_dim is padded with zeros to D = 64 or 128, as in the forward.

#include "mma_common.cuh"

namespace {

constexpr int kBT = 64;  // rows of a q tile, keys of a k/v tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 16 keys (dK/dV) or rows (dQ) per warp
constexpr int kMaxHeadDim = 128;

// per-SM blocks at head_dim D: caps the registers (at 128 threads a block:
// 168 for 3, 128 for 4, 255 for 2), within the shared memory of that many.
// The dQ kernel at head_dim 64 measured ~5% faster at 3 (no spill) than at 4
// (128 registers, 20 bytes spilled); at head_dim 128 both kernels spill a little.
template <int D>
struct Bwd {
  static constexpr int kDkvMinBlocks = D <= 64 ? 3 : 2;
  static constexpr int kDqMinBlocks = D <= 64 ? 3 : 2;
  static constexpr int kTile = kBT * (D + kPad);  // bf16 per shared tile
  // K, V, then Q and dO twice each; 1/l, m, di twice
  static constexpr size_t kDkvSmem = 6 * kTile * sizeof(bf16) + 2 * 3 * kBT * sizeof(float);
  // Q, dO, then K and V twice each
  static constexpr size_t kDqSmem = 6 * kTile * sizeof(bf16);
};

// Everything one launch reads and writes. q/k/v/dout/dq/dk/dv: [batch, heads,
// seq, d] at their strides; l, m, di: [batch * heads, sq] f32, contiguous.
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* l;
  const float* m;
  const float* di;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int heads, sq, sk, d;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float sm_scale;
  int causal;
};

// 1/l, m and di of q row `row` of the (batch, head) whose rows start at stat0;
// zeros past the last row
__device__ __forceinline__ void row_stats(float (&st)[3], const Args& a, int64_t stat0,
                                          int row) {
  const bool in = row < a.sq;
  st[0] = in ? 1.0f / a.l[stat0 + row] : 0.0f;
  st[1] = in ? a.m[stat0 + row] : 0.0f;
  st[2] = in ? a.di[stat0 + row] : 0.0f;
}

// p = exp(s * sm_scale - m) * inv_l in upstream's order of roundings
__device__ __forceinline__ float prob(float s, float sm_scale, float m, float inv_l) {
  return __fmul_rn(__expf(__fmul_rn(s, sm_scale) - m), inv_l);
}

// dS = (dP - di) * p * sm_scale, each product rounded
__device__ __forceinline__ float dscore(float dp, float di, float p, float sm_scale) {
  return __fmul_rn(__fmul_rn(dp - di, p), sm_scale);
}

// The warp's 16 rows of an f32 accumulator [16][D] (C fragments acc[NO][4])
// rounded to bf16, staged through the warp's own 16 rows of a shared tile
// `st`, and stored with 16-byte writes to rows r0 .. r0 + 15 of a [n, d]
// matrix at row stride ss
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ss, int r0, int n, int d,
                                           bf16* st, const float (&acc)[D / 8][4], int lane) {
  constexpr int LD = D + kPad;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(st + (g + 8 * i) * LD + j * 8 + 2 * tg) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e / kChunks, c = e % kChunks;
    if (r0 + r < n && c * 8 < d) {
      *reinterpret_cast<uint4*>(dst + (r0 + r) * ss + c * 8) =
          *reinterpret_cast<const uint4*>(st + r * LD + c * 8);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Bwd<D>::kDkvMinBlocks)
flash_attention_bwd_dkv_mma_kernel(Args a) {
  constexpr int LD = D + kPad;    // bf16 per shared row
  constexpr int TILE = Bwd<D>::kTile;
  constexpr int KD = D / 16;      // 16-wide head_dim steps of S^T and dP^T
  constexpr int NO = D / 8;       // 8-wide column blocks of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kBT][LD]; dK's staging at the end
  bf16* Vs = Ks + TILE;                           // [kBT][LD]; dV's staging at the end
  bf16* Qs = Vs + TILE;                           // [2][kBT][LD]
  bf16* dOs = Qs + 2 * TILE;                      // [2][kBT][LD]
  float* Sts = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][3][kBT]: 1/l, m, di

  const int ntk = (a.sk + kBT - 1) / kBT;
  const int kt = static_cast<int>(blockIdx.x % ntk);  // causal: the longest loops start first
  const int bh = static_cast<int>(blockIdx.x / ntk);
  const int b = bh / a.heads, h = bh % a.heads;
  const int k0 = kt * kBT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16;          // the warp's first key in the tile
  const int g = lane >> 2, tg = lane & 3;  // accumulator rows g, g + 8; columns 2 tg, 2 tg + 1
  // the row (of 8) and the 8-element half whose address this lane gives ldmatrix.x4
  const int lr = lane & 7, lh = (lane >> 3) & 1, lq = lane >> 4;

  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const bf16* dob = a.dout + b * a.dos.b + h * a.dos.h;
  const int64_t stat0 = static_cast<int64_t>(bh) * a.sq;
  const float scale = a.sm_scale;

  // the first q tile with a row that sees key k0 (row >= k0) when causal
  const int ntq = (a.sq + kBT - 1) / kBT;
  const int qt0 = a.causal ? k0 / kBT : 0;

  stage_tile<D, kBT, kThreads>(Ks, kb, a.ks.s, k0, a.sk, a.d, tid);
  stage_tile<D, kBT, kThreads>(Vs, vb, a.vs.s, k0, a.sk, a.d, tid);
  if (qt0 < ntq) {
    stage_tile<D, kBT, kThreads>(Qs, qb, a.qs.s, qt0 * kBT, a.sq, a.d, tid);
    stage_tile<D, kBT, kThreads>(dOs, dob, a.dos.s, qt0 * kBT, a.sq, a.d, tid);
    if (tid < kBT) {
      float st[3];
      row_stats(st, a, stat0, qt0 * kBT + tid);
#pragma unroll
      for (int x = 0; x < 3; ++x) Sts[x * kBT + tid] = st[x];
    }
  }
  cp_async_commit();

  uint32_t kf[KD][4], vf[KD][4];  // the warp's 16 keys of K and V as A fragments
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) dk[j][x] = dv[j][x] = 0.0f;
  }

  for (int qt = qt0; qt < ntq; ++qt) {
    const int cur = (qt - qt0) & 1;
    const bool next = qt + 1 < ntq;
    float nst[3];
    if (next) {  // the next tile's copies run while this one computes
      stage_tile<D, kBT, kThreads>(Qs + (cur ^ 1) * TILE, qb, a.qs.s, (qt + 1) * kBT, a.sq, a.d,
                                   tid);
      stage_tile<D, kBT, kThreads>(dOs + (cur ^ 1) * TILE, dob, a.dos.s, (qt + 1) * kBT, a.sq,
                                   a.d, tid);
      cp_async_commit();
      if (tid < kBT) row_stats(nst, a, stat0, (qt + 1) * kBT + tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (qt == qt0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        ldmatrix_x4(kf[kd], smem_addr(Ks + (wr + lr + 8 * lh) * LD + kd * 16 + 8 * lq));
        ldmatrix_x4(vf[kd], smem_addr(Vs + (wr + lr + 8 * lh) * LD + kd * 16 + 8 * lq));
      }
    }
    const bf16* Qt = Qs + cur * TILE;
    const bf16* dOt = dOs + cur * TILE;
    const float* st = Sts + cur * 3 * kBT;
    const int q0 = qt * kBT;
    const bool masked = q0 + kBT > a.sq || (a.causal && q0 < k0 + kBT - 1);

#pragma unroll
    for (int c = 0; c < kBT / 16; ++c) {  // the tile's 16-row chunks
      const int r0 = q0 + c * 16;
      // every (row, key) pair of the chunk and the warp's keys masked: nothing to add
      if (r0 >= a.sq || (a.causal && r0 + 15 < k0 + wr)) continue;
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys against the chunk's 16 rows
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) s[j][x] = dp[j][x] = 0.0f;
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t f[4];  // B fragments of row blocks 0 and 1
        ldmatrix_x4(f, smem_addr(Qt + (c * 16 + lr + 8 * lq) * LD + kd * 16 + 8 * lh));
        mma_bf16(s[0], kf[kd], f[0], f[1]);
        mma_bf16(s[1], kf[kd], f[2], f[3]);
        ldmatrix_x4(f, smem_addr(dOt + (c * 16 + lr + 8 * lq) * LD + kd * 16 + 8 * lh));
        mma_bf16(dp[0], vf[kd], f[0], f[1]);
        mma_bf16(dp[1], vf[kd], f[2], f[3]);
      }
      // P^T and dS^T: accumulator rows are keys k0 + wr + g + 8 i, columns rows
      // r0 + 8 j + 2 tg + e
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = c * 16 + 8 * j + 2 * tg;
        const float2 il = *reinterpret_cast<const float2*>(st + r);
        const float2 mm = *reinterpret_cast<const float2*>(st + kBT + r);
        const float2 dd = *reinterpret_cast<const float2*>(st + 2 * kBT + r);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = prob(s[j][2 * i + e], scale, e ? mm.y : mm.x, e ? il.y : il.x);
            if (masked) {
              const int row = q0 + r + e, key = k0 + wr + g + 8 * i;
              if (row >= a.sq || (a.causal && key > row)) p = 0.0f;  // exactly 0
            }
            s[j][2 * i + e] = p;
            dp[j][2 * i + e] = dscore(dp[j][2 * i + e], e ? dd.y : dd.x, p, scale);
          }
        }
      }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 and
      // repacked as A fragments (16 keys x 16 rows); dO and Q by ldmatrix.trans
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const uint32_t da[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t f[4];  // B fragments of column blocks j and j + 1
        ldmatrix_x4_trans(f, smem_addr(dOt + (c * 16 + lr + 8 * lh) * LD + j * 8 + 8 * lq));
        mma_bf16(dv[j], pa, f[0], f[1]);
        mma_bf16(dv[j + 1], pa, f[2], f[3]);
        ldmatrix_x4_trans(f, smem_addr(Qt + (c * 16 + lr + 8 * lh) * LD + j * 8 + 8 * lq));
        mma_bf16(dk[j], da, f[0], f[1]);
        mma_bf16(dk[j + 1], da, f[2], f[3]);
      }
    }
    if (next && tid < kBT) {  // its readers were done at the previous tile's end
#pragma unroll
      for (int x = 0; x < 3; ++x) Sts[(cur ^ 1) * 3 * kBT + x * kBT + tid] = nst[x];
    }
    __syncthreads();  // every warp is done with this tile's buffers before they refill
  }

  // dK and dV rounded once, through the warp's own 16 rows of Ks and Vs. Every
  // thread's copies into K and V must have landed before a warp writes there,
  // also when no q tile ran (causal keys past the last row): the copies of a
  // warp's rows come from all the block's threads.
  cp_async_wait<0>();
  __syncthreads();
  bf16* dkb = a.dk + b * a.dks.b + h * a.dks.h;
  bf16* dvb = a.dv + b * a.dvs.b + h * a.dvs.h;
  store_rows<D>(dkb, a.dks.s, k0 + wr, a.sk, a.d, Ks + wr * LD, dk, lane);
  store_rows<D>(dvb, a.dvs.s, k0 + wr, a.sk, a.d, Vs + wr * LD, dv, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads, Bwd<D>::kDqMinBlocks)
flash_attention_bwd_dq_mma_kernel(Args a) {
  constexpr int LD = D + kPad;
  constexpr int TILE = Bwd<D>::kTile;
  constexpr int KD = D / 16;  // 16-wide head_dim steps of S and dP
  constexpr int NO = D / 8;   // 8-wide column blocks of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBT][LD]; dQ's staging at the end
  bf16* dOs = Qs + TILE;                          // [kBT][LD]
  bf16* Ks = dOs + TILE;                          // [2][kBT][LD]
  bf16* Vs = Ks + 2 * TILE;                       // [2][kBT][LD]

  const int ntq = (a.sq + kBT - 1) / kBT;
  const int qt = ntq - 1 - static_cast<int>(blockIdx.x % ntq);  // causal: longest first
  const int bh = static_cast<int>(blockIdx.x / ntq);
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = qt * kBT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16;          // the warp's first row in the tile
  const int g = lane >> 2, tg = lane & 3;  // accumulator rows g, g + 8; columns 2 tg, 2 tg + 1
  const int lr = lane & 7, lh = (lane >> 3) & 1, lq = lane >> 4;

  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const bf16* dob = a.dout + b * a.dos.b + h * a.dos.h;
  const int64_t stat0 = static_cast<int64_t>(bh) * a.sq;
  const float scale = a.sm_scale;

  // keys this tile's rows can see: all of them, or col <= last row when causal
  const int q_last = (q0 + kBT < a.sq ? q0 + kBT : a.sq) - 1;
  const int k_end = a.causal ? (q_last + 1 < a.sk ? q_last + 1 : a.sk) : a.sk;
  const int ntk = (k_end + kBT - 1) / kBT;
  const int w_last = q0 + wr + 15;  // the warp's last row

  stage_tile<D, kBT, kThreads>(Qs, qb, a.qs.s, q0, a.sq, a.d, tid);
  stage_tile<D, kBT, kThreads>(dOs, dob, a.dos.s, q0, a.sq, a.d, tid);
  stage_tile<D, kBT, kThreads>(Ks, kb, a.ks.s, 0, a.sk, a.d, tid);
  stage_tile<D, kBT, kThreads>(Vs, vb, a.vs.s, 0, a.sk, a.d, tid);
  cp_async_commit();

  float st[2][3];  // 1/l, m, di of rows g and g + 8
  row_stats(st[0], a, stat0, q0 + wr + g);
  row_stats(st[1], a, stat0, q0 + wr + g + 8);

  uint32_t qf[KD][4], df[KD][4];  // the warp's 16 rows of Q and dO as A fragments
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int t = 0; t < ntk; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntk) {  // the next tile's copies run while this one computes
      stage_tile<D, kBT, kThreads>(Ks + (cur ^ 1) * TILE, kb, a.ks.s, (t + 1) * kBT, a.sk, a.d,
                                   tid);
      stage_tile<D, kBT, kThreads>(Vs + (cur ^ 1) * TILE, vb, a.vs.s, (t + 1) * kBT, a.sk, a.d,
                                   tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        ldmatrix_x4(qf[kd], smem_addr(Qs + (wr + lr + 8 * lh) * LD + kd * 16 + 8 * lq));
        ldmatrix_x4(df[kd], smem_addr(dOs + (wr + lr + 8 * lh) * LD + kd * 16 + 8 * lq));
      }
    }
    const bf16* Kt = Ks + cur * TILE;
    const bf16* Vt = Vs + cur * TILE;
    const int k0 = t * kBT;
    const bool masked = k0 + kBT > a.sk || (a.causal && k0 + kBT - 1 > q0);

#pragma unroll
    for (int c = 0; c < kBT / 16; ++c) {  // the tile's 16-key chunks
      const int c0 = k0 + c * 16;
      // every (row, key) pair of the warp's rows and the chunk masked: nothing to add
      if (c0 >= a.sk || (a.causal && c0 > w_last)) continue;
      // S = Q K^T and dP = dO V^T: the warp's 16 rows against the chunk's 16 keys
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) s[j][x] = dp[j][x] = 0.0f;
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t f[4];  // B fragments of key blocks 0 and 1
        ldmatrix_x4(f, smem_addr(Kt + (c * 16 + lr + 8 * lq) * LD + kd * 16 + 8 * lh));
        mma_bf16(s[0], qf[kd], f[0], f[1]);
        mma_bf16(s[1], qf[kd], f[2], f[3]);
        ldmatrix_x4(f, smem_addr(Vt + (c * 16 + lr + 8 * lq) * LD + kd * 16 + 8 * lh));
        mma_bf16(dp[0], df[kd], f[0], f[1]);
        mma_bf16(dp[1], df[kd], f[2], f[3]);
      }
      // P and dS on rows q0 + wr + g + 8 i, keys c0 + 8 j + 2 tg + e
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = prob(s[j][2 * i + e], scale, st[i][1], st[i][0]);
            if (masked) {
              const int row = q0 + wr + g + 8 * i, key = c0 + 8 * j + 2 * tg + e;
              if (key >= a.sk || (a.causal && key > row)) p = 0.0f;  // exactly 0
            }
            dp[j][2 * i + e] = dscore(dp[j][2 * i + e], st[i][2], p, scale);
          }
        }
      }
      // dQ += dS K: dS rounded to bf16 and repacked as A fragments (16 rows x
      // 16 keys); K by ldmatrix.trans
      const uint32_t da[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t f[4];  // B fragments of column blocks j and j + 1
        ldmatrix_x4_trans(f, smem_addr(Kt + (c * 16 + lr + 8 * lh) * LD + j * 8 + 8 * lq));
        mma_bf16(acc[j], da, f[0], f[1]);
        mma_bf16(acc[j + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with this tile's buffers before they refill
  }

  // dQ rounded once, through the warp's own 16 rows of Qs
  bf16* dqb = a.dq + b * a.dqs.b + h * a.dqs.h;
  store_rows<D>(dqb, a.dqs.s, q0 + wr, a.sq, a.d, Qs + wr * LD, acc, lane);
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

// the shapes and the inputs' 16-byte rows that both kernels need
bool bad_args(const Args& a, int batch) {
  return batch < 0 || a.heads < 1 || a.sq < 0 || a.sk < 1 || a.d < 8 || a.d > kMaxHeadDim ||
         a.d % 8 != 0 || (a.sq > 0 && (a.l == nullptr || a.m == nullptr || a.di == nullptr)) ||
         !rows_aligned(a.q, a.qs, batch, a.heads, a.sq) ||
         !rows_aligned(a.k, a.ks, batch, a.heads, a.sk) ||
         !rows_aligned(a.v, a.vs, batch, a.heads, a.sk) ||
         !rows_aligned(a.dout, a.dos, batch, a.heads, a.sq);
}

}  // namespace

extern "C" {

// dK and dV. bf16 q/dout: [batch, heads, sq, d], k/v/dk/dv: [batch, heads, sk,
// d], each given by its batch, head and sequence strides in elements (the
// head_dim stride is 1); d a multiple of 8 up to 128 and every row 16-byte
// aligned, else cudaErrorInvalidValue; l, m, di: [batch * heads, sq] f32,
// contiguous. Every key's row of dk and dv is written (zero where no query sees
// it). Launches on `stream`, allocates nothing.
int tft_flash_attention_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                    const void* dout, const float* l, const float* m,
                                    const float* di, void* dk, void* dv, int batch, int heads,
                                    int sq, int sk, int d, int64_t q_sb, int64_t q_sh,
                                    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb,
                                    int64_t do_sh, int64_t do_ss, int64_t dk_sb, int64_t dk_sh,
                                    int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                                    float sm_scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, m, di, nullptr,
               static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, sq, sk, d,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {do_sb, do_sh, do_ss}, {0, 0, 0}, {dk_sb, dk_sh, dk_ss}, {dv_sb, dv_sh, dv_ss},
               sm_scale, causal};
  if (bad_args(a, batch) || !rows_aligned(dk, a.dks, batch, heads, sk) ||
      !rows_aligned(dv, a.dvs, batch, heads, sk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = static_cast<int64_t>(batch) * heads * ((sk + kBT - 1) / kBT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = d <= 64 ? launch(flash_attention_bwd_dkv_mma_kernel<64>, Bwd<64>::kDkvSmem, blocks, a, st)
                : launch(flash_attention_bwd_dkv_mma_kernel<128>, Bwd<128>::kDkvSmem, blocks, a,
                         st);
  return static_cast<int>(err);
}

// dQ. Shapes, strides and rules as tft_flash_attention_bwd_dkv_mma; dq like q.
int tft_flash_attention_bwd_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                                   const float* l, const float* m, const float* di, void* dq,
                                   int batch, int heads, int sq, int sk, int d, int64_t q_sb,
                                   int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                                   int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb,
                                   int64_t dq_sh, int64_t dq_ss, float sm_scale, int causal,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, m, di,
               static_cast<bf16*>(dq), nullptr, nullptr, heads, sq, sk, d,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {do_sb, do_sh, do_ss}, {dq_sb, dq_sh, dq_ss}, {0, 0, 0}, {0, 0, 0},
               sm_scale, causal};
  if (bad_args(a, batch) || !rows_aligned(dq, a.dqs, batch, heads, sq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = static_cast<int64_t>(batch) * heads * ((sq + kBT - 1) / kBT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = d <= 64 ? launch(flash_attention_bwd_dq_mma_kernel<64>, Bwd<64>::kDqSmem, blocks, a, st)
                : launch(flash_attention_bwd_dq_mma_kernel<128>, Bwd<128>::kDqSmem, blocks, a,
                         st);
  return static_cast<int>(err);
}

}  // extern "C"
