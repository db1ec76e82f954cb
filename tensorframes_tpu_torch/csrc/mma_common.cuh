// Device pieces shared by the tensor-core kernels (sm_90a):
// flash_attention_mma.cu (the forward), flash_attention_bwd_mma.cu (dK/dV
// and dQ) and int8_matmul_mma.cu, and by decode_attention.cu. bf16 tiles
// staged in shared memory by 16-byte cp.async copies into rows padded by 16
// bytes; mbarriers and the copy engine's bulk copies (TMA); ldmatrix
// fragments (plain and transposed); the exact widening of int8 to f32;
// mma.sync m16n8k16 bf16 with f32 accumulators, and the repack of two f32
// accumulator values into one bf16x2 register of an A-fragment.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, tg = lane % 4):
//   A (16 x 16, row-major):  a[0] (row g,     cols 2tg, 2tg+1), a[1] (row g + 8, same),
//                            a[2] (row g, cols 8 + 2tg, +1),   a[3] (row g + 8, same);
//   B (16 x 8, col-major):   b0 (k 2tg, 2tg+1; col g), b1 (k 8 + 2tg, +1; col g);
//   C (16 x 8, f32):         c[0], c[1] (row g, cols 2tg, 2tg+1), c[2], c[3] (row g + 8).
// So the C fragments of two adjacent 8-column blocks, rounded to bf16, are the
// A fragment of the 16 x 16 block they form (pack_bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPad = 8;  // bf16 of padding per shared row (16 bytes)

using bf16 = __nv_bfloat16;

struct Strides {
  int64_t b, h, s;  // elements; the head_dim stride is 1
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; when !in, reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// mbarriers that count one arrival and the bytes of asynchronous copies (TMA)
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of the barrier's current phase, which then waits for `bytes`
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// before asynchronous copies overwrite shared memory that threads have read
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine, counted on the barrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ldmatrix.x2.trans: lanes 0-15 address the rows of two 8 x 8 b16 matrices
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// the four int8 of a word widened exactly to f32, byte i to f[i]: the float
// 2^23 + (b + 128), built from the byte's bits, minus 2^23 + 128 (an integer
// of magnitude <= 128, so its low 16 bits are 0 and it is also exact in bf16)
__device__ __forceinline__ void widen_s8x4(uint32_t r, float (&f)[4]) {
  const uint32_t u = r ^ 0x80808080u;  // each byte b + 128
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
}

// c += a.b for a 16 x 16 bf16 A (row-major fragments) and a 16 x 8 bf16 B
// (col-major), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows r0 .. r0 + ROWS - 1 of a [n, d] matrix (row stride ss) into a
// [ROWS][D + kPad] shared tile by a block of THREADS threads; rows past n and
// columns past d become zeros
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int64_t ss, int r0, int n,
                                           int d, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / kChunks, c = e % kChunks;
    const bool in = r0 + r < n && c * 8 < d;
    const bf16* p = in ? src + (r0 + r) * ss + c * 8 : src;
    cp_async16(smem_addr(dst + r * (D + kPad) + c * 8), p, in);
  }
}

// 16-byte rows: the pointer 16-byte aligned and every stride (of a dim longer
// than 1) a multiple of 8 bf16
bool rows_aligned(const void* p, const Strides& s, int batch, int heads, int seq) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (batch < 2 || s.b % 8 == 0) &&
         (heads < 2 || s.h % 8 == 0) && (seq < 2 || s.s % 8 == 0);
}

}  // namespace
