// Device pieces shared by the tensor-core flash kernels (sm_90a):
// flash_attention_mma.cu (the forward) and flash_attention_bwd_mma.cu (dK/dV
// and dQ). bf16 tiles staged in shared memory by 16-byte cp.async copies into
// rows padded by 16 bytes, ldmatrix fragments (plain and transposed), mma.sync
// m16n8k16 bf16 with f32 accumulators, and the repack of two f32 accumulator
// values into one bf16x2 register of an A-fragment.
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
