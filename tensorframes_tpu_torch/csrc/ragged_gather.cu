// Ragged row gather for Hopper (sm_90a): stage one shape group of ragged
// map_rows cells from a flat device buffer into a dense [g, length] batch.
//
// Replaces the Pallas TPU kernel tensorframes_tpu/kernels/ragged_gather.py
// (ragged_gather_rows), which walks the group's rows on a sequential grid
// and DMAs each row's slice out of HBM at a scalar-prefetched int32 start
// offset. Padding rows carry offset 0 and re-read the first cell.
//
// What bounds it on the H100: bytes. Pure data movement — each output byte
// is read once from the flat buffer and written once; g * length * elem
// bytes each way.
//
// Design: one warp per output row, no carried state. Lanes copy the row
// with 16-byte vector loads and stores when the source, the destination and
// the row length are 16-byte aligned, else 4-byte words when those are
// 4-byte aligned, else bytes — so the copy is bit-exact for every dtype.
// A row whose start falls outside the buffer is written as zeros (the
// Python wrapper validates host-side offsets before they get here).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
ragged_gather_kernel(const uint8_t* __restrict__ flat, int64_t flat_bytes,
                     const int32_t* __restrict__ starts, int g, int64_t row_bytes, int elem_size,
                     uint8_t* __restrict__ out) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= g) return;
  const int64_t start = static_cast<int64_t>(starts[row]) * elem_size;
  uint8_t* dst = out + static_cast<int64_t>(row) * row_bytes;
  if (start < 0 || start + row_bytes > flat_bytes) {
    for (int64_t b = lane; b < row_bytes; b += 32) dst[b] = 0;
    return;
  }
  const uint8_t* src = flat + start;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(row_bytes);
  if ((align & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t i = lane; i < row_bytes / 16; i += 32) d4[i] = s4[i];
  } else if ((align & 3) == 0) {
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d1 = reinterpret_cast<uint32_t*>(dst);
    for (int64_t i = lane; i < row_bytes / 4; i += 32) d1[i] = s1[i];
  } else {
    for (int64_t i = lane; i < row_bytes; i += 32) dst[i] = src[i];
  }
}

}  // namespace

extern "C" {

// flat: [total] elements of elem_size bytes; starts: [g] int32 element
// offsets; out: [g, length] elements.
int tft_ragged_gather(const void* flat, int64_t total, const int32_t* starts, int g, int length,
                      int elem_size, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g < 0 || length < 1 || elem_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (g == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (g + kRowsPerBlock - 1) / kRowsPerBlock;
  ragged_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flat), total * elem_size, starts, g,
      static_cast<int64_t>(length) * elem_size, elem_size, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
