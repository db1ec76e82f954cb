// Int8-weight matmul on Hopper's tensor cores (sm_90a), for bf16 x:
// out[m, n] = (x[m, k] @ q[k, n]) * scale[n], q int8, scale f32 per output
// channel, f32 sums, the scale on the f32 sum and one rounding to bf16.
//
// Replaces the Pallas TPU kernel tensorframes_tpu/ops/quantize.py
// (matmul_pallas_int8), which streams each int8 weight tile HBM->VMEM, widens
// it right before the MXU dot and accumulates over k in f32. f32 x, and
// shapes whose rows a tensor map cannot take (k % 8, n % 16, 16-byte
// alignment), keep the scalar kernel (int8_matmul.cu);
// ops/quantize.py::int8_matmul_build chooses.
//
// What bounds it on the H100: bytes, and at the decode server's m (1-128
// rows) the latency of getting them. A gpt_small layer's four products read
// 7.1 MB of int8 weight, ~2 us at 3.35 TB/s, while one output tile per block
// over all of k (the scalar kernel) puts only 12-48 blocks on 132 SMs, each
// waiting on one 4 KB load at a time.
//
// Design:
// - Split-k over a thread-block cluster. The grid is (splits, n / 32,
//   m / BM); the `splits` blocks of one 32-channel output tile form one
//   cluster, each summing its own k-chunk. The chunk is a function of (k, n)
//   only (int8_matmul_split in ops/quantize.py), chosen so that every gpt_small
//   product at m <= 16 puts at least 132 blocks on the card.
// - Bytes in flight: one thread per block hands the copy engine (TMA) each
//   64-deep k-tile of the chunk as two 2-D boxes, x's [BM][64] bf16 (rows
//   128-byte swizzled, so ldmatrix reads them without bank conflicts) and the
//   weight's [64][32] int8, into a ring of shared-memory stages, each with its
//   own mbarrier; the whole ring is issued before anyone waits, so at m <= 16
//   every gpt_small chunk (<= 512 rows) is in flight at once, and each tile is
//   used as it lands. Rows past the tensor arrive as zeros. The weight
//   crosses HBM as int8. (16-byte cp.async copies from every thread kept too
//   few bytes in flight per SM: the chunk arrived at ~6 bytes a cycle.)
// - Tensor cores, swapped: the weight is the mma's A (16 output channels as
//   its rows), x its B (8 tokens as its columns), so m = 1 wastes 7 of 8
//   columns and not 15 of 16 rows. ldmatrix.x2.trans reads the int8 tile as
//   pairs of bytes; each register then holds k-pairs of two neighbouring
//   channels, which become the A rows g (even channel) and g + 8 (odd
//   channel) after an exact widening to bf16 (|q| <= 127: a float built
//   from the byte's bits minus a constant, then its upper half). x's B
//   fragments come from ldmatrix.x4. bf16 mma.sync m16n8k16, f32 sums:
//   every bf16 product is exact in f32, so only the order of the sums
//   differs from the plain version.
// - Four k-groups: warp w takes channels 16 (w & 1) .. + 15 and the 16-deep
//   step w >> 1 of every 64-row stage, so each stage is one mma step per
//   warp; a block's partial is its k-groups added in order 0, 1, 2, 3.
// - A fixed reduction order, no float atomics, no workspace: block r owns
//   1/splits of the tile's elements; every block pushes its f32 partial of
//   each element into the owner's shared memory over the cluster's
//   distributed shared memory, and after one cluster barrier the owner adds
//   the splits in order 0, 1, ..., splits - 1, multiplies by the scale and
//   rounds once. One launch per call.
// - A row's bits depend on neither m nor the row's place: the partition and
//   every order of sums are functions of (k, n); an mma computes each output
//   from its own row of x. BM (16 or 64 tokens a block) follows m and
//   changes how many tokens share a block, not what any token's sums are.

#include <cooperative_groups.h>
#include <cuda.h>

#include "mma_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTN = 32;            // output channels per block: two 16-row A tiles
constexpr int kBK = 64;            // k rows per ring stage: four 16-deep mma steps
constexpr int kKG = kBK / 16;      // k-groups: step i of every stage sums into group i
constexpr int kThreads = 256;      // warp w: channels 16 (w & 1) .. + 15, k-group w >> 1
constexpr int kMaxSplits = 8;      // the portable cluster size

template <int BM>
struct Cfg {
  static constexpr int kStages = BM <= 16 ? 8 : 4;
  static constexpr int kXBytes = BM * kBK * 2;  // x tile [BM][64] bf16, 128-byte swizzled rows
  static constexpr int kWBytes = kBK * kTN;     // weight tile [64][32] int8, dense
  static constexpr int kStageBytes = kXBytes + kWBytes;  // a multiple of 1024: x stays aligned
  static constexpr int kRing = kStages * kStageBytes;    // the ring, later the k-groups' partials
  // 1024 bytes of alignment slack, the ring, the partials the other splits
  // push here ([splits][per] <= BM * kTN + kMaxSplits), the scales, the barriers
  static constexpr int kSmem = 1024 + kRing + (BM * kTN + kMaxSplits + kTN) * 4 + kStages * 8;
  static constexpr int kPairs = BM / 16;  // 16-token column pairs per warp
  static_assert(kKG * BM * kTN * 4 <= kRing, "the partials must fit in the ring");
  static_assert(kStageBytes % 1024 == 0, "128-byte swizzled tiles need 1024-byte alignment");
};

// a cluster barrier in two halves: arrive (no ordering) early, wait late
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// a 2-D box of a tensor map (coordinates innermost first) into shared memory,
// counted on the barrier; parts of the box outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the four int8 of r (bytes: (k, c), (k, c + 1), (k + 1, c), (k + 1, c + 1))
// widened exactly to bf16 pairs: even = (k, c), (k + 1, c); odd = the same at c + 1
// (the bf16 of each is its f32's upper half)
__device__ __forceinline__ void widen_pairs(uint32_t r, uint32_t& even, uint32_t& odd) {
  float f[4];
  widen_s8x4(r, f);
  even = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  odd = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_mma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const float* __restrict__ scale, bf16* __restrict__ out, int m, int k,
                       int n, int chunk) {
  using C = Cfg<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring starts on a 1024-byte boundary of the shared window
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* part = reinterpret_cast<float*>(smem);  // after the loop: [kKG][BM][kTN]
  float* recv = reinterpret_cast<float*>(smem + C::kRing);  // [splits][per], pushed here
  float* ssc = recv + BM * kTN + kMaxSplits;                 // [kTN] scales
  const uint32_t bars = smem_addr(ssc + kTN);                // [kStages] 8-byte barriers
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // waited on before the first push into another block

  const int split = blockIdx.x;  // the block's rank in its cluster of gridDim.x
  const int splits = gridDim.x;
  const int n0 = blockIdx.y * kTN;
  const int m0 = blockIdx.z * BM;
  const int kbeg = split * chunk;
  const int kend = min(k, kbeg + chunk);
  const int tiles = (kend - kbeg + kBK - 1) / kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto stage_x = [&](int s) { return smem + s * C::kStageBytes; };
  auto stage_w = [&](int s) { return smem + s * C::kStageBytes + C::kXBytes; };
  // k-tile t of the chunk into ring stage t % kStages by one thread: x's
  // [BM][64] box and the weight's [64][32] box; rows past the tensor are zeros
  auto load = [&](int t) {
    const int s = t % C::kStages;
    const int kt = kbeg + t * kBK;
    const uint32_t bar = bars + 8 * s;
    mbar_expect_tx(bar, C::kStageBytes);
    tma_load_2d(smem_addr(stage_x(s)), &map_x, kt, m0, bar);
    tma_load_2d(smem_addr(stage_w(s)), &map_w, n0, kt, bar);
  };
  // tile t's 16-deep step of k-group kg (warp-uniform; steps past the
  // chunk's end belong to the next split and are skipped)
  auto step = [&](int t, int kg, int cg16, float (&acc)[C::kPairs][2][4]) {
    const int kk = 16 * kg;
    if (kbeg + t * kBK + kk >= kend) return;
    const uint32_t ws = smem_addr(stage_w(t % C::kStages));
    const uint32_t xs = smem_addr(stage_x(t % C::kStages));
    // A: two 8 x 8 b16 matrices, k rows kk .. kk + 7 and kk + 8 .. kk + 15
    uint32_t w2[2], a[4];
    ldmatrix_x2_trans(w2, ws + (kk + (lane & 15)) * kTN + cg16);
    widen_pairs(w2[0], a[0], a[1]);
    widen_pairs(w2[1], a[2], a[3]);
#pragma unroll
    for (int p = 0; p < C::kPairs; ++p) {
      const int tok = 16 * p;
      if (m0 + tok >= m) break;  // no token of this pair exists
      // B: tokens tok .. + 7 and tok + 8 .. + 15, k kk .. + 7 and kk + 8 .. + 15;
      // x rows are 128 bytes with their 16-byte chunks swizzled by (row % 8)
      const int row = tok + (lane & 7) + 8 * (lane >> 4);
      const int chunk16 = (kk >> 3) + ((lane >> 3) & 1);
      uint32_t b[4];
      ldmatrix_x4(b, xs + row * 128 + ((chunk16 ^ (row & 7)) << 4));
      mma_bf16(acc[p][0], a, b[0], b[1]);
      if (m0 + tok + 8 < m) mma_bf16(acc[p][1], a, b[2], b[3]);
    }
  };

  float acc[C::kPairs][2][4];
#pragma unroll
  for (int p = 0; p < C::kPairs; ++p) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[p][i / 4][i % 4] = 0.0f;
  }
  const int cg16 = 16 * (warp & 1);  // the warp's 16 channels within the block's 32
  const int kg = warp >> 1;           // its 16 k rows within each stage

  if (tid == 0) {
    const uint64_t maps[2] = {reinterpret_cast<uint64_t>(&map_x),
                              reinterpret_cast<uint64_t>(&map_w)};
    for (const uint64_t map : maps) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
    }
    for (int s = 0; s < C::kStages; ++s) mbar_init(bars + 8 * s);
    for (int t = 0; t < tiles && t < C::kStages; ++t) load(t);  // the whole ring in flight
  }
  const float my_scale = tid < kTN && n0 + tid < n ? scale[n0 + tid] : 0.0f;  // used late
  __syncthreads();  // the barriers are initialised
  for (int t = 0; t < tiles; ++t) {
    mbar_wait(bars + 8 * (t % C::kStages), (t / C::kStages) & 1);  // tile t has landed
    step(t, kg, cg16, acc);
    if (t + C::kStages < tiles) {
      __syncthreads();  // every warp is done with the stage before it is refilled
      if (tid == 0) {
        fence_proxy_async();
        load(t + C::kStages);
      }
    }
  }
  if (tid < kTN) ssc[tid] = my_scale;
  __syncthreads();  // the ring is drained and read: it takes the k-groups' partials

  // each k-group's partial tile, token-major: C rows g / g + 8 are channels
  // 2g / 2g + 1, C columns 2tg / 2tg + 1 tokens
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int p = 0; p < C::kPairs; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = 16 * p + 8 * h + 2 * tg;
      float* dst = part + (kg * BM + tok) * kTN + cg16 + 2 * g;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[p][h][0], acc[p][h][2]);
      *reinterpret_cast<float2*>(dst + kTN) = make_float2(acc[p][h][1], acc[p][h][3]);
    }
  }
  __syncthreads();
  // the block's partial (its k-groups in order 0, 1, 2, 3) of each of the
  // tile's elements, pushed to the split that owns the element: `per`
  // consecutive elements of the tile's valid rows each
  const int valid = min(BM, m - m0) * kTN;
  const int per = (valid + splits - 1) / splits;
  cluster_wait();  // every block of the cluster runs: its shared memory can be written
  for (int e = tid; e < valid; e += kThreads) {
    float sum = part[e];
#pragma unroll
    for (int i = 1; i < kKG; ++i) sum += part[i * BM * kTN + e];
    const int owner = e / per;
    cluster.map_shared_rank(recv, owner)[split * per + e - owner * per] = sum;
  }
  cluster.sync();  // every push has landed

  // the owned elements: the splits in order 0, 1, ..., the scale, one rounding
  const int e0 = split * per, e1 = min(valid, e0 + per);
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const int r = e / kTN, c = e % kTN;
    if (n0 + c >= n) continue;
    float sum = recv[e - e0];
    for (int s = 1; s < splits; ++s) sum += recv[s * per + e - e0];
    out[static_cast<int64_t>(m0 + r) * n + n0 + c] = __float2bfloat16_rn(sum * ssc[c]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the runtime's entry points
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a row-major [rows, cols] tensor read in [box_rows, box_cols] boxes
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
                int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM>
cudaError_t launch(const bf16* x, const int8_t* q, const float* scale, bf16* out, int m, int k,
                   int n, int chunk, int splits, cudaStream_t st) {
  auto kern = int8_matmul_mma_kernel<BM>;
  static bool smem_set[64];  // per device; a race only sets the attribute twice
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<BM>::kSmem);
    if (err != cudaSuccess) return err;
    if (device < 64) smem_set[device] = true;
  }
  CUtensorMap map_x, map_w;
  if (!tensor_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, BM, kBK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, k, n, kBK, kTN,
                  CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n + kTN - 1) / kTN, (m + BM - 1) / BM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<BM>::kSmem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, map_x, map_w, scale, out, m, k, n, chunk);
}

}  // namespace

extern "C" {

// x: [m, k] bf16, q: [k, n] int8, scale: [n] f32, out: [m, n] bf16, all
// row-major and contiguous; k % 8 == 0, n % 16 == 0 (rows whose strides a
// tensor map takes), x and q 16-byte aligned. chunk (a multiple of 32) is
// the k-rows of each split; the splits, ceil(k / chunk), must be at most 8.
int tft_int8_matmul_mma(const void* x, const void* q, const void* scale, void* out, int m, int k,
                        int n, int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = chunk > 0 ? (k + chunk - 1) / chunk : 0;
  if (m < 0 || k < 1 || n < 1 || k % 8 != 0 || n % 16 != 0 || chunk % 32 != 0 || splits < 1 ||
      splits > kMaxSplits || (n + kTN - 1) / kTN > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  const bf16* xx = static_cast<const bf16*>(x);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(scale);
  bf16* oo = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 16) {
    err = launch<16>(xx, qq, ss, oo, m, k, n, chunk, splits, st);
  } else {
    if ((m + 63) / 64 > 65535) return static_cast<int>(cudaErrorInvalidValue);
    err = launch<64>(xx, qq, ss, oo, m, k, n, chunk, splits, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
