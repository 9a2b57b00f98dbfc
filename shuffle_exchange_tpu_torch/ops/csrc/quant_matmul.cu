// Weight-only quantized matmul for Hopper (sm_90a): out [M, N] bf16 =
// x [M, K] bf16 @ dequantize(q, scales), behind a plain C interface loaded
// with ctypes (ops/_build.py builds this file with nvcc at first use).
//
// Replaces the TPU kernel
//   shuffle_exchange_tpu/ops/quant_matmul.py:_quant_matmul_pallas
// and, on the card, the JAX default path it stands beside (dequantize into
// the dot, which XLA fuses so the weights cross HBM at storage width).
// Storage formats (int8, packed int4, e4m3 fp8, f32 scales [K/gs, N]):
// see QFormat in mma_gemv.cuh.
//
// Rounding: each weight is dequantized as q * s in f32 and rounded to bf16
// before the product, the JAX default's rounding point; products are
// summed in f32 and the result cast once. The kernel then differs from
// quant_matmul_reference (ops/quant_matmul.py) in summation order only.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode rows
// the weight bytes, 1 byte an element (half of one for int4) plus 4 / gs
// of scales: 16.8 MB for Llama-3-8B's [4096, 4096] int8 wq, 5.0 us.
// Those rows (up to the wrapper's GEMV_ROWS) take mma_gemv_quant_kernel,
// the tensor-core GEMV of mma_gemv.cuh (shared with B6, B7 and B16's decode
// rows) over the one matrix: persistent blocks walk (row group of up to 16
// rows, K chunk of whole scale groups, 128-column tile) items, each warp
// streams its run of the chunk's stages through a TMA ring and multiplies
// x (the A operand) by bf16(q * s) (the B operand, the product in f32, the
// rounding point above) on mma.sync; a split chunk writes f32 partials
// that the tile's last block adds in split order, so two runs give equal
// bits. It replaced a split-K CUDA-core GEMV (64-column tiles, x staged as
// f32) that reached ~15% of the bytes bound and was slower at 8 rows than
// the wgmma form below at 64. Past GEMV_ROWS (extend chunks, mixed ticks,
// a put() of 8 prompts padded to 1024 = 8192 rows) the work turns to
// operations: 2 M K N
// flops, ~0.97 ms at M = 8192, K 4096, N 14336. Those rows take
// wg_qmatmul_kernel: the quantized grouped GEMM's block (wgmma_qgemm.cuh's
// qgemm_tile, shared with grouped_gemm.cu's B16) over the one matrix, its
// row tiles in the band raster. A 256 x 128 output tile a block (128 x 128,
// WgQGemmShort, where the call has at most 128 rows: the tile's products
// are half the tall tile's there, and one row tile spans the call either
// way; 15-25% faster on w_gate at 9-128 rows, on the H100); a producer
// warpgroup whose one thread TMA-loads x's [256][64] tiles and the raw
// one-byte [64][128] weight tiles with their scale rows, and whose three
// other warps widen each raw tile to bf16(q * s) (f32 product, the rounding
// of the default route above) in the 128-byte swizzle; two consumer
// warpgroups of m64n128k16 wgmmas. Packed int4 reads each 64-row logical
// step as four 16-row pieces of packed rows, each the low or high nibbles of
// one group half, so x's tile and the reduction order are int8's. The
// widening bounds the block (as it does B16's: the widened step is
// shared by 256 rows of products, the shared-memory stores and the
// conversions are the cost). Ragged M and N are zero-filled by TMA and
// masked at the store; nothing is padded on the host. A grid of fewer tiles
// than the card has SMs (256 chunk rows against wk's [4096, 1024] is 8
// tiles) splits K across blocks in whole 64-row steps: each split writes f32
// partials that quant_out_kernel adds in split order, so two runs give equal
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma_gemv.cuh"      // tcg:: the tensor-core GEMV of the decode rows, QFormat
#include "wgmma_qgemm.cuh"   // qgemm_tile, the raster (shared with B16)
#include "wgmma_tile.cuh"    // tile_map_3d, plain_map_3d

namespace {

// Block (tile b by the raster, split blockIdx.y): out (one split) or
// part[split] (several) over the split's steps of x @ widened(q).
template <int FMT, class Qs>
__global__ void __launch_bounds__(kWgBlockThreads, 1) wg_qmatmul_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap smap, int M, int K, int N, int gs, int row_tiles,
    int col_tiles, int split_steps, __nv_bfloat16* __restrict__ out, float* __restrict__ part) {
  int y, c;
  raster(blockIdx.x, row_tiles, col_tiles, y, c);
  const int s0 = blockIdx.y * split_steps;
  const int steps = min((K + Qs::BK - 1) / Qs::BK - s0, split_steps);
  float* pp = part == nullptr ? nullptr : part + size_t(blockIdx.y) * M * N;
  qgemm_tile<FMT, Qs>(&amap, &qmap, &smap, 0, y * Qs::BM, min(Qs::BM, M - y * Qs::BM),
                      c * Qs::BN, N, gs, s0, steps, out, pp, N);
}

// ---------------------------------------------------------------------------
// The decode rows: mma_gemv.cuh's tensor-core GEMV over the one matrix
// ---------------------------------------------------------------------------

// The items: (row group of up to 16 rows, split, 128-column tile), the
// tile fastest, so neighbouring blocks read neighbouring columns of the same
// weight rows.
struct QuantGemv {
  const __nv_bfloat16* x;
  const float* sc;
  const CUtensorMap* map;
  int items, M, N, K, gs, splits, chunk, tiles;
  static constexpr int parts = tcg::kWarps;   // each warp a part of the chunk

  __device__ int units(int item) const {
    return tcg::chunk_stages((item / tiles) % splits, chunk, K);
  }
  __device__ tcg::Geo geo(int item, int lane, int) const {
    const int rest = item / tiles;
    tcg::Geo g;
    g.map = map;
    g.tile = item % tiles;
    g.c0 = g.tile * tcg::kTileCols;
    g.batch = 0;
    g.s = sc;
    g.col = g.c0 + tcg::kLaneCols * (lane >> 2);
    g.col_ok = g.col < N;
    g.split = rest % splits;
    g.u0 = g.split * chunk / tcg::kStageRows;
    g.grp = rest / splits;
    g.row0 = g.grp * tcg::kRows;
    g.rows = min(tcg::kRows, M - g.row0);
    return g;
  }
  __device__ tcg::RowsPlain rows_of(const tcg::Geo& g) const {
    return {x + size_t(g.row0) * K, K, g.rows, K};
  }
  __device__ const float* fold_scales(const tcg::Geo&, int, int, int, int) const {
    return nullptr;
  }
};

// out [M, N] (bf16) = x [M, K] @ bf16(q * s): one split writes out, several
// write part [splits, M, N] and the last block of each (row group, tile)
// adds them in split order.
template <int FMT>
__global__ void __launch_bounds__(tcg::kThreads, 1) mma_gemv_quant_kernel(
    const __grid_constant__ CUtensorMap map, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ sc, int M, int K, int N, int gs, int splits, int chunk,
    float* __restrict__ part, int* __restrict__ counters, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tcg::Smem sm = tcg::smem_layout(smem_raw);
  const int tiles = (N + tcg::kTileCols - 1) / tcg::kTileCols;
  const int groups = (M + tcg::kRows - 1) / tcg::kRows;
  const QuantGemv p{x, sc, &map, groups * splits * tiles, M, N, K, gs, splits, chunk, tiles};
  auto done = [&](int, const tcg::Geo& g, const float (&acc)[16][4]) {
    tcg::store_sums<FMT>(sm, g, acc, N, M, splits, part, counters, out);
  };
  tcg::run<FMT, true, false>(p, sm, [] {}, done);
}

template <int FMT>
cudaError_t launch_gemv(cudaStream_t s, const __nv_bfloat16* x, const void* q, const float* sc,
                        __nv_bfloat16* out, float* part, int* counters, int M, int K, int N,
                        int gs, int splits, int chunk, int blocks) {
  CUtensorMap map;
  cudaError_t err = tcg::weight_map<FMT>(&map, q, 1, K, N);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mma_gemv_quant_kernel<FMT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, tcg::kSmemBytes);
  if (err != cudaSuccess) return err;
  mma_gemv_quant_kernel<FMT><<<blocks, tcg::kThreads, tcg::kSmemBytes, s>>>(
      map, x, sc, M, K, N, gs, splits, chunk, part, counters, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Past the decode rows: the quantized wgmma block
// ---------------------------------------------------------------------------

// Sum of split partials [S, B, N] in split order, cast to bf16.
__global__ void quant_out_kernel(const float* __restrict__ part, int S, int B, int N,
                                 __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += part[size_t(s) * B * N + i];
  out[i] = __float2bfloat16(sum);
}

template <int FMT, class Qs>
cudaError_t launch_wg(cudaStream_t s, const void* x, const void* q, const void* sc,
                      __nv_bfloat16* out, float* part, int M, int K, int N, int gs, int splits,
                      int split_steps) {
  const int row_tiles = (M + Qs::BM - 1) / Qs::BM, col_tiles = (N + Qs::BN - 1) / Qs::BN;
  if ((long long)row_tiles * col_tiles > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap am, qm, sm;
  cudaError_t err = tile_map_3d(&am, x, 1, M, K, Qs::BM);
  if (err == cudaSuccess)
    err = FMT == kQInt4 ? plain_map_3d(&qm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2, N,
                                       Qs::PIECE, Qs::BN)
                        : plain_map_3d(&qm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, Qs::BK,
                                       Qs::BN);
  if (err == cudaSuccess)
    err = plain_map_3d(&sm, sc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, K / gs, N, Qs::SC_ROWS,
                       Qs::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wg_qmatmul_kernel<FMT, Qs>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Qs::SMEM);
  if (err != cudaSuccess) return err;
  wg_qmatmul_kernel<FMT, Qs><<<dim3(row_tiles * col_tiles, splits), kWgBlockThreads, Qs::SMEM,
                               s>>>(am, qm, sm, M, K, N, gs, row_tiles, col_tiles, split_steps,
                                    out, part);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sxt_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [M, N] bf16 = x [M, K] bf16 @ (q * scales) with format fmt (0 int8,
// 1 packed int4, 2 e4m3) and group size gs. M <= gemv_rows runs the
// tensor-core GEMV on `blocks` persistent blocks over `splits` chunks of
// `chunk` rows (whole scale groups); with several splits, f32 partials in
// part [splits, M, N] and counters [ceil(M / 16) * ceil(N / 128)] int32,
// zero between calls (the kernel leaves them zero). Larger M runs the
// wgmma kernel (on 128-row tiles up to 128 rows, 256-row tiles past them)
// over `splits` chunks of `chunk` rows (whole 64-row steps; partials in
// part where splits > 1; counters and blocks unused). Needs K % gs == 0,
// gs % 32 == 0, N % 16 == 0 and 16-byte aligned bases.
int sxt_quant_matmul_bf16(const void* x, const void* q, const void* scales, void* out,
                          void* part, void* counters, int M, int K, int N, int gs, int fmt,
                          int splits, int chunk, int blocks, int gemv_rows, void* stream) {
  if (M <= 0) return 0;
  if (gs < 32 || gs % 32 || K % gs || N % 16 || fmt < 0 || fmt > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M <= gemv_rows) {
    if (splits < 1 || chunk < 1 || chunk % gs || (long long)splits * chunk < K ||
        (long long)(splits - 1) * chunk >= K || blocks < 1 ||
        (splits > 1 && (part == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto* sp = static_cast<const float*>(scales);
    auto* pp = static_cast<float*>(part);
    auto* cp = static_cast<int*>(counters);
    cudaError_t err;
    if (fmt == kQInt8)
      err = launch_gemv<kQInt8>(s, xp, q, sp, op, pp, cp, M, K, N, gs, splits, chunk, blocks);
    else if (fmt == kQInt4)
      err = launch_gemv<kQInt4>(s, xp, q, sp, op, pp, cp, M, K, N, gs, splits, chunk, blocks);
    else
      err = launch_gemv<kQFp8>(s, xp, q, sp, op, pp, cp, M, K, N, gs, splits, chunk, blocks);
    return static_cast<int>(err);
  }
  constexpr int BK = WgQGemm::BK;
  if (chunk % BK || splits < 1 || splits > 65535 || (long long)splits * chunk < K ||
      (long long)(splits - 1) * chunk >= K || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  cudaError_t err;
  const int ss = chunk / BK;
  if (M <= WgQGemmShort::BM) {   // one short row tile spans the call
    if (fmt == kQInt8)
      err = launch_wg<kQInt8, WgQGemmShort>(s, x, q, scales, op, pp, M, K, N, gs, splits, ss);
    else if (fmt == kQInt4)
      err = launch_wg<kQInt4, WgQGemmShort>(s, x, q, scales, op, pp, M, K, N, gs, splits, ss);
    else
      err = launch_wg<kQFp8, WgQGemmShort>(s, x, q, scales, op, pp, M, K, N, gs, splits, ss);
  } else {
    if (fmt == kQInt8)
      err = launch_wg<kQInt8, WgQGemm>(s, x, q, scales, op, pp, M, K, N, gs, splits, ss);
    else if (fmt == kQInt4)
      err = launch_wg<kQInt4, WgQGemm>(s, x, q, scales, op, pp, M, K, N, gs, splits, ss);
    else
      err = launch_wg<kQFp8, WgQGemm>(s, x, q, scales, op, pp, M, K, N, gs, splits, ss);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  quant_out_kernel<<<(M * N + 255) / 256, 256, 0, s>>>(pp, splits, M, N, op);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
