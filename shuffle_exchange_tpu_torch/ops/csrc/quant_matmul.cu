// Weight-only quantized matmul for Hopper (sm_90a): out [M, N] bf16 =
// x [M, K] bf16 @ dequantize(q, scales), behind a plain C interface loaded
// with ctypes (ops/_build.py builds this file with nvcc at first use).
//
// Replaces the TPU kernel
//   shuffle_exchange_tpu/ops/quant_matmul.py:_quant_matmul_pallas
// and, on the card, the JAX default path it stands beside (dequantize into
// the dot, which XLA fuses so the weights cross HBM at storage width).
// Storage formats (int8, packed int4, e4m3 fp8, f32 scales [K/gs, N]):
// see quant_gemv.cuh.
//
// Rounding: each weight is dequantized as q * s in f32 and rounded to bf16
// before the product, the JAX default's rounding point; products are
// summed in f32 and the result cast once. The kernel then differs from
// quant_matmul_reference (ops/quant_matmul.py) in summation order only.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode rows
// (M <= 8) the weight bytes, 1 byte an element (half of one for int4) plus
// 4 / gs of scales: 16.8 MB for Llama-3-8B's [4096, 4096] int8 wq, 5.0 us.
// Those rows take the split-K GEMV of quant_gemv.cuh (64-column tiles,
// reduction chunks of whole scale groups, enough blocks for two an SM, f32
// partials added in a fixed order by quant_out_kernel below, so two runs give
// equal bits). Above 8 rows (extend chunks, mixed ticks, a put() of 8
// prompts padded to 1024 = 8192 rows) the work turns to operations: 2 M K N
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

#include "quant_gemv.cuh"    // formats, q_value, the split-K GEMV
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
// 1 packed int4, 2 e4m3) and group size gs. The reduction over K runs in
// `splits` chunks of `chunk` rows, with f32 partials in part [splits, M, N]
// (unused when splits is 1 above 8 rows). M <= 8 runs the GEMV, whose chunks
// are whole groups; larger M the wgmma kernel (on 128-row tiles up to 128
// rows, 256-row tiles past them), whose chunks are whole 64-row steps.
// Needs K % gs == 0, gs % 32 == 0, N % 16 == 0 and 16-byte aligned bases.
int sxt_quant_matmul_bf16(const void* x, const void* q, const void* scales, void* out,
                          void* part, int M, int K, int N, int gs, int fmt, int splits, int chunk,
                          void* stream) {
  if (M <= 0) return 0;
  if (gs % 32 || K % gs || N % 16 || fmt < 0 || fmt > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M <= kQMaxRows) {
    if (part == nullptr || bad_qsplit(K, gs, splits, chunk))
      return static_cast<int>(cudaErrorInvalidValue);
    const QMats mats = make_qmats(q, scales, N, nullptr, nullptr, 0);
    const cudaError_t err =
        launch_quant_gemv<true>(fmt, dim3(mats.tiles[0], splits), s, xp, M, K, gs, chunk, mats,
                                N, static_cast<float*>(part));
    if (err != cudaSuccess) return static_cast<int>(err);
    quant_out_kernel<<<(M * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), splits,
                                                         M, N, op);
    return static_cast<int>(cudaGetLastError());
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
