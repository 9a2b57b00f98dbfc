// Grouped (ragged) matmul for Hopper (sm_90a): out [N, F] bf16, row n =
// x[n] @ w[g(n)] where g(n) is the group that owns row n, behind a plain C
// interface loaded with ctypes (ops/_build.py builds this file with nvcc at
// first use).
//
// Replaces the TPU kernel
//   shuffle_exchange_tpu/ops/grouped_gemm.py:_grouped_matmul_gmm
// (the megablox gmm), which the MoE expert FFN calls three times a layer:
// x [N, K] bf16 with its rows sorted by group, w [E, K, F], group_sizes [E]
// int32 on the device (they sum to N). The weights come in three formats:
//   bf16  w [E, K, F]
//   int8  q [E, K, F] int8, scales [E, K/gs, F] f32
//   fp8   q [E, K, F] e4m3, scales [E, K/gs, F] f32
// A quantized weight is dequantized on the chip as bf16(q * s), the q * s
// product in f32 (quant_gemv.cuh's deq<true>): the JAX route dequantizes
// the stack to the activation dtype before gmm, so the products here run
// over the same bf16 values, summed in f32, and the result is cast once.
// The kernel then differs from grouped_matmul_reference in summation order
// only, and the dequantized stack is never written to device memory.
//
// Group offsets stay on the device: every block reads group_sizes and
// finds its own (group, row tile) from a grid sized for the worst case,
// ceil(N / rows) + E row tiles; tiles past the groups exit, a group of no
// rows has no tile and reads no weight bytes, and rows past the groups'
// sum (none when the sizes sum to N) are written as zeros. The host never
// reads group_sizes.
//
// The backward (megablox ops.py:63-101, the custom VJP jax.grad reaches
// through _grouped_matmul_gmm) is two more products, bf16 only (training
// casts the expert stacks to the activations' bf16):
//   B16-dx  dx [N, K] = dout [N, F] @ w[g]^T       (megablox gmm(transpose_rhs))
//   B16-dw  dw [E, K, F], block g = x_g^T @ dout_g   (megablox tgmm)
// Every form sums in f32 and rounds once to bf16; no sum is split across
// blocks and there are no atomics, so two runs give equal bits.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16), with N rows
// and K x F expert matrices (2 N K F operations):
//   a decode tick (8 rows, top-2: N = 16 on ~7 experts) reads the weight
//   bytes of the experts hit: one Mixtral w_gate call ~7 x 59.6 MB of int8
//   and scales, >= 0.13 ms (bytes);
//   a put() of 8 x 1024 prompts, Mixtral (4096 x 14336), 16,384 rows:
//   1.924 TFLOP -> 1.946 ms (operations);
//   _config3's training (K 1024, F 2816 and the transpose), ragged N 65,472:
//   377.6 GFLOP -> 0.382 ms; capacity 8 x 10,230 rows: 472.0 GFLOP ->
//   0.477 ms (operations).
// Three designs answer it.
//
// 1. N <= 16 (the decode tick), every format: a split-K GEMV. Blocks of (64
// columns, <= 8 rows of one group, a chunk of whole scale groups <= 1024
// rows) each stream their weight rows once with 8- (int8, fp8) or 16-byte
// (bf16) loads into FMAs for only as many rows (1, 2, 4 or 8) as its group
// has; f32 partials [splits, N, F] added in split order by
// grouped_out_kernel.
//
// 2. bf16 weights at N > 16, dx at every N and dw: warp-specialised wgmma
// kernels over TMA-fed tiles (wgmma_tile.cuh), the shape of the flash
// kernels' dense forms. A block is three warpgroups: two consumers that
// compute and one producer whose single thread issues every TMA load into a
// 4-slot ring of 48 KB stages guarded by mbarriers (full: the bytes landed;
// empty: all 8 consumer warps are done with the slot); setmaxnreg gives the
// consumers 240 registers a thread and the producer 24. Tiles live in the
// 128-byte swizzle that TMA writes and wgmma's descriptors read (64-column
// blocks of 128-byte rows). A consumer accumulates 64 x 256 outputs
// (m64n256k16, 128 f32 registers) over reduction steps of 64; its products
// of step s stay in flight while it waits for step s + 1, and it frees slot
// s - 1 once they are done. A block computes one output tile; its epilogue
// stages each consumer's bf16 results through shared memory a 64-column
// block at a time and stores whole 128-byte row segments (bf16 pairs
// stored straight from the accumulators' fragments were slower, most on
// the small and short-reduction calls). The tensor maps are encoded on the
// host for each call and passed as __grid_constant__ parameters.
//   gmm (wg_gmm_kernel<TRANS>: the forward, and dx with TRANS): a tile is a
//     128 x 256 output tile of one group's row tile (find_tile); A is the
//     tile's 128 rows of x (dx: dout), K-major; B is w[g] through one map
//     of [E, K, F] in {64, 64} boxes: four side by side [64 of K][256 of F]
//     read MN-major (the forward), or four one under the other [256 of
//     K][64 of F] read K-major (dx). A box past a group's last row reads
//     the next group's rows, which the epilogue does not store; rows past N
//     and columns past K or F read as zeros. Raster: tiles go in bands of
//     kBand = 16 row tiles; within a band the row tiles run fastest, then
//     the column tiles, so the 132 tiles in flight cover ~16 row tiles x ~8
//     column tiles, and each [K, 256] weight panel they read is shared
//     through L2 by up to 16 row tiles. A group's weights are then read
//     once per band that holds its row tiles: at Mixtral's 16,384 ragged
//     rows (~16 row tiles a group, 9 bands of 16) ~2 GB of w_gate's 0.94,
//     where an order that runs all column tiles of one row tile in turn
//     reads them once per row tile or two (~8-15 GB).
//   tgmm (wg_tgmm_kernel: dw): a tile is a 128 (K) x 256 (F) tile of one
//     group's dw; the tiles go by group, the groups ranked by size, largest
//     first (so the longest walks start first), a group's tiles in the band
//     raster (K tiles as its row tiles). A tile walks its group's rows from
//     the first in steps of 64: A = x^T, B = dout, both MN-major boxes [64
//     rows][64 columns] (wgmma with A transposed). The last step's box
//     reaches past the group into the next group's rows: the consumers zero
//     those rows in shared memory (then fence.proxy.async and a named
//     barrier) before the products read them. An empty group writes a zero
//     block. A group's rows are never split between tiles.
//
// 3. int8 / e4m3 weights at N > 16 (wg_qgmm_kernel<FMT>): form 2's
// consumers, raster and epilogue over weight tiles widened on the chip.
// The producer's one thread TMA-loads each step's raw one-byte [64 of K]
// [128 of F] tile and its (at most two) scale rows, unswizzled, into a ring
// of 6 raw stages, and x's [256][64] tile into a ring of 3 widened 48 KB
// slots; the producer's other three warps write bf16(q * s) (the product
// in f32, quant_gemv.cuh's deq<true> bit for bit) into the slot's B tile in
// the 128-byte swizzle the descriptors read, fence.proxy.async, and arrive
// on the slot's barrier, so widening step s + 1 overlaps the products of
// step s. The widening bounds the block, not the tensor cores: each
// widened step is reused for BM rows, so the tile is 256 x 128 (each
// consumer two m64n128 accumulators), half the widening a product of form
// 2's 128 x 256. The weight bytes cross device memory at one byte an
// element (half the bf16 stack's) and the widened stack never leaves
// shared memory. The block is wgmma_qgemm.cuh's qgemm_tile, which the
// quantized matmul (quant_matmul.cu, B8) runs too, as one group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "quant_gemv.cuh"    // kQInt8 / kQFp8, q_value, deq<ROUND_W>
#include "wgmma_qgemm.cuh"   // the block layout, raster, epilogue, qgemm_tile (shared with B8)
#include "wgmma_tile.cuh"    // wg:: mbarriers, the ring, TMA, wgmma; tile_map_3d

namespace {

constexpr int kGBf16 = 3;                 // format code of bf16 weights

// ---------------------------------------------------------------------------
// The row tile a block owns
// ---------------------------------------------------------------------------

struct RowTile {
  int row0;    // first row
  int rows;    // rows in the tile (<= the tile height)
  int group;   // its group; -1: rows past the groups (zeros); -2: no tile
};

// Slot y of the grid's row dimension: the groups' tiles in group order,
// then the tiles of the rows past the groups' sum. Sizes are clamped so no
// group reaches past row N.
__device__ __forceinline__ RowTile find_tile(const int* __restrict__ group_sizes, int E, int N,
                                             int tile_rows, int y) {
  int off = 0;
  for (int g = 0; g < E; ++g) {
    const int size = max(0, min(__ldg(group_sizes + g), N - off));
    const int tiles = (size + tile_rows - 1) / tile_rows;
    if (y < tiles) return {off + y * tile_rows, min(tile_rows, size - y * tile_rows), g};
    y -= tiles;
    off += size;
  }
  const int size = N - off;
  const int tiles = (size + tile_rows - 1) / tile_rows;
  if (y < tiles) return {off + y * tile_rows, min(tile_rows, size - y * tile_rows), -1};
  return {0, 0, -2};
}

template <int FMT>
__host__ __device__ constexpr int elt_bytes() {
  return FMT == kGBf16 ? 2 : 1;
}

// ---------------------------------------------------------------------------
// The split-K GEMV form (N <= kGemvMaxN)
// ---------------------------------------------------------------------------

constexpr int kGThreads = 256;
constexpr int kGTN = 64;                  // output columns per block
constexpr int kGTPR = kGTN / 8;           // threads per weight row (8 columns each)
constexpr int kGRG = kGThreads / kGTPR;   // row groups per block
constexpr int kGRows = 8;                 // rows of one group per block, at most
constexpr int kGChunk = 1024;             // reduction rows per block, at most
constexpr int kGUnroll = 4;               // weight rows in flight per thread
constexpr int kGemvMaxN = 16;             // total rows up to which the GEMV form runs

// 8 weights of one row from raw bytes: bf16 values as they are, quantized
// ones as bf16(q * s).
template <int FMT>
__device__ __forceinline__ void row_values(const uint4& raw, const float (&scale)[8],
                                           float (&w)[8]) {
  if constexpr (FMT == kGBf16) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = __bfloat162float(h[e]);
  } else {
    const uint2 r2 = make_uint2(raw.x, raw.y);
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = deq<true>(q_value<FMT>(r2, e, 0), scale[e]);
  }
}

// The GEMV body for a tile of at most R rows (R = 1, 2, 4 or 8, so a
// decode tick's groups of 1-4 rows spend no FMAs on absent rows): the
// block's part rows for its 64 columns and reduction chunk, from the x
// chunk in shared memory.
template <int FMT, int R>
__device__ __forceinline__ void gemv_rows(float* xs, int chunk, const uint8_t* __restrict__ q,
                                          const float* __restrict__ scg, int F, int gs,
                                          int grp_rows, int d0, int rows, int n0,
                                          const RowTile& tile, float* __restrict__ out) {
  const int tid = threadIdx.x;
  const size_t eb = elt_bytes<FMT>();
  const int lc = tid % kGTPR, rg = tid / kGTPR;
  const int c = n0 + lc * 8;
  const bool col_ok = c < F;
  float acc[R][8];
#pragma unroll
  for (int b = 0; b < R; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0.f;

  for (int g0 = 0; g0 < rows; g0 += grp_rows) {
    float scale[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) scale[e] = 1.f;
    if constexpr (FMT != kGBf16) {
      if (col_ok) {
        const int grp = (d0 + g0) / gs;
        const float4 s0 = *reinterpret_cast<const float4*>(scg + size_t(grp) * F + c);
        const float4 s1 = *reinterpret_cast<const float4*>(scg + size_t(grp) * F + c + 4);
        scale[0] = s0.x, scale[1] = s0.y, scale[2] = s0.z, scale[3] = s0.w;
        scale[4] = s1.x, scale[5] = s1.y, scale[6] = s1.z, scale[7] = s1.w;
      }
    }
    const int grows = min(grp_rows, rows - g0);
    const size_t row0 = size_t(d0 + g0);
    for (int r = rg; r < grows; r += kGRG * kGUnroll) {
      uint4 raw[kGUnroll];
#pragma unroll
      for (int u = 0; u < kGUnroll; ++u) {
        const int rr = r + u * kGRG;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (col_ok && rr < grows) {
          const uint8_t* p = q + ((row0 + rr) * F + c) * eb;
          if constexpr (FMT == kGBf16) {
            raw[u] = __ldg(reinterpret_cast<const uint4*>(p));
          } else {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
            raw[u].x = v.x;
            raw[u].y = v.y;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGUnroll; ++u) {
        const int rr = r + u * kGRG;
        if (rr < grows) {
          float wv[8];
          row_values<FMT>(raw[u], scale, wv);
          const float* xr = xs + g0 + rr;
#pragma unroll
          for (int b = 0; b < R; ++b) {
            const float xv = xr[b * chunk];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[b][e] += xv * wv[e];
          }
        }
      }
    }
  }

  // the row groups of one warp share columns: fold them with shuffles,
  // then the warps through shared memory
#pragma unroll
  for (int b = 0; b < R; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int o = kGTPR; o < 32; o <<= 1) acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], o);
  __syncthreads();   // every thread is done with the x chunk
  float* red = xs;   // [warps][R][kGTN]
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kGTPR) {
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * R + b) * kGTN + lane * 8 + e] = acc[b][e];
  }
  __syncthreads();
  for (int i = tid; i < tile.rows * kGTN; i += kGThreads) {
    const int b = i / kGTN, cc = i % kGTN;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kGThreads / 32; ++wp) sum += red[(wp * R + b) * kGTN + cc];
    if (n0 + cc < F) out[size_t(tile.row0 + b) * F + n0 + cc] = sum;
  }
}

// part[s, row, col] for the rows of one row tile, the block's 64 columns
// and reduction chunk s. Quantized weights walk whole scale groups of gs
// rows; bf16 weights take the chunk as one group with unit scales.
template <int FMT>
__global__ void __launch_bounds__(kGThreads) grouped_gemv_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ sc, const int* __restrict__ group_sizes, int E, int N, int K,
    int F, int gs, int chunk, float* __restrict__ part) {
  __shared__ __align__(16) float xs[kGRows * kGChunk];   // x chunk; then the reduction
  const RowTile tile = find_tile(group_sizes, E, N, kGRows, blockIdx.y);
  if (tile.group == -2) return;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kGTN;
  const int s = blockIdx.z;
  float* __restrict__ out = part + size_t(s) * N * F;
  if (tile.group == -1) {    // rows past the groups: zero partials
    for (int i = tid; i < tile.rows * kGTN; i += kGThreads) {
      const int r = i / kGTN, c = n0 + i % kGTN;
      if (c < F) out[size_t(tile.row0 + r) * F + c] = 0.f;
    }
    return;
  }
  const int d0 = s * chunk;
  const int rows = min(K, d0 + chunk) - d0;
  const size_t eb = elt_bytes<FMT>();
  const uint8_t* __restrict__ q = w + size_t(tile.group) * K * F * eb;
  const float* __restrict__ scg =
      FMT == kGBf16 ? nullptr : sc + size_t(tile.group) * (K / gs) * F;
  const int grp_rows = FMT == kGBf16 ? chunk : gs;

  for (int i = tid; i < kGRows * chunk; i += kGThreads) {
    const int b = i / chunk, d = i % chunk;
    xs[i] = (b < tile.rows && d < rows)
                ? __bfloat162float(x[size_t(tile.row0 + b) * K + d0 + d])
                : 0.f;
  }
  __syncthreads();
  // tile.rows is the same for the whole block
  if (tile.rows <= 1)
    gemv_rows<FMT, 1>(xs, chunk, q, scg, F, gs, grp_rows, d0, rows, n0, tile, out);
  else if (tile.rows <= 2)
    gemv_rows<FMT, 2>(xs, chunk, q, scg, F, gs, grp_rows, d0, rows, n0, tile, out);
  else if (tile.rows <= 4)
    gemv_rows<FMT, 4>(xs, chunk, q, scg, F, gs, grp_rows, d0, rows, n0, tile, out);
  else
    gemv_rows<FMT, kGRows>(xs, chunk, q, scg, F, gs, grp_rows, d0, rows, n0, tile, out);
}

// Sum of split partials [S, N, F] in split order, cast to bf16.
__global__ void grouped_out_kernel(const float* __restrict__ part, int S, size_t NF,
                                   __nv_bfloat16* __restrict__ out) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= NF) return;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += part[size_t(s) * NF + i];
  out[i] = __float2bfloat16(sum);
}

template <int FMT>
cudaError_t launch_gemv(cudaStream_t s, const __nv_bfloat16* x, const uint8_t* w,
                        const float* sc, const int* sizes, __nv_bfloat16* out, float* part,
                        int N, int K, int F, int E, int gs, int splits, int chunk) {
  const dim3 grid((F + kGTN - 1) / kGTN, (N + kGRows - 1) / kGRows + E, splits);
  grouped_gemv_kernel<FMT><<<grid, kGThreads, 0, s>>>(x, w, sc, sizes, E, N, K, F, gs, chunk,
                                                      part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t NF = size_t(N) * F;
  grouped_out_kernel<<<unsigned((NF + 255) / 256), 256, 0, s>>>(part, splits, NF, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 forms: warp-specialised wgmma kernels over TMA-fed tiles
// ---------------------------------------------------------------------------

// (the block's warpgroups, kBand, kBarStore and kStageLd: wgmma_qgemm.cuh)
// 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536 registers, one block an SM
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBarZero = 1;                          // tgmm: the last step's rows are zeroed

// The block of both kernels: a BM x BN output tile, two consumers of 64
// rows each; stages of BK reduction rows, an A tile [BM][BK] and a B tile
// [BK][BN] (gmm: BM rows of x or dout, BN columns of out; tgmm: BM of K,
// BN of F, BK rows of x and dout). 64 x 256 accumulators a consumer is
// 128 f32 registers, under the ~160 live accumulator registers at which
// ptxas serialises the wgmmas (flash_attention.cu's note).
struct WgGemm {
  static constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // each consumer's [64][64] bf16 staging tile of the epilogue
  static constexpr int OUT_BYTES = kConsumerWgs * 64 * kStageLd;
  static constexpr int SMEM = kAlign + STAGES * STAGE_BYTES + OUT_BYTES + 8 * 2 * STAGES;
  // tgmm, after the barriers: the group of the block's rank, then each
  // group's first row and size
  static constexpr int RANK_BYTES = 4, GROUP_BYTES = 2 * 4;
  static constexpr int MAX_GROUPS = (kSmemLimit - SMEM - RANK_BYTES) / GROUP_BYTES;
  static_assert(SMEM <= kSmemLimit, "wgmma grouped GEMM: shared memory");
};
static_assert(WgGemm::BK == wg::kBlockCols && WgGemm::BM == kConsumerWgs * 64 &&
                  kAlign == wg::kSwizzleAlign,
              "a stage is 64-column blocks of 64-row boxes, 64 rows a consumer");

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  for (int i = 0; i < WgGemm::STAGES; ++i) {
    wg::mbar_init(&full[i], 1);
    wg::mbar_init(&empty[i], kConsumerWarps);
  }
  wg::mbar_fence_init();
}

// The consumer's products of one stage: acc += A (64 x BK) B (BK x BN).
// TA / TB 1: that operand MN-major (rows of the reduction 128 bytes apart,
// 64-column blocks `lbo` bytes apart), else K-major.
template <int TA, int TB>
__device__ __forceinline__ void stage_products(float (&acc)[WgGemm::BN / 2],
                                               const unsigned char* a, const unsigned char* b,
                                               uint32_t a_lbo, uint32_t b_lbo) {
  wg::fence_regs(acc);
  wg::mma_fence();
#pragma unroll
  for (int kk = 0; kk < WgGemm::BK / 16; ++kk) {
    const uint64_t da = TA ? wg::desc_mn(a + kk * 16 * wg::kSwizzleBytes, a_lbo)
                           : wg::desc_k(a + kk * 32);
    const uint64_t db = TB ? wg::desc_mn(b + kk * 16 * wg::kSwizzleBytes, b_lbo)
                           : wg::desc_k(b + kk * 32);
    wg::mma_ss<WgGemm::BN, TB, TA>(acc, da, db, 1);
  }
  wg::mma_commit();
}

// Block (row slot, column tile) by the raster: out rows of the slot's tile
// = A rows @ the group's weight (TRANS: its transpose). R is the reduction
// length (K; dx: F), C the output columns (F; dx: K).
template <bool TRANS>
__global__ void __launch_bounds__(kWgBlockThreads, 1) wg_gmm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
    const int* __restrict__ group_sizes, int E, int N, int R, int C, int slots, int col_tiles,
    __nv_bfloat16* __restrict__ out) {
  using Sh = WgGemm;
  constexpr int BM = Sh::BM, BN = Sh::BN, BK = Sh::BK, STAGES = Sh::STAGES;
  constexpr uint32_t BOX = BK * wg::kSwizzleBytes;   // one {64, 64} box
  int y, c;
  raster(blockIdx.x, slots, col_tiles, y, c);
  const RowTile tile = find_tile(group_sizes, E, N, BM, y);
  if (tile.group == -2) return;
  const int c0 = c * BN;
  if (tile.group == -1) {    // rows past the groups: zeros
    zero_tile<Sh::BN>(out, C, tile.row0, tile.rows, c0, C);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = wg::align_smem(smem_raw);    // STAGES x (A tile, B tile)
  unsigned char* staging = ring + STAGES * Sh::STAGE_BYTES;   // the consumers' [64][64] tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + Sh::OUT_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) init_ring(full, empty);
  __syncthreads();
  const int steps = (R + BK - 1) / BK;
  const int wgi = threadIdx.x / kWgThreads;
  if (wgi == kConsumerWgs) {   // the producer: one thread issues every load
    wg::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerWgs * kWgThreads) {
      for (int s = 0; s < steps; ++s) {
        wg::ring_fill<STAGES>(full, empty, s, Sh::STAGE_BYTES);
        unsigned char* st = ring + (s % STAGES) * Sh::STAGE_BYTES;
        uint64_t* bar = &full[s % STAGES];
        wg::tma_load_3d(st, &amap, bar, s * BK, tile.row0, 0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          // the forward: box j is columns c0 + 64 j of K rows s * BK..; dx:
          // K rows c0 + 64 j of F columns s * BK..
          if constexpr (TRANS)
            wg::tma_load_3d(st + Sh::A_BYTES + j * BOX, &wmap, bar, s * BK, c0 + j * 64,
                            tile.group);
          else
            wg::tma_load_3d(st + Sh::A_BYTES + j * BOX, &wmap, bar, c0 + j * 64, s * BK,
                            tile.group);
        }
      }
    }
    return;
  }
  wg::regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  // both consumers compute their 64 rows, also those past a short tile's
  // end (not stored): a branch around the products serialises them (ptxas)
  float acc[BN / 2];
  wg::zero(acc);
  for (int s = 0; s < steps; ++s) {
    wg::ring_wait<STAGES>(full, s);
    const unsigned char* st = ring + (s % STAGES) * Sh::STAGE_BYTES;
    stage_products<0, TRANS ? 0 : 1>(acc, st + wgi * 64 * wg::kSwizzleBytes, st + Sh::A_BYTES,
                                     0, BOX);
    wg::mma_wait<1>();   // step s - 1's products are done; step s's may still run
    wg::fence_regs(acc);
    if (s > 0) wg::ring_free<STAGES>(empty, s - 1, lane);
  }
  wg::mma_wait<0>();
  wg::fence_regs(acc);
  store_acc(acc, staging + wgi * 64 * kStageLd, wgi, out + size_t(tile.row0 + wgi * 64) * C, C,
            tile.rows - wgi * 64, c0, C);
}

// Block (tile b of group rank z): dw[g][k0.., f0..] = x_g^T @ dout_g over
// the rows of the group g ranked z-th by size (largest first, ties by
// index), walked in order from its first row; the group's (K tile, F tile)
// by the raster, K tiles as its row slots.
__global__ void __launch_bounds__(kWgBlockThreads, 1) wg_tgmm_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dmap,
    const int* __restrict__ group_sizes, int E, int N, int K, int F,
    __nv_bfloat16* __restrict__ dw) {
  using Sh = WgGemm;
  constexpr int BM = Sh::BM, BN = Sh::BN, BK = Sh::BK, STAGES = Sh::STAGES;
  constexpr uint32_t BOX = BK * wg::kSwizzleBytes;   // one {64 columns, 64 rows} box
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = wg::align_smem(smem_raw);
  unsigned char* staging = ring + STAGES * Sh::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + Sh::OUT_BYTES);
  uint64_t* empty = full + STAGES;
  int* ranked = reinterpret_cast<int*>(empty + STAGES);  // the group of rank blockIdx.y
  int* offs = ranked + 1;                                // [E] each group's first row
  int* sizes = offs + E;                                 // [E] its rows, clamped as in find_tile
  if (threadIdx.x == 0) {
    init_ring(full, empty);
    int off = 0;
    for (int g = 0; g < E; ++g) {
      const int size = max(0, min(__ldg(group_sizes + g), N - off));
      offs[g] = off;
      sizes[g] = size;
      off += size;
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < E; h += blockDim.x) {
    int rank = 0;
    for (int j = 0; j < E; ++j) rank += sizes[j] > sizes[h] || (sizes[j] == sizes[h] && j < h);
    if (rank == int(blockIdx.y)) *ranked = h;
  }
  __syncthreads();
  const int grp = *ranked, off = offs[grp], size = sizes[grp];
  int kt, ft;
  raster(blockIdx.x, (K + BM - 1) / BM, (F + BN - 1) / BN, kt, ft);
  const int k0 = kt * BM, f0 = ft * BN;
  __nv_bfloat16* __restrict__ out = dw + size_t(grp) * K * F;
  if (size == 0) {           // an empty group: a zero block
    zero_tile<BN>(out, F, k0, min(BM, K - k0), f0, F);
    return;
  }
  const int steps = (size + BK - 1) / BK;
  const int wgi = threadIdx.x / kWgThreads;
  if (wgi == kConsumerWgs) {   // the producer
    wg::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerWgs * kWgThreads) {
      for (int s = 0; s < steps; ++s) {
        wg::ring_fill<STAGES>(full, empty, s, Sh::STAGE_BYTES);
        unsigned char* st = ring + (s % STAGES) * Sh::STAGE_BYTES;
        uint64_t* bar = &full[s % STAGES];
        const int row = off + s * BK;
#pragma unroll
        for (int j = 0; j < BM / 64; ++j)
          wg::tma_load_3d(st + j * BOX, &xmap, bar, k0 + j * 64, row, 0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          wg::tma_load_3d(st + Sh::A_BYTES + j * BOX, &dmap, bar, f0 + j * 64, row, 0);
      }
    }
    return;
  }
  wg::regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  float acc[BN / 2];
  wg::zero(acc);
  for (int s = 0; s < steps; ++s) {
    wg::ring_wait<STAGES>(full, s);
    unsigned char* st = ring + (s % STAGES) * Sh::STAGE_BYTES;
    const int valid = size - s * BK;
    if (valid < BK) {
      // the walk's last step: its box reaches past the group (into the next
      // group's rows, or past N where TMA filled zeros); zero those rows of
      // every 64-column block of x and dout (a swizzled row is 128
      // contiguous bytes), then hand the stores to wgmma's proxy
      constexpr int BLOCKS = (BM + BN) / 64;
      const int chunks = (BK - valid) * (wg::kSwizzleBytes / 16);
      for (int i = threadIdx.x; i < BLOCKS * chunks; i += kConsumerWgs * kWgThreads) {
        const int blk = i / chunks, rem = i % chunks;
        *reinterpret_cast<uint4*>(st + blk * BOX + valid * wg::kSwizzleBytes + rem * 16) =
            make_uint4(0, 0, 0, 0);
      }
      wg::fence_proxy_async();
      wg::bar_sync<kConsumerWgs * kWgThreads>(kBarZero);
    }
    stage_products<1, 1>(acc, st + wgi * BOX, st + Sh::A_BYTES, BOX, BOX);
    wg::mma_wait<1>();
    wg::fence_regs(acc);
    if (s > 0) wg::ring_free<STAGES>(empty, s - 1, lane);
  }
  wg::mma_wait<0>();
  wg::fence_regs(acc);
  store_acc(acc, staging + wgi * 64 * kStageLd, wgi, out + size_t(k0 + wgi * 64) * F, F,
            K - k0 - wgi * 64, f0, F);
}

// ---------------------------------------------------------------------------
// The quantized forward (int8, e4m3 weights; N > kGemvMaxN): wg_gmm_kernel's
// consumers over weight tiles widened in shared memory
// ---------------------------------------------------------------------------

// wgmma_qgemm.cuh's qgemm_tile over the block's (group, row tile) by the
// band raster: a 256 x 128 output tile, two consumer warpgroups of two
// m64n128 accumulators, the producer's warp 0 loading and its warps 1-3
// widening each raw one-byte [64][128] tile into the slot's bf16 B tile.

// Block (row slot, column tile) by the raster: out rows of the slot's tile
// = x rows @ the group's widened weight [K, F].
template <int FMT>
__global__ void __launch_bounds__(kWgBlockThreads, 1) wg_qgmm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap smap, const int* __restrict__ group_sizes, int E, int N,
    int K, int F, int gs, int slots, int col_tiles, __nv_bfloat16* __restrict__ out) {
  static_assert(FMT == kQInt8 || FMT == kQFp8, "bf16 weights take wg_gmm_kernel");
  using Qs = WgQGemm;
  int y, c;
  raster(blockIdx.x, slots, col_tiles, y, c);
  const RowTile tile = find_tile(group_sizes, E, N, Qs::BM, y);
  if (tile.group == -2) return;
  const int c0 = c * Qs::BN;
  if (tile.group == -1) {    // rows past the groups: zeros
    zero_tile<Qs::BN>(out, F, tile.row0, tile.rows, c0, F);
    return;
  }
  qgemm_tile<FMT>(&amap, &qmap, &smap, tile.group, tile.row0, tile.rows, c0, F, gs, 0,
                  (K + Qs::BK - 1) / Qs::BK, out, nullptr, F);
}

// gmm launcher: out [N, C] = a [N, R] by group @ w [E, K, F] (TRANS: ^T).
template <bool TRANS>
cudaError_t launch_gmm(cudaStream_t s, const void* a, const void* w, const int* sizes,
                       __nv_bfloat16* out, int N, int K, int F, int E) {
  using Sh = WgGemm;
  const int R = TRANS ? F : K, C = TRANS ? K : F;
  const long long slots = (long long)(N + Sh::BM - 1) / Sh::BM + E;
  const long long col_tiles = (C + Sh::BN - 1) / Sh::BN;
  if (slots * col_tiles > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap am, wm;
  cudaError_t err = tile_map_3d(&am, a, 1, N, R, Sh::BM);
  if (err == cudaSuccess) err = tile_map_3d(&wm, w, E, K, F, Sh::BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wg_gmm_kernel<TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Sh::SMEM);
  if (err != cudaSuccess) return err;
  wg_gmm_kernel<TRANS><<<int(slots * col_tiles), kWgBlockThreads, Sh::SMEM, s>>>(
      am, wm, sizes, E, N, R, C, int(slots), int(col_tiles), out);
  return cudaGetLastError();
}

// Quantized gmm launcher: out [N, F] = x [N, K] by group @ bf16(q [E, K, F] * s), scales
// s [E, K / gs, F] f32.
template <int FMT>
cudaError_t launch_qgmm(cudaStream_t s, const void* x, const void* q, const void* sc,
                        const int* sizes, __nv_bfloat16* out, int N, int K, int F, int E,
                        int gs) {
  using Qs = WgQGemm;
  const long long slots = (long long)(N + Qs::BM - 1) / Qs::BM + E;
  const long long col_tiles = (F + Qs::BN - 1) / Qs::BN;
  if (slots * col_tiles > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap am, qm, sm;
  cudaError_t err = tile_map_3d(&am, x, 1, N, K, Qs::BM);
  if (err == cudaSuccess)
    err = plain_map_3d(&qm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, E, K, F, Qs::BK, Qs::BN);
  if (err == cudaSuccess)
    err = plain_map_3d(&sm, sc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, E, K / gs, F, Qs::SC_ROWS,
                       Qs::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wg_qgmm_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Qs::SMEM);
  if (err != cudaSuccess) return err;
  wg_qgmm_kernel<FMT><<<int(slots * col_tiles), kWgBlockThreads, Qs::SMEM, s>>>(
      am, qm, sm, sizes, E, N, K, F, gs, int(slots), int(col_tiles), out);
  return cudaGetLastError();
}

// tgmm launcher: dw [E, K, F] from x [N, K] and dout [N, F].
cudaError_t launch_tgmm(cudaStream_t s, const void* x, const void* dout, const int* sizes,
                        __nv_bfloat16* dw, int N, int K, int F, int E) {
  using Sh = WgGemm;
  const long long tiles = (long long)((K + Sh::BM - 1) / Sh::BM) * ((F + Sh::BN - 1) / Sh::BN);
  if (E > Sh::MAX_GROUPS || tiles > INT_MAX) return cudaErrorInvalidValue;
  if (N == 0)   // every group is empty: nothing to map
    return cudaMemsetAsync(dw, 0, size_t(E) * K * F * sizeof(__nv_bfloat16), s);
  const int smem = Sh::SMEM + Sh::RANK_BYTES + Sh::GROUP_BYTES * E;
  CUtensorMap xm, dm;
  cudaError_t err = tile_map_3d(&xm, x, 1, N, K, Sh::BK);
  if (err == cudaSuccess) err = tile_map_3d(&dm, dout, 1, N, F, Sh::BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wg_tgmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wg_tgmm_kernel<<<dim3(unsigned(tiles), unsigned(E)), kWgBlockThreads, smem, s>>>(
      xm, dm, sizes, E, N, K, F, dw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sxt_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [N, F] bf16 = the grouped product of x [N, K] bf16 (rows sorted by
// group) with the E weights w of format fmt (0 int8, 2 e4m3: q [E, K, F]
// and scales [E, K/gs, F]; 3 bf16: w [E, K, F], scales unused), by
// group_sizes [E] int32 on the device. N <= 16 runs the split-K GEMV over
// `splits` chunks of `chunk` rows (whole scale groups, <= 1024 rows) with
// f32 partials in part [splits, N, F]; larger N the wgmma kernels (bf16:
// wg_gmm_kernel, int8 / e4m3: wg_qgmm_kernel). Needs K % 8 == 0, F % 16 ==
// 0 (bf16: F % 8 == 0), 16-byte aligned bases and, quantized, K % gs == 0
// and gs % 32 == 0.
int sxt_grouped_matmul_bf16(const void* x, const void* w, const void* scales,
                            const void* group_sizes, void* out, void* part, int N, int K, int F,
                            int E, int gs, int fmt, int splits, int chunk, void* stream) {
  if (N <= 0 || F <= 0) return 0;
  const bool quant = fmt == kQInt8 || fmt == kQFp8;
  if ((!quant && fmt != kGBf16) || E < 1 || K < 1 || K % 8 || F % (quant ? 16 : 8) ||
      (quant && (gs < 32 || gs % 32 || K % gs)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= kGemvMaxN &&
      (part == nullptr || splits < 1 || chunk < 1 || chunk > kGChunk ||
       (quant && chunk % gs) || (long long)splits * chunk < K ||
       (long long)(splits - 1) * chunk >= K))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  const auto* gp = static_cast<const int*>(group_sizes);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pp = static_cast<float*>(part);
  cudaError_t err;
  if (N <= kGemvMaxN) {
    if (fmt == kQInt8)
      err = launch_gemv<kQInt8>(s, xp, wp, sp, gp, op, pp, N, K, F, E, gs, splits, chunk);
    else if (fmt == kQFp8)
      err = launch_gemv<kQFp8>(s, xp, wp, sp, gp, op, pp, N, K, F, E, gs, splits, chunk);
    else
      err = launch_gemv<kGBf16>(s, xp, wp, sp, gp, op, pp, N, K, F, E, gs, splits, chunk);
  } else if (fmt == kQInt8) {
    err = launch_qgmm<kQInt8>(s, x, w, scales, gp, op, N, K, F, E, gs);
  } else if (fmt == kQFp8) {
    err = launch_qgmm<kQFp8>(s, x, w, scales, gp, op, N, K, F, E, gs);
  } else {
    err = launch_gmm<false>(s, x, w, gp, op, N, K, F, E);
  }
  return static_cast<int>(err);
}

// dx [N, K] bf16 = dout [N, F] bf16 (rows sorted by group) @ w[g]^T for
// the bf16 stack w [E, K, F], by group_sizes [E] int32 on the device.
// Needs K % 8 == 0, F % 8 == 0 and 16-byte aligned bases.
int sxt_grouped_matmul_dx_bf16(const void* dout, const void* w, const void* group_sizes,
                               void* dx, int N, int K, int F, int E, void* stream) {
  if (N <= 0 || K <= 0) return 0;
  if (E < 1 || F < 1 || K % 8 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_gmm<true>(static_cast<cudaStream_t>(stream), dout, w,
                                           static_cast<const int*>(group_sizes),
                                           static_cast<__nv_bfloat16*>(dx), N, K, F, E));
}

// dw [E, K, F] bf16: block g = x_g^T @ dout_g over group g's rows of x
// [N, K] and dout [N, F] (bf16, rows sorted by group), zeros for an empty
// group; group_sizes [E] int32 on the device. Needs K % 8 == 0, F % 8 == 0
// and 16-byte aligned bases.
int sxt_grouped_matmul_dw_bf16(const void* x, const void* dout, const void* group_sizes,
                               void* dw, int N, int K, int F, int E, void* stream) {
  if (E <= 0 || K <= 0 || F <= 0) return 0;
  if (N < 0 || K % 8 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_tgmm(static_cast<cudaStream_t>(stream), x, dout,
                                      static_cast<const int*>(group_sizes),
                                      static_cast<__nv_bfloat16*>(dw), N, K, F, E));
}

}  // extern "C"
