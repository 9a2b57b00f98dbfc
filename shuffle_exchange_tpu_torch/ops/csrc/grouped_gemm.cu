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
// Every form sums in f32 and rounds once to bf16; the wgmma forms split no
// sum across blocks, the GEMV adds its splits in split order, so two runs
// give equal bits.
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
// 1. N <= 16 (the decode tick), every format: mma_gemv.cuh's tensor-core
// GEMV (it replaced a split-K CUDA-core GEMV, which reached 25% of the
// bytes bound). Persistent blocks walk (row group of <= 16 rows of
// one group, 128-column tile, K chunk) items; each warp streams a run of
// the chunk's 32-row stages through its own cp.async ring and multiplies on
// mma.sync (x the A operand, the weight widened to bf16(q * s) the B
// operand); the block adds its warps' sums in order. A group of no rows
// has no item and reads no weight bytes; every weight byte of a group with
// rows is read once a call. Split chunks write f32 partials [splits, N, F]
// that the tile's last block adds in split order (a counter it resets).
//
// 2. bf16 weights past the GEMV's rows, dx at every N and dw: warp-specialised wgmma
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
// 3. int8 / e4m3 weights past the GEMV's rows (wg_qgmm_kernel<FMT>): form 2's
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

#include "mma_gemv.cuh"      // tcg:: the tensor-core GEMV of the decode rows (shared with B7)
#include "quant_gemv.cuh"    // kQInt8 / kQFp8
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

// ---------------------------------------------------------------------------
// The decode-row form (N <= the wrapper's GEMV_MAX_N): mma_gemv.cuh's
// tensor-core GEMV over the groups that have rows
// ---------------------------------------------------------------------------

// A row group of the GEMV: up to tcg::kRows rows of one group.
struct GroupRows {
  int g, row0, rows;
};

// Row groups of the groups that have rows, in group order (a group of more
// than 16 rows in several): at most min(E, N) + N / 16.
__host__ __device__ constexpr int row_groups_max(int E, int N) {
  return (E < N ? E : N) + N / tcg::kRows;
}

// The items of the grouped GEMV: (row group, split, column tile), the
// tile fastest, so neighbouring blocks share the group's x rows and read
// neighbouring columns of the same weight rows.
struct GroupedGemv {
  const __nv_bfloat16* x;
  const float* sc;
  const GroupRows* tab;
  size_t mat_scales;              // one group's scales
  const CUtensorMap* map;         // [E, K, F] in one-byte [32][128] or bf16 [32][64] boxes
  int items, N, K, gs, splits, chunk, tiles;
  static constexpr int parts = tcg::kWarps;   // each warp a part of the chunk

  __device__ int units(int item) const {
    return tcg::chunk_stages((item / tiles) % splits, chunk, K);
  }
  __device__ tcg::Geo geo(int item, int lane, int) const {
    const int rest = item / tiles, split = rest % splits;
    const GroupRows t = tab[rest / splits];
    tcg::Geo g;
    g.s = sc == nullptr ? nullptr : sc + size_t(t.g) * mat_scales;
    g.tile = item % tiles;
    g.map = map;
    g.c0 = g.tile * tcg::kTileCols;
    g.batch = t.g;
    g.col = g.tile * tcg::kTileCols + tcg::kLaneCols * (lane >> 2);
    g.col_ok = g.col < N;
    g.u0 = split * chunk / tcg::kStageRows;
    g.row0 = t.row0;
    g.rows = t.rows;
    g.grp = rest / splits;
    g.split = split;
    return g;
  }
  __device__ tcg::RowsPlain rows_of(const tcg::Geo& g) const {
    return {x + size_t(g.row0) * K, K, g.rows, K};
  }
  __device__ const float* fold_scales(const tcg::Geo&, int, int, int, int) const {
    return nullptr;
  }
};

// out [N, F] (bf16) of x [N, K] by group @ w [E, K, F]: every row group's
// items, the weights widened as bf16(q * s) (bf16 weights as they are);
// one split writes out, several write part [splits, N, F] and the last
// block of each (row group, tile) adds them in split order. Rows past the
// groups' sum are zeros.
template <int FMT>
__global__ void __launch_bounds__(tcg::kThreads, 1) mma_gemv_grouped_kernel(
    const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ sc, const int* __restrict__ group_sizes, int E, int N, int K,
    int F, int gs, int splits, int chunk, float* __restrict__ part, int* __restrict__ counters,
    __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tcg::Smem sm = tcg::smem_layout(smem_raw);
  float* red = sm.red;
  int* flag = sm.meta;
  int* meta = sm.meta + 1;   // row groups, rows in the groups
  GroupRows* tab = reinterpret_cast<GroupRows*>(sm.tail);
  if (threadIdx.x == 0) {
    int off = 0, n = 0;
    for (int g = 0; g < E; ++g) {
      const int size = max(0, min(__ldg(group_sizes + g), N - off));
      for (int r = 0; r < size; r += tcg::kRows) tab[n++] = {g, off + r, min(tcg::kRows, size - r)};
      off += size;
    }
    meta[0] = n;
    meta[1] = off;
  }
  __syncthreads();
  const int tiles = (F + tcg::kTileCols - 1) / tcg::kTileCols;
  const bool quant = FMT != tcg::kBf16;
  const GroupedGemv p{x, quant ? sc : nullptr, tab, quant ? size_t(K / gs) * F : 0, &wmap,
                      meta[0] * splits * tiles, F, K, quant ? gs : tcg::kStageRows, splits, chunk,
                      tiles};
  auto done = [&](int, const tcg::Geo& g, const float (&acc)[16][4]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __syncthreads();   // the last item's sums are read
    tcg::write_red<FMT>(red, warp, lane, acc, g.rows);
    __syncthreads();
    const int n0 = g.tile * tcg::kTileCols, cells = g.rows * tcg::kTileCols;
    if (splits == 1) {
      for (int i = threadIdx.x; i < cells; i += tcg::kThreads) {
        const int r = i / tcg::kTileCols, c = i % tcg::kTileCols;
        if (n0 + c < F)
          out[size_t(g.row0 + r) * F + n0 + c] = __float2bfloat16(tcg::red_sum(red, r, c));
      }
      return;
    }
    for (int i = threadIdx.x; i < cells; i += tcg::kThreads) {
      const int r = i / tcg::kTileCols, c = i % tcg::kTileCols;
      if (n0 + c < F)
        part[(size_t(g.split) * N + g.row0 + r) * F + n0 + c] = tcg::red_sum(red, r, c);
    }
    if (!tcg::last_of_tile(counters + g.grp * tiles + g.tile, splits, flag)) return;
    for (int i = threadIdx.x; i < cells; i += tcg::kThreads) {
      const int r = i / tcg::kTileCols, c = i % tcg::kTileCols;
      if (n0 + c >= F) continue;
      float v = 0.f;
#pragma unroll 4
      for (int s = 0; s < splits; ++s)
        v += __ldcg(part + (size_t(s) * N + g.row0 + r) * F + n0 + c);
      out[size_t(g.row0 + r) * F + n0 + c] = __float2bfloat16(v);
    }
  };
  tcg::run<FMT, FMT != tcg::kBf16, false>(p, sm, [] {}, done);
  const size_t past = size_t(N - meta[1]) * F;   // rows past the groups' sum
  for (size_t i = size_t(blockIdx.x) * tcg::kThreads + threadIdx.x; i < past;
       i += size_t(gridDim.x) * tcg::kThreads)
    out[size_t(meta[1]) * F + i] = __float2bfloat16(0.f);
}

template <int FMT>
cudaError_t launch_decode_gemv(cudaStream_t s, const __nv_bfloat16* x, const uint8_t* w,
                            const float* sc, const int* sizes, __nv_bfloat16* out, float* part,
                            int* counters, int N, int K, int F, int E, int gs, int splits,
                            int chunk, int blocks) {
  const int smem = tcg::kSmemBytes + row_groups_max(E, N) * int(sizeof(GroupRows));
  if (smem > tcg::kSmemLimit) return cudaErrorInvalidValue;
  constexpr bool bf16 = FMT == kGBf16;
  CUtensorMap wmap;
  cudaError_t err = tcg::box_map(&wmap, w, bf16, E, K, F, tcg::kStageRows, bf16 ? 64 : 128);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mma_gemv_grouped_kernel<FMT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mma_gemv_grouped_kernel<FMT><<<blocks, tcg::kThreads, smem, s>>>(
      wmap, x, sc, sizes, E, N, K, F, gs, splits, chunk, part, counters, out);
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
// The quantized forward (int8, e4m3 weights; past the GEMV's rows): wg_gmm_kernel's
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
// group_sizes [E] int32 on the device. N <= gemv_max_n runs the tensor-core
// GEMV (mma_gemv.cuh) on `blocks` persistent blocks over `splits` chunks of
// `chunk` rows (whole scale groups; bf16: multiples of 32); with several
// splits, f32 partials in part [splits, N, F] and counters
// [(min(E, N) + N / 16) * ceil(F / 128)] int32, zero between calls (the
// kernel leaves them zero). Larger N runs the wgmma kernels (bf16:
// wg_gmm_kernel, int8 / e4m3: wg_qgmm_kernel). Needs K % 8 == 0, F % 16 ==
// 0 (bf16: F % 8 == 0), 16-byte aligned bases and, quantized, K % gs == 0
// and gs % 32 == 0.
int sxt_grouped_matmul_bf16(const void* x, const void* w, const void* scales,
                            const void* group_sizes, void* out, void* part, int N, int K, int F,
                            int E, int gs, int fmt, int splits, int chunk, void* counters,
                            int blocks, int gemv_max_n, void* stream) {
  if (N <= 0 || F <= 0) return 0;
  const bool quant = fmt == kQInt8 || fmt == kQFp8;
  if ((!quant && fmt != kGBf16) || E < 1 || K < 1 || K % 8 || F % (quant ? 16 : 8) ||
      (quant && (gs < 32 || gs % 32 || K % gs)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool gemv = N <= gemv_max_n;
  if (gemv && (splits < 1 || chunk < 1 || chunk % (quant ? gs : tcg::kStageRows) ||
               (long long)splits * chunk < K || (long long)(splits - 1) * chunk >= K ||
               blocks < 1 || (splits > 1 && (part == nullptr || counters == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  const auto* gp = static_cast<const int*>(group_sizes);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pp = static_cast<float*>(part);
  auto* cp = static_cast<int*>(counters);
  cudaError_t err;
  if (gemv) {
    if (fmt == kQInt8)
      err = launch_decode_gemv<kQInt8>(s, xp, wp, sp, gp, op, pp, cp, N, K, F, E, gs, splits, chunk,
                                    blocks);
    else if (fmt == kQFp8)
      err = launch_decode_gemv<kQFp8>(s, xp, wp, sp, gp, op, pp, cp, N, K, F, E, gs, splits, chunk,
                                   blocks);
    else
      err = launch_decode_gemv<kGBf16>(s, xp, wp, sp, gp, op, pp, cp, N, K, F, E, gs, splits, chunk,
                                    blocks);
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
