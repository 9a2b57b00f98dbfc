// The warp-specialised wgmma GEMM pieces shared by the grouped GEMM
// (grouped_gemm.cu: B16) and the quantized matmul (quant_matmul.cu: B8):
// the block's thread layout, the band raster, the staged epilogue, and the
// quantized block itself, qgemm_tile<FMT, Qs>: one 256 x 128 output tile
// of x @ bf16(q * s) over weight tiles widened on the chip (WgQGemmShort: a
// 128 x 128 tile, for B8's calls of few rows).
//
// qgemm_tile is two consumer warpgroups over 64-row reduction steps: each
// consumer takes 128 rows of the tile as two m64n128 accumulators (64 f32
// registers each). The widened slots are 48 KB stages: x's [256][64] tile
// and the step's bf16 [64 of K][128 of N] weight tile in 64-column blocks
// of the 128-byte swizzle, read MN-major. The producer warpgroup fills
// them: its warp 0 has one thread that TMA-loads each step's raw one-byte
// [64][128] weight tile and its two scale rows (a 64-row step spans at
// most two scale groups: gs >= 32) into RAW raw stages, and x's tile into
// the widened slot; its warps 1-3 (the widening warps) write each raw
// stage into the slot's B tile as bf16(q * s) with the product in f32
// (quant_gemv.cuh's deq<true>, bit for bit), then fence.proxy.async and
// arrive on the slot's `full` barrier, which completes once x's bytes have
// landed too. The widening, not the tensor cores, bounds the block: a
// widened step feeds BM rows of products, so the tile is tall (256 x 128
// widens half the weights a product of wg_gmm's 128 x 256, and at few rows
// its padded rows still cost less than the widening). Three widened slots
// (a fourth does not fit) and six raw stages.
//
// Packed int4 (B8 only; q uint8 [K/2, N]: within a group of gs rows,
// packed row p holds logical rows p and p + gs/2, low nibble first) keeps
// x's tile and the reduction order of the one-byte formats: a 64-row
// logical step is four 16-row pieces, each inside one half of one group
// (gs/2 is a multiple of 16), so piece i is 16 consecutive packed rows read
// by its own TMA box into rows 16 i.. of the raw stage, and its rows widen
// from the nibble of its half. A packed byte is read once per half, so
// int4 reads int8's bytes from L2 (and half of them from device memory).
//
// A block covers the steps [s0, s0 + steps) of the reduction; with `part`
// set it stores f32 partials of that range (B8's split reduction, summed
// in split order by quant_out_kernel), else the bf16 result through the
// staged epilogue. Rows past the tensors and columns past N read as zeros
// (TMA's fill); rows past `rows` and columns past C are not stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_gemv.cuh"   // kQInt8 / kQInt4 / kQFp8
#include "wgmma_tile.cuh"   // wg:: mbarriers, TMA, wgmma, swizzled

namespace {

constexpr int kWgThreads = 128;                      // one warpgroup
constexpr int kConsumerWgs = 2;                      // the warpgroups that compute
constexpr int kWgBlockThreads = kWgThreads * (kConsumerWgs + 1);   // + the producer's
constexpr int kConsumerWarps = 4 * kConsumerWgs;     // the arrivals that free a ring slot
constexpr int kSmemLimit = 232448;                   // dynamic shared memory a block can have
constexpr int kAlign = 1024;                         // the swizzle's period: every tile's alignment
constexpr int kBand = 16;                            // row tiles a band of the raster
constexpr int kBarStore = 2;                         // + the warpgroup: its staging tile is full
constexpr int kStageLd = 144;                        // bytes a staging row: 128 + 16 of padding

// Zeros over rows [r0, r0 + rows) x columns [c0, c0 + BN) of a [.., ld]
// bf16 matrix, clipped to `c_end` columns (a multiple of 8), by all the
// block's threads.
template <int BN>
__device__ __forceinline__ void zero_tile(__nv_bfloat16* __restrict__ out, size_t ld, int r0,
                                          int rows, int c0, int c_end) {
  constexpr int vecs = BN / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs, c = c0 + (i % vecs) * 8;
    if (c < c_end)
      *reinterpret_cast<uint4*>(out + size_t(r0 + r) * ld + c) = make_uint4(0, 0, 0, 0);
  }
}

// Stores a consumer's 64 x BN accumulators as bf16, rows of out `ld` apart
// from `base` (its first row), the rows from `rows` on and the columns
// from C on left out. A 64-column block at a time goes through the
// warpgroup's staging tile `stage` (rows kStageLd bytes apart: the
// fragments' bf16 pairs land in 32 distinct banks), then to device memory
// as whole 128-byte row segments, 16 bytes a thread.
template <int NACC>
__device__ __forceinline__ void store_acc(const float (&acc)[NACC], unsigned char* stage, int wgi,
                                          __nv_bfloat16* __restrict__ base, size_t ld, int rows,
                                          int c0, int C) {
  const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
  const int r_lo = warp * 16 + lane / 4, tq = lane % 4;
#pragma unroll
  for (int cb = 0; cb < NACC / 32; ++cb) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (cb * 8 + n) + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(stage + (r_lo + 8 * h) * kStageLd + n * 16 + tq * 4) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    wg::bar_sync<kWgThreads>(kBarStore + wgi);
    for (int i = tid; i < 64 * 8; i += kWgThreads) {
      const int r = i / 8, col = c0 + cb * 64 + (i % 8) * 8;
      if (r < rows && col < C)
        *reinterpret_cast<uint4*>(base + size_t(r) * ld + col) =
            *reinterpret_cast<const uint4*>(stage + r * kStageLd + (i % 8) * 16);
    }
    wg::bar_sync<kWgThreads>(kBarStore + wgi);   // read before the next block lands
  }
}

// Stores a consumer's 64 x BN accumulators as f32 straight from the
// fragments (row warp * 16 + lane / 4 (+ 8), columns 8 n + 2 (lane % 4)
// and the next), rows of `base` `ld` apart, rows from `rows` and columns
// from C (even) left out: the split reduction's partials.
template <int NACC>
__device__ __forceinline__ void store_acc_f32(const float (&acc)[NACC], float* __restrict__ base,
                                              size_t ld, int rows, int c0, int C) {
  const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
  const int r_lo = warp * 16 + lane / 4, tq = lane % 4;
#pragma unroll
  for (int n = 0; n < NACC / 4; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h, col = c0 + n * 8 + tq * 2;
      if (r < rows && col < C)
        *reinterpret_cast<float2*>(base + size_t(r) * ld + col) =
            make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
    }
}

// The raster: tile b -> (row slot y, column tile c). Row slots go in bands
// of kBand; within a band the slots run fastest, then the column tiles, so
// the tiles in flight cover a patch of row tiles x column tiles and share
// each weight panel (tgmm: each row panel of x and dout) through L2.
__device__ __forceinline__ void raster(int b, int slots, int col_tiles, int& y, int& c) {
  const int per = kBand * col_tiles;
  const int band = b / per, r = b % per;
  const int width = min(kBand, slots - band * kBand);
  c = r / width;
  y = band * kBand + r % width;
}

// The quantized block's tile and stages (see the header).
struct WgQGemm {
  static constexpr int BM = 256, BN = 128, BK = 64, SLOTS = 3, RAW = 6;
  static constexpr int SUBS = BM / (kConsumerWgs * 64);      // m64 row blocks a consumer
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int Q_BYTES = BK * BN;                    // the raw one-byte tile
  static constexpr int SC_ROWS = 2, SC_BYTES = SC_ROWS * BN * 4;
  static constexpr int RAW_BYTES = Q_BYTES + SC_BYTES;
  static constexpr int OUT_BYTES = kConsumerWgs * 64 * kStageLd;   // the epilogue's staging
  static constexpr int SMEM = kAlign + SLOTS * STAGE_BYTES + RAW * RAW_BYTES + OUT_BYTES +
                              8 * 2 * (SLOTS + RAW);
  static constexpr int PIECE = 16;                           // int4: logical rows a TMA box
  static_assert(SMEM <= kSmemLimit, "quantized wgmma GEMM: shared memory");
  static_assert(SUBS * BN / 2 == 128, "a consumer's accumulators: 128 f32 registers");
  static_assert(BK == wg::kBlockCols && BK % PIECE == 0, "a step is one 64-column block");
};
// The same block on a 128 x 128 tile (each consumer one m64n128 block): half
// the products a widened step feeds, for calls of few rows (B8's, where one
// row tile spans the call).
struct WgQGemmShort {
  static constexpr int BM = 128, BN = WgQGemm::BN, BK = WgQGemm::BK;
  static constexpr int SLOTS = WgQGemm::SLOTS, RAW = WgQGemm::RAW;
  static constexpr int SUBS = BM / (kConsumerWgs * 64);
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = WgQGemm::B_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int Q_BYTES = WgQGemm::Q_BYTES, SC_ROWS = WgQGemm::SC_ROWS;
  static constexpr int RAW_BYTES = WgQGemm::RAW_BYTES, OUT_BYTES = WgQGemm::OUT_BYTES;
  static constexpr int SMEM = kAlign + SLOTS * STAGE_BYTES + RAW * RAW_BYTES + OUT_BYTES +
                              8 * 2 * (SLOTS + RAW);
  static constexpr int PIECE = WgQGemm::PIECE;
  static_assert(SUBS == 1 && STAGE_BYTES % kAlign == 0, "one m64 block a consumer");
};
// The widening warps keep the launch's registers: setmaxnreg's smaller
// producer budget held their loads and products in series.
constexpr int kWidenWarps = 3;       // the producer's warps 1-3 (warp 0 loads)
constexpr int kWidenBatch = 5;       // raw rows a widening thread loads before it widens them

// int4: the first packed row of the 16-row piece at logical row k (a
// multiple of 16), and whether it is the group's upper half (the high
// nibble). A k past the weight's rows lands past its packed rows (TMA
// fills zeros).
__device__ __forceinline__ int int4_piece_row(int k, int gs, bool& high) {
  const int g = k / gs, o = k - g * gs, half = gs / 2;
  high = o >= half;
  return g * half + (high ? o - half : o);
}

// 8 weights (one raw row's 8 bytes at 8 consecutive columns) as bf16(q * s)
// pairs, the product in f32, as quant_gemv.cuh's deq<true>(q_value): int8
// b as the f32 2^23 + (b + 128) minus 2^23 + 128 (exact, no conversion
// instruction); int4 likewise from the row's nibble (`high`: the upper
// one), 2^23 + (n ^ 8) minus 2^23 + 8; e4m3 pairs through
// cvt.rn.f16x2.e4m3x2 and f16 -> f32, the path fp8_to_float takes.
template <int FMT>
__device__ __forceinline__ uint4 widen8(uint2 raw, const float (&s)[8], bool high) {
  float v[8];
  if constexpr (FMT == kQInt8 || FMT == kQInt4) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t word = e < 4 ? raw.x : raw.y;
      uint32_t biased;
      if constexpr (FMT == kQInt8) {
        biased = __byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7440 | (e & 3));
        v[e] = (__uint_as_float(biased) - 8388736.f) * s[e];
      } else {
        const uint32_t nib = ((high ? word >> 4 : word) & 0x0F0F0F0Fu) ^ 0x08080808u;
        biased = __byte_perm(nib, 0x4B000000u, 0x7440 | (e & 3));
        v[e] = (__uint_as_float(biased) - 8388616.f) * s[e];
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t word = p < 2 ? raw.x : raw.y;
      const __nv_fp8x2_storage_t pair =
          static_cast<__nv_fp8x2_storage_t>(p % 2 ? word >> 16 : word & 0xFFFFu);
      const float2 q = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
      v[2 * p] = q.x * s[2 * p];
      v[2 * p + 1] = q.y * s[2 * p + 1];
    }
  }
  union {
    __nv_bfloat162 h[4];
    uint4 u;
  } w;
#pragma unroll
  for (int e = 0; e < 4; ++e) w.h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  return w.u;
}

// Widens rows row, row + STRIDE, .. < end of a raw stage `st` (rows of BN
// bytes) into the swizzled B tile `b` (this lane's 64-column block), the 8
// columns from `col` with scales `s`: kWidenBatch rows at a time, their
// bytes loaded first and no branch inside a batch, so the loads and the
// rows' arithmetic overlap; the last rows one by one. int4: row r takes
// the nibble that bit r / PIECE of `high` names. Returns the first of
// those rows past `end`.
template <int FMT, int STRIDE>
__device__ __forceinline__ int widen_rows(const unsigned char* st, unsigned char* b, int row,
                                          int end, int col, const float (&s)[8], uint32_t high) {
  constexpr int BN = WgQGemm::BN, PIECE = WgQGemm::PIECE;
  for (; row + (kWidenBatch - 1) * STRIDE < end; row += kWidenBatch * STRIDE) {
    uint2 q[kWidenBatch];
#pragma unroll
    for (int i = 0; i < kWidenBatch; ++i)
      q[i] = *reinterpret_cast<const uint2*>(st + (row + i * STRIDE) * BN + col);
    uint4 w[kWidenBatch];
#pragma unroll
    for (int i = 0; i < kWidenBatch; ++i)
      w[i] = widen8<FMT>(q[i], s, (high >> ((row + i * STRIDE) / PIECE)) & 1u);
#pragma unroll
    for (int i = 0; i < kWidenBatch; ++i)
      *reinterpret_cast<uint4*>(b + wg::swizzled(row + i * STRIDE, col % 64)) = w[i];
  }
  for (; row < end; row += STRIDE)
    *reinterpret_cast<uint4*>(b + wg::swizzled(row, col % 64)) =
        widen8<FMT>(*reinterpret_cast<const uint2*>(st + row * BN + col), s,
                    (high >> (row / PIECE)) & 1u);
  return row;
}

// One block's output tile (Qs: WgQGemm's 256 x 128, or WgQGemmShort's 128 x
// 128): rows [row0, row0 + rows) of x (amap: bf16 [.., K] in {64, BM} boxes) times columns [c0, c0 + BN) of the weight at depth z
// of qmap (raw bytes, {BN, 64} boxes; int4: {BN, 16} boxes of packed rows)
// and smap (f32 scales [K / gs, C] in {BN, 2} boxes), over reduction steps
// [s0, s0 + steps) of 64 rows. Stores bf16 rows into out, or, where part
// is set, f32 partials into part; both have rows ld apart, counted from
// the tensor's first row. Every thread of the block calls it once.
template <int FMT, class Qs = WgQGemm>
__device__ __forceinline__ void qgemm_tile(const CUtensorMap* amap, const CUtensorMap* qmap,
                                           const CUtensorMap* smap, int z, int row0, int rows,
                                           int c0, int C, int gs, int s0, int steps,
                                           __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ part, size_t ld) {
  constexpr int BN = Qs::BN, BK = Qs::BK, SLOTS = Qs::SLOTS, RAW = Qs::RAW;
  constexpr int SUBS = Qs::SUBS, PIECE = Qs::PIECE;
  constexpr uint32_t BOX = BK * wg::kSwizzleBytes;   // one {64, 64} bf16 block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wide = wg::align_smem(smem_raw);           // SLOTS x (x tile, bf16 B tile)
  unsigned char* raw = wide + SLOTS * Qs::STAGE_BYTES;      // RAW x (q tile, 2 scale rows)
  unsigned char* staging = raw + RAW * Qs::RAW_BYTES;       // the consumers' [64][64] tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + Qs::OUT_BYTES);   // widened slots
  uint64_t* empty = full + SLOTS;
  uint64_t* raw_full = empty + SLOTS;                        // raw stages
  uint64_t* raw_empty = raw_full + RAW;
  if (threadIdx.x == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      wg::mbar_init(&full[i], 1 + kWidenWarps);   // x's bytes + every widening warp
      wg::mbar_init(&empty[i], kConsumerWarps);
    }
    for (int i = 0; i < RAW; ++i) {
      wg::mbar_init(&raw_full[i], 1);
      wg::mbar_init(&raw_empty[i], kWidenWarps);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int wgi = threadIdx.x / kWgThreads;
  if (wgi == kConsumerWgs) {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    if (warp == 0) {
      // one thread serves both rings, polling: the raw stages run up to RAW
      // steps ahead of the widening, x's tiles up to SLOTS ahead of the consumers
      if (lane != 0) return;
      int r = 0, a = 0;
      for (uint32_t idle = 0; r < steps || a < steps;) {
        bool moved = false;
        if (r < steps && (r < RAW || wg::mbar_test(&raw_empty[r % RAW], (r / RAW - 1) & 1))) {
          unsigned char* st = raw + (r % RAW) * Qs::RAW_BYTES;
          uint64_t* bar = &raw_full[r % RAW];
          const int k0 = (s0 + r) * BK;
          wg::mbar_expect_tx(bar, Qs::RAW_BYTES);
          if constexpr (FMT == kQInt4) {
#pragma unroll
            for (int p = 0; p < BK / PIECE; ++p) {
              bool high;
              wg::tma_load_3d(st + p * PIECE * BN, qmap, bar, c0,
                              int4_piece_row(k0 + p * PIECE, gs, high), z);
            }
          } else {
            wg::tma_load_3d(st, qmap, bar, c0, k0, z);
          }
          wg::tma_load_3d(st + Qs::Q_BYTES, smap, bar, c0, k0 / gs, z);
          ++r;
          moved = true;
        }
        if (a < steps && (a < SLOTS || wg::mbar_test(&empty[a % SLOTS], (a / SLOTS - 1) & 1))) {
          uint64_t* bar = &full[a % SLOTS];
          wg::mbar_expect_tx(bar, Qs::A_BYTES);
          wg::tma_load_3d(wide + (a % SLOTS) * Qs::STAGE_BYTES, amap, bar, (s0 + a) * BK, row0,
                          0);
          ++a;
          moved = true;
        }
        idle = moved ? 0 : idle + 1;
        if (idle > (1u << 26)) __trap();   // a schedule fault: fail the launch, free the card
      }
      return;
    }
    // the widening warps: a row of BN columns is BN / 8 lanes of 8 columns
    // (a 16-byte chunk of a 64-column block), a warp's instruction 256 / BN
    // rows; warp w takes rows w * (256 / BN) + lane / (BN / 8), then every
    // kWidenWarps * (256 / BN)-th
    constexpr int LANES_PER_ROW = BN / 8, ROWS = 32 / LANES_PER_ROW;
    constexpr int STRIDE = kWidenWarps * ROWS;
    const int col = (lane % LANES_PER_ROW) * 8;
    const int first = (warp - 1) * ROWS + lane / LANES_PER_ROW;
    unsigned char* const bcol = wide + Qs::A_BYTES + (col / 64) * BOX;
    for (int s = 0; s < steps; ++s) {
      wg::mbar_wait(&raw_full[s % RAW], (s / RAW) & 1);
      if (s >= SLOTS) wg::mbar_wait(&empty[s % SLOTS], (s / SLOTS - 1) & 1);
      const unsigned char* st = raw + (s % RAW) * Qs::RAW_BYTES;
      unsigned char* b = bcol + (s % SLOTS) * Qs::STAGE_BYTES;
      // rows [0, split) take the step's first scale row, [split, BK) its second
      const int k0 = (s0 + s) * BK, split = min((k0 / gs + 1) * gs - k0, BK);
      uint32_t high = 0;   // int4: the pieces that take the upper nibble
      if constexpr (FMT == kQInt4) {
#pragma unroll
        for (int p = 0; p < BK / PIECE; ++p) {
          bool h;
          int4_piece_row(k0 + p * PIECE, gs, h);
          high |= uint32_t(h) << p;
        }
      }
      int row = first;
#pragma unroll
      for (int sp = 0; sp < Qs::SC_ROWS; ++sp) {
        const int end = sp == 0 ? split : BK;
        if (row >= end) continue;
        const float4* sc4 = reinterpret_cast<const float4*>(st + Qs::Q_BYTES + sp * BN * 4 +
                                                            col * 4);
        const float4 lo = sc4[0], hi = sc4[1];
        const float sc[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        row = widen_rows<FMT, STRIDE>(st, b, row, end, col, sc, high);
      }
      // the B tile's stores, visible to wgmma's reads; one arrival a warp
      wg::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        wg::mbar_arrive(&raw_empty[s % RAW]);
        wg::mbar_arrive(&full[s % SLOTS]);
      }
    }
    return;
  }
  const int lane = threadIdx.x % 32;
  // a consumer's SUBS row blocks of 64: rows wgi * 64 * SUBS + 64 h
  float acc[SUBS][BN / 2];
#pragma unroll
  for (int h = 0; h < SUBS; ++h) wg::zero(acc[h]);
  for (int s = 0; s < steps; ++s) {
    wg::ring_wait<SLOTS>(full, s);
    const unsigned char* st = wide + (s % SLOTS) * Qs::STAGE_BYTES;
    const unsigned char* a = st + wgi * SUBS * 64 * wg::kSwizzleBytes;
#pragma unroll
    for (int h = 0; h < SUBS; ++h) wg::fence_regs(acc[h]);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = wg::desc_mn(st + Qs::A_BYTES + kk * 16 * wg::kSwizzleBytes, BOX);
#pragma unroll
      for (int h = 0; h < SUBS; ++h)
        wg::mma_ss<BN, 1>(acc[h], wg::desc_k(a + h * 64 * wg::kSwizzleBytes + kk * 32), db, 1);
    }
    wg::mma_commit();
    // the step's products done, its slot freed: keeping them in flight into
    // the next step (wg_gmm's mma_wait<1>) made ptxas serialise the wgmmas
    // here (C7515) and was slower
    wg::mma_wait<0>();
#pragma unroll
    for (int h = 0; h < SUBS; ++h) wg::fence_regs(acc[h]);
    wg::ring_free<SLOTS>(empty, s, lane);
  }
#pragma unroll
  for (int h = 0; h < SUBS; ++h) {
    const int r0 = (wgi * SUBS + h) * 64;
    if (part != nullptr)
      store_acc_f32(acc[h], part + size_t(row0 + r0) * ld, ld, rows - r0, c0, C);
    else
      store_acc(acc[h], staging + wgi * 64 * kStageLd, wgi, out + size_t(row0 + r0) * ld, ld,
                rows - r0, c0, C);
  }
}

}  // namespace
