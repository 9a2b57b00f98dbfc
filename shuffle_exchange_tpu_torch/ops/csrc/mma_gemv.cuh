// Tensor-core GEMV for decode rows on Hopper (sm_90a), shared by four
// kernels: B16's decode rows (grouped_gemm.cu: mma_gemv_grouped_kernel),
// B8's (quant_matmul.cu: mma_gemv_quant_kernel), and the fused MLP over
// bf16 weights (B6) and quantized ones (B7) (fused_decode.cu:
// mma_gemv_mlp_up_kernel and mma_gemv_mlp_down_kernel).
//
// out[r, n] = sum over k of x[r, k] * W[k, n] for up to 16 activation rows r
// of one row group, W [K, N] stored as bf16, int8, packed int4 or e4m3
// (QFormat below; f32 scales [K / gs, N]).
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): the weight bytes.
// 16 rows make 32 flops a weight element against the card's ~295 flop/byte
// ridge, so the card should stream every weight byte once at the memory's
// rate. The split-K CUDA-core GEMVs this replaces reached 21-25% of that
// bound: short blocks behind a serial prologue (x staged as f32 for a fixed
// 8 rows with 2-byte loads), 8-byte weight loads, and ~14 lane-instructions
// a weight byte on the CUDA cores (a byte extract, I2F, FMUL, a bf16 round
// trip and R FFMAs), which is above the byte bound by itself. The design:
//
// 1. Products on the tensor cores: mma.sync.m16n8k16, bf16 operands, f32
//    accumulators. The activation rows are the 16-row A operand (absent
//    rows zero); the weight is the B operand. A lane owns 16 physical
//    columns (one-byte weights: one 16-byte chunk of a row; bf16: one chunk
//    of each 64-column half), and their 16 n8-tile slots sit at its fragment
//    position (lane group g = lane / 4 gives slot g of n-tiles 0..15), so a
//    warp's tile is 128 columns. The accumulators come back permuted (lane
//    quad t holds slots 2 t and 2 t + 1 of every n-tile, for rows lane / 4
//    and lane / 4 + 8); the epilogue stores each at its column. Byte
//    permutes pair rows k and k + 1 of a column into one bf16x2 B register:
//    per weight element only the widening is left.
// 2. Rounding points, each TPU kernel's own. B16 and B8: bf16(q * s), the
//    product in f32 (pair1<FMT, true>, the JAX route's dequantize and
//    cast), and bf16 weights (B16, B6) as they are: every product x * w is
//    exact in f32. B7: q widened to bf16 exactly (int8, int4 and e4m3
//    values all are), each scale group's products x * q summed in f32 on
//    the tensor cores, then s[g, n] x the group sum added to the
//    accumulator in f32 (q * s is never rounded).
// 3. Streaming: each warp keeps a private ring of kRingBytes of stages in
//    shared memory; its lane 0 fills a stage with TMA boxes of 128-byte
//    rows in the 128-byte swizzle that complete on the slot's mbarrier,
//    ring_stages - 1 stages ahead of the products and across item
//    boundaries (rows of 64 bytes, the MLP's gate and up tiles side by side,
//    streamed ~25% slower). The swizzle puts the rows a lane quad reads
//    (rows 2 t + {0, 1, 8, 9} of each 16) in distinct banks. 16-byte
//    cp.async into the same ring streamed at ~1.7 TB/s on the H100, TMA
//    boxes at ~2.7. A stage's A operand (32-bit pairs of the rows that
//    exist) is loaded while the stage before it multiplies.
// 4. Work: an item is (row group, 128-column tile, K chunk of whole scale
//    groups); warp w takes part w of the chunk's stages (a contiguous run)
//    and the warps add their sums in warp order through shared memory
//    (the fused MLP's gated up GEMV: warps 0-3 the gate's tile, 4-7 the up
//    matrix's, each of the four a quarter of the chunk).
//    Blocks are persistent (one an SM) and walk items blockIdx.x, +
//    gridDim.x, ... A chunk that is not the whole of K writes f32 partials;
//    the last block to finish a tile (an atomic counter it resets to zero)
//    adds them in split order, so two runs give equal bits. The host picks
//    the split count (ops/decode_gemv.py: plan) from the busiest SM's weight
//    bytes, its items' fixed cost and the partials' bytes: on the H100 an
//    item costs about 5 us beyond its bytes (the block's barrier and sums,
//    the ring refilling behind them), and items of 2, 4 or 8 adjacent tiles
//    a block (warps splitting columns instead of K) were no faster.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "mma_sync.cuh"     // mma_bf16
#include "wgmma_tile.cuh"   // wg:: mbarriers, TMA; encode_tiled

namespace {

// The storage formats of a weight-only quantized weight [K, N]
// (QuantizedMatrix in ops/quant_matmul.py), shared with the quantized
// `wgmma` block (wgmma_qgemm.cuh):
//   int8  q int8 [K, N]
//   int4  q uint8 [K/2, N]: within each K-group of gs rows, row r < gs/2
//         shares a byte with row r + gs/2, low nibble first; a nibble is a
//         two's-complement value in [-8, 7]
//   fp8   q e4m3 [K, N]
// with f32 scales [K/gs, N]; the weight is q * s, dequantized on the chip.
enum QFormat { kQInt8 = 0, kQInt4 = 1, kQFp8 = 2 };

}  // namespace

namespace tcg {

constexpr int kBf16 = 3;                 // format code of bf16 weights
constexpr int kWarps = 8;                // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                // activation rows a row group: the m16 A operand
constexpr int kTileCols = 128;           // weight columns a tile: 8 lane groups x 16
constexpr int kLaneCols = 16;            // columns a lane owns
constexpr int kStageRows = 32;           // logical weight rows a stage: two k16 steps
constexpr int kRingBytes = 16384;        // a warp's ring of stages
// the warps' sums of an item: a row of 128 slots in four 32-slot pieces 36
// floats apart, rows 144 floats apart (write_red's 16-byte stores fall in
// distinct banks)
constexpr int kRedLd = kTileCols + 16;
constexpr int kRedBytes = kWarps * kRows * kRedLd * 4;
constexpr int kStatBytes = 2 * kRows * 4;                   // the MLP's norm: mean, 1 / std a row
constexpr int kMetaBytes = 16;                              // a flag, B16's table sizes
constexpr int kBarBytes = kWarps * 8 * 8;                   // the rings' mbarriers (<= 8 slots)
constexpr int kAlign = 1024;                                // the swizzle's period
constexpr int kSmemBytes =
    kAlign + kWarps * kRingBytes + kRedBytes + kStatBytes + kMetaBytes + kBarBytes;
constexpr int kSmemLimit = 232448;       // dynamic shared memory an H100 block can have
static_assert(kSmemBytes <= kSmemLimit, "tensor-core GEMV: shared memory");
static_assert(kTileCols == 8 * kLaneCols && kStageRows == 32, "the fragment layout");

// A stage's bytes: int8 / e4m3 32 rows x 128 bytes, packed int4 16 packed
// rows x 128 bytes, bf16 32 rows x 256 bytes
template <int FMT>
__host__ __device__ constexpr int stage_bytes() {
  return FMT == kBf16 ? 8192 : FMT == kQInt4 ? 2048 : 4096;
}
template <int FMT>
__host__ __device__ constexpr int ring_stages() {
  return kRingBytes / stage_bytes<FMT>();
}
static_assert(ring_stages<kQInt4>() <= 8, "kBarBytes: at most 8 slots a warp");

// Where the block's shared memory is (the dynamic base aligned to kAlign).
struct Smem {
  unsigned char* ring;   // kWarps x kRingBytes
  float* red;            // the warps' sums
  float* mean;           // the MLP's row statistics
  float* inv;
  int* meta;             // [0] the fold's flag, [1], [2] B16's table sizes
  uint64_t* bars;        // kWarps x 8
  unsigned char* tail;   // past the fixed layout (B16's row-group table)
};

__device__ __forceinline__ Smem smem_layout(unsigned char* raw) {
  Smem m;
  m.ring = wg::align_smem(raw);
  m.red = reinterpret_cast<float*>(m.ring + kWarps * kRingBytes);
  m.mean = m.red + kRedBytes / 4;
  m.inv = m.mean + kRows;
  m.meta = reinterpret_cast<int*>(m.inv + kRows);
  m.bars = reinterpret_cast<uint64_t*>(m.meta + kMetaBytes / 4);
  m.tail = reinterpret_cast<unsigned char*>(m.bars + kBarBytes / 8);
  return m;
}

// ---------------------------------------------------------------------------
// Items
// ---------------------------------------------------------------------------

// One item as one lane sees it.
struct Geo {
  const CUtensorMap* map;  // the warp's weight in boxes
  int c0, batch;           // the tile's first column, the map's batch (B16: the group)
  const float* s;     // the lane's scales [K / gs, N] (B16's, B8's; null for bf16)
  int col;            // the lane's first column (B16's and B8's scales)
  bool col_ok;        // col < N
  int u0;             // the item's first stage, counted from row 0 (32 logical rows a stage)
  int row0, rows;     // the item's activation rows
  int grp, split, tile;
};

// Stages of the chunk [split * chunk, min(K, (split + 1) * chunk)).
__device__ __forceinline__ int chunk_stages(int split, int chunk, int K) {
  const int k0 = split * chunk;
  return (min(K, k0 + chunk) - k0 + kStageRows - 1) / kStageRows;
}

// The contiguous run [s, end) of a chunk's nu stages of part `part` of
// `parts` (warp w's: part w % parts).
__device__ __forceinline__ void warp_run(int part, int parts, int nu, int& s, int& end) {
  s = part * nu / parts;
  end = (part + 1) * nu / parts;
}

// From `item` on, the first item whose run of stages for `warp` is not
// empty: its stages [s, end); false past the last item.
template <class P>
__device__ __forceinline__ bool seek(const P& p, int warp, int& item, int& s, int& end) {
  for (; item < p.items; item += gridDim.x) {
    warp_run(warp % p.parts, p.parts, p.units(item), s, end);
    if (s < end) return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// Loads
// ---------------------------------------------------------------------------

// Stage `unit` of the warp's tile into its ring slot (lane 0): one box of
// [32 rows][128 bytes] (int4: 16 packed rows), bf16's two [32][64 columns]
// halves. Rows and columns past the tensor arrive as zeros.
template <int FMT>
__device__ __forceinline__ void issue_stage(unsigned char* slot, uint64_t* bar, const Geo& g,
                                            int unit) {
  const int row = FMT == kQInt4 ? unit * 16 : unit * kStageRows;
  wg::mbar_expect_tx(bar, stage_bytes<FMT>());
  wg::tma_load_3d(slot, g.map, bar, g.c0, row, g.batch);
  if (FMT == kBf16) wg::tma_load_3d(slot + stage_bytes<FMT>() / 2, g.map, bar, g.c0 + 64, row,
                                    g.batch);
}

// The byte offset in a stage of lane group gr's 16-byte chunk of row r in
// box h (the 128-byte swizzle: chunk gr ^ (r % 8)); bf16's box h holds
// columns 64 h + 8 gr ..
template <int FMT>
__device__ __forceinline__ int chunk_at(int r, int gr, int h = 0) {
  constexpr int ROWS = FMT == kQInt4 ? 16 : kStageRows;
  return h * ROWS * 128 + r * 128 + ((gr ^ (r & 7)) << 4);
}

__device__ __forceinline__ void lds4(const unsigned char* p, uint32_t (&w)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

__device__ __forceinline__ void ldg16f(const float* p, float (&s)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    s[4 * i] = v.x, s[4 * i + 1] = v.y, s[4 * i + 2] = v.z, s[4 * i + 3] = v.w;
  }
}

// Activation rows as stored (bf16 [rows, ld]), absent rows zero.
struct RowsPlain {
  const __nv_bfloat16* x;
  int ld, rows, K;
  // the bf16 pair at columns k, k + 1 of row r (k even); zero past K
  __device__ __forceinline__ uint32_t load2(int r, int k) const {
    return r < rows && k < K ? __ldg(reinterpret_cast<const uint32_t*>(x + size_t(r) * ld + k))
                             : 0u;
  }
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// Widening: one bf16x2 B register, (row a, row b) of one column
// ---------------------------------------------------------------------------

// int8 byte e of w as the exact f32 2^23 + (b + 128) minus 2^23 + 128
__device__ __forceinline__ float i8_value(uint32_t w, int e) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | e)) - 8388736.f;
}

// int4: nibble of byte e (`high`: the upper one) as 2^23 + (n ^ 8) minus 2^23 + 8
__device__ __forceinline__ float i4_value(uint32_t w, int e, bool high) {
  const uint32_t nib = ((high ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
  return __uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7440 | e)) - 8388616.f;
}

// Column j of two one-byte (or packed int4) rows; SCALED: bf16(q * s)
// with the product in f32, else the exact value.
template <int FMT, bool SCALED>
__device__ __forceinline__ uint32_t pair1(const uint32_t (&a)[4], const uint32_t (&b)[4], int j,
                                          bool high, float s) {
  const int w = j >> 2, e = j & 3;
  float lo, hi;
  if constexpr (FMT == kQInt8) {
    lo = i8_value(a[w], e);
    hi = i8_value(b[w], e);
  } else if constexpr (FMT == kQInt4) {
    lo = i4_value(a[w], e, high);
    hi = i4_value(b[w], e, high);
  } else {   // e4m3: bytes e of both rows as one e4m3x2, to f16 (exact), to f32
    const uint32_t two = __byte_perm(a[w], b[w], e | ((4 + e) << 4));
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    lo = f.x;
    hi = f.y;
  }
  if constexpr (SCALED) {
    lo *= s;
    hi *= s;
  }
  return pack2(lo, hi);
}

// Column j of two bf16 rows (8 words each): the halves as they are.
__device__ __forceinline__ uint32_t pair16(const uint32_t (&a)[8], const uint32_t (&b)[8], int j) {
  return __byte_perm(a[j >> 1], b[j >> 1], (j & 1) ? 0x7632 : 0x5410);
}

// ---------------------------------------------------------------------------
// A stage's products
// ---------------------------------------------------------------------------

// The A operand of stage `unit` for rows lane / 4 and lane / 4 + 8 (t =
// lane % 4): k16 step st takes the pairs at k and k + 8 with k = 16 st + 2 t
// of the stage's logical rows; those of int8 / e4m3 / bf16 are rows 32 unit
// .., int4's step 0 the low nibbles of its 16 packed rows (logical rows
// g gs + p .., g its group, p its first packed row in the group) and step 1
// the high ones (g gs + gs / 2 + p ..). a[4 st ..] = {row, row + 8} x {k,
// k + 8}, the m16n8k16 A fragment.
template <int FMT, class Rows>
__device__ __forceinline__ void load_a(const Rows& xr, int unit, int gs, int lane,
                                       uint32_t (&a)[8]) {
  const int gid = lane >> 2, t = lane & 3;
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    int k;
    if constexpr (FMT == kQInt4) {
      const int per = gs / kStageRows;   // stages a group
      k = (unit / per) * gs + (unit % per) * 16 + st * (gs / 2) + 2 * t;
    } else {
      k = unit * kStageRows + 16 * st + 2 * t;
    }
    a[4 * st] = xr.load2(gid, k);
    a[4 * st + 1] = xr.load2(gid + 8, k);
    a[4 * st + 2] = xr.load2(gid, k + 8);
    a[4 * st + 3] = xr.load2(gid + 8, k + 8);
  }
}

// acc[j] += A (the stage's A operand `a`, load_a's) x B (n-tile j) for the
// 16 n-tiles, from the warp's stage at `st`: k16 step s's B rows are 16 s +
// 2 t + {0, 1} (b0) and + {8, 9} (b1) (int4: packed rows 2 t + .., low
// nibbles in step 0, high in step 1).
template <int FMT, bool SCALED>
__device__ __forceinline__ void stage_products(const unsigned char* st, int lane,
                                               const uint32_t (&a)[8], const float (&sc)[16],
                                               float (&acc)[16][4]) {
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int step = 0; step < 2; ++step) {
    const uint32_t as[4] = {a[4 * step], a[4 * step + 1], a[4 * step + 2], a[4 * step + 3]};
    const int r0 = (FMT == kQInt4 ? 0 : 16 * step) + 2 * t;   // rows r0, r0 + 1, r0 + 8, r0 + 9
    if constexpr (FMT == kBf16) {
      uint32_t w[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + (i & 1) + 8 * (i >> 1);
        uint32_t lo[4], hi[4];
        lds4(st + chunk_at<FMT>(r, gr, 0), lo);
        lds4(st + chunk_at<FMT>(r, gr, 1), hi);
#pragma unroll
        for (int q = 0; q < 4; ++q) w[i][q] = lo[q], w[i][4 + q] = hi[q];
      }
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        mma_bf16(acc[j], as, pair16(w[0], w[1], j), pair16(w[2], w[3], j));
    } else {
      uint32_t w[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        lds4(st + chunk_at<FMT>(r0 + (i & 1) + 8 * (i >> 1), gr), w[i]);
      const bool high = FMT == kQInt4 && step == 1;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        mma_bf16(acc[j], as, pair1<FMT, SCALED>(w[0], w[1], j, high, sc[j]),
                 pair1<FMT, SCALED>(w[2], w[3], j, high, sc[j]));
    }
  }
}

// B7's scale fold at a group's end: acc += s x gacc, gacc = 0. s0 / s1:
// the scales of the lane's accumulator columns 32 t + j / 32 t + 16 + j
// (null: columns past N).
__device__ __forceinline__ void fold_group(float (&acc)[16][4], float (&gacc)[16][4],
                                           const float* s0, const float* s1) {
  float a[16], b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = b[j] = 0.f;
  if (s0 != nullptr) ldg16f(s0, a);
  if (s1 != nullptr) ldg16f(s1, b);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[j][0] = fmaf(a[j], gacc[j][0], acc[j][0]);
    acc[j][1] = fmaf(b[j], gacc[j][1], acc[j][1]);
    acc[j][2] = fmaf(a[j], gacc[j][2], acc[j][2]);
    acc[j][3] = fmaf(b[j], gacc[j][3], acc[j][3]);
    gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
  }
}

// B6's stage fold: acc += gacc in f32 (rounded to nearest), gacc = 0, so
// the tensor cores' own f32 accumulation spans one stage's 32 products.
// Accumulating all of K on the tensor cores left B6's g and u far enough
// from their f64 values that a = bf16(act(g) * u) rounded the other way
// 3.6x as often as in the plain version's f32 sums (PERF.md section 6).
__device__ __forceinline__ void add_stage(float (&acc)[16][4], float (&gacc)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[j][c] += gacc[j][c];
      gacc[j][c] = 0.f;
    }
}

// ---------------------------------------------------------------------------
// The block's sum of an item
// ---------------------------------------------------------------------------

// The tile column of lane group gr's j-th column: 16 gr + j (one-byte
// weights), or bf16's 8 gr + j of the first half and 64 + 8 gr + j - 8 of
// the second.
template <int FMT>
__host__ __device__ __forceinline__ int tile_col(int gr, int j) {
  if (FMT == kBf16) return j < 8 ? 8 * gr + j : 64 + 8 * gr + j - 8;
  return kLaneCols * gr + j;
}

// The warp's accumulators into red[warp][row][tile column] (rows < `rows`):
// lane quad t holds slots 2 t (acc[j][0], row lane / 4; acc[j][2], row + 8)
// and 2 t + 1 (acc[j][1], acc[j][3]) of n-tile j, the columns of lane
// groups 2 t and 2 t + 1. A row's 128 columns sit in four 32-column pieces
// 36 floats apart (one-byte weights: lane quad t's 32 columns one piece).
template <int FMT>
__device__ __forceinline__ void write_red(float* red, int warp, int lane, const float (&acc)[16][4],
                                          int rows) {
  const int gid = lane >> 2, t = lane & 3;
  float* base = red + warp * kRows * kRedLd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gid + 8 * h;
    if (r >= rows) continue;
    if constexpr (FMT != kBf16) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float4* p = reinterpret_cast<float4*>(base + r * kRedLd + 36 * t + 16 * e);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          p[q] = make_float4(acc[4 * q][2 * h + e], acc[4 * q + 1][2 * h + e],
                             acc[4 * q + 2][2 * h + e], acc[4 * q + 3][2 * h + e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) {
          const int c = tile_col<FMT>(2 * t + e, j);
          base[r * kRedLd + c + 4 * (c >> 5)] = acc[j][2 * h + e];
        }
    }
  }
}

// The block's sum at (row, tile column c): warps w0 .. w1 - 1's (a tile's
// parts) in warp order.
__device__ __forceinline__ float red_sum(const float* red, int r, int c, int w0 = 0,
                                         int w1 = kWarps) {
  float v = 0.f;
  for (int w = w0; w < w1; ++w) v += red[(w * kRows + r) * kRedLd + c + 4 * (c >> 5)];
  return v;
}

// After a block stored its split's partials of a tile: true in the block
// that finished the tile last (it then reads every split's partials; the
// counter is back at zero for the next call). Called by the whole block.
__device__ __forceinline__ bool last_of_tile(int* counter, int splits, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(counter, 1) == splits - 1;
    if (last) atomicExch(counter, 0);
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------------
// The item loop
// ---------------------------------------------------------------------------

// Runs the block's items (blockIdx.x, + gridDim.x, ...) of problem `p`:
// each warp's run of each item's stages through its ring, then
// done(item, geo, acc) with the warp's sums (called by every warp of the
// block for every item, in order). GSUM: B7's form (per-group sums folded
// with p.fold_scales), and over bf16 weights B6's (each stage's sums added
// to acc, add_stage); SCALED: B16's and B8's (bf16(q * s) in the B
// operand). A stage's A operand (and their scale row at a group's start)
// is loaded while the stage before it multiplies. `pre` runs after the
// rings' first loads are issued and before any product (a block-wide step
// such as the MLP's row statistics, ending in its own barrier). Each warp's lane 0
// initialises the warp's mbarriers, which only that warp uses.
template <int FMT, bool SCALED, bool GSUM, class P, class Pre, class Done>
__device__ __forceinline__ void run(const P& p, const Smem& sm, Pre&& pre, Done&& done) {
  constexpr int S = ring_stages<FMT>();
  constexpr int SB = stage_bytes<FMT>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* ring = sm.ring + warp * kRingBytes;
  uint64_t* bars = sm.bars + warp * 8;
  const int per = p.gs / kStageRows;   // stages a scale group
  if (lane == 0) {
    for (int i = 0; i < S; ++i) wg::mbar_init(&bars[i], 1);
    wg::mbar_fence_init();
  }
  __syncwarp();

  int li = 0, ld_item = blockIdx.x, ld_s = 0, ld_end = 0;
  bool ld_ok = seek(p, warp, ld_item, ld_s, ld_end);
  Geo lg{};
  if (ld_ok) lg = p.geo(ld_item, lane, warp);
  // the next stage of the warp's stream into slot li % S (lane 0 issues)
  auto issue = [&]() {
    if (!ld_ok) return;
    if (lane == 0) issue_stage<FMT>(ring + (li % S) * SB, &bars[li % S], lg, lg.u0 + ld_s);
    ++li;
    if (++ld_s == ld_end) {
      ld_item += gridDim.x;
      ld_ok = seek(p, warp, ld_item, ld_s, ld_end);
      if (ld_ok) lg = p.geo(ld_item, lane, warp);
    }
  };
#pragma unroll 1
  for (int i = 0; i < S - 1; ++i) issue();
  pre();

  int ci = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const Geo g = p.geo(item, lane, warp);
    const auto xr = p.rows_of(g);
    int s0, s1;
    warp_run(warp % p.parts, p.parts, p.units(item), s0, s1);
    float acc[16][4], gacc[16][4], sc[16];
    uint32_t a[8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[j] = 1.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = gacc[j][c] = 0.f;
    }
    if (s0 < s1) {
      load_a<FMT>(xr, g.u0 + s0, p.gs, lane, a);
      if constexpr (SCALED) {
        if (g.col_ok) ldg16f(g.s + size_t((g.u0 + s0) / per) * p.N + g.col, sc);
      }
    }
#pragma unroll 1
    for (int s = s0; s < s1; ++s) {
      __syncwarp();   // every lane is done with the slot the next load refills
      issue();
      const int unit = g.u0 + s;
      const bool more = s + 1 < s1;
      uint32_t an[8];
      float sn[16];
      if (more) load_a<FMT>(xr, unit + 1, p.gs, lane, an);
      if constexpr (SCALED) {
        if (more && (unit + 1) % per == 0 && g.col_ok)
          ldg16f(g.s + size_t((unit + 1) / per) * p.N + g.col, sn);
      }
      wg::mbar_wait(&bars[ci % S], (ci / S) & 1);
      const unsigned char* st = ring + (ci % S) * SB;
      if constexpr (GSUM) {
        stage_products<FMT, SCALED>(st, lane, a, sc, gacc);
        if constexpr (FMT == kBf16)
          add_stage(acc, gacc);
        else if (!more || (unit + 1) % per == 0)
          fold_group(acc, gacc, p.fold_scales(g, lane, warp, unit / per, 0),
                     p.fold_scales(g, lane, warp, unit / per, 1));
      } else {
        stage_products<FMT, SCALED>(st, lane, a, sc, acc);
      }
      ++ci;
      if (more) {
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = an[i];
        if constexpr (SCALED) {
          if ((unit + 1) % per == 0 && g.col_ok) {
#pragma unroll
            for (int j = 0; j < 16; ++j) sc[j] = sn[j];
          }
        }
      }
    }
    done(item, g, acc);
  }
}

// The block's sums of item g (its rows g.row0 .. of the call's `rows`,
// the tile's columns from g.c0 of `n`) into out (bf16 [rows, n]): directly
// with one split; else its split's f32 partials into part [splits, rows, n],
// and the tile's last block (counter g.grp x tiles + g.tile) adds every
// split's in split order. Called by the whole block.
template <int FMT>
__device__ __forceinline__ void store_sums(const Smem& sm, const Geo& g, const float (&acc)[16][4],
                                           int n, int rows, int splits, float* part,
                                           int* counters, __nv_bfloat16* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();   // the last item's sums are read
  write_red<FMT>(sm.red, warp, lane, acc, g.rows);
  __syncthreads();
  const int cells = g.rows * kTileCols;
  if (splits > 1) {
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const int r = i / kTileCols, c = i % kTileCols;
      if (g.c0 + c < n)
        part[(size_t(g.split) * rows + g.row0 + r) * n + g.c0 + c] = red_sum(sm.red, r, c);
    }
    const int tiles = (n + kTileCols - 1) / kTileCols;
    if (!last_of_tile(counters + g.grp * tiles + g.tile, splits, sm.meta)) return;
  }
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int r = i / kTileCols, c = i % kTileCols;
    if (g.c0 + c >= n) continue;
    float v = 0.f;
    if (splits == 1)
      v = red_sum(sm.red, r, c);
    else
#pragma unroll 4
      for (int s = 0; s < splits; ++s) v += __ldcg(part + (size_t(s) * rows + g.row0 + r) * n + g.c0 + c);
    out[size_t(g.row0 + r) * n + g.c0 + c] = __float2bfloat16(v);
  }
}

// The map of a contiguous [batch, rows, cols] tensor of one-byte or bf16
// (`bf16`) elements read in boxes of {box_cols, box_rows, 1} whose rows
// are 128 bytes (the 128-byte swizzle) or 64 bytes (the 64-byte swizzle);
// rows and columns past the tensor read as zeros.
inline cudaError_t box_map(CUtensorMap* map, const void* base, bool bf16, int batch,
                           long long rows, long long cols, int box_rows, int box_cols) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int eb = bf16 ? 2 : 1, row_bytes = box_cols * eb;
  if (row_bytes != 128 && row_bytes != 64) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * eb, cuuint64_t(cols) * eb * rows};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
      const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of `batch` [K, N] weights of format FMT in a stage's boxes:
// one-byte [32 rows][128 columns] (int4: 16 packed rows of [K / 2, N]),
// bf16 [32][64] (issue_stage loads two side by side).
template <int FMT>
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int batch, int K, int N) {
  if (FMT == kBf16) return box_map(map, w, true, batch, K, N, kStageRows, 64);
  if (FMT == kQInt4) return box_map(map, w, false, batch, K / 2, N, 16, kTileCols);
  return box_map(map, w, false, batch, K, N, kStageRows, kTileCols);
}

}  // namespace tcg
