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
// A quantized weight is dequantized in registers as bf16(q * s), the q * s
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
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): in a decode
// tick (8 rows, top-2: N = 16 on ~7 experts) the weight bytes of the
// experts hit: one Mixtral w_gate call reads ~7 x 59.6 MB of int8 and
// scales, >= 0.13 ms. Those calls (N <= 16) take a split-K GEMV: blocks of
// (64 columns, <= 8 rows of one group, a chunk of whole scale groups <=
// 1024 rows), each streaming its weight rows once with 8- (int8, fp8) or
// 16-byte (bf16) loads into FMAs for only as many rows (1, 2, 4 or 8) as
// its group has, f32 partials [splits, N, F] added in split order by
// grouped_out_kernel (two runs give equal bits). Larger calls (a tick's
// 512 chunk rows: all experts, 477 MB, >= 0.14 ms; a put() of 8 x 1024
// prompts: 16,384 rows, 1.92 TFLOP, >= 1.95 ms) take a tiled tensor-core
// kernel: 128 x 128 output tiles of one group, 8 warps of 32 x 64, K steps
// of 32 rows that never cross a scale group, the x tile, the raw weight
// tile and the scale row copied with cp.async three steps ahead, the
// weight tile dequantized by all threads into a bf16 tile, mma.sync
// m16n8k16 (bf16, f32 accumulators) from ldmatrix fragments. A group's
// weights are read once per 128 of its rows. wgmma, TMA and a producer
// warp are later work.
//
// The backward (megablox ops.py:63-101, the custom VJP jax.grad reaches
// through _grouped_matmul_gmm) is two more tensor-core kernels, bf16 only
// (training casts the expert stacks to the activations' bf16):
//   B16-dx  dx [N, K] = dout [N, F] @ w[g]^T       (megablox gmm(transpose_rhs))
//   B16-dw  dw [E, K, F], block g = x_g^T @ dout_g   (megablox tgmm)
// Both sum in f32 and round once to bf16; no sum is split across blocks,
// so two runs give equal bits.
//
// dx is the forward's tiled form with the weight read as it lies: the
// contraction runs over F, and a [128 of K][32 of F] weight tile is the
// mma's column-major B operand, taken with plain ldmatrix (no transpose,
// no dequantize pass). Row tiles come from find_tile as in the forward:
// an empty group has no tile and reads no weight bytes, rows past the
// groups' sum are written as zeros. Calls of 16 rows or fewer take the
// same tiled kernel (training calls have thousands of rows).
// dw's grid is (F tile, K tile, group); a block finds its group's row
// range on the device, walks the rows in 32-row steps (a masked tail),
// the x and dout tiles [32 rows][128] copied with cp.async three steps
// ahead and taken as ldmatrix.trans fragments (x^T as the row-major A,
// dout as the B), and writes its [128 x 128] block once; a group of no
// rows writes zeros. Groups are very uneven (0 to 65,472 rows at
// bench.py's _config3 shapes); the rows of one group are not split
// across blocks, so a long group is one long walk per output tile.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s), both kernels being
// 2 N K F operations with N rows, K x F expert matrices:
//   _config3 (K 1024, F 2816 and the transpose), ragged N 65,472:
//     377.6 GFLOP -> 0.382 ms (operations; dx moves 0.549 GB, 0.164 ms);
//   _config3 capacity, 8 x 10,230 rows: 472.0 GFLOP -> 0.477 ms;
//   Mixtral (4096 x 14336), 16,384 rows: 1.924 TFLOP -> 1.946 ms.
// Operations bound every training shape; the simple mma.sync forms here
// are expected well short of it (wgmma is later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_gemv.cuh"   // kQInt8 / kQFp8, q_value, deq<ROUND_W>
#include "mma_sync.cuh"     // cp_async16, ldsm_x4, mma_bf16, ...

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

// ---------------------------------------------------------------------------
// The tensor-core form
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kStages = 3;                // K steps in flight
constexpr int kMmaThreads = 256;          // 8 warps: 4 along M x 2 along N
constexpr int kLDA = kBK + 8;             // padded x tile row, in bf16 (80 bytes)
constexpr int kLDB = kBN + 8;             // padded bf16 weight tile row (272 bytes)

struct Stage {
  __nv_bfloat16 a[kBM * kLDA];   // x tile [128][32 + 8]
  uint8_t q[kBK * kBN * 2];      // raw weight rows [32][128] (bf16: 256 bytes a row)
  float s[kBN];                  // the step's scale row
};

// Issue the copies of K step `step` of row tile (row0, rows) into `st`
// (the caller commits). Rows of x past the tile and K rows past K are
// zero-filled.
template <int FMT>
__device__ __forceinline__ void load_step(Stage& st, const __nv_bfloat16* __restrict__ x,
                                          const uint8_t* __restrict__ q,
                                          const float* __restrict__ sc, int row0, int rows, int K,
                                          int F, int gs, int n0, int step, int tid) {
  const int k0 = step * kBK;
  // x: 128 rows x 4 vectors of 8 bf16
  for (int i = tid; i < kBM * 4; i += kMmaThreads) {
    const int r = i / 4, v = i % 4;
    const bool ok = r < rows && k0 + v * 8 < K;
    const __nv_bfloat16* src = x + (ok ? size_t(row0 + r) * K + k0 + v * 8 : 0);
    cp_async16(st.a + r * kLDA + v * 8, src, ok);
  }
  // raw weight rows: 128 columns = 8 (int8, fp8) or 16 (bf16) vectors a row
  constexpr int eb = elt_bytes<FMT>();
  constexpr int vecs = kBN * eb / 16;
  for (int i = tid; i < kBK * vecs; i += kMmaThreads) {
    const int r = i / vecs, v = i % vecs;
    const int col = n0 + v * (16 / eb);
    const bool ok = col < F && k0 + r < K;
    const uint8_t* src = q + (ok ? (size_t(k0 + r) * F + col) * eb : 0);
    cp_async16(st.q + r * kBN * eb + v * 16, src, ok);
  }
  // scales: 128 f32 = 32 vectors
  if constexpr (FMT != kGBf16) {
    if (tid < kBN / 4) {
      const bool ok = n0 + tid * 4 < F;
      cp_async16(st.s + tid * 4, sc + (ok ? size_t(k0 / gs) * F + n0 + tid * 4 : 0), ok);
    }
  }
}

constexpr size_t kMmaSmem = kStages * sizeof(Stage) + size_t(kBK) * kLDB * sizeof(__nv_bfloat16);

// Block (column tile, row slot): out rows of the slot's tile = x rows @
// the group's weight.
template <int FMT>
__global__ void __launch_bounds__(kMmaThreads) grouped_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ sc, const int* __restrict__ group_sizes, int E, int N, int K, int F,
    int gs, __nv_bfloat16* __restrict__ out) {
  const RowTile tile = find_tile(group_sizes, E, N, kBM, blockIdx.y);
  if (tile.group == -2) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kBN;
  if (tile.group == -1) {    // rows past the groups: zeros
    for (int i = tid; i < tile.rows * kBN; i += kMmaThreads) {
      const int r = i / kBN, c = n0 + i % kBN;
      if (c < F) out[size_t(tile.row0 + r) * F + c] = __float2bfloat16(0.f);
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  // the dequantized weight tile [32][136]
  __nv_bfloat16* bt = reinterpret_cast<__nv_bfloat16*>(smem + kStages * sizeof(Stage));
  constexpr int eb = elt_bytes<FMT>();
  const uint8_t* __restrict__ q = w + size_t(tile.group) * K * F * eb;
  const float* __restrict__ scg =
      FMT == kGBf16 ? nullptr : sc + size_t(tile.group) * (K / gs) * F;
  const int wm = warp % 4, wn = warp / 4;    // warp tile: rows wm*32, columns wn*64
  const int steps = (K + kBK - 1) / kBK;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one commit group per step, empty past the end, so the wait below
  // always leaves the newer kStages - 1 steps in flight
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps)
      load_step<FMT>(stage[i], x, q, scg, tile.row0, tile.rows, K, F, gs, n0, i, tid);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int ahead = step + kStages - 1;
    if (ahead < steps)
      load_step<FMT>(stage[ahead % kStages], x, q, scg, tile.row0, tile.rows, K, F, gs, n0,
                     ahead, tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Stage& st = stage[step % kStages];

    // the bf16 weight tile: thread -> (row kr, 16 columns)
    {
      const int kr = tid / 8, c0 = (tid % 8) * 16;
      if constexpr (FMT == kGBf16) {
        const uint4* src = reinterpret_cast<const uint4*>(st.q + (kr * kBN + c0) * 2);
        *reinterpret_cast<uint4*>(bt + kr * kLDB + c0) = src[0];
        *reinterpret_cast<uint4*>(bt + kr * kLDB + c0 + 8) = src[1];
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(st.q + kr * kBN + c0);
        const uint2 lo2 = make_uint2(raw.x, raw.y), hi2 = make_uint2(raw.z, raw.w);
        union {
          __nv_bfloat162 h[4];
          uint4 u;
        } w0, w1;
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          w0.h[e / 2] = __floats2bfloat162_rn(q_value<FMT>(lo2, e, 0) * st.s[c0 + e],
                                              q_value<FMT>(lo2, e + 1, 0) * st.s[c0 + e + 1]);
          w1.h[e / 2] = __floats2bfloat162_rn(q_value<FMT>(hi2, e, 0) * st.s[c0 + 8 + e],
                                              q_value<FMT>(hi2, e + 1, 0) * st.s[c0 + 9 + e]);
        }
        *reinterpret_cast<uint4*>(bt + kr * kLDB + c0) = w0.u;
        *reinterpret_cast<uint4*>(bt + kr * kLDB + c0 + 8) = w1.u;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], st.a + (wm * 32 + i * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLDA +
                           kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, bt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLDB + wn * 64 +
                             np * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * np], af[i], r[0], r[1]);
          mma_bf16(acc[i][2 * np + 1], af[i], r[2], r[3]);
        }
      }
    }
    __syncthreads();   // done with this stage and the bf16 tile before they are refilled
  }

  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn * 64 + j * 8 + tq * 2;
      if (col >= F) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + g + h * 8;
        if (r >= tile.rows) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + size_t(tile.row0 + r) * F + col) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <int FMT>
cudaError_t launch_forms(cudaStream_t s, const __nv_bfloat16* x, const uint8_t* w,
                         const float* sc, const int* sizes, __nv_bfloat16* out, float* part,
                         int N, int K, int F, int E, int gs, int splits, int chunk) {
  if (N <= kGemvMaxN) {
    const dim3 grid((F + kGTN - 1) / kGTN, (N + kGRows - 1) / kGRows + E, splits);
    grouped_gemv_kernel<FMT><<<grid, kGThreads, 0, s>>>(x, w, sc, sizes, E, N, K, F, gs, chunk,
                                                        part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t NF = size_t(N) * F;
    grouped_out_kernel<<<unsigned((NF + 255) / 256), 256, 0, s>>>(part, splits, NF, out);
    return cudaGetLastError();
  }
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_mma_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kMmaSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kBN - 1) / kBN, (N + kBM - 1) / kBM + E);
  grouped_mma_kernel<FMT><<<grid, kMmaThreads, kMmaSmem, s>>>(x, w, sc, sizes, E, N, K, F, gs,
                                                              out);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The backward: dx (B16-dx) and dw (B16-dw), bf16
// ---------------------------------------------------------------------------

constexpr int kLDT = kBK + 8;             // padded [rows][32] tile row, in bf16 (80 bytes)
constexpr int kLDW = kBN + 8;             // padded [32][128] tile row, in bf16 (272 bytes)

struct DxStage {
  __nv_bfloat16 a[kBM * kLDT];   // dout tile [128 rows][32 of F]
  __nv_bfloat16 b[kBN * kLDT];   // weight tile [128 of K][32 of F]
};

struct DwStage {
  __nv_bfloat16 a[kBK * kLDW];   // x tile [32 rows][128 of K]
  __nv_bfloat16 b[kBK * kLDW];   // dout tile [32 rows][128 of F]
};

constexpr size_t kDxSmem = kStages * sizeof(DxStage);
constexpr size_t kDwSmem = kStages * sizeof(DwStage);

// Copies of F step `step` for a dx block: dout rows of the tile and the
// weight rows k0.. of its group, 32 columns each; past the edges zeros.
__device__ __forceinline__ void load_dx_step(DxStage& st, const __nv_bfloat16* __restrict__ dout,
                                             const __nv_bfloat16* __restrict__ wg, int row0,
                                             int rows, int K, int F, int k0, int step, int tid) {
  const int f0 = step * kBK;
  for (int i = tid; i < kBM * 4; i += kMmaThreads) {
    const int r = i / 4, v = i % 4;
    const bool ok = r < rows && f0 + v * 8 < F;
    cp_async16(st.a + r * kLDT + v * 8, dout + (ok ? size_t(row0 + r) * F + f0 + v * 8 : 0), ok);
  }
  for (int i = tid; i < kBN * 4; i += kMmaThreads) {
    const int r = i / 4, v = i % 4;
    const bool ok = k0 + r < K && f0 + v * 8 < F;
    cp_async16(st.b + r * kLDT + v * 8, wg + (ok ? size_t(k0 + r) * F + f0 + v * 8 : 0), ok);
  }
}

// Block (K tile, row slot): dx rows of the slot's tile = dout rows @ the
// group's weight^T.
__global__ void __launch_bounds__(kMmaThreads) grouped_dx_kernel(
    const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ group_sizes, int E, int N, int K, int F,
    __nv_bfloat16* __restrict__ dx) {
  const RowTile tile = find_tile(group_sizes, E, N, kBM, blockIdx.y);
  if (tile.group == -2) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kBN;
  if (tile.group == -1) {    // rows past the groups: zeros
    for (int i = tid; i < tile.rows * kBN; i += kMmaThreads) {
      const int r = i / kBN, c = k0 + i % kBN;
      if (c < K) dx[size_t(tile.row0 + r) * K + c] = __float2bfloat16(0.f);
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  DxStage* stage = reinterpret_cast<DxStage*>(smem);
  const __nv_bfloat16* __restrict__ wg = w + size_t(tile.group) * K * F;
  const int wm = warp % 4, wn = warp / 4;    // warp tile: rows wm*32, columns wn*64
  const int steps = (F + kBK - 1) / kBK;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) load_dx_step(stage[i], dout, wg, tile.row0, tile.rows, K, F, k0, i, tid);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int ahead = step + kStages - 1;
    if (ahead < steps)
      load_dx_step(stage[ahead % kStages], dout, wg, tile.row0, tile.rows, K, F, k0, ahead, tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const DxStage& st = stage[step % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], st.a + (wm * 32 + i * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLDT +
                           kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // [K rows][F] is the column-major B: b0/b1 of columns np*16.. and np*16 + 8..
        uint32_t r[4];
        ldsm_x4(r, st.b + (wn * 64 + np * 16 + (lane % 8) + (lane / 16) * 8) * kLDT + kk * 16 +
                       ((lane / 8) % 2) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * np], af[i], r[0], r[1]);
          mma_bf16(acc[i][2 * np + 1], af[i], r[2], r[3]);
        }
      }
    }
    __syncthreads();   // done with this stage before it is refilled
  }

  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + wn * 64 + j * 8 + tq * 2;
      if (col >= K) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + g + h * 8;
        if (r >= tile.rows) continue;
        *reinterpret_cast<__nv_bfloat162*>(dx + size_t(tile.row0 + r) * K + col) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// Copies of row step `step` for a dw block: rows r0.. (below rend) of x
// (columns k0..) and of dout (columns f0..); past the edges zeros.
__device__ __forceinline__ void load_dw_step(DwStage& st, const __nv_bfloat16* __restrict__ x,
                                             const __nv_bfloat16* __restrict__ dout, int r0,
                                             int rend, int K, int F, int k0, int f0, int tid) {
  for (int i = tid; i < kBK * (kBM / 8); i += kMmaThreads) {
    const int r = i / (kBM / 8), v = i % (kBM / 8);
    const bool ok = r0 + r < rend && k0 + v * 8 < K;
    cp_async16(st.a + r * kLDW + v * 8, x + (ok ? size_t(r0 + r) * K + k0 + v * 8 : 0), ok);
  }
  for (int i = tid; i < kBK * (kBN / 8); i += kMmaThreads) {
    const int r = i / (kBN / 8), v = i % (kBN / 8);
    const bool ok = r0 + r < rend && f0 + v * 8 < F;
    cp_async16(st.b + r * kLDW + v * 8, dout + (ok ? size_t(r0 + r) * F + f0 + v * 8 : 0), ok);
  }
}

// Block (F tile, K tile, group g): dw[g][k0.., f0..] = x_g^T @ dout_g over
// the group's rows, in row order.
__global__ void __launch_bounds__(kMmaThreads) grouped_dw_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dout,
    const int* __restrict__ group_sizes, int E, int N, int K, int F,
    __nv_bfloat16* __restrict__ dw) {
  const int grp = blockIdx.z;
  const int k0 = blockIdx.y * kBM, f0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the group's rows, sizes clamped as in find_tile
  int off = 0;
  for (int e = 0; e < grp; ++e) off += max(0, min(__ldg(group_sizes + e), N - off));
  const int size = max(0, min(__ldg(group_sizes + grp), N - off));
  __nv_bfloat16* __restrict__ out = dw + size_t(grp) * K * F;
  if (size == 0) {           // an empty group: a zero block
    for (int i = tid; i < kBM * kBN; i += kMmaThreads) {
      const int r = k0 + i / kBN, c = f0 + i % kBN;
      if (r < K && c < F) out[size_t(r) * F + c] = __float2bfloat16(0.f);
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  DwStage* stage = reinterpret_cast<DwStage*>(smem);
  const int rend = off + size;
  const int wm = warp % 4, wn = warp / 4;    // warp tile: K rows wm*32, F columns wn*64
  const int steps = (size + kBK - 1) / kBK;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) load_dw_step(stage[i], x, dout, off + i * kBK, rend, K, F, k0, f0, tid);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int ahead = step + kStages - 1;
    if (ahead < steps)
      load_dw_step(stage[ahead % kStages], x, dout, off + ahead * kBK, rend, K, F, k0, f0, tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const DwStage& st = stage[step % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // x^T as the row-major A: the stored [rows][K] tile read transposed
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_trans(af[i], st.a + (kk * 16 + (lane % 8) + (lane / 16) * 8) * kLDW + wm * 32 +
                                 i * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, st.b + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLDW + wn * 64 +
                             np * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * np], af[i], r[0], r[1]);
          mma_bf16(acc[i][2 * np + 1], af[i], r[2], r[3]);
        }
      }
    }
    __syncthreads();   // done with this stage before it is refilled
  }

  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + wn * 64 + j * 8 + tq * 2;
      if (col >= F) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = k0 + wm * 32 + i * 16 + g + h * 8;
        if (r >= K) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + size_t(r) * F + col) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
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
// f32 partials in part [splits, N, F]; larger N the tensor-core kernel.
// Needs K % 8 == 0, F % 16 == 0 (bf16: F % 8 == 0) and, quantized, K % gs
// == 0 and gs % 32 == 0.
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
  if (fmt == kQInt8)
    err = launch_forms<kQInt8>(s, xp, wp, sp, gp, op, pp, N, K, F, E, gs, splits, chunk);
  else if (fmt == kQFp8)
    err = launch_forms<kQFp8>(s, xp, wp, sp, gp, op, pp, N, K, F, E, gs, splits, chunk);
  else
    err = launch_forms<kGBf16>(s, xp, wp, sp, gp, op, pp, N, K, F, E, gs, splits, chunk);
  return static_cast<int>(err);
}

// dx [N, K] bf16 = dout [N, F] bf16 (rows sorted by group) @ w[g]^T for
// the bf16 stack w [E, K, F], by group_sizes [E] int32 on the device.
// Needs K % 8 == 0 and F % 8 == 0.
int sxt_grouped_matmul_dx_bf16(const void* dout, const void* w, const void* group_sizes,
                               void* dx, int N, int K, int F, int E, void* stream) {
  if (N <= 0 || K <= 0) return 0;
  if (E < 1 || F < 1 || K % 8 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(grouped_dx_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(kDxSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + kBN - 1) / kBN, (N + kBM - 1) / kBM + E);
  grouped_dx_kernel<<<grid, kMmaThreads, kDxSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(group_sizes), E, N, K, F, static_cast<__nv_bfloat16*>(dx));
  return static_cast<int>(cudaGetLastError());
}

// dw [E, K, F] bf16: block g = x_g^T @ dout_g over group g's rows of x
// [N, K] and dout [N, F] (bf16, rows sorted by group), zeros for an empty
// group; group_sizes [E] int32 on the device. Needs K % 8 == 0 and F % 8
// == 0.
int sxt_grouped_matmul_dw_bf16(const void* x, const void* dout, const void* group_sizes,
                               void* dw, int N, int K, int F, int E, void* stream) {
  if (E <= 0 || K <= 0 || F <= 0) return 0;
  if (N < 0 || K % 8 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(grouped_dw_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(kDwSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + kBN - 1) / kBN, (K + kBM - 1) / kBM, E);
  grouped_dw_kernel<<<grid, kMmaThreads, kDwSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const int*>(group_sizes), E, N, K, F, static_cast<__nv_bfloat16*>(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
