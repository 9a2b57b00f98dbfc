// Per-row LoRA delta for Hopper (sm_90a): out [B, T, N] bf16, row b =
// bf16((x[b] @ A[slot[b]]) @ B[slot[b]]), behind a plain C interface
// loaded with ctypes (ops/_build.py builds this file with nvcc at first
// use).
//
// Replaces the TPU kernel
//   shuffle_exchange_tpu/ops/lora_gemm.py:lora_delta_pallas
// which the serving layer body calls once per adapted projection (wq, wk,
// wv, wo) of every layer and lane when the adapter pool is on: x [B, T, D]
// bf16, the layer's factor stacks A [S, D, R] and B [S, R, N] bf16 (views
// of the pool's [L, S, ...] planes; slot 0 is all zeros, the null
// adapter), and slots [B] int32 ON THE DEVICE. Each block reads its row's
// slot from device memory (the TPU kernel's scalar prefetch); the host
// never reads the slots. A slot outside [0, S) writes NaN rows, so a bad
// index shows instead of reading past the pool.
//
// Numerics are the TPU kernel's and the oracle's: mid = x @ A[slot] with
// f32 sums, kept in f32 (never rounded to one bf16 between the two
// products, as Punica-style kernels do), then out = mid @ f32(B[slot]) in
// f32, cast once. Every row is computed, null rows included: their zero
// factors give an exact 0.0. Sums run in a fixed order with no atomics,
// and how a row's sums are split depends on T, D and R only, so two runs
// give equal bits and a row's result does not depend on the other rows of
// the call.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): the bytes of x
// and out plus the factors of the distinct slots the rows name. A decode
// tick's call (8 rows, T = 1, D = 4096, R = 8) moves ~0.6 MB: ~0.2 us, so
// it is bound by the launch. A put() of 8 x 1024 prompts at N = 4096 moves
// 128 MB of x and out: >= 38 us; its products (2 T (D + N) R a row) stay
// under that on the tensor cores at every rank up to 256.
//
// Design:
// - One-token rows at ranks up to kRowRank (decode ticks at the small ranks
//   serving pools use): lora_row_kernel, one block of 256 threads per row
//   on the CUDA cores, one launch where the pair below takes two (on the
//   H100: 0.0154-0.0165 against 0.0170-0.0174 ms at rank 8; from rank 16
//   the pair is faster). Stage 1 streams A[slot] as it lies in memory,
//   thread t taking rows d = t, t + 256, ... (a warp reads 32 consecutive
//   rows: coalesced) and keeping R partial sums in registers; a fixed
//   xor-shuffle tree per warp, then the 8 warps in order, give mid [R] in
//   shared memory. Stage 2 reads B[slot]
//   row by row, 8 columns a thread in 16-byte loads (any N: a scalar path
//   when N % 8 != 0), and writes 8 bf16 at once.
// - Every other call (rows of more than one token at every rank, one-token
//   rows past kRowRank): two tensor-core launches through bf16 scratch.
//   lora_shrink_kernel: a block is 64 tokens of one row (4 warps of 16) by
//   a chunk of ranks (16, 32 or 64 up to rank 64, 128 past it) by a split
//   of D; mma.sync m16n8k16 (bf16 in, f32 sums) over 64-row D steps of x's
//   tile and A[slot]'s, copied by cp.async four steps deep. Few tokens split
//   D (whole steps, at most 8) so the A[slot] bytes each token tile reads
//   spread over the SMs; the splits of a (row, tile, chunk) are one thread
//   block cluster, which adds their sums in split order through its
//   distributed shared memory (each block a slice of the elements). The
//   block that ends with mid's value (f32) writes it as two bf16 terms, hi
//   = bf16(mid) and lo = bf16(mid - hi), into mid [2, B, T, R rounded up
//   to 16] (as the flash kernels carry P). The rank chunk runs fastest in
//   the grid, then the token tile, so a row's blocks share A[slot] (and a
//   tile's chunks its x) through L2.
//   lora_expand_kernel: a block is 64 tokens of one row by a range of N;
//   it runs mma.sync over 64-column tiles of B[slot] (64 ranks a ring
//   stage, three deep, only the ranks up to R rounded to 16 read): out =
//   hi @ B + lo @ B summed in f32, cast once, through a warp's staging tile
//   to whole row segments. Up to rank kResidentRank the block copies mid's
//   two terms for its tokens into shared memory once; past it each ring
//   stage carries its 64 ranks of mid's terms beside B's tile (read again
//   for each column tile), so every rank fits. B's values are bf16, so
//   each product is exact; what the two terms drop is mid - hi - lo, at
//   most 2^-16 of |mid| (round to nearest twice), 2^-8 of what one bf16
//   term drops.
//   Ranks that are not a multiple of 8 (no 16-byte rows), D or N that are
//   not, or unaligned bases, load element by element, zero-filled; the
//   tiles' ranks past R are zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_sync.cuh"   // cp_async16, ldsm_x4(_trans), mma_bf16

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowRank = 8;      // ranks the one-token row kernel takes

// the tensor-core pair
constexpr int kTcThreads = 128;  // 4 warps of 16 tokens
constexpr int kTile = 64;        // tokens a block
constexpr int kStep = 64;        // D rows (shrink) or ranks (expand) a ring stage
constexpr int kExpandCols = 64;  // output columns an expand tile
constexpr int kLd = 72;          // bf16 a tile row: 64 + 8 (144 bytes: 8 bank groups)
constexpr int kShrinkStages = 4; // D steps in flight (the x tiles bound the shrink)
constexpr int kStages = 3;       // B tiles in flight (expand)
constexpr int kResidentRank = 512;  // ranks whose mid an expand block holds whole
constexpr int kMaxSplits = 8;    // D splits at most: one portable thread block cluster
constexpr int kTileBytes = kTile * kLd * 2;   // one [64][72] bf16 tile

// the shrink block's shared memory: a ring of (x tile, A tile of CW = 8 NT
// rank columns, rows CW + 8 apart) stages
__host__ __device__ constexpr int shrink_smem(int nt) {
  return kShrinkStages * (kTileBytes + kTile * (8 * nt + 8) * 2);
}
__host__ __device__ constexpr int round16(int r) { return (r + 15) / 16 * 16; }
// the shrink block's n8 rank tiles: one chunk of 16, 32 or 64 ranks up to
// rank 64, chunks of 128 past it
__host__ __device__ constexpr int shrink_tiles(int R) {
  return R > 64 ? 16 : R > 32 ? 8 : R > 16 ? 4 : 2;
}
// whether the expand block holds mid's two terms whole (else a ring stage
// carries its ranks' share)
__host__ __device__ constexpr bool mid_resident(int R) { return round16(R) <= kResidentRank; }
// the expand block's shared memory at rank R: the ring of B tiles (the
// ranks up to 64 a stage, rounded to 16, by kExpandCols + 8 columns), mid's
// hi and lo terms (whole: [64][round16(R) + 8] each; else [64][kLd] each a
// stage), and each warp's [16][kExpandCols + 8] staging tile of the epilogue
__host__ __device__ constexpr int expand_smem(int R) {
  return (mid_resident(R) ? kStages * (round16(R) < kStep ? round16(R) : kStep) *
                                    (kExpandCols + 8) + 2 * kTile * (round16(R) + 8)
                          : kStages * (kStep * (kExpandCols + 8) + 2 * kTile * kLd)) * 2 +
         4 * 16 * (kExpandCols + 8) * 2;
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

// A slot outside [0, S) writes NaN over the block's rows and returns true.
__device__ __forceinline__ bool bad_slot(int slot, int S, __nv_bfloat16* out, size_t n) {
  if (slot >= 0 && slot < S) return false;
  const __nv_bfloat16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) out[i] = nan;
  return true;
}

// ---------------------------------------------------------------------------
// One-token rows
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
lora_row_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b, const int* __restrict__ slots,
                __nv_bfloat16* __restrict__ out, int D, int R, int N, int S) {
  __shared__ float red[kWarps][kRowRank];
  __shared__ float mid[kRowRank];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = __ldg(slots + row);
  __nv_bfloat16* o = out + static_cast<size_t>(row) * N;
  if (bad_slot(slot, S, o, N)) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * D;
  const __nv_bfloat16* A = a + static_cast<size_t>(slot) * D * R;
  const __nv_bfloat16* Bm = b + static_cast<size_t>(slot) * R * N;

  // stage 1: partial sums over d = tid, tid + 256, ... in order
  float part[kRowRank];
#pragma unroll
  for (int r = 0; r < kRowRank; ++r) part[r] = 0.f;
#pragma unroll 4
  for (int d = tid; d < D; d += kThreads) {
    const float xv = bf(xr[d]);
    const __nv_bfloat16* ar = A + static_cast<size_t>(d) * R;
#pragma unroll
    for (int r = 0; r < kRowRank; ++r)
      if (r < R) part[r] = fmaf(xv, bf(ar[r]), part[r]);
  }
#pragma unroll
  for (int r = 0; r < kRowRank; ++r) {
    if (r < R) {                                   // R is the same for the whole block
      float s = part[r];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp][r] = s;
    }
  }
  __syncthreads();
  if (tid < R) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    mid[tid] = s;
  }
  __syncthreads();

  // stage 2: out[n] = bf16(sum_r mid[r] f32(B[r][n]))
  if ((N & 7) == 0) {
    for (int c = tid * 8; c < N; c += kThreads * 8) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 8
      for (int r = 0; r < R; ++r) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(Bm + static_cast<size_t>(r) * N + c));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float m = mid[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          acc[2 * j] = fmaf(m, f.x, acc[2 * j]);
          acc[2 * j + 1] = fmaf(m, f.y, acc[2 * j + 1]);
        }
      }
      uint4 w;
      __nv_bfloat162* wh = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j) wh[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
      *reinterpret_cast<uint4*>(o + c) = w;
    }
  } else {
    for (int n = tid; n < N; n += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < R; ++r) acc = fmaf(mid[r], bf(Bm[static_cast<size_t>(r) * N + n]), acc);
      o[n] = __float2bfloat16(acc);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core pair: shrink (mid = x @ A as two bf16 terms), expand
// (out = hi @ B + lo @ B)
// ---------------------------------------------------------------------------

// Copies rows [0, tile_rows) x columns [c0, c0 + COLS) of a row-major bf16
// matrix (rows `ld` apart from `src`) into a tile whose rows are LD apart;
// row r is read where r < rows, column c where c < c_end (elsewhere zeros).
// vec: every row and c0 16-byte aligned and c_end - c0 a multiple of 8 or
// past the tile: cp.async 16 bytes a copy (the caller commits); else
// element by element.
template <int COLS, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* src, size_t ld,
                                          int rows, int c0, int c_end, bool vec,
                                          int tile_rows = kTile) {
  constexpr int V = COLS / 8;
  if (vec) {
    for (int i = threadIdx.x; i < tile_rows * V; i += kTcThreads) {
      const int r = i / V, c = c0 + (i % V) * 8;
      const bool ok = r < rows && c < c_end;
      cp_async16(tile + r * LD + (i % V) * 8, ok ? src + size_t(r) * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < tile_rows * COLS; i += kTcThreads) {
      const int r = i / COLS, c = c0 + i % COLS;
      tile[r * LD + i % COLS] =
          r < rows && c < c_end ? src[size_t(r) * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// mid value v of (token t, rank r) as its two bf16 terms: hi = bf16(v) and
// lo = bf16(v - hi), rows rp apart (mid [2][B T][rp]: hi, then lo).
__device__ __forceinline__ void put_mid(__nv_bfloat16* hi, __nv_bfloat16* lo, size_t at, float v) {
  const __nv_bfloat16 h = __float2bfloat16(v);
  hi[at] = h;
  lo[at] = __float2bfloat16(v - __bfloat162float(h));
}

// Block (token tile x rank chunk, row b, D split): the sums over the
// split's D rows of x[b][t][d] A[slot][d][c0 + r] for the tile's 64 tokens
// and the chunk's CW = 8 NT ranks (NT: 2, 4, 8 or 16). One split: they are
// mid, written as its two bf16 terms. Several: the splits of a (row,
// tile, chunk) are one thread block cluster (1, 1, splits), which adds
// them in split order through its shared memory and writes mid's terms.
template <int NT>
__global__ void __launch_bounds__(kTcThreads) lora_shrink_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
    const int* __restrict__ slots, __nv_bfloat16* __restrict__ mid, int B, int T, int D, int R,
    int S, int chunk, int splits, int vec_x, int vec_a) {
  constexpr int CW = 8 * NT, LDA = CW + 8;
  constexpr int STAGE = kTileBytes + kTile * LDA * 2;
  static_assert(kTile * CW * 4 <= kShrinkStages * STAGE, "the cluster's sums fit the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = (R + CW - 1) / CW;
  const int tile = blockIdx.x / chunks, ck = blockIdx.x % chunks;
  const int t0 = tile * kTile, c0 = ck * CW;
  const int b = blockIdx.y, split = blockIdx.z;
  const int slot = __ldg(slots + b);
  if (slot < 0 || slot >= S) return;   // the expand kernel writes the row's NaNs (the
                                       // cluster's blocks share the row: all return)
  const int tt = min(kTile, T - t0);
  const int d0 = split * chunk, d1 = min(D, d0 + chunk);
  const int steps = (d1 - d0 + kStep - 1) / kStep;
  const __nv_bfloat16* xr = x + (size_t(b) * T + t0) * D;
  const __nv_bfloat16* A = a + size_t(slot) * D * R;
  const int c_end = min(R, c0 + CW);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto xs = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem + st * STAGE); };
  auto as = [&](int st) { return xs(st) + kTile * kLd; };
  auto load = [&](int s) {
    const int d = d0 + s * kStep;
    load_tile<kStep, kLd>(xs(s % kShrinkStages), xr + d, D, tt, 0, d1 - d, vec_x);
    load_tile<CW, LDA>(as(s % kShrinkStages), A + size_t(d) * R, R, d1 - d, c0, c_end, vec_a);
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kShrinkStages - 1; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    if (s + kShrinkStages - 1 < steps) load(s + kShrinkStages - 1);
    cp_async_commit();
    cp_async_wait<kShrinkStages - 1>();
    __syncthreads();
    const __nv_bfloat16* xt = xs(s % kShrinkStages);
    const __nv_bfloat16* at = as(s % kShrinkStages);
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, xt + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLd + kk * 16 +
                      (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, at + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDA + np * 16 +
                             (lane / 16) * 8);
        mma_bf16(acc[2 * np], af, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], af, r[2], r[3]);
      }
    }
    __syncthreads();   // done with this stage before it is refilled
  }

  // fragment (j, h, e): token warp * 16 + lane / 4 + 8 h, rank c0 + 8 j + 2 (lane % 4) + e
  const int g = lane / 4, tq = lane % 4;
  const int rp = round16(R), c_mid = min(rp, c0 + CW);   // mid's columns (zeros from R on)
  const size_t bt = size_t(B) * T, row0 = size_t(b) * T + t0;
  __nv_bfloat16* hi = mid + row0 * rp;
  __nv_bfloat16* lo = mid + (bt + row0) * rp;
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = warp * 16 + g + 8 * h, r = c0 + j * 8 + tq * 2 + e;
          if (t < tt && r < c_mid) put_mid(hi, lo, size_t(t) * rp + r, acc[j][2 * h + e]);
        }
    return;
  }
  // the splits are one cluster: each block's sums [64][CW] in its shared
  // memory (the ring is free), then each block adds its slice of the
  // elements over the cluster's blocks in split order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(red + (warp * 16 + g + 8 * h) * CW + j * 8 + tq * 2) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int v4 = (c_mid - c0) / 4, cells = tt * v4;   // float4 cells of the (t, r < c_mid) region
  const int per = (cells + splits - 1) / splits;
  const int lo_cell = split * per, hi_cell = min(cells, lo_cell + per);
  for (int i = lo_cell + tid; i < hi_cell; i += kTcThreads) {
    const int t = i / v4, c = (i % v4) * 4;
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float4 p = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red + t * CW + c, sp));
      m.x += p.x, m.y += p.y, m.z += p.z, m.w += p.w;
    }
    const size_t at = size_t(t) * rp + c0 + c;
    put_mid(hi, lo, at, m.x);
    put_mid(hi, lo, at + 1, m.y);
    put_mid(hi, lo, at + 2, m.z);
    put_mid(hi, lo, at + 3, m.w);
  }
  cluster.sync();   // the peers' reads of this block's sums are done
}

// Block (token tile, row b, column split z): out[b][t][n] for the split's
// columns = bf16(hi @ B[slot] + lo @ B[slot]) in f32, hi and lo mid's two
// bf16 terms from the shrink kernel; warp w computes tokens 16 w.. by
// kExpandCols columns at a time. Ring item i is (column tile i / kchunks,
// 64-rank chunk i % kchunks).
__global__ void __launch_bounds__(kTcThreads) lora_expand_kernel(
    const __nv_bfloat16* __restrict__ mid, const __nv_bfloat16* __restrict__ bm,
    const int* __restrict__ slots, __nv_bfloat16* __restrict__ out, int B, int T, int R, int N,
    int S, int split_cols, int vec_b) {
  constexpr int CH = kExpandCols, LDB = CH + 8, NJ = CH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t0 = blockIdx.x * kTile, b = blockIdx.y;
  const int n_begin = blockIdx.z * split_cols, n_end = min(N, n_begin + split_cols);
  const int tt = min(kTile, T - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = __ldg(slots + b);
  __nv_bfloat16* o = out + (size_t(b) * T + t0) * N;
  if (slot < 0 || slot >= S) {   // NaN over the block's rows and columns
    const __nv_bfloat16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
    const int w = n_end - n_begin;
    for (int i = tid; i < tt * w; i += kTcThreads) o[size_t(i / w) * N + n_begin + i % w] = nan;
    return;
  }
  const __nv_bfloat16* Bs = bm + size_t(slot) * R * N;
  const int rp = round16(R);
  const bool resident = mid_resident(R);
  const int sr = min(kStep, rp);                   // B rows a ring stage holds
  // a ring stage: B's tile [sr][LDB], then (mid not resident) the stage's
  // ranks of hi and lo [64][kLd] each
  const int stage = sr * LDB + (resident ? 0 : 2 * kTile * kLd);
  const int ld_mid = resident ? rp + 8 : kLd;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hi = ring + kStages * stage;      // resident: [64][ld_mid] each
  __nv_bfloat16* lo = hi + (resident ? kTile * ld_mid : 0);
  __nv_bfloat16* stg = lo + (resident ? kTile * ld_mid : 0) + warp * 16 * LDB;   // [16][LDB]
  const int kchunks = (rp + kStep - 1) / kStep;
  const int items = (n_end - n_begin + CH - 1) / CH * kchunks;
  const size_t row0 = size_t(b) * T + t0, bt = size_t(B) * T;
  // mid's terms for the tile's tokens and ranks [k0, k0 + cols) (zeros past
  // T) into hi_s / lo_s, rows ld apart
  auto load_mid = [&](__nv_bfloat16* hi_s, __nv_bfloat16* lo_s, int ld, int k0, int cols) {
    const int v = cols / 8;
    for (int i = tid; i < 2 * kTile * v; i += kTcThreads) {
      const int which = i / (kTile * v), t = (i / v) % kTile, c = (i % v) * 8;
      const bool ok = t < tt;
      cp_async16((which ? lo_s : hi_s) + t * ld + c,
                 ok ? mid + (which * bt + row0 + t) * rp + k0 + c : mid, ok);
    }
  };
  if (resident) {   // once, its own copy group
    load_mid(hi, lo, ld_mid, 0, rp);
    cp_async_commit();
  }
  auto load = [&](int i) {
    const int n0 = n_begin + (i / kchunks) * CH, k0 = (i % kchunks) * kStep;
    __nv_bfloat16* st = ring + (i % kStages) * stage;
    load_tile<CH, LDB>(st, Bs + size_t(k0) * N, N, R - k0, n0, n_end, vec_b,
                       min(kStep, rp - k0));
    if (!resident) load_mid(st + sr * LDB, st + sr * LDB + kTile * kLd, kLd, k0,
                            min(kStep, rp - k0));
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < items) load(i);
    cp_async_commit();
  }

  float acc[NJ][4];
  const int g = lane / 4, tq = lane % 4;
  const bool vec_out = (N & 7) == 0;
  for (int i = 0; i < items; ++i) {
    if (i + kStages - 1 < items) load(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int kc = i % kchunks, k0 = kc * kStep;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    const __nv_bfloat16* bs = ring + (i % kStages) * stage;
    const __nv_bfloat16* hs = resident ? hi : bs + sr * LDB;   // mid's terms for the chunk
    const __nv_bfloat16* ls = resident ? lo : hs + kTile * kLd;
    const int km = resident ? k0 : 0;   // the chunk's first rank there
    const int kk_end = min(kStep, rp - k0) / 16;
    for (int kk = 0; kk < kk_end; ++kk) {
      uint32_t r[NJ / 2][4];
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np)
        ldsm_x4_trans(r[np], bs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDB +
                                 np * 16 + (lane / 16) * 8);
      uint32_t ah[4], al[4];
      const int at = (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ld_mid + km + kk * 16 +
                     (lane / 16) * 8;
      ldsm_x4(ah, hs + at);
      ldsm_x4(al, ls + at);
      // hi's products, then lo's: independent accumulators between two
      // products into one
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        mma_bf16(acc[2 * np], ah, r[np][0], r[np][1]);
        mma_bf16(acc[2 * np + 1], ah, r[np][2], r[np][3]);
      }
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        mma_bf16(acc[2 * np], al, r[np][0], r[np][1]);
        mma_bf16(acc[2 * np + 1], al, r[np][2], r[np][3]);
      }
    }
    if (kc == kchunks - 1) {
      // the column tile's sums are whole: through the warp's staging tile
      // to whole row segments of out
      const int n0 = n_begin + (i / kchunks) * CH;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(stg + (g + 8 * h) * LDB + j * 8 + tq * 2) =
              __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
      __syncwarp();
      if (vec_out) {
        for (int k = lane; k < 16 * NJ; k += 32) {
          const int r0 = k / NJ, c = (k % NJ) * 8, t = warp * 16 + r0;
          if (t < tt && n0 + c < n_end)
            *reinterpret_cast<uint4*>(o + size_t(t) * N + n0 + c) =
                *reinterpret_cast<const uint4*>(stg + r0 * LDB + c);
        }
      } else {
        for (int k = lane; k < 16 * CH; k += 32) {
          const int r0 = k / CH, c = k % CH, t = warp * 16 + r0;
          if (t < tt && n0 + c < n_end) o[size_t(t) * N + n0 + c] = stg[r0 * LDB + c];
        }
      }
      __syncwarp();
    }
    __syncthreads();   // done with this stage before it is refilled
  }
}

template <int NT>
cudaError_t launch_shrink(cudaStream_t s, dim3 grid, const __nv_bfloat16* x,
                          const __nv_bfloat16* a, const int* slots, __nv_bfloat16* mid, int B,
                          int T, int D, int R, int S, int chunk, int splits, int vec_x,
                          int vec_a) {
  constexpr int smem = shrink_smem(NT);
  cudaError_t err = cudaFuncSetAttribute(lora_shrink_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;   // a (row, tile, chunk)'s D splits
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lora_shrink_kernel<NT>, x, a, slots, mid, B, T, D, R, S, chunk,
                           splits, vec_x, vec_a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sxt_lora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [B, T, N] bf16 = per row b, bf16((x[b] @ A[slots[b]]) @ B[slots[b]])
// with f32 sums and an f32 mid: x [B, T, D], A [S, D, R], B [S, R, N]
// bf16, contiguous; slots [B] int32 on the device. A null `mid` takes the
// row kernel (one-token rows, ranks up to 8; the split arguments unused);
// a `mid` scratch [2, B, T, round16(R)] bf16 (its two terms) the
// tensor-core pair, at every shape and rank: the reduction over D in
// `splits` (at most 8: one cluster) chunks of `chunk` rows (a multiple of
// 64), and N in `col_splits` ranges of whole 64-column tiles.
int sxt_lora_delta_bf16(const void* x, const void* a, const void* b, const void* slots,
                        void* out, void* mid, int B, int T, int D, int R, int N, int S,
                        int splits, int chunk, int col_splits, void* stream) {
  if (B <= 0 || T <= 0 || N <= 0) return 0;
  if (D < 1 || R < 1 || S < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* sp = static_cast<const int*>(slots);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (mid == nullptr) {
    if (T != 1 || R > kRowRank) return static_cast<int>(cudaErrorInvalidValue);
    lora_row_kernel<<<B, kThreads, 0, s>>>(xp, ap, bp, sp, op, D, R, N, S);
    return static_cast<int>(cudaGetLastError());
  }
  const int nt = shrink_tiles(R), cw = 8 * nt;
  const long long tiles = (T + kTile - 1) / kTile, chunks = (R + cw - 1) / cw;
  if (chunk < 1 || chunk % kStep || splits < 1 ||
      splits > kMaxSplits || (long long)splits * chunk < D ||
      (long long)(splits - 1) * chunk >= D || col_splits < 1 || col_splits > 65535 ||
      tiles * chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_x = D % 8 == 0 && aligned(x), vec_a = R % 8 == 0 && aligned(a);
  const int vec_b = N % 8 == 0 && aligned(b);
  auto* mp = static_cast<__nv_bfloat16*>(mid);
  const dim3 sgrid(unsigned(tiles * chunks), B, splits);
  cudaError_t err;
  if (nt == 16)
    err = launch_shrink<16>(s, sgrid, xp, ap, sp, mp, B, T, D, R, S, chunk, splits, vec_x, vec_a);
  else if (nt == 8)
    err = launch_shrink<8>(s, sgrid, xp, ap, sp, mp, B, T, D, R, S, chunk, splits, vec_x, vec_a);
  else if (nt == 4)
    err = launch_shrink<4>(s, sgrid, xp, ap, sp, mp, B, T, D, R, S, chunk, splits, vec_x, vec_a);
  else
    err = launch_shrink<2>(s, sgrid, xp, ap, sp, mp, B, T, D, R, S, chunk, splits, vec_x, vec_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_n = (N + kExpandCols - 1) / kExpandCols;
  const int split_cols = (tiles_n + col_splits - 1) / col_splits * kExpandCols;
  const int smem = expand_smem(R);
  err = cudaFuncSetAttribute(lora_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lora_expand_kernel<<<dim3(unsigned(tiles), B, (N + split_cols - 1) / split_cols), kTcThreads,
                       smem, s>>>(mp, bp, sp, op, B, T, R, N, S, split_cols, vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
