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
// f32 sums, kept in f32 (never rounded to bf16 between the two products,
// as Punica-style kernels do), then out = mid @ f32(B[slot]) in f32, cast
// once. Every row is computed, null rows included: their zero factors give
// an exact 0.0. Sums run in a fixed order with no atomics and no split
// across blocks, so two runs give equal bits and a row's result does not
// depend on the other rows of the call.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s
// f32): the bytes of x and out plus the factors of the distinct slots
// the rows name. A decode tick's call (8 rows, T = 1, D = 4096, R = 8) moves
// ~0.6 MB: ~0.2 us, so it is bound by the launch. A put() of 8 x 1024
// prompts at N = 4096 moves 128 MB of x and out: >= 38 us; at R = 64 its
// second product (2 T R N f32 operations a row) needs >= 64 us of f32
// FMAs.
//
// Design (two forms, both with one block of 256 threads and no split
// across blocks):
// - One-token rows (decode, T = 1): one block per row. Stage 1 streams
//   A[slot] as it lies in memory, thread t taking rows d = t, t + 256, ...
//   (a warp reads 32 consecutive rows: coalesced; 16-byte reads when
//   R % 8 == 0 and R > 8, which measured slower at R = 8) and keeping R
//   partial sums in registers; a fixed xor-shuffle tree per warp, then the 8
//   warps in order, give mid [R] in shared memory. Stage 2 reads B[slot]
//   row by row, 8 columns a thread in 16-byte loads (any N: a scalar path
//   when N % 8 != 0), and writes 8 bf16 at once.
// - Longer rows (chunk and prefill rows): one block per (row, tile of 16
//   tokens); the grid tiles T, so a prefill call of [8, 1024, 4096] is 512
//   blocks. Stage 1 stages x's tile and A[slot] through shared memory in
//   D-tiles of 128 rows; each (token, group of 8 ranks) item belongs to KS
//   consecutive lanes of one warp (KS = 16 at rank 8, 2 at rank 64), each
//   lane summing every KS-th d in order with one 16-byte read of A's row
//   for 8 FMAs, and a fixed xor-shuffle tree adds the lanes. Stage 2: each
//   thread owns 2 adjacent columns (bf16x2 loads and stores; a scalar path
//   for odd N) and keeps the tile's 16 tokens' sums in registers.
// - Ranks above 64 (any rank): the same two forms with stage 1 run in
//   rank chunks of 64 columns, each chunk a pass over D that re-reads x
//   and that chunk's columns of A[slot]; mid goes to f32 scratch [B, T, R]
//   in device memory (the wrapper's), so no rank is too large for shared
//   memory or registers. Ranks up to 64 run the forms above unchanged.
// Tensor cores, TMA and skipping null rows are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 64;     // ranks the shared-memory forms take (a chunk of the wide ones)
constexpr int kTileTokens = 16;  // tokens per block of the tiled form
constexpr int kDTile = 128;      // D rows of x and A staged per step (tiled form)
// A's staged rows (144 bytes, 16-byte aligned): 8 lanes reading 16 bytes
// of 8 consecutive rows hit 8 different groups of 4 banks
constexpr int kAPitch = kMaxRank + 8;

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

// A slot outside [0, S) writes NaN over the block's rows and returns true.
__device__ __forceinline__ bool bad_slot(int slot, int S, __nv_bfloat16* out, size_t n) {
  if (slot >= 0 && slot < S) return false;
  const __nv_bfloat16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
  for (size_t i = threadIdx.x; i < n; i += kThreads) out[i] = nan;
  return true;
}

// ---------------------------------------------------------------------------
// One-token rows
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
lora_row_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b, const int* __restrict__ slots,
                __nv_bfloat16* __restrict__ out, int D, int R, int N, int S) {
  __shared__ float red[kWarps][kMaxRank];
  __shared__ float mid[kMaxRank];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = __ldg(slots + row);
  __nv_bfloat16* o = out + static_cast<size_t>(row) * N;
  if (bad_slot(slot, S, o, N)) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * D;
  const __nv_bfloat16* A = a + static_cast<size_t>(slot) * D * R;
  const __nv_bfloat16* Bm = b + static_cast<size_t>(slot) * R * N;

  // stage 1: partial sums over d = tid, tid + 256, ... in order
  float part[kMaxRank];
#pragma unroll
  for (int r = 0; r < kMaxRank; ++r) part[r] = 0.f;
  if ((R & 7) == 0 && R > 8) {                     // A's rows in 16-byte reads
#pragma unroll 4
    for (int d = tid; d < D; d += kThreads) {
      const float xv = bf(xr[d]);
      const uint4* ar = reinterpret_cast<const uint4*>(A + static_cast<size_t>(d) * R);
#pragma unroll
      for (int g = 0; g < kMaxRank / 8; ++g) {
        if (g * 8 < R) {
          const uint4 v = __ldg(ar + g);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            part[g * 8 + 2 * j] = fmaf(xv, f.x, part[g * 8 + 2 * j]);
            part[g * 8 + 2 * j + 1] = fmaf(xv, f.y, part[g * 8 + 2 * j + 1]);
          }
        }
      }
    }
  } else {
#pragma unroll 4
    for (int d = tid; d < D; d += kThreads) {
      const float xv = bf(xr[d]);
      const __nv_bfloat16* ar = A + static_cast<size_t>(d) * R;
#pragma unroll
      for (int r = 0; r < kMaxRank; ++r)
        if (r < R) part[r] = fmaf(xv, bf(ar[r]), part[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRank; ++r) {
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
// Tiles of 16 tokens
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
lora_tile_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, const int* __restrict__ slots,
                 __nv_bfloat16* __restrict__ out, int T, int D, int R, int N, int S, int ks) {
  constexpr int TT = kTileTokens;
  __shared__ __nv_bfloat16 xs[TT][kDTile];
  __shared__ __align__(16) __nv_bfloat16 as[kDTile][kAPitch];
  __shared__ float mid[TT][kMaxRank];

  const int row = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tt = min(TT, T - t0);                  // tokens of this tile
  const int tid = threadIdx.x;
  const int slot = __ldg(slots + row);
  const size_t xrow = (static_cast<size_t>(row) * T + t0);
  if (bad_slot(slot, S, out + xrow * N, static_cast<size_t>(tt) * N)) return;
  const __nv_bfloat16* A = a + static_cast<size_t>(slot) * D * R;
  const __nv_bfloat16* Bm = b + static_cast<size_t>(slot) * R * N;
  const int groups = (R + 7) / 8;                  // rank groups of 8 columns
  for (int i = tid; i < kDTile * (groups * 8 - R); i += kThreads) {
    const int pad = groups * 8 - R;                // the groups' columns past R stay 0
    as[i / pad][R + i % pad] = __float2bfloat16(0.f);
  }

  // stage 1: mid[t][r] = sum_d x[t][d] A[d][r], f32. Item (t, rank group)
  // belongs to ks consecutive lanes of one warp; lane k sums every ks-th d
  // in order, 8 ranks at a time from one 16-byte read of A's row
  const int items = TT * groups;
  const int k = tid % ks;
  const int item = tid / ks;
  const int t = item / groups, rg = item % groups;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kDTile) {
    const int dn = min(kDTile, D - d0);
    for (int i = tid; i < TT * kDTile; i += kThreads) {
      const int tx = i / kDTile, dd = i % kDTile;
      xs[tx][dd] = (tx < tt && dd < dn) ? x[(xrow + tx) * D + d0 + dd] : __float2bfloat16(0.f);
    }
    for (int i = tid; i < kDTile * R; i += kThreads) {
      const int dd = i / R, r = i % R;
      as[dd][r] = dd < dn ? A[static_cast<size_t>(d0 + dd) * R + r] : __float2bfloat16(0.f);
    }
    __syncthreads();
    if (item < items) {
      for (int dd = k; dd < dn; dd += ks) {
        const float xv = bf(xs[t][dd]);
        const uint4 v = *reinterpret_cast<const uint4*>(&as[dd][rg * 8]);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          acc[2 * j] = fmaf(xv, f.x, acc[2 * j]);
          acc[2 * j + 1] = fmaf(xv, f.y, acc[2 * j + 1]);
        }
      }
    }
    __syncthreads();
  }
  // the ks lanes of an item are consecutive lanes of one warp: a fixed tree
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float sj = acc[j];
    for (int off = ks >> 1; off > 0; off >>= 1) sj += __shfl_xor_sync(0xffffffffu, sj, off);
    const int r = rg * 8 + j;
    if (k == 0 && item < items && r < R) mid[t][r] = sj;
  }
  __syncthreads();

  // stage 2: out[t][n] = bf16(sum_r mid[t][r] f32(B[r][n]))
  if ((N & 1) == 0) {
    for (int n = tid * 2; n < N; n += kThreads * 2) {
      float o0[TT], o1[TT];
#pragma unroll
      for (int tx = 0; tx < TT; ++tx) o0[tx] = o1[tx] = 0.f;
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Bm + static_cast<size_t>(r) * N + n));
#pragma unroll
        for (int tx = 0; tx < TT; ++tx) {
          o0[tx] = fmaf(mid[tx][r], bv.x, o0[tx]);
          o1[tx] = fmaf(mid[tx][r], bv.y, o1[tx]);
        }
      }
#pragma unroll
      for (int tx = 0; tx < TT; ++tx)
        if (tx < tt)
          *reinterpret_cast<__nv_bfloat162*>(out + (xrow + tx) * N + n) =
              __floats2bfloat162_rn(o0[tx], o1[tx]);
    }
  } else {
    for (int n = tid; n < N; n += kThreads) {
      float o[TT];
#pragma unroll
      for (int tx = 0; tx < TT; ++tx) o[tx] = 0.f;
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        const float bv = bf(Bm[static_cast<size_t>(r) * N + n]);
#pragma unroll
        for (int tx = 0; tx < TT; ++tx) o[tx] = fmaf(mid[tx][r], bv, o[tx]);
      }
#pragma unroll
      for (int tx = 0; tx < TT; ++tx)
        if (tx < tt) out[(xrow + tx) * N + n] = __float2bfloat16(o[tx]);
    }
  }
}

// lanes that share one (token, rank group) item's sum over D: the largest
// power of two <= 32 with items * ks <= kThreads
__host__ __device__ int lanes_per_item(int items) {
  int ks = 1;
  while (ks < 32 && items * ks * 2 <= kThreads) ks *= 2;
  return ks;
}

// ---------------------------------------------------------------------------
// Ranks above kMaxRank: the two forms above with stage 1 run in rank
// chunks of kMaxRank columns, each chunk a pass over D that re-reads x and
// reads its columns of A[slot]. mid (f32) goes to the caller's scratch
// [B, T, R] in device memory instead of shared memory, so no rank is too
// large; stage 2 reads it back as the forms above read their shared mid.
// Every column of mid is the same sum in the same order as in the forms
// above, and ranks <= kMaxRank never reach these kernels.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
lora_row_wide_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ b, const int* __restrict__ slots,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ mid_g, int D, int R,
                     int N, int S) {
  __shared__ float red[kWarps][kMaxRank];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = __ldg(slots + row);
  __nv_bfloat16* o = out + static_cast<size_t>(row) * N;
  if (bad_slot(slot, S, o, N)) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * D;
  const __nv_bfloat16* A = a + static_cast<size_t>(slot) * D * R;
  const __nv_bfloat16* Bm = b + static_cast<size_t>(slot) * R * N;
  float* mid = mid_g + static_cast<size_t>(row) * R;

  // stage 1, chunk by chunk: partial sums over d = tid, tid + 256, ... in order
#pragma unroll 1
  for (int c0 = 0; c0 < R; c0 += kMaxRank) {
    const int rc = min(kMaxRank, R - c0);          // the chunk's ranks
    float part[kMaxRank];
#pragma unroll
    for (int r = 0; r < kMaxRank; ++r) part[r] = 0.f;
    if ((R & 7) == 0) {                            // A's rows in 16-byte reads
#pragma unroll 4
      for (int d = tid; d < D; d += kThreads) {
        const float xv = bf(xr[d]);
        const uint4* ar = reinterpret_cast<const uint4*>(A + static_cast<size_t>(d) * R + c0);
#pragma unroll
        for (int g = 0; g < kMaxRank / 8; ++g) {
          if (g * 8 < rc) {
            const uint4 v = __ldg(ar + g);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(h[j]);
              part[g * 8 + 2 * j] = fmaf(xv, f.x, part[g * 8 + 2 * j]);
              part[g * 8 + 2 * j + 1] = fmaf(xv, f.y, part[g * 8 + 2 * j + 1]);
            }
          }
        }
      }
    } else {
#pragma unroll 4
      for (int d = tid; d < D; d += kThreads) {
        const float xv = bf(xr[d]);
        const __nv_bfloat16* ar = A + static_cast<size_t>(d) * R + c0;
#pragma unroll
        for (int r = 0; r < kMaxRank; ++r)
          if (r < rc) part[r] = fmaf(xv, bf(ar[r]), part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRank; ++r) {
      if (r < rc) {
        float s = part[r];
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) red[warp][r] = s;
      }
    }
    __syncthreads();
    if (tid < rc) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][tid];
      mid[c0 + tid] = s;
    }
    __syncthreads();                               // red is the next chunk's; mid is read below
  }

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

__global__ void __launch_bounds__(kThreads)
lora_tile_wide_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ b, const int* __restrict__ slots,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ mid_g, int T, int D,
                      int R, int N, int S) {
  constexpr int TT = kTileTokens;
  __shared__ __nv_bfloat16 xs[TT][kDTile];
  __shared__ __align__(16) __nv_bfloat16 as[kDTile][kAPitch];

  const int row = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tt = min(TT, T - t0);                  // tokens of this tile
  const int tid = threadIdx.x;
  const int slot = __ldg(slots + row);
  const size_t xrow = (static_cast<size_t>(row) * T + t0);
  if (bad_slot(slot, S, out + xrow * N, static_cast<size_t>(tt) * N)) return;
  const __nv_bfloat16* A = a + static_cast<size_t>(slot) * D * R;
  const __nv_bfloat16* Bm = b + static_cast<size_t>(slot) * R * N;
  float* mid = mid_g + xrow * R;                   // [TT][R] of this tile (rows t < tt)

  // stage 1, chunk by chunk: mid[t][c0 + r] = sum_d x[t][d] A[d][c0 + r],
  // items and lanes as in lora_tile_kernel over the chunk's rank groups
#pragma unroll 1
  for (int c0 = 0; c0 < R; c0 += kMaxRank) {
    const int rc = min(kMaxRank, R - c0);          // the chunk's ranks
    const int groups = (rc + 7) / 8;
    const int pad = groups * 8 - rc;               // the groups' columns past rc stay 0
    for (int i = tid; i < kDTile * pad; i += kThreads) as[i / pad][rc + i % pad] =
        __float2bfloat16(0.f);
    const int items = TT * groups;
    const int ks = lanes_per_item(items);
    const int k = tid % ks;
    const int item = tid / ks;
    const int t = item / groups, rg = item % groups;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDTile) {
      const int dn = min(kDTile, D - d0);
      for (int i = tid; i < TT * kDTile; i += kThreads) {
        const int tx = i / kDTile, dd = i % kDTile;
        xs[tx][dd] = (tx < tt && dd < dn) ? x[(xrow + tx) * D + d0 + dd] : __float2bfloat16(0.f);
      }
      for (int i = tid; i < kDTile * rc; i += kThreads) {
        const int dd = i / rc, r = i % rc;
        as[dd][r] = dd < dn ? A[static_cast<size_t>(d0 + dd) * R + c0 + r]
                            : __float2bfloat16(0.f);
      }
      __syncthreads();
      if (item < items) {
        for (int dd = k; dd < dn; dd += ks) {
          const float xv = bf(xs[t][dd]);
          const uint4 v = *reinterpret_cast<const uint4*>(&as[dd][rg * 8]);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            acc[2 * j] = fmaf(xv, f.x, acc[2 * j]);
            acc[2 * j + 1] = fmaf(xv, f.y, acc[2 * j + 1]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float sj = acc[j];
      for (int off = ks >> 1; off > 0; off >>= 1) sj += __shfl_xor_sync(0xffffffffu, sj, off);
      const int r = rg * 8 + j;
      if (k == 0 && item < items && r < rc && t < tt) mid[static_cast<size_t>(t) * R + c0 + r] = sj;
    }
  }
  __syncthreads();

  // stage 2: out[t][n] = bf16(sum_r mid[t][r] f32(B[r][n])); rows t >= tt
  // of the tile read row tt - 1 (in bounds) and are never stored
  const int tl = tt - 1;
  if ((N & 1) == 0) {
    for (int n = tid * 2; n < N; n += kThreads * 2) {
      float o0[TT], o1[TT];
#pragma unroll
      for (int tx = 0; tx < TT; ++tx) o0[tx] = o1[tx] = 0.f;
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Bm + static_cast<size_t>(r) * N + n));
#pragma unroll
        for (int tx = 0; tx < TT; ++tx) {
          const float m = mid[static_cast<size_t>(min(tx, tl)) * R + r];
          o0[tx] = fmaf(m, bv.x, o0[tx]);
          o1[tx] = fmaf(m, bv.y, o1[tx]);
        }
      }
#pragma unroll
      for (int tx = 0; tx < TT; ++tx)
        if (tx < tt)
          *reinterpret_cast<__nv_bfloat162*>(out + (xrow + tx) * N + n) =
              __floats2bfloat162_rn(o0[tx], o1[tx]);
    }
  } else {
    for (int n = tid; n < N; n += kThreads) {
      float o[TT];
#pragma unroll
      for (int tx = 0; tx < TT; ++tx) o[tx] = 0.f;
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        const float bv = bf(Bm[static_cast<size_t>(r) * N + n]);
#pragma unroll
        for (int tx = 0; tx < TT; ++tx)
          o[tx] = fmaf(mid[static_cast<size_t>(min(tx, tl)) * R + r], bv, o[tx]);
      }
#pragma unroll
      for (int tx = 0; tx < TT; ++tx)
        if (tx < tt) out[(xrow + tx) * N + n] = __float2bfloat16(o[tx]);
    }
  }
}

}  // namespace

extern "C" {

const char* sxt_lora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [B, T, N] bf16 = per row b, bf16((x[b] @ A[slots[b]]) @ B[slots[b]])
// with f32 sums and an f32 mid: x [B, T, D], A [S, D, R], B [S, R, N]
// bf16, contiguous, A 16-byte aligned when R % 8 == 0 and B when
// N % 8 == 0 (4 bytes when N is even); slots [B] int32 on the device.
// Any R >= 1; above 64, mid is f32 scratch [B, T, R] on the device (null
// at R <= 64, where mid stays in shared memory).
int sxt_lora_delta_bf16(const void* x, const void* a, const void* b, const void* slots,
                        void* out, void* mid, int B, int T, int D, int R, int N, int S,
                        void* stream) {
  if (B <= 0 || T <= 0 || N <= 0) return 0;
  if (D < 1 || R < 1 || S < 1 || B > 65535 || (R > kMaxRank) != (mid != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* sp = static_cast<const int*>(slots);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (R > kMaxRank) {
    auto* mp = static_cast<float*>(mid);
    if (T == 1)
      lora_row_wide_kernel<<<B, kThreads, 0, s>>>(xp, ap, bp, sp, op, mp, D, R, N, S);
    else
      lora_tile_wide_kernel<<<dim3((T + kTileTokens - 1) / kTileTokens, B), kThreads, 0, s>>>(
          xp, ap, bp, sp, op, mp, T, D, R, N, S);
  } else if (T == 1) {
    lora_row_kernel<<<B, kThreads, 0, s>>>(xp, ap, bp, sp, op, D, R, N, S);
  } else {
    const dim3 grid((T + kTileTokens - 1) / kTileTokens, B);
    lora_tile_kernel<<<grid, kThreads, 0, s>>>(xp, ap, bp, sp, op, T, D, R, N, S,
                                               lanes_per_item(kTileTokens * ((R + 7) / 8)));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
