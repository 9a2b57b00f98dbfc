// Paged attention for Hopper (sm_90a): decode and chunked-prefill extend
// over a block-paged KV pool (bf16, or int8 / e4m3 with f32 scale planes),
// behind a plain C interface loaded with ctypes (ops/_build.py builds this
// file with nvcc at first use).
//
// Replaces the TPU kernels
//   shuffle_exchange_tpu/ops/paged_attention.py:paged_decode_attention_pallas
//   shuffle_exchange_tpu/ops/paged_attention.py:paged_extend_attention_pallas
//
// Layouts (all contiguous):
//   q       decode [B, 1, H, Dh] / extend [B, C, H, Dh]   bf16
//   k, v    one layer of the pool [nblk, KV, bs, Dh]       bf16, int8 or e4m3
//   k_scale, v_scale  [nblk, KV, bs] f32 (one-byte pools; null for bf16)
//   table   [B, W] int32 block ids (-1 is read as block 0)
//   kv_len  [B] int32 (decode) / start [B] int32 (extend)
//   slopes  [H] f32 ALiBi slopes, or null (no position bias)
//   out     same shape as q, bf16
//   o_part [B, S, H, Dh], m_part / l_part [B, S, H] f32: the decode's split
//           partials, from the wrapper (null when S = 1)
// q head h reads kv head h / G (G = H / KV, the _repeat_kv convention);
// the softmax scale is Dh^-0.5; softmax and accumulation are in f32.
// ALiBi adds slope_h * j to the scaled score of key position j, in f32
// and before the running max. j is the logical sequence position the
// tile loop walks (table entry j / bs, offset j % bs), never a pool slot:
// a bias of ~1,450 at j = 2048 (slope 2^-0.5) must not be rounded, and a
// shift that differs between blocks would not cancel in the softmax.
// Masked scores are the finite -1e30 sentinel of the TPU kernels, masked
// probabilities are exactly 0, and the output divides by max(l, 1e-30):
// a fully masked row gives 0, never NaN.
//
// What bounds them on the H100. Decode reads every visible K/V row of the
// pool once per (sequence, kv head) and does 4 * G flops per K/V element:
// far below the ~295 flop/byte ridge of the bf16 tensor cores, so bytes
// bound it: ~1 us at Falcon-7B's 8 sequences over one kv head (2.9 MB of
// K/V a layer) to ~45 us at GPT-J-6B's 16 kv heads of 256. Below ~10 us
// what is left is latency: how many SMs the launch keeps busy and how
// fast each block gets its tiles. Extend reuses each K/V row for the
// G * TC query rows of a block, ~64 * 4 flops per K/V element: the tensor
// cores bound it.
//
// A block that walks a whole sequence alone, dot products in f32 on the
// CUDA cores, synchronous staging, or a tile staged once per head chunk
// each keep these kernels at a few percent of those bounds. This design:
//
// Decode (B2): split-K over the sequence, tensor cores, one read of K/V.
//   - The grid is (sequence, kv head, split). A split is split_len logical
//     positions, a multiple of 16 chosen by the wrapper from the SM count:
//     256 (four tiles, so the ring's prologue and the partials are paid once
//     per four tiles), shorter, down to 128, where 256 leaves the grid under
//     one block an SM, and one split where the (sequence, kv head) blocks
//     alone reach two an SM. On the H100 that ran within 3% of the fastest
//     fixed length from 128 to 512 at the decode cells of Llama-3-8B,
//     Falcon-7B, GPT-J-6B, BLOOM-1b7, Phi-3-mini and Pythia-2.8b, and 12-15%
//     below the 43 splits of 48 positions that two blocks an SM take at
//     Falcon-7B's (8 sequences of 2,048 over one kv head). One split at one
//     block an SM ran up to 35% slower over one-byte pools (Phi-3-mini's
//     and Pythia-2.8b's 8 x 32 kv heads).
//     A split past the sequence's end returns at once. With one split the
//     kernel writes out itself; otherwise each split writes its f32
//     (acc, m, l) and paged_decode_merge_kernel combines the first
//     ceil(len / split_len) of them in split order (B5's formula, in base
//     2). The f32 partials come from the wrapper; nothing is allocated here.
//     The decode body is paged_decode.cuh's decode_split, which the split-K
//     decode of fused_decode.cu (B5) shares, there with the merge folded
//     into the last split of each (sequence, kv head).
//   - The whole query-head group of the kv head is one block: Q is G rows
//     of bf16 in shared memory, zero-padded to whole 16-row MMA tiles, and
//     every K/V tile is staged once and read by all of them. A group of
//     at most 16 heads (one MMA row tile: MHA, Llama's 4, GPT-J's 1) lets
//     the 4 warps split each 64-key tile into four 16-key slices, each warp
//     with its own (m, l, acc), merged through shared memory in warp order
//     at the end. A wider group gives each warp whole 16-row tiles against
//     all 64 keys: up to 128 heads at head_dim <= 96 (Falcon-7B's 71 heads
//     of 64: 5 row tiles, two on warp 0), 64 at 128 and 256 (registers);
//     past that the block walks its split again for the next 128 / 64
//     heads (from L2).
// Extend (B3): FlashAttention-2 on mma.sync over block-table tiles.
//   - A block takes 64 query rows of one (sequence, kv head), 16 a warp.
//     Rows are numbered as before: u = cb * G * TC + g * TC + ci for chunk
//     row c = cb * TC + ci of head kv * G + g, TC = 64 / G chunk rows up to
//     64 heads (a block is TC chunk rows of every head, g-major), TC = 1
//     past 64 (64 consecutive rows of the c-major order, spanning at most
//     two chunk rows). Each row keeps its own causal limit start + c + 1
//     (capped at W * bs) and its own slope.
//   - Tiles wholly below every row's limit run unmasked; tiles past the
//     block's largest limit are never loaded. Blocks are issued longest
//     first (highest chunk rows), so the short ones fill the tail.
//   - At head_dim 256 shared memory holds one block an SM, so the block
//     runs 8 warps, the second four on the second half of every key tile,
//     and the two halves' (m, l, O) merge through shared memory at the end:
//     the block's serial chain of tiles halves. On the H100 that ran
//     1.2-1.3x faster than 4 warps at GPT-J-6B's heads at 2, 4 and 8 x 256
//     chunk rows (128 to 512 blocks, one wave and past it), over bf16 and
//     int8 pools alike. At the other head dims 2-4 blocks an SM already
//     give 8-16 warps, and 8-warp blocks ran slower (BLOOM-1b7's 128,
//     Phi-3-mini's 96).
// Both:
//   - K/V tiles of 64 positions are gathered through the block table by
//     cp.async into a double buffer: the copies of tile i + 1 are issued
//     right after the one barrier of tile i and land while it computes.
//     Each warp looks up its rows' pool addresses once a tile (one table
//     read and one division a row, handed to the copying lanes by shuffle).
//     Positions past the end are zero-filled, so no NaN meets a zero
//     probability. Staged rows are padded by 16 bytes, so ldmatrix reads of
//     8 rows hit 8 distinct groups of banks (at head_dim 80 and 96 too:
//     pitches of 176 and 208 bytes).
//   - S = Q K^T and O += P V are m16n8k16 bf16 MMAs with f32 accumulators,
//     operands loaded by ldmatrix. Q's fragments stay in registers in the
//     extend kernel at head_dim 128 (its block count is bound by shared
//     memory there); elsewhere they are re-read from shared memory at every
//     k-step (registers go to O: 128 a thread at 256). P enters P V as two
//     bf16 terms, hi = bf16(P) and lo = bf16(P - hi), so it keeps ~16 bits
//     (flash_attention.cu's convention): within one bf16 step of the plain
//     version with P in f32.
//   - The running max and sum stay in registers. Scores are kept in the
//     log2 domain (the softmax scale and the ALiBi slopes times log2(e),
//     the bias still added in f32 at logical position j), so a probability
//     is one MUFU.EX2 of x - m. Every sum runs in a fixed order and no sum
//     uses atomics: two runs give equal bits.
//   - One-byte pools: the tile is staged at storage width (half the bytes
//     of a bf16 tile) with its 64 row scales, then widened in shared memory
//     to bf16 (exact: int8 needs 8 significant bits, e4m3 has 4). The K row
//     scale multiplies S's column in f32; the V row scale multiplies P's
//     column before the hi / lo split. That moves the rounding point of the
//     TPU kernels' kb * s[:, None] (dequantize, then multiply) by an f32
//     rounding: the card check holds it to PAGED_TOL.
// wgmma, TMA and warp specialisation are later work.
//
// Head dims 64, 80, 96, 128 and 256: a k-step is 16 columns, so QK^T takes
// Dh / 16 k-steps and P V Dh / 8 column tiles. At 256 the extend kernel's
// staged Q and double-buffered K/V take ~169 KB of dynamic shared memory
// (one block an SM); set_smem raises the limit. The extend kernel's
// registers are held to what its shared memory allows
// (extend_min_blocks); registers and spills of every instance are in the
// build's -Xptxas -v log (ops/_build.py keeps it beside the library).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_decode.cuh"  // the shared decode body, tiles, staging, attend

namespace {

using namespace pdec;

constexpr int kExtendRows = 16 * kWarps;   // query rows of an extend block

// ---------------------------------------------------------------------------
// Decode: one query token per sequence. Block (b, kv, split s), 128
// threads (paged_decode.cuh: decode_split); the merge kernel combines the
// splits' partials.
// ---------------------------------------------------------------------------

template <int DH, int KIND, bool KSPLIT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpool_,
    const void* __restrict__ vpool_, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ kv_len, const float* __restrict__ slopes,
    __nv_bfloat16* __restrict__ out, float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int H, int KV, int bs, int W, int split_len, float scale) {
  decode_split<DH, KIND, KSPLIT, false>(q, kpool_, vpool_, kscale, vscale, table, kv_len, slopes,
                                        out, o_part, m_part, l_part, nullptr, H, KV, bs, W,
                                        split_len, scale);
}

// Merge of the splits: block (b, h), Dh threads.
__global__ void paged_decode_merge_kernel(const float* __restrict__ o_part,
                                          const float* __restrict__ m_part,
                                          const float* __restrict__ l_part,
                                          const int* __restrict__ kv_len,
                                          __nv_bfloat16* __restrict__ out, int S, int H, int Dh,
                                          int cap, int split_len) {
  merge_partials(o_part, m_part, l_part, kv_len, out, S, H, Dh, cap, split_len, blockIdx.x,
                 blockIdx.y, threadIdx.x);
}

// ---------------------------------------------------------------------------
// Extend: a C-token chunk per sequence. Block rank x of a 1-D grid: (b, kv)
// = x % (B * KV), row tile z = NZ - 1 - x / (B * KV) (longest first); tile
// z holds rows [z * RT, z * RT + R) of (b, kv), RT = G * TC up to 64 heads,
// else 64. Warp w owns rows [16 (w % 4), 16 (w % 4) + 16) of the tile and,
// with NG = 2 key groups (8 warps), the half w / 4 of every key tile; the
// two groups' (m, l, O) merge through shared memory at the end.
// ---------------------------------------------------------------------------

// Blocks an SM the extend kernel's registers are held to: what its shared
// memory allows (head_dim 64: 4, 80 / 96: 3, 128: 2, 256: 1)
template <int DH>
__host__ __device__ constexpr int extend_min_blocks() {
  return DH == 64 ? 4 : DH <= 96 ? 3 : DH == 128 ? 2 : 1;
}

template <int DH, int KIND, int NG>
__global__ void __launch_bounds__(kThreads * NG, extend_min_blocks<DH>()) paged_extend_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpool_,
    const void* __restrict__ vpool_, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ start, const float* __restrict__ slopes,
    __nv_bfloat16* __restrict__ out, int B, int C, int H, int KV, int bs, int W, int TC, int RT,
    int NZ, float scale) {
  using T = Tiles<DH, KIND>;
  constexpr int LD = T::kLd, NT = kThreads * NG, NK = TK / NG;
  const int bk = blockIdx.x % (B * KV), z = NZ - 1 - int(blockIdx.x / (B * KV));
  const int b = bk / KV, kv = bk % KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp % kWarps, grp = warp / kWarps;   // row tile, key group
  const int g = lane / 4, tq = lane % 4;
  const int G = H / KV;
  const int GT = G * TC;                                // rows of one block of TC chunk rows
  const int u0 = z * RT;                                // the tile's first row
  const int R = min(RT, (C + TC - 1) / TC * GT - u0);   // the tile's rows
  // tile row r -> (head g, chunk row c); c >= C is a padding row
  auto head_of = [&](int r) { return (u0 + r) % GT / TC; };
  auto row_of = [&](int r) { return (u0 + r) / GT * TC + (u0 + r) % GT % TC; };
  const unsigned char* kpool = static_cast<const unsigned char*>(kpool_);
  const unsigned char* vpool = static_cast<const unsigned char*>(vpool_);
  const bool alibi = slopes != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [64][LD]
  unsigned char* ring = smem + kExtendRows * LD * 2;             // two stages
  __nv_bfloat16* kw = reinterpret_cast<__nv_bfloat16*>(ring + 2 * T::kStage);
  __nv_bfloat16* vw = kw + TK * LD;                              // (one-byte pools)

  const int st = start[b];
  const int cap = W * bs;
  // the tile's first and last chunk rows bound its rows' causal limits
  const int c_first = u0 / GT * TC;
  const int c_last = min((u0 + R - 1) / GT * TC + TC, C) - 1;
  const int lim_min = min(st + c_first + 1, cap);
  const int lim_max = min(st + c_last + 1, cap);
  const int* trow = table + size_t(b) * W;

  for (int i = tid; i < kExtendRows * (DH / 8); i += NT) {
    const int r = i / (DH / 8), cc = (i % (DH / 8)) * 8;
    const int c = r < R ? row_of(r) : C;
    const bool ok = c < C;
    cp_async16(qs + r * LD + cc,
               ok ? q + ((size_t(b) * C + c) * H + size_t(kv) * G + head_of(r)) * DH + cc : q, ok);
  }
  cp_async_commit();
  const int ntile = lim_max > 0 ? (lim_max + TK - 1) / TK : 0;
  if (ntile > 0) {
    stage_kv<DH, KIND, kWarps * NG>(ring, kpool, vpool, kscale, vscale, trow, kv, KV, bs, 0,
                                    min(TK, lim_max), warp, lane);
    cp_async_commit();
  }

  int lim[2];
  float sl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw * 16 + g + 8 * h;
    const int c = r < R ? row_of(r) : C;
    lim[h] = c < C ? min(st + c + 1, cap) : 0;
    sl[h] = alibi && r < R ? slopes[kv * G + head_of(r)] * kLog2e : 0.f;
  }
  Rows<DH> rs;
  rs.init();
  // Q's A fragments stay in registers at head_dim 128 with one key group
  // (the block count is bound by shared memory there, not registers)
  constexpr bool QREG = DH == 128 && NG == 1;
  uint32_t qa[QREG ? DH / 16 : 1][4];
  const __nv_bfloat16* qw = qs + rw * 16 * LD;

  for (int it = 0; it < ntile; ++it) {
    const int p0 = it * TK;
    cp_async_wait<0>();   // tile it (and Q)
    __syncthreads();      // tile it visible; tile it - 1's stage free
    if (it + 1 < ntile) {
      stage_kv<DH, KIND, kWarps * NG>(ring + ((it + 1) & 1) * T::kStage, kpool, vpool, kscale,
                                      vscale, trow, kv, KV, bs, p0 + TK,
                                      min(TK, lim_max - p0 - TK), warp, lane);
      cp_async_commit();
    }
    if constexpr (QREG) {
      if (it == 0) {
        const __nv_bfloat16* qfrag =
            qw + ((lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) ldsm_x4(qa[kk], qfrag + kk * 16);
      }
    }
    const TileView tv =
        view_tile<DH, KIND, NT>(ring + (it & 1) * T::kStage, kw, vw, tid);
    if constexpr (T::kScaled) __syncthreads();
    attend<DH, T::kScaled, NK, QREG>(rs, qw, qa, tv.k, tv.v, tv.ks, tv.vs, grp * NK, p0, lim, sl,
                                     alibi, p0 + TK > lim_min, scale * kLog2e, lane);
  }
  cp_async_wait<0>();

  if constexpr (NG == 2) {
    // the second key group's (m, l, O) of each row, merged into the first's
    __syncthreads();   // every warp is done with the ring
    constexpr int OL = DH + 4;
    float* mo = reinterpret_cast<float*>(ring);   // [64] m, then [64] l
    float* oo = mo + 2 * kExtendRows;             // [64][OL]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw * 16 + g + 8 * h;
      if (grp == 1) {
        if (tq == 0) {
          mo[r] = rs.m[h];
          mo[kExtendRows + r] = rs.l[h];
        }
#pragma unroll
        for (int d = 0; d < DH / 8; ++d)
          *reinterpret_cast<float2*>(oo + r * OL + d * 8 + tq * 2) =
              make_float2(rs.o[d][2 * h], rs.o[d][2 * h + 1]);
      }
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw * 16 + g + 8 * h;
      const float m1 = mo[r], m = fmaxf(rs.m[h], m1);
      const float f0 = ex2(rs.m[h] - m), f1 = ex2(m1 - m);
      rs.m[h] = m;
      rs.l[h] = f0 * rs.l[h] + f1 * mo[kExtendRows + r];
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        const float2 o1 = *reinterpret_cast<const float2*>(oo + r * OL + d * 8 + tq * 2);
        rs.o[d][2 * h] = f0 * rs.o[d][2 * h] + f1 * o1.x;
        rs.o[d][2 * h + 1] = f0 * rs.o[d][2 * h + 1] + f1 * o1.y;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw * 16 + g + 8 * h;
    if (r >= R) continue;
    const int c = row_of(r);
    if (c >= C) continue;
    const float inv = 1.f / fmaxf(rs.l[h], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t(b) * C + c) * H + size_t(kv) * G + head_of(r)) * DH;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + tq * 2) =
          __floats2bfloat162_rn(rs.o[d][2 * h] * inv, rs.o[d][2 * h + 1] * inv);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct PagedArgs {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lens;      // kv_len (decode) or start (extend)
  const float* slopes;
  __nv_bfloat16* out;
};

struct Partials {
  float* o;
  float* m;
  float* l;
};

template <int DH, int KIND, bool KSPLIT>
cudaError_t launch_decode_as(const PagedArgs& a, const Partials& p, dim3 grid, cudaStream_t s,
                             int H, int KV, int bs, int W, int split_len, float scale) {
  const size_t smem = DecodeSmem<DH, KIND, KSPLIT>::kBytes;
  const auto kernel = paged_decode_kernel<DH, KIND, KSPLIT>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(a.q, a.k, a.v, a.ks, a.vs, a.table, a.lens, a.slopes, a.out,
                                      p.o, p.m, p.l, H, KV, bs, W, split_len, scale);
  return cudaSuccess;
}

template <int DH, int KIND>
cudaError_t launch_decode(const PagedArgs& a, const Partials& p, dim3 grid, cudaStream_t s, int H,
                          int KV, int bs, int W, int split_len, float scale) {
  return H / KV <= 16
             ? launch_decode_as<DH, KIND, true>(a, p, grid, s, H, KV, bs, W, split_len, scale)
             : launch_decode_as<DH, KIND, false>(a, p, grid, s, H, KV, bs, W, split_len, scale);
}

template <int DH, int KIND, int NG>
cudaError_t launch_extend_as(const PagedArgs& a, unsigned grid, cudaStream_t s, int B, int C,
                             int H, int KV, int bs, int W, int TC, int RT, int NZ, float scale) {
  using T = Tiles<DH, KIND>;
  const size_t smem = size_t(kExtendRows) * T::kLd * 2 + T::kBytes;
  const auto kernel = paged_extend_kernel<DH, KIND, NG>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads * NG, smem, s>>>(a.q, a.k, a.v, a.ks, a.vs, a.table, a.lens, a.slopes,
                                           a.out, B, C, H, KV, bs, W, TC, RT, NZ, scale);
  return cudaSuccess;
}

// two key groups (8 warps) at head_dim 256, where one block fills an SM
template <int DH, int KIND>
cudaError_t launch_extend(const PagedArgs& a, unsigned grid, cudaStream_t s, int B, int C, int H,
                          int KV, int bs, int W, int TC, int RT, int NZ, float scale) {
  return launch_extend_as<DH, KIND, DH == 256 ? 2 : 1>(a, grid, s, B, C, H, KV, bs, W, TC, RT,
                                                       NZ, scale);
}

// The instance for (Dh, kind): F<DH, KIND>::run(args...).
template <template <int, int> class F, typename... Args>
cudaError_t dispatch(int Dh, int kind, Args... args) {
  switch (Dh * 4 + kind) {
    case 256 * 4 + KvBf16: return F<256, KvBf16>::run(args...);   // GPT-J-6B
    case 256 * 4 + KvInt8: return F<256, KvInt8>::run(args...);
    case 256 * 4 + KvFp8: return F<256, KvFp8>::run(args...);
    case 128 * 4 + KvBf16: return F<128, KvBf16>::run(args...);
    case 128 * 4 + KvInt8: return F<128, KvInt8>::run(args...);
    case 128 * 4 + KvFp8: return F<128, KvFp8>::run(args...);
    case 64 * 4 + KvBf16: return F<64, KvBf16>::run(args...);
    case 64 * 4 + KvInt8: return F<64, KvInt8>::run(args...);
    case 64 * 4 + KvFp8: return F<64, KvFp8>::run(args...);
    case 96 * 4 + KvBf16: return F<96, KvBf16>::run(args...);    // Phi-3-mini
    case 96 * 4 + KvInt8: return F<96, KvInt8>::run(args...);
    case 96 * 4 + KvFp8: return F<96, KvFp8>::run(args...);
    case 80 * 4 + KvBf16: return F<80, KvBf16>::run(args...);    // Pythia-2.8b
    case 80 * 4 + KvInt8: return F<80, KvInt8>::run(args...);
    case 80 * 4 + KvFp8: return F<80, KvFp8>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <int DH, int KIND>
struct Decode {
  template <typename... A>
  static cudaError_t run(A... a) { return launch_decode<DH, KIND>(a...); }
};

template <int DH, int KIND>
struct Extend {
  template <typename... A>
  static cudaError_t run(A... a) { return launch_extend<DH, KIND>(a...); }
};

bool bad_kind(int kind, const void* ks, const void* vs) {
  if (kind < KvBf16 || kind > KvFp8) return true;
  return (kind == KvBf16) != (ks == nullptr) || (ks == nullptr) != (vs == nullptr);
}

}  // namespace

extern "C" {

const char* sxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kind: 0 bf16 pool (k_scale = v_scale = null), 1 int8, 2 e4m3 (with the
// f32 scale planes). splits x split_len positions cover the table's W * bs,
// none of the splits empty; with splits > 1, o_part [B, splits, H, Dh] and
// m_part / l_part [B, splits, H] f32 (else null). Returns
// cudaGetLastError() after the launches (0 on success).
int sxt_paged_decode(const void* q, const void* k, const void* v, const void* k_scale,
                     const void* v_scale, const void* table, const void* kv_len,
                     const void* slopes, void* out, void* o_part, void* m_part, void* l_part,
                     int kind, int B, int H, int KV, int Dh, int bs, int W, int splits,
                     int split_len, float scale, void* stream) {
  if (B <= 0) return 0;
  const long long cap = (long long)W * bs;
  if (KV <= 0 || H % KV != 0 || bad_kind(kind, k_scale, v_scale) || splits < 1 ||
      split_len < 1 || (long long)splits * split_len < cap ||
      (long long)(splits - 1) * split_len >= cap ||
      (splits > 1 && (o_part == nullptr || m_part == nullptr || l_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const int*>(table), static_cast<const int*>(kv_len),
                    static_cast<const float*>(slopes), static_cast<__nv_bfloat16*>(out)};
  const Partials p{static_cast<float*>(o_part), static_cast<float*>(m_part),
                   static_cast<float*>(l_part)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch<Decode>(Dh, kind, a, p, dim3(B, KV, splits), s, H, KV, bs, W,
                                           split_len, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1)
    paged_decode_merge_kernel<<<dim3(B, H), Dh, 0, s>>>(p.o, p.m, p.l, a.lens, a.out, splits, H,
                                                        Dh, int(cap), split_len);
  return static_cast<int>(cudaGetLastError());
}

int sxt_paged_extend(const void* q, const void* k, const void* v, const void* k_scale,
                     const void* v_scale, const void* table, const void* start,
                     const void* slopes, void* out, int kind, int B, int C, int H, int KV,
                     int Dh, int bs, int W, float scale, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || bad_kind(kind, k_scale, v_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const int TC = G <= kExtendRows ? kExtendRows / G : 1;   // chunk rows of a row block
  const int RT = G <= kExtendRows ? G * TC : kExtendRows;  // rows of a tile
  const long long rows = (long long)((C + TC - 1) / TC) * G * TC;
  const int NZ = int((rows + RT - 1) / RT);
  const PagedArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const int*>(table), static_cast<const int*>(start),
                    static_cast<const float*>(slopes), static_cast<__nv_bfloat16*>(out)};
  const cudaError_t err =
      dispatch<Extend>(Dh, kind, a, unsigned(B) * KV * NZ, static_cast<cudaStream_t>(stream), B,
                       C, H, KV, bs, W, TC, RT, NZ, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
