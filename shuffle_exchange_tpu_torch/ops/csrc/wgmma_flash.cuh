// The warp-specialised wgmma flash kernels for Hopper (sm_90a), shared by
// the dense flash attention (flash_attention.cu: B14 / B15) and the ALiBi
// flash attention (alibi_attention.cu: B11 forward, B12 dq, B13 dk/dv and
// the slope cotangent): the block shapes (WgFwd, WgDq, WgDkv), the ring
// and tile helpers, the backward's delta pass, and the four kernel bodies
// (forward; dq; dk/dv by the query split at 128 and 256; dk/dv by the key
// split at 64), each a __device__ function templated on its head dim and
// its Form. Each unit wraps the bodies in __global__ kernels of its own
// names (wg_fwd_kernel, ... in flash_attention.cu; alibi_wg_fwd_kernel, ...
// in alibi_attention.cu), so a profile tells B11-B13 from B14 / B15.
// Everything the ALiBi form adds sits under `if constexpr`, so a dense
// instance compiles as if that form were absent (its SASS is the one it
// had alone). The design of the bodies is described in flash_attention.cu's
// header, what the ALiBi form adds in alibi_attention.cu's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"   // kNeg, kLog2e, kLn2, kThreads, kWarps, delta_row
#include "wgmma_tile.cuh"   // mbarriers, TMA, wgmma, tensor maps

namespace {

// What a body computes: dense attention (causal or full, segment ids), or
// causal ALiBi with the bottom-right diagonal, with (dk/dv pass) or without
// the dslope partials.
enum Form : int { kDense = 0, kAlibi = 1, kAlibiDslope = 2 };

// The ALiBi form's operands (the dense instances pass Alibi{}, unread).
struct Alibi {
  const float* slopes;   // [H] f32: query head h's bias is slopes[h] * j at absolute key j
  int off;               // S - T >= 0: query i sees keys j <= i + off
  float* dslope;         // [B, H, ceil(S / 64)] f32 partials sum dS_ij * j (kAlibiDslope)
};

// delta[b, h, t] = rowsum(dout * out): one warp a row (flash_tile.cuh). The
// backward's first pass, dense and ALiBi alike.
template <int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    float* __restrict__ delta, long long rows, int T, int H) {
  delta_row<DH>(o, dout, delta, rows, T, H);
}

constexpr int kWgThreads = 128;                      // one warpgroup
constexpr int kConsumerWgs = 2;                      // the warpgroups that compute
constexpr int kWgBlockThreads = kWgThreads * (kConsumerWgs + 1);   // + the producer's
constexpr int kConsumerWarps = 4 * kConsumerWgs;     // the arrivals that free a ring slot
// 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536 registers, one block an SM
// (the 168 a thread of the launch, moved from the producer to the consumers)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kSmemLimit = 232448;                   // dynamic shared memory a block can have
constexpr int kAlign = 1024;                         // the swizzle's period: every tile's alignment

// The forward: K_j and V_j tiles of 64 keys pass through a ring of SLOTS
// single tiles (K_j, V_j, K_j+1, ...), each slot freed as soon as its
// product is done. At 128 a block is a 128-row query tile of one head, 64
// rows a consumer warpgroup. At 256 (COLS) a block is a 64-row tile and
// the two consumers split the head dim instead: each computes the partial
// scores over its 128 columns, the partials are summed through shared
// memory (X_BYTES, two buffers), and each accumulates its 128 columns of O.
// That keeps a consumer's accumulators at 64 (O) + 32 (S) registers: 64
// rows of O at 256 (128 registers) beside S and P do not fit the wgmma
// pipeline's registers (ptxas serialises the wgmmas and spills).
// At 80 and 96 a tile is one full 64-column block and a narrow tail block
// of TAIL columns (16 in the 32-byte swizzle, 32 in the 64-byte one): S
// takes one or two more k-steps over it, O one m64n16 / m64n32 product.
template <int DH>
struct WgFwd {
  static constexpr bool COLS = DH == 256;
  static constexpr int BM = COLS ? 64 : 128, BN = 64, SLOTS = COLS ? 4 : 8, CB = DH / 64;
  static constexpr int TAIL = DH % 64;
  static constexpr int Q_BYTES = BM * DH * 2, TILE_BYTES = BN * DH * 2;
  static constexpr int X_BYTES = COLS ? 2 * kConsumerWgs * BM * BN * 4 : 0;
  static constexpr int SMEM =
      kAlign + Q_BYTES + SLOTS * TILE_BYTES + X_BYTES + 8 * (2 * SLOTS + 1);
  static_assert(SMEM <= kSmemLimit, "forward: shared memory");
};

// The dq pass: a block is a query tile of one head with its dO rows; V_j
// and K_j of 64 keys pass through the ring (V first: it is freed after dP,
// K only after dq += dS K). At 256 (COLS) the tile is 64 rows and the
// consumers split the head dim as the forward does, summing their partial
// S and dP through one shared buffer.
template <int DH>
struct WgDq {
  static constexpr bool COLS = DH == 256;
  static constexpr int BM = COLS ? 64 : 128, BN = 64, SLOTS = COLS ? 3 : 8, CB = DH / 64;
  static constexpr int Q_BYTES = BM * DH * 2, TILE_BYTES = BN * DH * 2;
  static constexpr int X_BYTES = COLS ? kConsumerWgs * 2 * BM * BN * 4 : 0;
  static constexpr int SMEM =
      kAlign + 2 * Q_BYTES + SLOTS * TILE_BYTES + X_BYTES + 8 * (2 * SLOTS + 1);
  static_assert(SMEM <= kSmemLimit, "dq pass: shared memory");
};

// The dk/dv pass: Q_i and dO_i of each 64-query tile of each query head of
// the group pass through the ring; K and V stay.
// At 128 and 256 a block is a 64-key tile of one kv head. Each warpgroup
// forms P^T and dS^T for 32 of the 64 queries and writes them, as bf16 hi
// and lo, into 4 shared [64, 64] tiles that both then read (two sets by
// iteration where shared memory allows), then accumulates half the
// head-dim columns of dk and dv; each stages its 32 queries' lse and delta
// in VEC_BYTES.
// At 64 (KEY_SPLIT, FlashAttention-3's backward) a block is a 128-key tile
// and each warpgroup owns 64 of its keys: S^T and dP^T over all 64 queries
// (m64n64), then dv += P^T dO and dk += dS^T Q with P^T and dS^T straight
// from registers as wgmma's A operand (bf16 hi and lo): no P^T / dS^T
// tiles and no barrier between the warpgroups. Each stages the tile's 64
// lse and delta values. (Split by head-dim columns, 64 would shrink every
// dk and dv product to m64n32 and pass P^T and dS^T through shared memory.)
template <int DH>
struct WgDkv {
  static constexpr bool KEY_SPLIT = DH == 64;
  static constexpr int BN = KEY_SPLIT ? 128 : 64, BQ = 64, SLOTS = DH == 256 ? 4 : 8;
  static constexpr int CB = DH / 64, HALF = DH / 2;
  static constexpr int KV_BYTES = BN * DH * 2, TILE_BYTES = BQ * DH * 2;
  // P^T / dS^T tiles: two sets by iteration where shared memory allows (128), one at 256,
  // none under KEY_SPLIT
  static constexpr int PBUF = DH == 256 ? 1 : 2;
  static constexpr int P_TILE = KEY_SPLIT ? 0 : BN * BQ * 2, P_BYTES = PBUF * 4 * P_TILE;
  // a warpgroup's staged lse and delta values, two iterations: its 32 queries' or all 64
  static constexpr int VEC = KEY_SPLIT ? BQ : BQ / 2;
  static constexpr int VEC_BYTES = kConsumerWgs * 2 * 2 * VEC * 4;
  static constexpr int SMEM = kAlign + 2 * KV_BYTES + SLOTS * TILE_BYTES + P_BYTES + VEC_BYTES +
                              8 * (2 * SLOTS + 1);
  // the ALiBi form with dslope adds one f32 for each of the consumers' 4
  // warps after the mbarriers: their partial sums of dS_ij * j
  static constexpr int RED_BYTES = kConsumerWgs * 4 * 4;
  static_assert(SMEM + RED_BYTES <= kSmemLimit, "dk/dv pass: shared memory");
};

using wg::align_smem;   // kAlign is the swizzle's period, wg::kSwizzleAlign
static_assert(kAlign == wg::kSwizzleAlign, "tiles align to the swizzle's period");

// One [ROWS, CB * 64] tile: CB boxes of {64, ROWS}, column blocks ROWS * 128 bytes apart.
template <int ROWS, int CB>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col0, int row0, int b) {
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
    wg::tma_load_3d(dst + cb * ROWS * wg::kSwizzleBytes, map, bar, col0 + cb * wg::kBlockCols,
                    row0, b);
}

// One [ROWS, CB * 64 + TAIL] tile: the CB full blocks, then (TAIL > 0) the
// tail block of {TAIL, ROWS} through its own map, right after them.
template <int ROWS, int CB, int TAIL>
__device__ __forceinline__ void tma_tile_tail(unsigned char* dst, const CUtensorMap* map,
                                              const CUtensorMap* tail_map, uint64_t* bar,
                                              int col0, int row0, int b) {
  tma_tile<ROWS, CB>(dst, map, bar, col0, row0, b);
  if constexpr (TAIL > 0)
    wg::tma_load_3d(dst + CB * ROWS * wg::kSwizzleBytes, tail_map, bar,
                    col0 + CB * wg::kBlockCols, row0, b);
}

// The ring (wgmma_tile.cuh): tile t lives in slot t % SLOTS; its round is t / SLOTS.
using wg::ring_fill;
using wg::ring_free;
using wg::ring_wait;

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int slots,
                                          uint64_t* once) {
  for (int i = 0; i < slots; ++i) {
    wg::mbar_init(&full[i], 1);
    wg::mbar_init(&empty[i], kConsumerWarps);
  }
  wg::mbar_init(once, 1);
  wg::mbar_fence_init();
}

// 2^x in one MUFU instruction (ex2.approx.ftz: results below 2^-126 flush
// to 0; exp2f adds a range fix-up around it that these kernels do not need).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) -> bf16x2 hi + lo with hi = x truncated to bf16 (its upper 16
// bits: two integer ops and a byte permute) and lo = bf16(x - hi), so
// hi + lo keeps ~16 significant bits; one conversion a pair where a
// rounded hi takes two. x0 lands in the low halves.
__device__ __forceinline__ void split_hi_lo(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(x0) & 0xffff0000u, b1 = __float_as_uint(x1) & 0xffff0000u;
  hi = __byte_perm(b0, b1, 0x7632);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __uint_as_float(b0), x1 - __uint_as_float(b1));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The m16n8k16 A fragments of 16 columns (kk) of a 64 x N f32 accumulator,
// as bf16 hi + lo terms.
template <int N>
__device__ __forceinline__ void split_fragment(const float (&acc)[N], int kk, uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  split_hi_lo(acc[8 * kk + 0], acc[8 * kk + 1], hi[0], lo[0]);
  split_hi_lo(acc[8 * kk + 2], acc[8 * kk + 3], hi[1], lo[1]);
  split_hi_lo(acc[8 * kk + 4], acc[8 * kk + 5], hi[2], lo[2]);
  split_hi_lo(acc[8 * kk + 6], acc[8 * kk + 7], hi[3], lo[3]);
}

// Sets the disallowed entries of a 64 x N accumulator tile (this lane's
// rows r_lo for e < 2 and r_hi for e >= 2, columns k0 + n * 8 + tq * 2 + (e & 1))
// to the sentinel: keys past S, above the causal diagonal, or, with
// segment ids, in another segment. Branches are per tile, not per entry.
template <int N>
__device__ __forceinline__ void mask_tile(float (&x)[N], int k0, int r_lo, int r_hi, int tq,
                                          int S, int causal, const int* segb, int seg_lo,
                                          int seg_hi) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + tq * 2 + (e & 1), row = e < 2 ? r_lo : r_hi;
      const bool ok = key < S && !(causal && key > row);
      x[4 * n + e] = ok ? x[4 * n + e] : kNeg;
    }
  if (segb != nullptr) {
#pragma unroll
    for (int n = 0; n < N / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = min(k0 + n * 8 + tq * 2 + (e & 1), S - 1);
        if (segb[key] != (e < 2 ? seg_lo : seg_hi)) x[4 * n + e] = kNeg;
      }
  }
}

using wg::zero;

// The block of a forward or dq launch: blocks go by (sequence, kv head),
// then query tile (longest first under a causal mask), then the group's
// query heads, so the blocks in flight share their K/V tiles in L2 (by
// query tile first, as the mma.sync kernels issue them, every head's K/V
// would be in flight at once: 128 MB at GPT-J-6B's 8 x 2048).
__device__ __forceinline__ void block_of_rows(int nqt, int H, int KV, int causal, int& b, int& h,
                                              int& kvh, int& qt) {
  const int G = H / KV, per = nqt * G;
  const int grp = blockIdx.x / per, rem = blockIdx.x % per;
  const int rank = rem / G;
  b = grp / KV;
  kvh = grp % KV;
  h = kvh * G + rem % G;
  qt = causal ? nqt - 1 - rank : rank;
}

// The ALiBi forms' block orders: the (sequence, kv head) groups go in chunks
// of kAlibiChunk, and within a chunk by query tile (forward, dq: longest
// first, then group, then the group's query heads) or by key tile (dk/dv:
// key tile 0, with the most query tiles, first; then group). Chunks of
// groups keep the tiles in flight within L2 (16 of BLOOM's heads' K and V,
// or Q and dO, at 2,048 positions: 16 MB), and the order within a chunk is
// longest first across its groups, so the short tiles fill the tail (by
// group first, a grid of a few waves, B = 1 or 2, ends on a group's long
// tiles).
constexpr int kAlibiChunk = 16;

__device__ __forceinline__ void alibi_block_of_rows(int nqt, int B, int H, int KV, int& b,
                                                    int& h, int& kvh, int& qt) {
  const int G = H / KV, per = nqt * G;
  const int chunk = blockIdx.x / (kAlibiChunk * per), rem = blockIdx.x % (kAlibiChunk * per);
  const int groups = min(kAlibiChunk, B * KV - chunk * kAlibiChunk);   // in this chunk
  const int rank = rem / (groups * G), at = rem % (groups * G);
  const int grp = chunk * kAlibiChunk + at / G;
  b = grp / KV;
  kvh = grp % KV;
  h = kvh * G + at % G;
  qt = nqt - 1 - rank;
}

// (b, kv head, key tile) of an ALiBi dk/dv block (nkt key tiles a group).
__device__ __forceinline__ void alibi_block_of_keys(int nkt, int B, int KV, int& b, int& kvh,
                                                    int& kt) {
  const int chunk = blockIdx.x / (kAlibiChunk * nkt), rem = blockIdx.x % (kAlibiChunk * nkt);
  const int groups = min(kAlibiChunk, B * KV - chunk * kAlibiChunk);
  kt = rem / groups;
  const int grp = chunk * kAlibiChunk + rem % groups;
  b = grp / KV;
  kvh = grp % KV;
}

// Adds the other consumer's partial accumulator to this one's, through
// `buf` ([2 warpgroups][N][128] f32): each warpgroup computes mine + theirs,
// and f32 addition commutes, so both hold the same bits.
template <int N>
__device__ __forceinline__ void exchange_store(float* buf, int wgi, int tid, const float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) buf[(wgi * N + i) * kWgThreads + tid] = r[i];
}
template <int N>
__device__ __forceinline__ void exchange_add(const float* buf, int wgi, int tid, float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] += buf[((1 - wgi) * N + i) * kWgThreads + tid];
}

// named barriers between the two consumer warpgroups (0 is __syncthreads)
constexpr int kBarX = 1;       // the partial accumulators are in shared memory
constexpr int kBarXFree = 2;   // both have read them (the dq pass's single buffer)

// The forward's body (the __global__ kernels pass their __grid_constant__
// maps by reference). ALiBi (F != kDense, head dims 64 and 128, causal):
// the score enters the log2 domain with its bias, t = s * scale_log2 +
// slope_h log2(e) j at the absolute key j, in the one FMA that scales it;
// the row max runs over t and p = 2^(t - m); the diagonal is bottom-right
// (query i sees keys j <= i + off), and keys past S are masked (a zero key
// from TMA's fill would still score slope_h * j).
template <int DH, Form F>
__device__ __forceinline__ void wg_fwd(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                       const CUtensorMap& vmap, const CUtensorMap& qtail,
                                       const CUtensorMap& ktail, const CUtensorMap& vtail,
                                       const int* __restrict__ seg, __nv_bfloat16* __restrict__ o,
                                       float* __restrict__ lse, int B, int T, int S, int H, int KV,
                                       int causal, float scale_log2, const Alibi alibi) {
  constexpr bool AL = F != kDense;
  using Sh = WgFwd<DH>;
  static_assert(!AL || (!Sh::COLS && Sh::TAIL == 0), "ALiBi is built at head dims 64 and 128");
  constexpr bool COLS = Sh::COLS;
  constexpr int BM = Sh::BM, BN = Sh::BN, SLOTS = Sh::SLOTS, CB = Sh::CB, TAIL = Sh::TAIL;
  constexpr int NO = COLS ? DH / 2 : CB * 64;        // a consumer's columns of O (full blocks)
  constexpr int KSTEPS = COLS ? DH / 32 : CB * 4;    // its k-steps of S over the full blocks
  constexpr int TB = TAIL * 2;                       // bytes of a tail block's row: its swizzle
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_smem(smem_raw);          // CB blocks of [BM][64]
  unsigned char* ring = qs + Sh::Q_BYTES;            // SLOTS tiles of CB blocks of [BN][64]
  float* xbuf = reinterpret_cast<float*>(ring + SLOTS * Sh::TILE_BYTES);   // COLS: 2 buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SLOTS * Sh::TILE_BYTES + Sh::X_BYTES);
  uint64_t* empty = full + SLOTS;
  uint64_t* qbar = empty + SLOTS;

  const int nqt = (T + BM - 1) / BM;
  int b, h, kvh, qt;
  if constexpr (AL)
    alibi_block_of_rows(nqt, B, H, KV, b, h, kvh, qt);
  else
    block_of_rows(nqt, H, KV, causal, b, h, kvh, qt);
  const int q0 = qt * BM;
  const int n_s = (S + BN - 1) / BN;
  // ALiBi: the tiles up to the bottom-right diagonal of the block's last row
  const int n_kv = AL       ? min((q0 + BM - 1 + alibi.off) / BN + 1, n_s)
                   : causal ? min((q0 + BM - 1) / BN + 1, n_s)
                            : n_s;

  if (threadIdx.x == 0) init_ring(full, empty, SLOTS, qbar);
  __syncthreads();
  const int wgi = threadIdx.x / kWgThreads;
  if (wgi == kConsumerWgs) {   // the producer: one thread issues every load
    wg::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerWgs * kWgThreads) {
      wg::mbar_expect_tx(qbar, Sh::Q_BYTES);
      tma_tile_tail<BM, CB, TAIL>(qs, &qmap, &qtail, qbar, h * DH, q0, b);
      for (int t = 0; t < 2 * n_kv; ++t) {
        ring_fill<SLOTS>(full, empty, t, Sh::TILE_BYTES);
        tma_tile_tail<BN, CB, TAIL>(ring + (t % SLOTS) * Sh::TILE_BYTES,
                                    (t & 1) ? &vmap : &kmap, (t & 1) ? &vtail : &ktail,
                                    &full[t % SLOTS], kvh * DH, (t >> 1) * BN, b);
      }
    }
  } else {
    wg::regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const int r0 = COLS ? q0 : q0 + wgi * 64;        // this warpgroup's 64 rows
    const int r_lo = r0 + warp * 16 + g, r_hi = r_lo + 8;
    const int* segb = seg ? seg + size_t(b) * T : nullptr;
    const int seg_lo = segb ? segb[min(r_lo, T - 1)] : 0;
    const int seg_hi = segb ? segb[min(r_hi, T - 1)] : 0;
    // this warpgroup's rows of Q, and its first column block of Q, K and V
    const int cb0 = COLS ? wgi * (CB / 2) : 0;
    const unsigned char* qa = qs + (COLS ? 0 : wgi * 64 * wg::kSwizzleBytes);
    // and of Q's tail block (80, 96): its rows are TB bytes
    const unsigned char* qa_tail = qs + CB * BM * wg::kSwizzleBytes + wgi * 64 * TB;
    // the key tiles this warpgroup computes: a prefix (a tile wholly above its
    // diagonal is the block's last and is skipped; its slots are still freed)
    const int n_live = AL       ? min(n_kv, (r0 + 63 + alibi.off) / BN + 1)
                       : causal ? min(n_kv, (r0 + 63) / BN + 1)
                                : n_kv;
    // ALiBi: this head's slope in the log2 domain (f32: the bias reaches
    // ~1,447 at S = 2048, where bf16 resolves 8)
    float slope2 = 0.f;
    if constexpr (AL) slope2 = alibi.slopes[h] * kLog2e;

    float oacc[NO / 2], otail[TAIL > 0 ? TAIL / 2 : 1], s[BN / 2];
    zero(oacc);
    if constexpr (TAIL > 0) zero(otail);
    float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;

    // S = Q K_j^T: 64 rows x 64 keys (COLS: the partial over this warpgroup's columns)
    auto issue_s = [&](int j) {
      const unsigned char* kt = ring + ((2 * j) % SLOTS) * Sh::TILE_BYTES;
      ring_wait<SLOTS>(full, 2 * j);
      zero(s);
      wg::fence_regs(s);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int cb = cb0 + kk / 4, off = (kk % 4) * 32;
        wg::mma_ss<BN, 0>(s, wg::desc_k(qa + cb * BM * 128 + off),
                          wg::desc_k(kt + cb * BN * 128 + off), kk > 0);
      }
      if constexpr (TAIL > 0) {   // the tail block's k-steps, 32 bytes each in its swizzle
#pragma unroll
        for (int kk = 0; kk < TAIL / 16; ++kk)
          wg::mma_ss<BN, 0>(s, wg::desc_k<TB>(qa_tail + kk * 32),
                            wg::desc_k<TB>(kt + CB * BN * 128 + kk * 32), 1);
      }
      wg::mma_commit();
    };
    // O += P_j V_j over this warpgroup's columns, P from registers as bf16 hi + lo, V MN-major
    using Frag = uint32_t[BN / 16][4];
    auto issue_pv = [&](int j, const Frag& ph, const Frag& pl) {
      const unsigned char* vt = ring + ((2 * j + 1) % SLOTS) * Sh::TILE_BYTES;
      ring_wait<SLOTS>(full, 2 * j + 1);
      wg::fence_regs(oacc);
      if constexpr (TAIL > 0) wg::fence_regs(otail);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t vd = wg::desc_mn(vt + cb0 * BN * 128 + kk * 16 * 128, BN * 128);
        wg::mma_rs<NO, 1>(oacc, ph[kk], vd, 1);
        wg::mma_rs<NO, 1>(oacc, pl[kk], vd, 1);
        if constexpr (TAIL > 0) {   // V's tail block, MN-major: 16 rows of TB bytes a k-step
          const uint64_t vtd = wg::desc_mn<TB>(vt + CB * BN * 128 + kk * 16 * TB, BN * TB);
          wg::mma_rs<TAIL, 1>(otail, ph[kk], vtd, 1);
          wg::mma_rs<TAIL, 1>(otail, pl[kk], vtd, 1);
        }
      }
      wg::mma_commit();
    };
    // the online softmax of tile j in the log2 domain (rows r_lo: e < 2, r_hi: e >= 2):
    // P into (hi, lo), the rescale of the running sums into (al_lo, al_hi)
    auto softmax = [&](int j, Frag& hi, Frag& lo, float& al_lo, float& al_hi) {
      const int k0 = j * BN;
      if constexpr (COLS) {   // S = the two partials, summed in both warpgroups
        float* buf = xbuf + (j & 1) * kConsumerWgs * (BN / 2) * kWgThreads;
        exchange_store(buf, wgi, tid, s);
        wg::bar_sync<2 * kWgThreads>(kBarX);
        exchange_add(buf, wgi, tid, s);
      }
      // the row max over the raw scores (masked ones the sentinel); the log2
      // domain's m = max * scale_log2, and p = 2^(s * scale_log2 - m) in one FFMA
      // (ALiBi: over t = s * scale_log2 + bias, m = max t and p = 2^(t - m))
      bool masked;
      if constexpr (AL) {
        masked = k0 + BN - 1 > r0 + alibi.off || k0 + BN > S;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {   // this lane's two columns of each 8
            const int key = k0 + n * 8 + tq * 2 + c;
            const float bias = slope2 * float(key);
            float& t_lo = s[4 * n + c];
            float& t_hi = s[4 * n + 2 + c];
            t_lo = fmaf(t_lo, scale_log2, bias);
            t_hi = fmaf(t_hi, scale_log2, bias);
            if (masked) {
              t_lo = key < S && key <= r_lo + alibi.off ? t_lo : kNeg;
              t_hi = key < S && key <= r_hi + alibi.off ? t_hi : kNeg;
            }
          }
      } else {
        masked = (causal && k0 + BN - 1 > r0) || k0 + BN > S || segb != nullptr;
        if (masked) mask_tile(s, k0, r_lo, r_hi, tq, S, causal, segb, seg_lo, seg_hi);
      }
      float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * n + 0], s[4 * n + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float sc = AL ? 1.f : scale_log2;   // t is in the log2 domain already
      const float mn_lo = fmaxf(m_lo, mx_lo * sc), mn_hi = fmaxf(m_hi, mx_hi * sc);
      // 2^(m - m_new): exactly 1 while a row has seen only masked keys
      al_lo = ex2(m_lo - mn_lo);
      al_hi = ex2(m_hi - mn_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = AL ? ex2(s[4 * n + e] - (e < 2 ? mn_lo : mn_hi))
                       : ex2(fmaf(s[4 * n + e], scale_log2, -(e < 2 ? mn_lo : mn_hi)));
          // a masked key gives exactly 0, also while the row's max is the sentinel
          if (masked) p = s[4 * n + e] <= kNeg ? 0.f : p;
          s[4 * n + e] = p;
          if (e < 2)
            sum_lo += p;
          else
            sum_hi += p;
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
      }
      l_lo = l_lo * al_lo + sum_lo;
      l_hi = l_hi * al_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) split_fragment(s, kk, hi[kk], lo[kk]);
    };

    // The pipeline (FlashAttention-3's intra-warpgroup overlap): S_j and
    // P_j-1 V_j-1 are in flight together, and tile j's softmax runs while
    // P_j-1 V_j-1 is on the tensor cores; O takes tile j's rescale once
    // that product is done, before P_j V_j is issued. P alternates between
    // two register sets (no copies between wgmmas' operands).
    // step j: P_j-1 in (prev_hi, prev_lo), P_j into (next_hi, next_lo)
    auto step = [&](int j, const Frag& prev_hi, const Frag& prev_lo, Frag& next_hi,
                    Frag& next_lo) {
      float al_lo, al_hi;
      issue_s(j);
      issue_pv(j - 1, prev_hi, prev_lo);
      wg::mma_wait<1>();                 // S_j is done; P_j-1 V_j-1 may still run
      wg::fence_regs(s);
      ring_free<SLOTS>(empty, 2 * j, lane);
      softmax(j, next_hi, next_lo, al_lo, al_hi);
      wg::mma_wait<0>();
      wg::fence_regs(oacc);
      if constexpr (TAIL > 0) wg::fence_regs(otail);
      ring_free<SLOTS>(empty, 2 * j - 1, lane);
#pragma unroll
      for (int d = 0; d < NO / 8; ++d) {
        oacc[4 * d + 0] *= al_lo;
        oacc[4 * d + 1] *= al_lo;
        oacc[4 * d + 2] *= al_hi;
        oacc[4 * d + 3] *= al_hi;
      }
#pragma unroll
      for (int d = 0; d < TAIL / 8; ++d) {
        otail[4 * d + 0] *= al_lo;
        otail[4 * d + 1] *= al_lo;
        otail[4 * d + 2] *= al_hi;
        otail[4 * d + 3] *= al_hi;
      }
    };
    wg::mbar_wait(qbar, 0);
    if (n_live > 0) {
      Frag ah, al, bh, bl;
      float al_lo, al_hi;
      issue_s(0);
      wg::mma_wait<0>();
      wg::fence_regs(s);
      ring_free<SLOTS>(empty, 0, lane);
      softmax(0, ah, al, al_lo, al_hi);   // O is still 0: no rescale
      int j = 1;
      for (; j + 1 < n_live; j += 2) {
        step(j, ah, al, bh, bl);
        step(j + 1, bh, bl, ah, al);
      }
      if (j < n_live) {
        step(j, ah, al, bh, bl);
        issue_pv(j, bh, bl);
      } else {
        issue_pv(j - 1, ah, al);
      }
      wg::mma_wait<0>();
      wg::fence_regs(oacc);
      if constexpr (TAIL > 0) wg::fence_regs(otail);
      ring_free<SLOTS>(empty, 2 * n_live - 1, lane);
    }
    for (int t = 2 * n_live; t < 2 * n_kv; ++t) {   // tiles above the diagonal: free their slots
      ring_wait<SLOTS>(full, t);
      ring_free<SLOTS>(empty, t, lane);
    }

    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    const int c0 = COLS ? wgi * NO : 0;
    // 8 columns (d) of O: the accumulator's 4 values a thread, rows r_lo / r_hi
    auto store = [&](int col, float a0, float a1, float a2, float a3) {
      if (r_lo < T)
        *reinterpret_cast<__nv_bfloat162*>(o + ((size_t(b) * T + r_lo) * H + h) * DH + col) =
            __floats2bfloat162_rn(a0 * inv_lo, a1 * inv_lo);
      if (r_hi < T)
        *reinterpret_cast<__nv_bfloat162*>(o + ((size_t(b) * T + r_hi) * H + h) * DH + col) =
            __floats2bfloat162_rn(a2 * inv_hi, a3 * inv_hi);
    };
#pragma unroll
    for (int d = 0; d < NO / 8; ++d)
      store(c0 + d * 8 + tq * 2, oacc[4 * d], oacc[4 * d + 1], oacc[4 * d + 2], oacc[4 * d + 3]);
#pragma unroll
    for (int d = 0; d < TAIL / 8; ++d)
      store(NO + d * 8 + tq * 2, otail[4 * d], otail[4 * d + 1], otail[4 * d + 2],
            otail[4 * d + 3]);
    // the quad holds equal m and l: one lane writes (under COLS, of warpgroup 0)
    if (lse != nullptr && tq == 0 && (!COLS || wgi == 0)) {
      float* lrow = lse + (size_t(b) * H + h) * T;
      if (r_lo < T) lrow[r_lo] = (m_lo + log2f(fmaxf(l_lo, 1e-30f))) * kLn2;
      if (r_hi < T) lrow[r_hi] = (m_hi + log2f(fmaxf(l_hi, 1e-30f))) * kLn2;
    }
  }
}

// The dq pass's body. ALiBi: P = 2^(s * scale_log2 + slope_h log2(e) j -
// lse log2(e)) at the absolute key j, the bottom-right diagonal; a row past
// T takes lse = +1e30, so its P is exactly 0 without a mask.
template <int DH, Form F>
__device__ __forceinline__ void wg_dq(const CUtensorMap& qmap, const CUtensorMap& domap,
                                      const CUtensorMap& kmap, const CUtensorMap& vmap,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta, const int* __restrict__ seg,
                                      __nv_bfloat16* __restrict__ dq, int B, int T, int S, int H,
                                      int KV, int causal, float scale, float scale_log2,
                                      const Alibi alibi) {
  constexpr bool AL = F != kDense;
  using Sh = WgDq<DH>;
  static_assert(!AL || !Sh::COLS, "ALiBi is built at head dims 64 and 128");
  constexpr bool COLS = Sh::COLS;
  constexpr int BM = Sh::BM, BN = Sh::BN, SLOTS = Sh::SLOTS, CB = Sh::CB;
  constexpr int NO = COLS ? DH / 2 : DH;             // a consumer's columns of dq
  constexpr int KSTEPS = COLS ? DH / 32 : DH / 16;   // its k-steps of S and dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_smem(smem_raw);          // CB blocks of [BM][64]
  unsigned char* dos = qs + Sh::Q_BYTES;             // the same for dO
  unsigned char* ring = dos + Sh::Q_BYTES;           // SLOTS tiles of CB blocks of [64][64]
  float* xbuf = reinterpret_cast<float*>(ring + SLOTS * Sh::TILE_BYTES);   // COLS: S and dP
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SLOTS * Sh::TILE_BYTES + Sh::X_BYTES);
  uint64_t* empty = full + SLOTS;
  uint64_t* qbar = empty + SLOTS;

  const int nqt = (T + BM - 1) / BM;
  int b, h, kvh, qt;
  if constexpr (AL)
    alibi_block_of_rows(nqt, B, H, KV, b, h, kvh, qt);
  else
    block_of_rows(nqt, H, KV, causal, b, h, kvh, qt);
  const int q0 = qt * BM;
  const int n_s = (S + BN - 1) / BN;
  const int n_kv = AL       ? min((q0 + BM - 1 + alibi.off) / BN + 1, n_s)
                   : causal ? min((q0 + BM - 1) / BN + 1, n_s)
                            : n_s;

  if (threadIdx.x == 0) init_ring(full, empty, SLOTS, qbar);
  __syncthreads();
  const int wgi = threadIdx.x / kWgThreads;
  if (wgi == kConsumerWgs) {
    wg::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerWgs * kWgThreads) {
      wg::mbar_expect_tx(qbar, 2 * Sh::Q_BYTES);
      tma_tile<BM, CB>(qs, &qmap, qbar, h * DH, q0, b);
      tma_tile<BM, CB>(dos, &domap, qbar, h * DH, q0, b);
      for (int t = 0; t < 2 * n_kv; ++t) {   // V_j, then K_j
        ring_fill<SLOTS>(full, empty, t, Sh::TILE_BYTES);
        tma_tile<BN, CB>(ring + (t % SLOTS) * Sh::TILE_BYTES, (t & 1) ? &kmap : &vmap,
                         &full[t % SLOTS], kvh * DH, (t >> 1) * BN, b);
      }
    }
  } else {
    wg::regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const int r0 = COLS ? q0 : q0 + wgi * 64;
    const int r_lo = r0 + warp * 16 + g, r_hi = r_lo + 8;
    const int* segb = seg ? seg + size_t(b) * T : nullptr;
    const int seg_lo = segb ? segb[min(r_lo, T - 1)] : 0;
    const int seg_hi = segb ? segb[min(r_hi, T - 1)] : 0;
    const size_t so = (size_t(b) * H + h) * T;
    constexpr float past_t = AL ? -kNeg : 0.f;   // the lse of a row past T
    const float lse_lo = r_lo < T ? lse[so + r_lo] * kLog2e : past_t;
    const float lse_hi = r_hi < T ? lse[so + r_hi] * kLog2e : past_t;
    const float del_lo = r_lo < T ? delta[so + r_lo] : 0.f;
    const float del_hi = r_hi < T ? delta[so + r_hi] : 0.f;
    float slope2 = 0.f;   // ALiBi: this head's slope in the log2 domain
    if constexpr (AL) slope2 = alibi.slopes[h] * kLog2e;
    const int cb0 = COLS ? wgi * (CB / 2) : 0;
    const int row_off = COLS ? 0 : wgi * 64 * wg::kSwizzleBytes;
    const unsigned char* qa = qs + row_off;
    const unsigned char* da = dos + row_off;

    float dqacc[NO / 2];
    zero(dqacc);
    wg::mbar_wait(qbar, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int tv = 2 * j, tk = tv + 1, k0 = j * BN;
      const unsigned char* vt = ring + (tv % SLOTS) * Sh::TILE_BYTES;
      const unsigned char* kt = ring + (tk % SLOTS) * Sh::TILE_BYTES;
      const bool live = AL ? k0 <= r0 + 63 + alibi.off : !(causal && k0 > r0 + 63);

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each (COLS: partials)
      float s[BN / 2], dp[BN / 2];
      zero(s);
      zero(dp);
      ring_wait<SLOTS>(full, tv);
      ring_wait<SLOTS>(full, tk);
      if (live) {
        wg::fence_regs(s);
        wg::fence_regs(dp);
        wg::mma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const int cb = cb0 + kk / 4, off = (kk % 4) * 32;
          const int ao = cb * BM * 128 + off, bo = cb * BN * 128 + off;
          wg::mma_ss<BN, 0>(s, wg::desc_k(qa + ao), wg::desc_k(kt + bo), kk > 0);
          wg::mma_ss<BN, 0>(dp, wg::desc_k(da + ao), wg::desc_k(vt + bo), kk > 0);
        }
        wg::mma_commit();
        wg::mma_wait<0>();
        wg::fence_regs(s);
        wg::fence_regs(dp);
      }
      ring_free<SLOTS>(empty, tv, lane);
      if constexpr (COLS) {   // S and dP = the two partials, summed in both warpgroups
        exchange_store(xbuf, wgi, tid, s);
        exchange_store(xbuf + kConsumerWgs * (BN / 2) * kWgThreads, wgi, tid, dp);
        wg::bar_sync<2 * kWgThreads>(kBarX);
        exchange_add(xbuf, wgi, tid, s);
        exchange_add(xbuf + kConsumerWgs * (BN / 2) * kWgThreads, wgi, tid, dp);
        wg::bar_sync<2 * kWgThreads>(kBarXFree);   // the buffer is free for the next tile
      }

      if (live) {
        // P = exp(S - lse), masked pairs exactly 0; dS = P (dP - delta)
        if constexpr (AL) {
          const bool masked = k0 + BN - 1 > r0 + alibi.off || k0 + BN > S;
#pragma unroll
          for (int n = 0; n < BN / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // bias - lse first: exact where P matters (the two within 2x), so
              // the score's one rounding is at its small final magnitude
              const int key = k0 + n * 8 + tq * 2 + (e & 1);
              float p = ex2(fmaf(s[4 * n + e], scale_log2,
                                 slope2 * float(key) - (e < 2 ? lse_lo : lse_hi)));
              if (masked) p = key < S && key <= (e < 2 ? r_lo : r_hi) + alibi.off ? p : 0.f;
              dp[4 * n + e] = p * (dp[4 * n + e] - (e < 2 ? del_lo : del_hi));
            }
        } else {
          const bool masked = (causal && k0 + BN - 1 > r0) || k0 + BN > S || segb != nullptr;
          if (masked) mask_tile(s, k0, r_lo, r_hi, tq, S, causal, segb, seg_lo, seg_hi);
#pragma unroll
          for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = ex2(fmaf(s[4 * n + e], scale_log2, -(e < 2 ? lse_lo : lse_hi)));
              if (masked) p = s[4 * n + e] <= kNeg ? 0.f : p;
              dp[4 * n + e] = p * (dp[4 * n + e] - (e < 2 ? del_lo : del_hi));
            }
          }
        }
        // dq += dS K over this warpgroup's columns: dS from registers as bf16 hi + lo, K MN-major
        uint32_t sh[BN / 16][4], sl[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) split_fragment(dp, kk, sh[kk], sl[kk]);
        wg::fence_regs(dqacc);
        wg::mma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint64_t kd = wg::desc_mn(kt + cb0 * BN * 128 + kk * 16 * 128, BN * 128);
          wg::mma_rs<NO, 1>(dqacc, sh[kk], kd, 1);
          wg::mma_rs<NO, 1>(dqacc, sl[kk], kd, 1);
        }
        wg::mma_commit();
        wg::mma_wait<0>();
        wg::fence_regs(dqacc);
      }
      ring_free<SLOTS>(empty, tk, lane);
    }

    const int c0 = COLS ? wgi * NO : 0;
#pragma unroll
    for (int d = 0; d < NO / 8; ++d) {
      const int col = c0 + d * 8 + tq * 2;
      if (r_lo < T)
        *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t(b) * T + r_lo) * H + h) * DH + col) =
            __floats2bfloat162_rn(dqacc[4 * d + 0] * scale, dqacc[4 * d + 1] * scale);
      if (r_hi < T)
        *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t(b) * T + r_hi) * H + h) * DH + col) =
            __floats2bfloat162_rn(dqacc[4 * d + 2] * scale, dqacc[4 * d + 3] * scale);
    }
  }
}

// named barriers of the dk/dv pass (0 is __syncthreads)
constexpr int kBarPDs = 1;     // both warpgroups' halves of P^T and dS^T are in shared memory
constexpr int kBarFree = 2;    // (one set of tiles) both are done with the last set
constexpr int kBarVec = 3;     // + w: warpgroup w's lse and delta values are staged (w only)
constexpr int kBarDslope = 5;  // (+ w under the key split) the warps' dslope partials are staged

// The ALiBi dk/dv passes' first query tile of a key tile starting at key k0:
// the tile of the first query that sees k0 (j <= i + off).
__device__ __forceinline__ int alibi_first_query_tile(int k0, int off, int BQ) {
  return max(0, (k0 - off) / BQ);
}

// The dk/dv pass's body by the query split (head dims 128 and 256). ALiBi:
// P^T = 2^(s * scale_log2 + slope_h log2(e) j - lse log2(e)) with each
// query head's own slope, the bottom-right diagonal, queries past T at lse
// +1e30 (P exactly 0); with kAlibiDslope each thread sums dS over its
// queries for each of its two keys, and at a head's last query tile the
// sums times j are added lanes by butterfly, then warps 0-3 of warpgroup 0,
// then 0-3 of warpgroup 1, into the head's partial of this key tile.
template <int DH, Form F>
__device__ __forceinline__ void wg_dkv(const CUtensorMap& qmap, const CUtensorMap& domap,
                                       const CUtensorMap& kmap, const CUtensorMap& vmap,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                                       __nv_bfloat16* __restrict__ dv, int B, int T, int S, int H,
                                       int KV, int causal, float scale, float scale_log2,
                                       const Alibi alibi) {
  constexpr bool AL = F != kDense, DSLOPE = F == kAlibiDslope;
  using Sh = WgDkv<DH>;
  static_assert(!Sh::KEY_SPLIT, "64 runs wg_dkv_keys");
  static_assert(!AL || DH == 128, "ALiBi is built at head dims 64 and 128");
  constexpr int BN = Sh::BN, BQ = Sh::BQ, SLOTS = Sh::SLOTS, CB = Sh::CB, HALF = Sh::HALF;
  constexpr int QW = BQ / kConsumerWgs;               // a warpgroup's query columns of S^T, dP^T
  constexpr int BOTH = 2 * kWgThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = align_smem(smem_raw);          // CB blocks of [64][64]
  unsigned char* vs = ks + Sh::KV_BYTES;
  unsigned char* ring = vs + Sh::KV_BYTES;           // SLOTS tiles: Q_i, dO_i, Q_i+1, ...
  unsigned char* pbuf = ring + SLOTS * Sh::TILE_BYTES;   // PBUF x (P^T hi, lo, dS^T hi, lo)
  float* vecs = reinterpret_cast<float*>(pbuf + Sh::P_BYTES);   // [2 wg][2 it][lse, delta][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(pbuf + Sh::P_BYTES + Sh::VEC_BYTES);
  uint64_t* empty = full + SLOTS;
  uint64_t* kvbar = empty + SLOTS;
  float* red = reinterpret_cast<float*>(kvbar + 1);   // DSLOPE: [2 wg][4 warps]

  // blocks by (sequence, kv head), then key tile: the blocks in flight read
  // the same query heads' Q and dO from L2; key tile 0 has the most query
  // tiles under a causal mask and is issued first
  const int nkt = (S + BN - 1) / BN;
  int b, kvh, kt;
  if constexpr (AL) {
    alibi_block_of_keys(nkt, B, KV, b, kvh, kt);
  } else {
    const int bkv = blockIdx.x / nkt;
    kt = blockIdx.x % nkt;
    b = bkv / KV;
    kvh = bkv % KV;
  }
  const int n_rep = H / KV;
  const int k0 = kt * BN;
  const int nqt = (T + BQ - 1) / BQ;
  // causal needs T == S (ALiBi S >= T): at least one query tile
  const int qt_lo = AL ? alibi_first_query_tile(k0, alibi.off, BQ) : causal ? kt : 0;
  const int n_q = nqt - qt_lo, n_it = n_rep * n_q;

  if (threadIdx.x == 0) init_ring(full, empty, SLOTS, kvbar);
  __syncthreads();
  const int wgi = threadIdx.x / kWgThreads;
  if (wgi == kConsumerWgs) {
    wg::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerWgs * kWgThreads) {
      wg::mbar_expect_tx(kvbar, 2 * Sh::KV_BYTES);
      tma_tile<BN, CB>(ks, &kmap, kvbar, kvh * DH, k0, b);
      tma_tile<BN, CB>(vs, &vmap, kvbar, kvh * DH, k0, b);
      for (int t = 0; t < 2 * n_it; ++t) {   // Q_i, then dO_i
        const int i = t >> 1;
        ring_fill<SLOTS>(full, empty, t, Sh::TILE_BYTES);
        tma_tile<BQ, CB>(ring + (t % SLOTS) * Sh::TILE_BYTES, (t & 1) ? &domap : &qmap,
                         &full[t % SLOTS], (kvh * n_rep + i / n_q) * DH, (qt_lo + i % n_q) * BQ,
                         b);
      }
    }
  } else {
    wg::regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const int row = warp * 16 + g;                   // this lane's keys: row, row + 8 of the tile
    const int key_lo = k0 + row, key_hi = key_lo + 8;
    const int* segb = seg ? seg + size_t(b) * T : nullptr;   // segment ids need T == S
    const int seg_lo = segb ? segb[min(key_lo, S - 1)] : 0;
    const int seg_hi = segb ? segb[min(key_hi, S - 1)] : 0;
    const int qw0 = wgi * QW;                        // this warpgroup's query columns
    // this warpgroup's dk and dv columns: [wgi * HALF, wgi * HALF + HALF)
    const int half_off = wgi * (HALF / 64) * BQ * 128;

    float dkacc[HALF / 2], dvacc[HALF / 2];
    zero(dkacc);
    zero(dvacc);
    // the tile's lse (into the log2 domain) and delta for this warpgroup's 32
    // queries, read one iteration ahead and staged in shared memory
    auto load_vec = [&](int i) {
      const int head = kvh * n_rep + i / n_q;
      const int query = (qt_lo + i % n_q) * BQ + qw0 + tid % QW;
      const float* vec = tid < QW ? lse : delta;
      return tid < 2 * QW && query < T
                 ? vec[(size_t(b) * H + head) * T + query] * (tid < QW ? kLog2e : 1.f)
                 : (AL && tid < QW ? -kNeg : 0.f);   // ALiBi: a query past T at lse +1e30
    };
    float dsum_lo = 0.f, dsum_hi = 0.f;   // DSLOPE: sum of dS over this head's queries, per key
    float next_vec = load_vec(0);
    wg::mbar_wait(kvbar, 0);
    for (int i = 0; i < n_it; ++i) {
      const int tqt = 2 * i, tdo = tqt + 1;
      const unsigned char* qtile = ring + (tqt % SLOTS) * Sh::TILE_BYTES;
      const unsigned char* dotile = ring + (tdo % SLOTS) * Sh::TILE_BYTES;
      const int qt = qt_lo + i % n_q, q0 = qt * BQ;
      const int head = kvh * n_rep + i / n_q;
      float bias_lo = 0.f, bias_hi = 0.f;   // ALiBi: this head's bias at this lane's keys
      if constexpr (AL) {
        const float slope2 = alibi.slopes[head] * kLog2e;
        bias_lo = slope2 * float(key_lo);
        bias_hi = slope2 * float(key_hi);
      }
      unsigned char* p_hi = pbuf + (i % Sh::PBUF) * 4 * Sh::P_TILE;   // this tile's set
      unsigned char* p_lo = p_hi + Sh::P_TILE;
      unsigned char* ds_hi = p_hi + 2 * Sh::P_TILE;
      unsigned char* ds_lo = p_hi + 3 * Sh::P_TILE;
      ring_wait<SLOTS>(full, tqt);
      ring_wait<SLOTS>(full, tdo);

      // S^T = K Q^T and dP^T = V dO^T over this warpgroup's 32 queries: 64 keys x 32
      float st[QW / 2], dpt[QW / 2];
      zero(st);
      zero(dpt);
      wg::fence_regs(st);
      wg::fence_regs(dpt);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int off = (kk / 4) * BN * 128 + (kk % 4) * 32, qoff = (kk / 4) * BQ * 128 + qw0 * 128 + (kk % 4) * 32;
        wg::mma_ss<QW, 0>(st, wg::desc_k(ks + off), wg::desc_k(qtile + qoff), kk > 0);
        wg::mma_ss<QW, 0>(dpt, wg::desc_k(vs + off), wg::desc_k(dotile + qoff), kk > 0);
      }
      wg::mma_commit();
      float* colv = vecs + (wgi * 2 + (i & 1)) * 2 * QW;   // [lse2 | delta] of the 32 queries
      const float mine = next_vec;
      if (i + 1 < n_it) next_vec = load_vec(i + 1);
      wg::mma_wait<0>();
      wg::fence_regs(st);
      wg::fence_regs(dpt);
      if (tid < 2 * QW) colv[tid] = mine;
      wg::bar_sync<kWgThreads>(kBarVec + wgi);

      // one set of tiles: both warpgroups must be done with the last one (each
      // reaches this point only after its products of the last tile)
      if (Sh::PBUF == 1 && i > 0) wg::bar_sync<BOTH>(kBarFree);
      // P^T = exp(S^T - lse) with masked pairs exactly 0, dS^T = P^T (dP^T - delta),
      // each to shared memory as bf16 hi + lo in this warpgroup's 32 columns
      bool masked;
      if constexpr (AL) {
        masked = k0 + BN - 1 > q0 + alibi.off || k0 + BN > S;
      } else {
        masked = (causal && qt == kt) || q0 + BQ > T || k0 + BN > S || segb != nullptr;
        if (masked) {   // keys are rows here, queries columns
#pragma unroll
          for (int n = 0; n < QW / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int query = q0 + qw0 + n * 8 + tq * 2 + (e & 1), key = e < 2 ? key_lo : key_hi;
              bool ok = key < S && query < T && !(causal && key > query);
              if (segb != nullptr) ok = ok && segb[min(query, T - 1)] == (e < 2 ? seg_lo : seg_hi);
              st[4 * n + e] = ok ? st[4 * n + e] : kNeg;
            }
        }
      }
#pragma unroll
      for (int n = 0; n < QW / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + tq * 2 + (e & 1);
          float p;
          if constexpr (AL) {
            const int key = e < 2 ? key_lo : key_hi;
            // bias - lse first, as in wg_dq
            p = ex2(fmaf(st[4 * n + e], scale_log2, (e < 2 ? bias_lo : bias_hi) - colv[c]));
            if (masked) p = key < S && key <= q0 + qw0 + c + alibi.off ? p : 0.f;
          } else {
            p = ex2(fmaf(st[4 * n + e], scale_log2, -colv[c]));
            if (masked) p = st[4 * n + e] <= kNeg ? 0.f : p;
          }
          st[4 * n + e] = p;
          dpt[4 * n + e] = p * (dpt[4 * n + e] - colv[QW + c]);
          if constexpr (DSLOPE) (e < 2 ? dsum_lo : dsum_hi) += dpt[4 * n + e];
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {   // rows row (hr 0) and row + 8
          const uint32_t at = wg::swizzled(row + 8 * hr, qw0 + n * 8 + tq * 2);
          uint32_t hi, lo;
          split_hi_lo(st[4 * n + 2 * hr], st[4 * n + 2 * hr + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(p_hi + at) = hi;
          *reinterpret_cast<uint32_t*>(p_lo + at) = lo;
          split_hi_lo(dpt[4 * n + 2 * hr], dpt[4 * n + 2 * hr + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(ds_hi + at) = hi;
          *reinterpret_cast<uint32_t*>(ds_lo + at) = lo;
        }
      }
      wg::fence_proxy_async();
      wg::bar_sync<BOTH>(kBarPDs);

      // dv[:, half] += P^T dO[:, half] and dk[:, half] += dS^T Q[:, half]: A from the
      // exchanged tiles (hi and lo), B MN-major over this warpgroup's column blocks
      wg::fence_regs(dkacc);
      wg::fence_regs(dvacc);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const int bo = half_off + kk * 16 * 128;
        const uint64_t dod = wg::desc_mn(dotile + bo, BQ * 128);
        const uint64_t qd = wg::desc_mn(qtile + bo, BQ * 128);
        wg::mma_ss<HALF, 1>(dvacc, wg::desc_k(p_hi + kk * 32), dod, 1);
        wg::mma_ss<HALF, 1>(dvacc, wg::desc_k(p_lo + kk * 32), dod, 1);
        wg::mma_ss<HALF, 1>(dkacc, wg::desc_k(ds_hi + kk * 32), qd, 1);
        wg::mma_ss<HALF, 1>(dkacc, wg::desc_k(ds_lo + kk * 32), qd, 1);
      }
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::fence_regs(dkacc);
      wg::fence_regs(dvacc);
      ring_free<SLOTS>(empty, tqt, lane);
      ring_free<SLOTS>(empty, tdo, lane);
      if constexpr (DSLOPE) {
        if (i % n_q == n_q - 1) {   // the head's last query tile: its partial of this key tile
          float part = dsum_lo * float(key_lo) + dsum_hi * float(key_hi);
#pragma unroll
          for (int x = 16; x > 0; x >>= 1) part += __shfl_xor_sync(0xffffffffu, part, x);
          if (lane == 0) red[wgi * 4 + warp] = part;
          // (read before both pass the next tile's kBarPDs: only then is red rewritten)
          wg::bar_sync<BOTH>(kBarDslope);
          if (wgi == 0 && tid == 0)
            alibi.dslope[(size_t(b) * H + head) * nkt + kt] =
                (((red[0] + red[1]) + red[2]) + red[3]) + (((red[4] + red[5]) + red[6]) + red[7]);
          dsum_lo = dsum_hi = 0.f;
        }
      }
    }

#pragma unroll
    for (int d = 0; d < HALF / 8; ++d) {
      const int col = wgi * HALF + d * 8 + tq * 2;
      if (key_lo < S) {
        const size_t at = ((size_t(b) * S + key_lo) * KV + kvh) * DH + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[4 * d + 0] * scale, dkacc[4 * d + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[4 * d + 0], dvacc[4 * d + 1]);
      }
      if (key_hi < S) {
        const size_t at = ((size_t(b) * S + key_hi) * KV + kvh) * DH + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[4 * d + 2] * scale, dkacc[4 * d + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[4 * d + 2], dvacc[4 * d + 3]);
      }
    }
  }
}

// The dk/dv pass at 64 (WgDkv's KEY_SPLIT): a block is a 128-key tile of
// one kv head, warpgroup w its keys [k0 + 64 w, k0 + 64 w + 64). For each
// (query head of the group, 64-query tile) in the ring's order it computes
// S^T = K_w Q^T and dP^T = V_w dO^T (m64n64k16, 64 keys x 64 queries),
// P^T = 2^(S^T scale_log2 - lse2) with masked pairs exactly 0 and dS^T =
// P^T (dP^T - delta) in registers, then dv += P^T dO and dk += dS^T Q with
// those tiles, as bf16 hi and lo terms, as wgmma's register A operand and
// dO, Q read MN-major. A query tile wholly above a warpgroup's keys
// (causal) is computed all masked: it adds exact zeros. ALiBi as in wg_dkv;
// with kAlibiDslope each warpgroup writes the partial of its own 64 keys
// (lanes by butterfly, then its warps 0-3), the dslope buffer's tile
// 2 kt + w.
template <int DH, Form F>
__device__ __forceinline__ void wg_dkv_keys(const CUtensorMap& qmap, const CUtensorMap& domap,
                                            const CUtensorMap& kmap, const CUtensorMap& vmap,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            const int* __restrict__ seg,
                                            __nv_bfloat16* __restrict__ dk,
                                            __nv_bfloat16* __restrict__ dv, int B, int T, int S,
                                            int H, int KV, int causal, float scale,
                                            float scale_log2, const Alibi alibi) {
  constexpr bool AL = F != kDense, DSLOPE = F == kAlibiDslope;
  using Sh = WgDkv<DH>;
  static_assert(Sh::KEY_SPLIT && Sh::CB == 1, "the key split is built at head_dim 64");
  constexpr int BN = Sh::BN, BQ = Sh::BQ, SLOTS = Sh::SLOTS;
  constexpr int WK = BN / kConsumerWgs;               // a warpgroup's keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = align_smem(smem_raw);          // [128 keys][64]: warpgroup w's at row 64 w
  unsigned char* vs = ks + Sh::KV_BYTES;
  unsigned char* ring = vs + Sh::KV_BYTES;           // SLOTS tiles: Q_i, dO_i, Q_i+1, ...
  float* vecs = reinterpret_cast<float*>(ring + SLOTS * Sh::TILE_BYTES);   // [2 wg][2 it][lse2 | delta][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SLOTS * Sh::TILE_BYTES + Sh::VEC_BYTES);
  uint64_t* empty = full + SLOTS;
  uint64_t* kvbar = empty + SLOTS;
  float* red = reinterpret_cast<float*>(kvbar + 1);   // DSLOPE: [2 wg][4 warps]

  // blocks by (sequence, kv head), then key tile, key tile 0 (the most
  // query tiles under a causal mask) first
  const int nkt = (S + BN - 1) / BN;
  int b, kvh, kt;
  if constexpr (AL) {
    alibi_block_of_keys(nkt, B, KV, b, kvh, kt);
  } else {
    const int bkv = blockIdx.x / nkt;
    kt = blockIdx.x % nkt;
    b = bkv / KV;
    kvh = bkv % KV;
  }
  const int n_rep = H / KV;
  const int k0 = kt * BN;
  const int nqt = (T + BQ - 1) / BQ;
  // causal needs T == S (ALiBi S >= T): at least one query tile
  const int qt_lo = AL ? alibi_first_query_tile(k0, alibi.off, BQ) : causal ? k0 / BQ : 0;
  const int n_q = nqt - qt_lo, n_it = n_rep * n_q;

  if (threadIdx.x == 0) init_ring(full, empty, SLOTS, kvbar);
  __syncthreads();
  const int wgi = threadIdx.x / kWgThreads;
  if (wgi == kConsumerWgs) {
    wg::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerWgs * kWgThreads) {
      // K and V as two 64-row boxes each, one under the other (rows past S read as zeros)
      wg::mbar_expect_tx(kvbar, 2 * Sh::KV_BYTES);
#pragma unroll
      for (int w = 0; w < kConsumerWgs; ++w) {
        wg::tma_load_3d(ks + w * WK * wg::kSwizzleBytes, &kmap, kvbar, kvh * DH, k0 + w * WK, b);
        wg::tma_load_3d(vs + w * WK * wg::kSwizzleBytes, &vmap, kvbar, kvh * DH, k0 + w * WK, b);
      }
      for (int t = 0; t < 2 * n_it; ++t) {   // Q_i, then dO_i
        const int i = t >> 1;
        ring_fill<SLOTS>(full, empty, t, Sh::TILE_BYTES);
        wg::tma_load_3d(ring + (t % SLOTS) * Sh::TILE_BYTES, (t & 1) ? &domap : &qmap,
                        &full[t % SLOTS], (kvh * n_rep + i / n_q) * DH, (qt_lo + i % n_q) * BQ,
                        b);
      }
    }
  } else {
    wg::regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const int kw0 = k0 + wgi * WK;                   // this warpgroup's keys
    const int key_lo = kw0 + warp * 16 + g, key_hi = key_lo + 8;   // this lane's rows
    const int* segb = seg ? seg + size_t(b) * T : nullptr;   // segment ids need T == S
    const int seg_lo = segb ? segb[min(key_lo, S - 1)] : 0;
    const int seg_hi = segb ? segb[min(key_hi, S - 1)] : 0;
    const unsigned char* ka = ks + wgi * WK * wg::kSwizzleBytes;
    const unsigned char* va = vs + wgi * WK * wg::kSwizzleBytes;

    float dkacc[DH / 2], dvacc[DH / 2];
    zero(dkacc);
    zero(dvacc);
    // the tile's lse (into the log2 domain: threads 0-63) and delta (64-127)
    // of its 64 queries, read one iteration ahead and staged in shared memory
    auto load_vec = [&](int i) {
      const int head = kvh * n_rep + i / n_q;
      const int query = (qt_lo + i % n_q) * BQ + tid % BQ;
      const float* vec = tid < BQ ? lse : delta;
      return query < T ? vec[(size_t(b) * H + head) * T + query] * (tid < BQ ? kLog2e : 1.f)
                       : (AL && tid < BQ ? -kNeg : 0.f);   // ALiBi: a query past T at lse +1e30
    };
    float dsum_lo = 0.f, dsum_hi = 0.f;   // DSLOPE: sum of dS over this head's queries, per key
    float next_vec = load_vec(0);
    wg::mbar_wait(kvbar, 0);
    for (int i = 0; i < n_it; ++i) {
      const int tqt = 2 * i, tdo = tqt + 1;
      const unsigned char* qtile = ring + (tqt % SLOTS) * Sh::TILE_BYTES;
      const unsigned char* dotile = ring + (tdo % SLOTS) * Sh::TILE_BYTES;
      const int q0 = (qt_lo + i % n_q) * BQ;
      const int head = kvh * n_rep + i / n_q;
      float bias_lo = 0.f, bias_hi = 0.f;   // ALiBi: this head's bias at this lane's keys
      if constexpr (AL) {
        const float slope2 = alibi.slopes[head] * kLog2e;
        bias_lo = slope2 * float(key_lo);
        bias_hi = slope2 * float(key_hi);
      }
      ring_wait<SLOTS>(full, tqt);
      ring_wait<SLOTS>(full, tdo);

      // S^T = K_w Q^T and dP^T = V_w dO^T: 64 keys x 64 queries. Both
      // warpgroups compute every iteration (a branch around the products
      // serialises them, ptxas C7518): a query tile wholly above this
      // warpgroup's keys is all masked and adds exact zeros.
      float st[BQ / 2], dpt[BQ / 2];
      zero(st);
      zero(dpt);
      wg::fence_regs(st);
      wg::fence_regs(dpt);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wg::mma_ss<BQ, 0>(st, wg::desc_k(ka + kk * 32), wg::desc_k(qtile + kk * 32), kk > 0);
        wg::mma_ss<BQ, 0>(dpt, wg::desc_k(va + kk * 32), wg::desc_k(dotile + kk * 32), kk > 0);
      }
      wg::mma_commit();
      float* colv = vecs + (wgi * 2 + (i & 1)) * 2 * BQ;   // [lse2 | delta] of the 64 queries
      const float mine = next_vec;
      if (i + 1 < n_it) next_vec = load_vec(i + 1);
      colv[tid] = mine;
      wg::bar_sync<kWgThreads>(kBarVec + wgi);

      wg::mma_wait<0>();
      wg::fence_regs(st);
      wg::fence_regs(dpt);
      // P^T = exp(S^T - lse) with masked pairs exactly 0, dS^T = P^T (dP^T - delta);
      // keys are rows here, queries columns
      bool masked;
      if constexpr (AL) {
        masked = kw0 + WK - 1 > q0 + alibi.off || kw0 + WK > S;
      } else {
        masked = (causal && kw0 + WK - 1 > q0) || q0 + BQ > T || kw0 + WK > S || segb != nullptr;
        if (masked) {
#pragma unroll
          for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int query = q0 + n * 8 + tq * 2 + (e & 1), key = e < 2 ? key_lo : key_hi;
              bool ok = key < S && query < T && !(causal && key > query);
              if (segb != nullptr) ok = ok && segb[min(query, T - 1)] == (e < 2 ? seg_lo : seg_hi);
              st[4 * n + e] = ok ? st[4 * n + e] : kNeg;
            }
        }
      }
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + tq * 2 + (e & 1);
          float p;
          if constexpr (AL) {
            const int key = e < 2 ? key_lo : key_hi;
            // bias - lse first, as in wg_dq
            p = ex2(fmaf(st[4 * n + e], scale_log2, (e < 2 ? bias_lo : bias_hi) - colv[c]));
            if (masked) p = key < S && key <= q0 + c + alibi.off ? p : 0.f;
          } else {
            p = ex2(fmaf(st[4 * n + e], scale_log2, -colv[c]));
            if (masked) p = st[4 * n + e] <= kNeg ? 0.f : p;
          }
          st[4 * n + e] = p;
          dpt[4 * n + e] = p * (dpt[4 * n + e] - colv[BQ + c]);
          if constexpr (DSLOPE) (e < 2 ? dsum_lo : dsum_hi) += dpt[4 * n + e];
        }
      // dv += P^T dO and dk += dS^T Q: P^T and dS^T from registers as bf16 hi + lo
      // (16 queries a k-step), dO and Q MN-major
      uint32_t ph[BQ / 16][4], pl[BQ / 16][4], sh[BQ / 16][4], sl[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        split_fragment(st, kk, ph[kk], pl[kk]);
        split_fragment(dpt, kk, sh[kk], sl[kk]);
      }
      wg::fence_regs(dkacc);
      wg::fence_regs(dvacc);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t dod = wg::desc_mn(dotile + kk * 16 * wg::kSwizzleBytes, BQ * 128);
        const uint64_t qd = wg::desc_mn(qtile + kk * 16 * wg::kSwizzleBytes, BQ * 128);
        wg::mma_rs<DH, 1>(dvacc, ph[kk], dod, 1);
        wg::mma_rs<DH, 1>(dvacc, pl[kk], dod, 1);
        wg::mma_rs<DH, 1>(dkacc, sh[kk], qd, 1);
        wg::mma_rs<DH, 1>(dkacc, sl[kk], qd, 1);
      }
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::fence_regs(dkacc);
      wg::fence_regs(dvacc);
      ring_free<SLOTS>(empty, tqt, lane);
      ring_free<SLOTS>(empty, tdo, lane);
      if constexpr (DSLOPE) {
        if (i % n_q == n_q - 1) {   // the head's last query tile: the partial of these 64 keys
          float part = dsum_lo * float(key_lo) + dsum_hi * float(key_hi);
#pragma unroll
          for (int x = 16; x > 0; x >>= 1) part += __shfl_xor_sync(0xffffffffu, part, x);
          if (lane == 0) red[wgi * 4 + warp] = part;
          // (read before this warpgroup passes the next tile's kBarVec: only then rewritten)
          wg::bar_sync<kWgThreads>(kBarDslope + wgi);
          const int tile = kw0 / WK, n_tiles = (S + WK - 1) / WK;
          if (tid == 0 && tile < n_tiles)
            alibi.dslope[(size_t(b) * H + head) * n_tiles + tile] =
                ((red[wgi * 4] + red[wgi * 4 + 1]) + red[wgi * 4 + 2]) + red[wgi * 4 + 3];
          dsum_lo = dsum_hi = 0.f;
        }
      }
    }

#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      const int col = d * 8 + tq * 2;
      if (key_lo < S) {
        const size_t at = ((size_t(b) * S + key_lo) * KV + kvh) * DH + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[4 * d + 0] * scale, dkacc[4 * d + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[4 * d + 0], dvacc[4 * d + 1]);
      }
      if (key_hi < S) {
        const size_t at = ((size_t(b) * S + key_hi) * KV + kvh) * DH + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[4 * d + 2] * scale, dkacc[4 * d + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[4 * d + 2], dvacc[4 * d + 3]);
      }
    }
  }
}

}  // namespace
