// Flash attention forward and backward for Hopper (sm_90a): causal or full
// masks, grouped-query heads read from unexpanded K/V, optional segment
// ids, behind a plain C interface loaded with ctypes (ops/_build.py builds
// this file with nvcc at first use).
//
// Replaces the forward and the backward passes of the TPU kernels
//   shuffle_exchange_tpu/ops/flash_attention.py:pallas_attention
//     (the stock flash kernel: MHA, causal/full, segment ids; fwd + bwd)
//   shuffle_exchange_tpu/ops/flash_attention.py:splash_attention_gqa
//     (GQA with unexpanded K/V, causal/full masks, segment ids and the
//      block-sparse element mask mask_np; the forward, the dq pass and the
//      dkv pass)
//
// Layouts (contiguous, bf16; the JAX package's [batch, seq, heads, Dh]):
//   q, o    [B, T, H, Dh];  k, v  [B, S, KV, Dh];  seg  [B, T] int32 or null
// Query head h reads kv head h / (H / KV) (the _repeat_kv convention), so
// one kernel serves MHA (H == KV) and GQA. Causal masking needs T == S
// (query i sees keys j <= i); the wrapper refuses causal T != S.
//
// Element mask (splash's NumpyMask, reached through sparse_attention): a
// [T, S] boolean mask shared by every sequence and head, given as a tile
// map built on the host (ops/flash_attention.py:TileMask). Each (64-query,
// 64-key) tile of the mask is empty, full or partial; for each query tile
// the map lists its non-empty key tiles, and for each key tile its
// non-empty query tiles, each entry with the index of its partial block
// (a [64, 64] byte copy of the mask under the tile, zero past T and S) or
// -1 when full. The forward and dq passes walk their query tile's list,
// the dk/dv pass its key tile's list, so empty tiles are never loaded or
// computed; full tiles run unmasked and partial tiles test the byte of
// their block where segment ids are tested. A query row with no allowed
// key gives 0 and contributes 0 to every gradient (its probabilities are
// forced to 0, never a uniform average), as the JAX package's dense path.
//
// What it computes (reference_attention, the plain version): scores
// q.k * Dh^-0.5 in f32; masked scores -1e30 (causal, segment ids that
// differ, keys past S); softmax in f32, online across key tiles; output
// rounded to bf16 once.
//
// What bounds it on the H100: 4*B*H*Dh*(visible pairs) flops against
// q + o + k + v bytes. At the prefill's shapes (T = S ~ 1024, Dh 128) that
// is ~600 flops per byte, above the ~295 flop/byte ridge of the bf16 tensor
// cores, so the tensor cores bound it; the backward (10 * pairs * H * Dh
// flops against ~3x the forward's bytes) likewise. Two designs answer it.
//
// 1. The dense forms (every main path: the prefill of every served model,
// and training): the FlashAttention-3 shape, wgmma over TMA-fed tiles
// (wgmma_tile.cuh); the forward at head dims 64, 80, 96, 128 and 256, the
// backward at 64, 128 and 256. Their bodies and block shapes live in
// wgmma_flash.cuh, whose ALiBi form alibi_attention.cu instantiates
// (B11-B13); the __global__ kernels below wrap the dense form.
// A block is three warpgroups: two consumers that compute and one producer
// whose single thread issues every TMA load into a ring of single K, V, Q
// or dO tiles guarded by mbarriers (full: the bytes landed; empty: all 8
// consumer warps are done with the slot). setmaxnreg gives the consumers
// 240 registers a thread and the producer 24. Tiles live in the 128-byte
// swizzle that TMA writes and wgmma's descriptors read (64-column blocks
// of 128-byte rows); TMA's 3-D maps [B, rows, heads * Dh] make rows past a
// sequence's end read as zeros. TMA rather than cp.async: one producer
// thread keeps the ring full while the consumers' registers all go to
// accumulators, and the swizzle comes from the hardware. The maps are
// encoded on the host for each call (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint: no -lcuda) and passed as __grid_constant__
// parameters. Blocks go by (sequence, kv head) first, so the blocks in
// flight share their K/V (or Q/dO) tiles in L2.
//   Registers decide the shapes: ptxas serialises the wgmmas and spills
//   (its note C7512) once a consumer keeps ~160 accumulator registers
//   live, so every consumer here holds at most 64 + 32 + 32 (+ 32 P
//   fragments). At 256 (COLS) the forward and dq consumers therefore split
//   the head dim: a block is 64 query rows, each consumer computes the
//   partial scores over its 128 columns, the two partials are summed
//   through shared memory (each adds the other's: f32 addition commutes,
//   so both hold the same bits), and each accumulates its 128 columns of O
//   or dq. At 128 (and 64, 80, 96) a block is 128 rows, 64 a consumer.
//   forward: K_j and V_j tiles of 64 keys pass through a ring (4 slots at
//     256, 8 at 128), K_j freed right after S. S = Q K^T by wgmma m64n64k16
//     with both operands in shared memory; the online softmax in registers
//     in the log2 domain (p = 2^(s * scale_log2 - m) in one FFMA and one
//     ex2; the rescale is 2^(m - m_new), exactly 1 while a row has seen
//     only masked keys, and a masked key's p is exactly 0); O += P V with P
//     from registers as wgmma's A operand (the RS form) and V read
//     MN-major. FlashAttention-3's intra-warpgroup overlap: S_j and
//     P_j-1 V_j-1 are in flight together and tile j's softmax runs under
//     P_j-1 V_j-1. Below 256 a tile wholly above a consumer's diagonal is
//     skipped (its slots still freed); interior tiles run unmasked.
//     At 80 and 96 (Pythia-2.8b's and Phi-3-mini's prefill) a tile is one
//     full 64-column block and a tail block of 16 or 32 columns in the 32-
//     or 64-byte swizzle (its own TMA map and descriptors): S adds 1 or 2
//     k-steps, O an m64n16 or m64n32 product over V's tail read MN-major;
//     at 64 a tile is one block. O then takes 40 / 48 / 32 f32 registers a
//     consumer thread beside S's 32.
//     Shared memory: 230,472 B at 256 (Q 32 KB, ring 4 x 32 KB, two f32
//     exchange buffers 64 KB), 165,000 B at 128, 124,040 at 96, 103,560 at
//     80, 83,080 at 64.
//   dk/dv: a block is a 64-key tile of one kv head (K and V resident); Q_i
//     and dO_i of every 64-query tile at and below the diagonal of every
//     query head of the group pass through the ring. Each consumer
//     computes S^T = K Q^T and dP^T = V dO^T for its 32 of the tile's 64
//     queries (wgmma m64n32k16), forms P^T and dS^T = P^T (dP^T - delta)
//     and writes both, as bf16 hi and lo tiles, into its 32 columns of
//     four shared [64, 64] tiles; after one barrier each consumer runs
//     dv += P^T dO and dk += dS^T Q over its half of the head-dim columns
//     (64 + 64 accumulator registers at 256). The pass is one launch at
//     every head dim, and the group's sum over query heads stays in
//     registers in a fixed order. The tiles come in two sets by iteration
//     at 128 (231,560 B), one at 256 (231,496 B: a second barrier).
//     At 64 that split would leave m64n32 products and four shared tiles a
//     step for little work, so the pass takes FlashAttention-3's shape: a
//     block is a 128-key tile, each consumer owns 64 keys and all 64
//     queries of a ring tile (S^T and dP^T at m64n64k16), and P^T and dS^T
//     feed dv += P^T dO and dk += dS^T Q from registers (the RS form, dO
//     and Q MN-major): no shared P^T / dS^T tiles, no barrier between the
//     consumers, 32 + 32 accumulator registers (101,512 B).
//   dq: a block is a query tile of one head (Q and dO resident); V_j then
//     K_j of 64 keys pass through the ring (3 slots at 256, 8 at 128 and
//     64); S and dP by wgmma, dS from registers (RS) against K MN-major.
//     230,456 B at 256, 197,768 B at 128, 99,464 B at 64.
//   With no atomics the backward stays three kernels (delta, dk/dv, dq)
//   and 7 products a tile pair; every sum runs in a fixed order, so two
//   runs give equal bits.

// 2. The element-mask forms (sparse_attention) at every head dim:
// FlashAttention-2 on mma.sync, one block
// per (64-row query tile, head, sequence), 4 warps of 16 query rows each;
// a loop over 64-key K/V tiles up to the causal limit (tiles wholly above
// the diagonal are never loaded), K/V staged with cp.async into a double
// buffer while the previous tile computes; QK^T and PV as m16n8k16 bf16
// MMAs with f32 accumulators, operands from shared memory by ldmatrix
// (rows padded by 16 bytes: conflict-free); the running max and sum stay
// in registers. The causal query tiles are issued longest first, so the
// short tiles fill the tail.
//
// P.V precision (both designs): P is split into two bf16 terms, P = hi + lo
// with hi = bf16(P) (the wgmma kernels truncate: split_hi_lo) and lo =
// bf16(P - hi), and both are multiplied by V, so P keeps ~16 significant
// bits where one bf16 operand would keep 8. That puts the kernel within one
// bf16 step of the plain version with P in f32 (the card check) and costs
// half again the P.V work. dS takes the same split in the backward.
//
// Head dims: the forward takes 64, 128 and 256 (GPT-J-6B's prefill), and
// 80 (Pythia-2.8b) and 96 (Phi-3-mini), where the TPU package runs its jnp
// reference instead of a kernel. In the mma.sync kernels at 256 Q's
// fragments are re-read from shared memory at every k-step (the O
// accumulators take 128 registers a thread) and the staged tiles take
// 165 KB of dynamic shared memory, one block an SM. At 80 and 96 a k-step
// is 16 columns, so QK^T takes 5 and 6 k-steps and P.V 10 and 12 column
// tiles; the staged rows' pitch of Dh + 8 elements (176 and 208 bytes)
// keeps ldmatrix's 8 rows on 8 distinct groups of 4 banks. The backward
// takes 64, 128 and 256 (GPT-J-6B's training); the wrapper refuses 80 and
// 96, where the TPU package has no kernel either (training at those head
// dims is later work).
//
// The forward optionally writes lse [B, H, T] f32, the natural-log
// log-sum-exp of each row's scaled scores (the convention of the TPU
// ALiBi flash kernel), which is all the backward needs besides q, k, v,
// out and dout.
//
// The mma.sync backward (what the TPU dq and dkv passes compute), three
// kernels, no atomics:
//   delta  = rowsum(dout * out)                    one warp per (b, t, h)
//   dk, dv : one block per (64-key tile, kv head, sequence); it loops over
//            the query heads of the group and, for each, over the 64-query
//            tiles at and below the diagonal (or the tile map's entries),
//            with dk and dv (16 keys x Dh per warp) in registers; S^T and
//            dP^T are recomputed per tile, P^T = exp(S^T - lse), dS^T =
//            P^T (dP^T - delta), dv += P^T dO, dk += dS^T Q.
//   dq     : one block per (64-query tile, head, sequence) looping over the
//            key tiles up to the diagonal: dq += dS K.
// Masked pairs get p = 0 explicitly (never exp of a sentinel), so a row
// whose lse is the -1e30 sentinel contributes nothing. At 256 (the mask
// form) dk and dv would take 256 f32 accumulators a thread, so its dk/dv
// pass runs as two launches of the same kernel, a dv pass and a dk pass,
// each with 128 accumulators (8 tile products where 64 and 128 do 7); both
// passes stage 6 tiles of 64 x (256 + 8) bf16 (198 KB, one block an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"     // block shape, load_tile, stage_queries, delta_row
#include "wgmma_flash.cuh"    // the wgmma kernels' bodies and shapes, the delta pass
#include "wgmma_tile.cuh"     // mbarriers, TMA, wgmma, tensor maps

namespace {

// The host-built tile map of an element mask; row_ptr == null: no mask.
struct TileMap {
  const int* row_ptr;            // [nqt + 1]: query tile qt owns entries [row_ptr[qt], row_ptr[qt + 1])
  const int* row_kt;             // the entry's key tile
  const int* row_blk;            // its partial block, or -1 (full)
  const int* col_ptr;            // [nkt + 1]: the same by key tile
  const int* col_qt;
  const int* col_blk;
  const unsigned char* blocks;   // [n_partial][64][64]: mask byte (query row, key) of the tile
};

// Whether (query r, key c) of a tile with partial block blk is allowed (r,
// c relative to the tile); a full tile (blk < 0) allows everything.
__device__ __forceinline__ bool tile_allows(const TileMap& tm, int blk, int r, int c) {
  return blk < 0 || tm.blocks[(size_t(blk) * kBlockM + r) * kBlockN + c] != 0;
}

// The element-mask forward (the dense forms run wg_fwd_kernel): the key
// tiles of each query tile are its tile-map entries.
template <int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg, const TileMap tm,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B, int T, int S, int H, int KV,
    float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int KSTEPS = DH / 16;     // k-steps of QK^T
  constexpr int NT = kBlockN / 8;     // 8-key column tiles of S
  constexpr int DT = DH / 8;          // 8-wide column tiles of O
  // Q's A fragments stay in registers up to Dh 128; at 256 the O
  // accumulators alone take 128 registers a thread, so the fragments are
  // re-read from the staged Q tile at every k-step instead
  constexpr bool QREG = DH <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [64][LD]
  __nv_bfloat16* ks = qs + kBlockM * LD;                         // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * kBlockN * LD;                     // [2][64][LD]

  // heads of one kv group side by side
  const int BH = B * H;
  const int qt = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kBlockM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;   // mma row group, column pair

  const int qstride = H * DH, kstride = KV * DH;
  const __nv_bfloat16* qb = q + (size_t(b) * T + q0) * qstride + size_t(h) * DH;
  const __nv_bfloat16* kb = k + size_t(b) * S * kstride + size_t(kvh) * DH;
  const __nv_bfloat16* vb = v + size_t(b) * S * kstride + size_t(kvh) * DH;
  // the key tiles to visit: this query tile's tile-map entries
  const int base = tm.row_ptr[qt];
  const int n_kv = tm.row_ptr[qt + 1] - base;

  load_tile<DH>(qs, qb, qstride, T - q0, q, tid);
  if (n_kv > 0) {
    const int k00 = tm.row_kt[base] * kBlockN;
    load_tile<DH>(ks, kb + size_t(k00) * kstride, kstride, S - k00, k, tid);
    load_tile<DH>(vs, vb + size_t(k00) * kstride, kstride, S - k00, v, tid);
  }
  cp_async_commit();

  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const int* segb = seg ? seg + size_t(b) * T : nullptr;
  const int seg_lo = segb ? segb[min(r_lo, T - 1)] : 0;
  const int seg_hi = segb ? segb[min(r_hi, T - 1)] : 0;

  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
  uint32_t qa[QREG ? KSTEPS : 1][4];
  const __nv_bfloat16* qfrag =   // this lane's ldmatrix row of the warp's 16 query rows
      qs + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) {   // prefetch the next tile into the other buffer
      const int nb = (it + 1) & 1;
      const int k0n = tm.row_kt[base + it + 1] * kBlockN;
      load_tile<DH>(ks + nb * kBlockN * LD, kb + size_t(k0n) * kstride, kstride, S - k0n, k, tid);
      load_tile<DH>(vs + nb * kBlockN * LD, vb + size_t(k0n) * kstride, kstride, S - k0n, v, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qa[kk], qfrag + kk * 16);
      }
    }
    const int j = tm.row_kt[base + it];
    const int blk = tm.row_blk[base + it];
    const __nv_bfloat16* kt = ks + (it & 1) * kBlockN * LD;
    const __nv_bfloat16* vt = vs + (it & 1) * kBlockN * LD;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qf[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
      } else {
        ldsm_x4(qf, qfrag + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, kt + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                       ((lane / 8) % 2) * 8);
        mma_bf16(sacc[2 * np], qf, r[0], r[1]);
        mma_bf16(sacc[2 * np + 1], qf, r[2], r[3]);
      }
    }

    // scale into the log2 domain, mask, row max (rows r_lo: e < 2, r_hi: e >= 2)
    const int k0 = j * kBlockN;
    const bool masked_tile = blk >= 0 || segb != nullptr;
    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[n][e] * scale_log2;
        if (masked_tile) {
          const int key = k0 + n * 8 + tq * 2 + (e & 1);
          const int row = e < 2 ? r_lo : r_hi;
          bool ok = tile_allows(tm, blk, row - q0, key - k0);
          if (ok && segb) ok = segb[key] == (e < 2 ? seg_lo : seg_hi);
          s = ok ? s : kNeg;
        }
        sacc[n][e] = s;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, s);
        else
          mx_hi = fmaxf(mx_hi, s);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // under a mask a row may have no allowed key yet: its masked
        // scores give exactly 0, not exp2(kNeg - kNeg) = 1
        const float p = sacc[n][e] <= kNeg ? 0.f : exp2f(sacc[n][e] - (e < 2 ? mn_lo : mn_hi));
        sacc[n][e] = p;
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
    for (int d = 0; d < DT; ++d) {
      oacc[d][0] *= al_lo;
      oacc[d][1] *= al_lo;
      oacc[d][2] *= al_hi;
      oacc[d][3] *= al_hi;
    }

    // O += P V: the S accumulators of two key tiles are one A operand
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(sacc[2 * kk][0], sacc[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(sacc[2 * kk][2], sacc[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, vt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                             (lane / 16) * 8);
        mma_bf16(oacc[2 * dp], ph, r[0], r[1]);
        mma_bf16(oacc[2 * dp], pl, r[0], r[1]);
        mma_bf16(oacc[2 * dp + 1], ph, r[2], r[3]);
        mma_bf16(oacc[2 * dp + 1], pl, r[2], r[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer before it is refilled
  }

  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + tq * 2;
    if (r_lo < T)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t(b) * T + r_lo) * H + h) * DH + col) =
          __floats2bfloat162_rn(oacc[d][0] * inv_lo, oacc[d][1] * inv_lo);
    if (r_hi < T)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t(b) * T + r_hi) * H + h) * DH + col) =
          __floats2bfloat162_rn(oacc[d][2] * inv_hi, oacc[d][3] * inv_hi);
  }
  if (lse != nullptr && tq == 0) {   // the quad holds equal m and l: one lane writes
    float* lrow = lse + (size_t(b) * H + h) * T;
    if (r_lo < T) lrow[r_lo] = (m_lo + log2f(fmaxf(l_lo, 1e-30f))) * kLn2;
    if (r_hi < T) lrow[r_hi] = (m_hi + log2f(fmaxf(l_hi, 1e-30f))) * kLn2;
  }
}

template <int DH>
cudaError_t launch(int blocks, cudaStream_t s, const void* q, const void* k, const void* v,
                   const void* seg, const TileMap& tm, void* o, void* lse, int B, int T, int S,
                   int H, int KV, float scale_log2) {
  const size_t smem = size_t(kBlockM + 4 * kBlockN) * (DH + 8) * sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DH><<<blocks, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg), tm,
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), B, T, S, H, KV, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// The delta pass (flash_bwd_delta_kernel) lives in wgmma_flash.cuh.

// What a dk/dv block computes: both gradients (head dims 64 and 128), or
// at 256 one of them, in two launches (see the header).
enum DkvPass : int { kDkDv = 0, kDvOnly = 1, kDkOnly = 2 };

template <int DH, bool SPARSE, int PASS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ seg,
    const TileMap tm, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B,
    int T, int S, int H, int KV, int causal, float scale, float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int KSTEPS = DH / 16;     // k-steps over the head dim
  constexpr int NT = kBlockM / 8;     // 8-query column tiles of S^T
  constexpr int DT = DH / 8;          // 8-wide column tiles of dk, dv
  constexpr int TILE = kBlockN * LD;
  constexpr bool DO_DV = PASS != kDkOnly, DO_DK = PASS != kDvOnly;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [64][LD]
  __nv_bfloat16* vs = ks + TILE;                                 // [64][LD] (dk only)
  __nv_bfloat16* qs = vs + TILE;                                 // [2][64][LD]
  __nv_bfloat16* dos = qs + 2 * TILE;                            // [2][64][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * TILE);        // [2][64], log2 domain
  float* dels = lses + 2 * kBlockM;                              // [2][64]

  // key tile 0 has the most query tiles under a causal mask: issued first
  const int BKV = B * KV;
  const int kt = blockIdx.x / BKV, bkv = blockIdx.x % BKV;
  const int b = bkv / KV, kvh = bkv % KV, n_rep = H / KV;
  const int k0 = kt * kBlockN;
  const int nqt = (T + kBlockM - 1) / kBlockM;
  // the query tiles to visit: qt_lo .. nqt - 1 (causal needs T == S, so
  // at least one), or this key tile's tile-map entries (maybe none)
  constexpr bool sparse = SPARSE;
  const int base = sparse ? tm.col_ptr[kt] : 0;
  const int qt_lo = causal ? kt : 0;
  const int n_q = sparse ? tm.col_ptr[kt + 1] - base : nqt - qt_lo;
  const int n_it = n_rep * n_q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  const int kstride = KV * DH;
  const size_t koff = (size_t(b) * S + k0) * kstride + size_t(kvh) * DH;
  load_tile<DH>(ks, k + koff, kstride, S - k0, k, tid);
  if constexpr (DO_DK) load_tile<DH>(vs, v + koff, kstride, S - k0, v, tid);
  if (n_it > 0)
    stage_queries<DH>(qs, dos, lses, dels, q, dout, lse, delta, b, kvh * n_rep,
                      (sparse ? tm.col_qt[base] : qt_lo) * kBlockM, T, H, tid);
  cp_async_commit();

  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const int* segb = seg ? seg + size_t(b) * T : nullptr;   // segment ids need T == S
  const int seg_lo = segb ? segb[min(key_lo, S - 1)] : 0;
  const int seg_hi = segb ? segb[min(key_hi, S - 1)] : 0;

  float dkacc[DO_DK ? DT : 1][4], dvacc[DO_DV ? DT : 1][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (DO_DK) dkacc[d][e] = 0.f;
      if constexpr (DO_DV) dvacc[d][e] = 0.f;
    }

  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {   // prefetch the next (head, query tile) into the other buffer
      const int nx = it + 1, nb = nx & 1;
      const int qtn = sparse ? tm.col_qt[base + nx % n_q] : qt_lo + nx % n_q;
      stage_queries<DH>(qs + nb * TILE, dos + nb * TILE, lses + nb * kBlockM, dels + nb * kBlockM,
                        q, dout, lse, delta, b, kvh * n_rep + nx / n_q, qtn * kBlockM, T, H, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int qt = sparse ? tm.col_qt[base + it % n_q] : qt_lo + it % n_q, q0 = qt * kBlockM;
    const int blk = sparse ? tm.col_blk[base + it % n_q] : -1;
    const __nv_bfloat16* qtile = qs + buf * TILE;
    const __nv_bfloat16* dotile = dos + buf * TILE;
    const float* lse2 = lses + buf * kBlockM;
    const float* del = dels + buf * kBlockM;

    // S^T = K Q^T and (for dk) dP^T = V dO^T for this warp's 16 keys x 64 queries
    float sacc[NT][4], dpacc[DO_DK ? NT : 1][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] = 0.f;
        if constexpr (DO_DK) dpacc[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ks + a_row * LD + kk * 16 + a_col);
      if constexpr (DO_DK) ldsm_x4(va, vs + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int boff = (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldsm_x4(r, qtile + boff);
        mma_bf16(sacc[2 * np], ka, r[0], r[1]);
        mma_bf16(sacc[2 * np + 1], ka, r[2], r[3]);
        if constexpr (DO_DK) {
          ldsm_x4(r, dotile + boff);
          mma_bf16(dpacc[2 * np], va, r[0], r[1]);
          mma_bf16(dpacc[2 * np + 1], va, r[2], r[3]);
        }
      }
    }

    // P^T = exp(S^T - lse) with masked pairs exactly 0; dS^T = P^T (dP^T - delta)
    const bool masked_tile = sparse ? blk >= 0 || segb != nullptr
                                    : (causal && qt == kt) || q0 + kBlockM > T ||
                                          k0 + kBlockN > S || segb != nullptr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + tq * 2 + (e & 1);
        float p = exp2f(sacc[n][e] * scale_log2 - lse2[c]);
        if (masked_tile) {
          const int query = q0 + c;
          const int key = e < 2 ? key_lo : key_hi;
          bool ok = sparse ? tile_allows(tm, blk, c, key - k0)
                           : key < S && query < T && !(causal && key > query);
          if (ok && segb) ok = segb[query] == (e < 2 ? seg_lo : seg_hi);
          p = ok ? p : 0.f;
        }
        sacc[n][e] = p;
        if constexpr (DO_DK) dpacc[n][e] = p * (dpacc[n][e] - del[c]);
      }
    }

    // dv += P^T dO and dk += dS^T Q; the accumulators of two query tiles
    // are one A operand, each as two bf16 terms
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      if constexpr (DO_DV) {
        split_bf16x2(sacc[2 * kk][0], sacc[2 * kk][1], ph[0], pl[0]);
        split_bf16x2(sacc[2 * kk][2], sacc[2 * kk][3], ph[1], pl[1]);
        split_bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ph[3], pl[3]);
      }
      if constexpr (DO_DK) {
        split_bf16x2(dpacc[2 * kk][0], dpacc[2 * kk][1], sh[0], sl[0]);
        split_bf16x2(dpacc[2 * kk][2], dpacc[2 * kk][3], sh[1], sl[1]);
        split_bf16x2(dpacc[2 * kk + 1][0], dpacc[2 * kk + 1][1], sh[2], sl[2]);
        split_bf16x2(dpacc[2 * kk + 1][2], dpacc[2 * kk + 1][3], sh[3], sl[3]);
      }
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        const int boff = (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                         (lane / 16) * 8;
        uint32_t r[4];
        if constexpr (DO_DV) {
          ldsm_x4_trans(r, dotile + boff);
          mma_bf16(dvacc[2 * dp], ph, r[0], r[1]);
          mma_bf16(dvacc[2 * dp], pl, r[0], r[1]);
          mma_bf16(dvacc[2 * dp + 1], ph, r[2], r[3]);
          mma_bf16(dvacc[2 * dp + 1], pl, r[2], r[3]);
        }
        if constexpr (DO_DK) {
          ldsm_x4_trans(r, qtile + boff);
          mma_bf16(dkacc[2 * dp], sh, r[0], r[1]);
          mma_bf16(dkacc[2 * dp], sl, r[0], r[1]);
          mma_bf16(dkacc[2 * dp + 1], sh, r[2], r[3]);
          mma_bf16(dkacc[2 * dp + 1], sl, r[2], r[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + tq * 2;
    if (key_lo < S) {
      const size_t at = ((size_t(b) * S + key_lo) * KV + kvh) * DH + col;
      if constexpr (DO_DK)
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[d][0] * scale, dkacc[d][1] * scale);
      if constexpr (DO_DV)
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[d][0], dvacc[d][1]);
    }
    if (key_hi < S) {
      const size_t at = ((size_t(b) * S + key_hi) * KV + kvh) * DH + col;
      if constexpr (DO_DK)
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[d][2] * scale, dkacc[d][3] * scale);
      if constexpr (DO_DV)
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[d][2], dvacc[d][3]);
    }
  }
}

template <int DH, bool SPARSE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ seg,
    const TileMap tm, __nv_bfloat16* __restrict__ dq, int B, int T, int S, int H, int KV,
    int causal, float scale, float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int KSTEPS = DH / 16;
  constexpr int NT = kBlockN / 8;
  constexpr int DT = DH / 8;
  constexpr int TILE = kBlockN * LD;
  // Q's A fragments stay in registers up to Dh 128; at 256 the dq
  // accumulators take 128 registers a thread, and the fragments are re-read
  // from the staged Q tile at every k-step instead (as the forward does)
  constexpr bool QREG = DH <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [64][LD]
  __nv_bfloat16* dos = qs + TILE;                                // [64][LD]
  __nv_bfloat16* ks = dos + TILE;                                // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * TILE;                             // [2][64][LD]

  const int nqt = (T + kBlockM - 1) / kBlockM;
  const int BH = B * H;
  const int rank = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int qt = causal ? nqt - 1 - rank : rank;   // longest causal tiles first
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kBlockM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  const int qstride = H * DH, kstride = KV * DH;
  const size_t qoff = (size_t(b) * T + q0) * qstride + size_t(h) * DH;
  const __nv_bfloat16* kb = k + size_t(b) * S * kstride + size_t(kvh) * DH;
  const __nv_bfloat16* vb = v + size_t(b) * S * kstride + size_t(kvh) * DH;
  const int n_s = (S + kBlockN - 1) / kBlockN;
  constexpr bool sparse = SPARSE;
  const int base = sparse ? tm.row_ptr[qt] : 0;
  const int n_kv = sparse ? tm.row_ptr[qt + 1] - base : causal ? min(qt + 1, n_s) : n_s;

  load_tile<DH>(qs, q + qoff, qstride, T - q0, q, tid);
  load_tile<DH>(dos, dout + qoff, qstride, T - q0, dout, tid);
  if (n_kv > 0) {
    const int k00 = (sparse ? tm.row_kt[base] : 0) * kBlockN;
    load_tile<DH>(ks, kb + size_t(k00) * kstride, kstride, S - k00, k, tid);
    load_tile<DH>(vs, vb + size_t(k00) * kstride, kstride, S - k00, v, tid);
  }
  cp_async_commit();

  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const int* segb = seg ? seg + size_t(b) * T : nullptr;
  const int seg_lo = segb ? segb[min(r_lo, T - 1)] : 0;
  const int seg_hi = segb ? segb[min(r_hi, T - 1)] : 0;
  const size_t so = (size_t(b) * H + h) * T;
  const float lse_lo = r_lo < T ? lse[so + r_lo] * kLog2e : 0.f;
  const float lse_hi = r_hi < T ? lse[so + r_hi] * kLog2e : 0.f;
  const float del_lo = r_lo < T ? delta[so + r_lo] : 0.f;
  const float del_hi = r_hi < T ? delta[so + r_hi] : 0.f;

  float dqacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[d][e] = 0.f;
  uint32_t qa[QREG ? KSTEPS : 1][4];
  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;

  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) {
      const int nb = (it + 1) & 1;
      const int k0n = (sparse ? tm.row_kt[base + it + 1] : it + 1) * kBlockN;
      load_tile<DH>(ks + nb * TILE, kb + size_t(k0n) * kstride, kstride, S - k0n, k, tid);
      load_tile<DH>(vs + nb * TILE, vb + size_t(k0n) * kstride, kstride, S - k0n, v, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qa[kk], qs + a_row * LD + kk * 16 + a_col);
      }
    }
    const int j = sparse ? tm.row_kt[base + it] : it;
    const int blk = sparse ? tm.row_blk[base + it] : -1;
    const __nv_bfloat16* kt = ks + (it & 1) * TILE;
    const __nv_bfloat16* vt = vs + (it & 1) * TILE;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float sacc[NT][4], dpacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = dpacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t da[4], qf[4];
      ldsm_x4(da, dos + a_row * LD + kk * 16 + a_col);
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
      } else {
        ldsm_x4(qf, qs + a_row * LD + kk * 16 + a_col);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int boff = (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldsm_x4(r, kt + boff);
        mma_bf16(sacc[2 * np], qf, r[0], r[1]);
        mma_bf16(sacc[2 * np + 1], qf, r[2], r[3]);
        ldsm_x4(r, vt + boff);
        mma_bf16(dpacc[2 * np], da, r[0], r[1]);
        mma_bf16(dpacc[2 * np + 1], da, r[2], r[3]);
      }
    }

    const int k0 = j * kBlockN;
    const bool masked_tile = sparse ? blk >= 0 || segb != nullptr
                                    : (causal && j == qt) || k0 + kBlockN > S ||
                                          q0 + kBlockM > T || segb != nullptr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(sacc[n][e] * scale_log2 - (e < 2 ? lse_lo : lse_hi));
        if (masked_tile) {
          const int key = k0 + n * 8 + tq * 2 + (e & 1);
          const int row = e < 2 ? r_lo : r_hi;
          bool ok = sparse ? tile_allows(tm, blk, row - q0, key - k0)
                           : key < S && row < T && !(causal && key > row);
          if (ok && segb) ok = segb[key] == (e < 2 ? seg_lo : seg_hi);
          p = ok ? p : 0.f;
        }
        dpacc[n][e] = p * (dpacc[n][e] - (e < 2 ? del_lo : del_hi));
      }
    }

    // dq += dS K
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t sh[4], sl[4];
      split_bf16x2(dpacc[2 * kk][0], dpacc[2 * kk][1], sh[0], sl[0]);
      split_bf16x2(dpacc[2 * kk][2], dpacc[2 * kk][3], sh[1], sl[1]);
      split_bf16x2(dpacc[2 * kk + 1][0], dpacc[2 * kk + 1][1], sh[2], sl[2]);
      split_bf16x2(dpacc[2 * kk + 1][2], dpacc[2 * kk + 1][3], sh[3], sl[3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, kt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                             (lane / 16) * 8);
        mma_bf16(dqacc[2 * dp], sh, r[0], r[1]);
        mma_bf16(dqacc[2 * dp], sl, r[0], r[1]);
        mma_bf16(dqacc[2 * dp + 1], sh, r[2], r[3]);
        mma_bf16(dqacc[2 * dp + 1], sl, r[2], r[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + tq * 2;
    if (r_lo < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t(b) * T + r_lo) * H + h) * DH + col) =
          __floats2bfloat162_rn(dqacc[d][0] * scale, dqacc[d][1] * scale);
    if (r_hi < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t(b) * T + r_hi) * H + h) * DH + col) =
          __floats2bfloat162_rn(dqacc[d][2] * scale, dqacc[d][3] * scale);
  }
}

template <int DH, bool SPARSE>
cudaError_t launch_bwd(cudaStream_t s, const void* q, const void* k, const void* v,
                       const void* seg, const TileMap& tm, const void* o, const void* dout,
                       const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int T,
                       int S, int H, int KV, int causal, float scale) {
  using bf = __nv_bfloat16;
  const float scale_log2 = scale * kLog2e;
  const long long rows = (long long)B * T * H;
  const long long nkt = (S + kBlockN - 1) / kBlockN, nqt = (T + kBlockM - 1) / kBlockM;
  const long long dkv_blocks = nkt * B * KV, dq_blocks = nqt * B * H;
  const long long delta_blocks = (rows + kWarps - 1) / kWarps;
  if (dkv_blocks > 0x7fffffffLL || dq_blocks > 0x7fffffffLL || delta_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<DH><<<int(delta_blocks), kThreads, 0, s>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), static_cast<float*>(delta), rows, T,
      H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t tiles = size_t(6) * kBlockN * (DH + 8) * sizeof(bf);
  const size_t dkv_smem = tiles + 4 * kBlockM * sizeof(float);
  auto dkv = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(dkv_smem));
    if (e != cudaSuccess) return e;
    kernel<<<int(dkv_blocks), kThreads, dkv_smem, s>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const int*>(seg), tm,
        static_cast<bf*>(dk), static_cast<bf*>(dv), B, T, S, H, KV, causal, scale, scale_log2);
    return cudaGetLastError();
  };
  if constexpr (DH > 128) {   // dk and dv in two passes (see the header)
    err = dkv(flash_bwd_dkv_kernel<DH, SPARSE, kDvOnly>);
    if (err != cudaSuccess) return err;
    err = dkv(flash_bwd_dkv_kernel<DH, SPARSE, kDkOnly>);
  } else {
    err = dkv(flash_bwd_dkv_kernel<DH, SPARSE, kDkDv>);
  }
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DH, SPARSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(tiles));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DH, SPARSE><<<int(dq_blocks), kThreads, tiles, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), tm, static_cast<bf*>(dq), B,
      T, S, H, KV, causal, scale, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Dense instances: warp-specialised wgmma kernels (their bodies and block
// shapes live in wgmma_flash.cuh, shared with the ALiBi kernels)
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kWgBlockThreads, 1) wg_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap qtail,
    const __grid_constant__ CUtensorMap ktail, const __grid_constant__ CUtensorMap vtail,
    const int* __restrict__ seg, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B,
    int T, int S, int H, int KV, int causal, float scale_log2) {
  wg_fwd<DH, kDense>(qmap, kmap, vmap, qtail, ktail, vtail, seg, o, lse, B, T, S, H, KV, causal,
                     scale_log2, Alibi{});
}

template <int DH>
__global__ void __launch_bounds__(kWgBlockThreads, 1) wg_dq_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ seg,
    __nv_bfloat16* __restrict__ dq, int B, int T, int S, int H, int KV, int causal, float scale,
    float scale_log2) {
  wg_dq<DH, kDense>(qmap, domap, kmap, vmap, lse, delta, seg, dq, B, T, S, H, KV, causal, scale,
                    scale_log2, Alibi{});
}

template <int DH>
__global__ void __launch_bounds__(kWgBlockThreads, 1) wg_dkv_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ seg,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int T, int S, int H,
    int KV, int causal, float scale, float scale_log2) {
  wg_dkv<DH, kDense>(qmap, domap, kmap, vmap, lse, delta, seg, dk, dv, B, T, S, H, KV, causal,
                     scale, scale_log2, Alibi{});
}

template <int DH>
__global__ void __launch_bounds__(kWgBlockThreads, 1) wg_dkv_keys_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ seg,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int T, int S, int H,
    int KV, int causal, float scale, float scale_log2) {
  wg_dkv_keys<DH, kDense>(qmap, domap, kmap, vmap, lse, delta, seg, dk, dv, B, T, S, H, KV,
                          causal, scale, scale_log2, Alibi{});
}

template <int DH>
cudaError_t wg_launch(cudaStream_t s, const void* q, const void* k, const void* v,
                      const void* seg, void* o, void* lse, int B, int T, int S, int H, int KV,
                      int causal, float scale_log2) {
  using Sh = WgFwd<DH>;
  const long long blocks = (long long)((T + Sh::BM - 1) / Sh::BM) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the full blocks' maps, and the tail blocks' (80, 96; else the same maps, unread)
  CUtensorMap qm, km, vm, qt, kt, vt;
  const long long qcols = (long long)H * DH, kcols = (long long)KV * DH;
  cudaError_t err = tile_map_3d(&qm, q, B, T, qcols, Sh::BM);
  if (err == cudaSuccess) err = tile_map_3d(&km, k, B, S, kcols, Sh::BN);
  if (err == cudaSuccess) err = tile_map_3d(&vm, v, B, S, kcols, Sh::BN);
  qt = qm;
  kt = km;
  vt = vm;
  if constexpr (Sh::TAIL > 0) {
    if (err == cudaSuccess) err = tile_map_3d(&qt, q, B, T, qcols, Sh::BM, Sh::TAIL);
    if (err == cudaSuccess) err = tile_map_3d(&kt, k, B, S, kcols, Sh::BN, Sh::TAIL);
    if (err == cudaSuccess) err = tile_map_3d(&vt, v, B, S, kcols, Sh::BN, Sh::TAIL);
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wg_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Sh::SMEM);
  if (err != cudaSuccess) return err;
  wg_fwd_kernel<DH><<<int(blocks), kWgBlockThreads, Sh::SMEM, s>>>(
      qm, km, vm, qt, kt, vt, static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), B, T, S, H, KV, causal, scale_log2);
  return cudaGetLastError();
}

template <int DH>
cudaError_t wg_launch_bwd(cudaStream_t s, const void* q, const void* k, const void* v,
                          const void* seg, const void* o, const void* dout,
                          const void* lse, void* delta, void* dq, void* dk, void* dv, int B,
                          int T, int S, int H, int KV, int causal, float scale) {
  using bf = __nv_bfloat16;
  const float scale_log2 = scale * kLog2e;
  const long long rows = (long long)B * T * H;
  const long long delta_blocks = (rows + kWarps - 1) / kWarps;
  const long long dkv_blocks = (long long)((S + WgDkv<DH>::BN - 1) / WgDkv<DH>::BN) * B * KV;
  const long long dq_blocks = (long long)((T + WgDq<DH>::BM - 1) / WgDq<DH>::BM) * B * H;
  if (dkv_blocks > 0x7fffffffLL || dq_blocks > 0x7fffffffLL || delta_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // the dk/dv pass reads 64-row boxes of everything; the dq pass BM-row boxes of Q and dO
  CUtensorMap q64, do64, k64, v64, qbm, dobm;
  const long long qcols = (long long)H * DH, kcols = (long long)KV * DH;
  cudaError_t err = tile_map_3d(&q64, q, B, T, qcols, 64);
  if (err == cudaSuccess) err = tile_map_3d(&do64, dout, B, T, qcols, 64);
  if (err == cudaSuccess) err = tile_map_3d(&k64, k, B, S, kcols, 64);
  if (err == cudaSuccess) err = tile_map_3d(&v64, v, B, S, kcols, 64);
  if (err == cudaSuccess) err = tile_map_3d(&qbm, q, B, T, qcols, WgDq<DH>::BM);
  if (err == cudaSuccess) err = tile_map_3d(&dobm, dout, B, T, qcols, WgDq<DH>::BM);
  // the dk/dv kernel: the key split at 64, the query and column split above
  auto* dkv_kernel = [] {
    if constexpr (WgDkv<DH>::KEY_SPLIT) return wg_dkv_keys_kernel<DH>;
    else return wg_dkv_kernel<DH>;
  }();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgDkv<DH>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wg_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgDq<DH>::SMEM);
  if (err != cudaSuccess) return err;

  flash_bwd_delta_kernel<DH><<<int(delta_blocks), kThreads, 0, s>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), static_cast<float*>(delta), rows, T,
      H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<int(dkv_blocks), kWgBlockThreads, WgDkv<DH>::SMEM, s>>>(
      q64, do64, k64, v64, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf*>(dk), static_cast<bf*>(dv), B, T, S, H, KV,
      causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wg_dq_kernel<DH><<<int(dq_blocks), kWgBlockThreads, WgDq<DH>::SMEM, s>>>(
      qbm, dobm, k64, v64, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf*>(dq), B, T, S, H, KV, causal, scale,
      scale_log2);
  return cudaGetLastError();
}

// The tile map of an element mask from the host's one int32 buffer (null:
// no mask): row_ptr [nqt + 1], row_kt [nnz], row_blk [nnz], col_ptr
// [nkt + 1], col_qt [nnz], col_blk [nnz], in that order.
TileMap tile_map(const void* tiles, const void* blocks, int nnz, int T, int S) {
  TileMap tm{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (tiles == nullptr) return tm;
  const int nqt = (T + kBlockM - 1) / kBlockM, nkt = (S + kBlockN - 1) / kBlockN;
  tm.row_ptr = static_cast<const int*>(tiles);
  tm.row_kt = tm.row_ptr + nqt + 1;
  tm.row_blk = tm.row_kt + nnz;
  tm.col_ptr = tm.row_blk + nnz;
  tm.col_qt = tm.col_ptr + nkt + 1;
  tm.col_blk = tm.col_qt + nnz;
  tm.blocks = static_cast<const unsigned char*>(blocks);
  return tm;
}

}  // namespace

extern "C" {

const char* sxt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// o = attention(q, k, v) as described above; seg may be null, and so may
// lse ([B, H, T] f32, written when given) and the mask's tile map (tiles:
// the int32 buffer of tile_map, blocks: the partial blocks, nnz entries;
// a mask needs causal = 0). scale is the softmax scale (Dh^-0.5). Returns
// cudaGetLastError() after the launch.
int sxt_flash_attention_bf16(const void* q, const void* k, const void* v, const void* seg,
                             const void* tiles, const void* blocks, int nnz, void* o, void* lse,
                             int B, int T, int S, int H, int KV, int Dh, int causal, float scale,
                             void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV || (causal && T != S) || (tiles != nullptr && causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks_ = (long long)((T + kBlockM - 1) / kBlockM) * B * H;
  if (blocks_ > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  const TileMap tm = tile_map(tiles, blocks, nnz, T, S);
  auto run = [&](auto kernel_launch) {
    return static_cast<int>(kernel_launch(int(blocks_), s, q, k, v, seg, tm, o, lse, B, T, S, H,
                                          KV, scale_log2));
  };
  // the mask's code is compiled into its own mma.sync instances; the dense
  // forms run the wgmma kernel
  auto dense = [&](auto wg_kernel_launch) {
    return static_cast<int>(wg_kernel_launch(s, q, k, v, seg, o, lse, B, T, S, H, KV, causal,
                                             scale_log2));
  };
  if (Dh == 256) return tiles ? run(launch<256>) : dense(wg_launch<256>);   // GPT-J-6B
  if (Dh == 128) return tiles ? run(launch<128>) : dense(wg_launch<128>);
  if (Dh == 64) return tiles ? run(launch<64>) : dense(wg_launch<64>);
  if (Dh == 96) return tiles ? run(launch<96>) : dense(wg_launch<96>);   // Phi-3-mini
  if (Dh == 80) return tiles ? run(launch<80>) : dense(wg_launch<80>);   // Pythia-2.8b
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq, dk, dv = the gradients of attention(q, k, v) given dout, the forward's
// out and its lse; delta is [B, H, T] f32 scratch. seg may be null, and so
// may the mask's tile map (as in the forward).
int sxt_flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* seg,
                                 const void* tiles, const void* blocks, int nnz, const void* o,
                                 const void* dout, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int T, int S, int H, int KV, int Dh,
                                 int causal, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV || (causal && T != S) || (seg != nullptr && T != S) ||
      (tiles != nullptr && causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileMap tm = tile_map(tiles, blocks, nnz, T, S);
  auto run = [&](auto kernel_launch) {
    return static_cast<int>(kernel_launch(s, q, k, v, seg, tm, o, dout, lse, delta, dq, dk, dv, B,
                                          T, S, H, KV, causal, scale));
  };
  auto dense = [&](auto wg_kernels_launch) {
    return static_cast<int>(wg_kernels_launch(s, q, k, v, seg, o, dout, lse, delta, dq, dk, dv, B,
                                              T, S, H, KV, causal, scale));
  };
  if (Dh == 128) return tiles ? run(launch_bwd<128, true>) : dense(wg_launch_bwd<128>);
  if (Dh == 64) return tiles ? run(launch_bwd<64, true>) : dense(wg_launch_bwd<64>);
  if (Dh == 256) return tiles ? run(launch_bwd<256, true>) : dense(wg_launch_bwd<256>);   // GPT-J-6B
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
