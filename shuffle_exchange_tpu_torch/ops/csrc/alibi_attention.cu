// ALiBi flash attention, forward and backward, for Hopper (sm_90a): causal,
// with a per-head slope bias, grouped-query heads read from unexpanded K/V,
// behind a plain C interface loaded with ctypes (ops/_build.py builds this
// file with nvcc at first use).
//
// Replaces the TPU kernels of shuffle_exchange_tpu/ops/alibi_attention.py:
//   B11  _alibi_flash_fwd_impl (kernel _alibi_fwd_kernel): out and lse
//   B12  _flash_bwd_impl, the dq pass (_alibi_dq_kernel)
//   B13  _flash_bwd_impl, the dk/dv pass (_alibi_dkv_kernel), with the
//        slope cotangent
//
// Layouts (contiguous, bf16; the JAX package's [batch, seq, heads, Dh]):
//   q, o, dout  [B, T, H, Dh];  k, v  [B, S, KV, Dh];  slopes  [H] f32
//   lse, delta  [B, H, T] f32;  dslope partials  [B, H, ceil(S / 64)] f32
// Query head h reads kv head h / (H / KV) (the _repeat_kv convention).
//
// What it computes (reference_alibi_attention_lse, the plain version):
// scores q.k * Dh^-0.5 in f32 plus slope_h * j on the ABSOLUTE key position
// j, formed and added in f32 (at S = 2048 BLOOM's first slope makes the bias
// ~1447, where bf16 resolves 8); the causal diagonal aligned bottom-right:
// query i sees keys j <= i + S - T (S >= T); masked scores -1e30; softmax in
// f32, online across key tiles; out rounded to bf16 once; lse the natural
// log-sum-exp of each row's biased scores, as the TPU kernel writes it.
//
// What bounds it on the H100: 4 * pairs * H * Dh flops (forward) and
// 10 * pairs * H * Dh (backward) against a few bytes per element of q, k,
// v: at BLOOM's training shape (T = S = 2047, Dh 128) ~1,000 flops a byte,
// far above the ~295 flop/byte ridge, so the tensor cores bound it. Design:
// the FlashAttention-2 shape of ops/csrc/flash_attention.cu, with its tile
// code from flash_tile.cuh and mma_sync.cuh (B14/B15's kernels stay as they
// were, so their bits do too): one block per 64-row
// query tile (forward, dq) or 64-key tile (dk/dv), 4 warps of 16 rows, K/V
// (or Q/dO) tiles double-buffered with cp.async, m16n8k16 bf16 mma.sync with
// f32 accumulators, operands by ldmatrix from rows padded by 16 bytes. Key
// tiles wholly above the shifted diagonal are never loaded; ragged T and S
// are masked inside the kernels (training runs T = 2047). P and dS enter
// their products as two bf16 terms (hi + lo), as in the B14/B15 kernels, so
// results sit within one bf16 step of a plain version that keeps P in f32.
//
// Backward: delta = rowsum(dout * out) (one warp a row), then the dk/dv
// pass: one block per (key tile, kv head, sequence) looping over the query
// heads of its group, each with ITS OWN slope, and their query tiles at and
// below the diagonal; it also writes dslope partials per (b, h, key tile),
// sum_ij dS_ij * j, which the wrapper sums in a fixed order. Then the dq
// pass: one block per (query tile, head, sequence). No atomics anywhere, so
// two runs give equal bits. wgmma and TMA forms are later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"   // block shape, load_tile, stage_queries, delta_row

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// B11: forward
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kThreads) alibi_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ slopes, bf16* __restrict__ o, float* __restrict__ lse, int B,
    int T, int S, int H, int KV, float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int KSTEPS = DH / 16;
  constexpr int NT = kBlockN / 8;
  constexpr int DT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [64][LD]
  bf16* ks = qs + kBlockM * LD;               // [2][64][LD]
  bf16* vs = ks + 2 * kBlockN * LD;           // [2][64][LD]

  // longest query tiles (the most keys under the causal mask) first
  const int nqt = (T + kBlockM - 1) / kBlockM;
  const int BH = B * H;
  const int rank = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int qt = nqt - 1 - rank;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kBlockM, off = S - T;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const float slope2 = slopes[h] * kLog2e;   // the bias in the log2 domain, f32

  const int qstride = H * DH, kstride = KV * DH;
  const bf16* qb = q + (size_t(b) * T + q0) * qstride + size_t(h) * DH;
  const bf16* kb = k + size_t(b) * S * kstride + size_t(kvh) * DH;
  const bf16* vb = v + size_t(b) * S * kstride + size_t(kvh) * DH;
  const int n_s = (S + kBlockN - 1) / kBlockN;
  const int last_row = min(q0 + kBlockM, T) - 1;
  const int n_kv = min((last_row + off) / kBlockN + 1, n_s);

  load_tile<DH>(qs, qb, qstride, T - q0, q, tid);
  load_tile<DH>(ks, kb, kstride, S, k, tid);
  load_tile<DH>(vs, vb, kstride, S, v, tid);
  cp_async_commit();

  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;

  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
  uint32_t qa[KSTEPS][4];

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {   // prefetch the next tile into the other buffer
      const int nb = (j + 1) & 1, k0n = (j + 1) * kBlockN;
      load_tile<DH>(ks + nb * kBlockN * LD, kb + size_t(k0n) * kstride, kstride, S - k0n, k, tid);
      load_tile<DH>(vs + nb * kBlockN * LD, vb + size_t(k0n) * kstride, kstride, S - k0n, v, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(qa[kk], qs + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16 +
                            (lane / 16) * 8);
    }
    const bf16* kt = ks + (j & 1) * kBlockN * LD;
    const bf16* vt = vs + (j & 1) * kBlockN * LD;

    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, kt + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                       ((lane / 8) % 2) * 8);
        mma_bf16(sacc[2 * np], qa[kk], r[0], r[1]);
        mma_bf16(sacc[2 * np + 1], qa[kk], r[2], r[3]);
      }
    }

    // scale and bias into the log2 domain (f32), mask, row max
    const int k0 = j * kBlockN;
    const bool masked_tile = k0 + kBlockN - 1 > q0 + off || k0 + kBlockN > S;
    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + tq * 2 + (e & 1);
        float s = fmaf(sacc[n][e], scale_log2, slope2 * float(key));
        if (masked_tile) {
          const int row = e < 2 ? r_lo : r_hi;
          s = (key < S && key <= row + off) ? s : kNeg;
        }
        sacc[n][e] = s;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, s);
        else
          mx_hi = fmaxf(mx_hi, s);
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sacc[n][e] - (e < 2 ? mn_lo : mn_hi));
        sacc[n][e] = p;
        if (e < 2)
          sum_lo += p;
        else
          sum_hi += p;
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, sh);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, sh);
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

// ---------------------------------------------------------------------------
// Backward: delta
// ---------------------------------------------------------------------------

// delta[b, h, t] = rowsum(dout * out): one warp a row (flash_tile.cuh).
template <int DH>
__global__ void __launch_bounds__(kThreads) alibi_bwd_delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
    long long rows, int T, int H) {
  delta_row<DH>(o, dout, delta, rows, T, H);
}

// ---------------------------------------------------------------------------
// B13: dk, dv (and the dslope partials)
// ---------------------------------------------------------------------------

template <int DH, bool DSLOPE>
__global__ void __launch_bounds__(kThreads) alibi_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ slopes, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ dslope_part, int B, int T, int S, int H, int KV,
    float scale, float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int KSTEPS = DH / 16;
  constexpr int NT = kBlockM / 8;     // 8-query column tiles of S^T
  constexpr int DT = DH / 8;
  constexpr int TILE = kBlockN * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);          // [64][LD]
  bf16* vs = ks + TILE;                               // [64][LD]
  bf16* qs = vs + TILE;                               // [2][64][LD]
  bf16* dos = qs + 2 * TILE;                          // [2][64][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * TILE);   // [2][64], log2 domain
  float* dels = lses + 2 * kBlockM;                         // [2][64]
  float* red = dels + 2 * kBlockM;                          // [kWarps]

  // key tile 0 has the most query tiles under the causal mask: issued first
  const int BKV = B * KV;
  const int kt = blockIdx.x / BKV, bkv = blockIdx.x % BKV;
  const int b = bkv / KV, kvh = bkv % KV, n_rep = H / KV;
  const int k0 = kt * kBlockN, off = S - T;
  const int nkt = (S + kBlockN - 1) / kBlockN;
  const int nqt = (T + kBlockM - 1) / kBlockM;
  const int qt_lo = k0 > off ? (k0 - off) / kBlockM : 0;   // first tile with a query j sees
  const int n_q = nqt - qt_lo;        // >= 1 because S >= T
  const int n_it = n_rep * n_q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  const int kstride = KV * DH;
  const size_t koff = (size_t(b) * S + k0) * kstride + size_t(kvh) * DH;
  load_tile<DH>(ks, k + koff, kstride, S - k0, k, tid);
  load_tile<DH>(vs, v + koff, kstride, S - k0, v, tid);
  stage_queries<DH>(qs, dos, lses, dels, q, dout, lse, delta, b, kvh * n_rep, qt_lo * kBlockM, T,
                    H, tid);
  cp_async_commit();

  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;

  float dkacc[DT][4], dvacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[d][e] = dvacc[d][e] = 0.f;
  float dsum_lo = 0.f, dsum_hi = 0.f;   // sum of dS over this head's queries, per key row

  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {   // prefetch the next (head, query tile) into the other buffer
      const int nx = it + 1, nb = nx & 1;
      stage_queries<DH>(qs + nb * TILE, dos + nb * TILE, lses + nb * kBlockM, dels + nb * kBlockM,
                        q, dout, lse, delta, b, kvh * n_rep + nx / n_q,
                        (qt_lo + nx % n_q) * kBlockM, T, H, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int h = kvh * n_rep + it / n_q;
    const int qt = qt_lo + it % n_q, q0 = qt * kBlockM;
    // each query head of the group brings its own slope
    const float slope2 = slopes[h] * kLog2e;
    const float bias_lo = slope2 * float(key_lo), bias_hi = slope2 * float(key_hi);
    const bf16* qtile = qs + buf * TILE;
    const bf16* dotile = dos + buf * TILE;
    const float* lse2 = lses + buf * kBlockM;
    const float* del = dels + buf * kBlockM;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
    float sacc[NT][4], dpacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = dpacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ks + a_row * LD + kk * 16 + a_col);
      ldsm_x4(va, vs + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int boff = (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldsm_x4(r, qtile + boff);
        mma_bf16(sacc[2 * np], ka, r[0], r[1]);
        mma_bf16(sacc[2 * np + 1], ka, r[2], r[3]);
        ldsm_x4(r, dotile + boff);
        mma_bf16(dpacc[2 * np], va, r[0], r[1]);
        mma_bf16(dpacc[2 * np + 1], va, r[2], r[3]);
      }
    }

    // P^T = exp(S^T + bias - lse) with masked pairs exactly 0; dS^T = P^T (dP^T - delta)
    const bool masked_tile = k0 + kBlockN - 1 > q0 + off || q0 + kBlockM > T || k0 + kBlockN > S;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + tq * 2 + (e & 1);
        float p = exp2f(fmaf(sacc[n][e], scale_log2, e < 2 ? bias_lo : bias_hi) - lse2[c]);
        if (masked_tile) {
          const int query = q0 + c;
          const int key = e < 2 ? key_lo : key_hi;
          p = (key < S && query < T && key <= query + off) ? p : 0.f;
        }
        sacc[n][e] = p;
        const float ds = p * (dpacc[n][e] - del[c]);
        dpacc[n][e] = ds;
        if (DSLOPE) {
          if (e < 2)
            dsum_lo += ds;
          else
            dsum_hi += ds;
        }
      }
    }

    // dv += P^T dO and dk += dS^T Q, each A operand as two bf16 terms
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split_bf16x2(sacc[2 * kk][0], sacc[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(sacc[2 * kk][2], sacc[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ph[3], pl[3]);
      split_bf16x2(dpacc[2 * kk][0], dpacc[2 * kk][1], sh[0], sl[0]);
      split_bf16x2(dpacc[2 * kk][2], dpacc[2 * kk][3], sh[1], sl[1]);
      split_bf16x2(dpacc[2 * kk + 1][0], dpacc[2 * kk + 1][1], sh[2], sl[2]);
      split_bf16x2(dpacc[2 * kk + 1][2], dpacc[2 * kk + 1][3], sh[3], sl[3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        const int boff = (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                         (lane / 16) * 8;
        uint32_t r[4];
        ldsm_x4_trans(r, dotile + boff);
        mma_bf16(dvacc[2 * dp], ph, r[0], r[1]);
        mma_bf16(dvacc[2 * dp], pl, r[0], r[1]);
        mma_bf16(dvacc[2 * dp + 1], ph, r[2], r[3]);
        mma_bf16(dvacc[2 * dp + 1], pl, r[2], r[3]);
        ldsm_x4_trans(r, qtile + boff);
        mma_bf16(dkacc[2 * dp], sh, r[0], r[1]);
        mma_bf16(dkacc[2 * dp], sl, r[0], r[1]);
        mma_bf16(dkacc[2 * dp + 1], sh, r[2], r[3]);
        mma_bf16(dkacc[2 * dp + 1], sl, r[2], r[3]);
      }
    }

    if (DSLOPE && it % n_q == n_q - 1) {
      // the head's last query tile: sum_ij dS_ij * j over this key tile, in
      // a fixed order (lanes by butterfly, then warps 0..3)
      float part = dsum_lo * float(key_lo) + dsum_hi * float(key_hi);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) part += __shfl_xor_sync(0xffffffffu, part, sh);
      if (lane == 0) red[warp] = part;
      __syncthreads();
      if (tid == 0)
        dslope_part[(size_t(b) * H + h) * nkt + kt] = ((red[0] + red[1]) + red[2]) + red[3];
      dsum_lo = dsum_hi = 0.f;
    }
    __syncthreads();   // every warp is done with this buffer (and red) before reuse
  }

#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + tq * 2;
    if (key_lo < S) {
      const size_t at = ((size_t(b) * S + key_lo) * KV + kvh) * DH + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dkacc[d][0] * scale, dkacc[d][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(dvacc[d][0], dvacc[d][1]);
    }
    if (key_hi < S) {
      const size_t at = ((size_t(b) * S + key_hi) * KV + kvh) * DH + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dkacc[d][2] * scale, dkacc[d][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(dvacc[d][2], dvacc[d][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// B12: dq
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kThreads) alibi_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ slopes, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    int B, int T, int S, int H, int KV, float scale, float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int KSTEPS = DH / 16;
  constexpr int NT = kBlockN / 8;
  constexpr int DT = DH / 8;
  constexpr int TILE = kBlockN * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [64][LD]
  bf16* dos = qs + TILE;                       // [64][LD]
  bf16* ks = dos + TILE;                       // [2][64][LD]
  bf16* vs = ks + 2 * TILE;                    // [2][64][LD]

  const int nqt = (T + kBlockM - 1) / kBlockM;
  const int BH = B * H;
  const int rank = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int qt = nqt - 1 - rank;   // longest tiles first
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kBlockM, off = S - T;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const float slope2 = slopes[h] * kLog2e;

  const int qstride = H * DH, kstride = KV * DH;
  const size_t qoff = (size_t(b) * T + q0) * qstride + size_t(h) * DH;
  const bf16* kb = k + size_t(b) * S * kstride + size_t(kvh) * DH;
  const bf16* vb = v + size_t(b) * S * kstride + size_t(kvh) * DH;
  const int n_s = (S + kBlockN - 1) / kBlockN;
  const int last_row = min(q0 + kBlockM, T) - 1;
  const int n_kv = min((last_row + off) / kBlockN + 1, n_s);

  load_tile<DH>(qs, q + qoff, qstride, T - q0, q, tid);
  load_tile<DH>(dos, dout + qoff, qstride, T - q0, dout, tid);
  load_tile<DH>(ks, kb, kstride, S, k, tid);
  load_tile<DH>(vs, vb, kstride, S, v, tid);
  cp_async_commit();

  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
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
  uint32_t qa[KSTEPS][4];
  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      const int nb = (j + 1) & 1, k0n = (j + 1) * kBlockN;
      load_tile<DH>(ks + nb * TILE, kb + size_t(k0n) * kstride, kstride, S - k0n, k, tid);
      load_tile<DH>(vs + nb * TILE, vb + size_t(k0n) * kstride, kstride, S - k0n, v, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qa[kk], qs + a_row * LD + kk * 16 + a_col);
    }
    const bf16* kt = ks + (j & 1) * TILE;
    const bf16* vt = vs + (j & 1) * TILE;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float sacc[NT][4], dpacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = dpacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t da[4];
      ldsm_x4(da, dos + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int boff = (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldsm_x4(r, kt + boff);
        mma_bf16(sacc[2 * np], qa[kk], r[0], r[1]);
        mma_bf16(sacc[2 * np + 1], qa[kk], r[2], r[3]);
        ldsm_x4(r, vt + boff);
        mma_bf16(dpacc[2 * np], da, r[0], r[1]);
        mma_bf16(dpacc[2 * np + 1], da, r[2], r[3]);
      }
    }

    const int k0 = j * kBlockN;
    const bool masked_tile = k0 + kBlockN - 1 > q0 + off || k0 + kBlockN > S || q0 + kBlockM > T;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + tq * 2 + (e & 1);
        float p = exp2f(fmaf(sacc[n][e], scale_log2, slope2 * float(key)) -
                        (e < 2 ? lse_lo : lse_hi));
        if (masked_tile) {
          const int row = e < 2 ? r_lo : r_hi;
          p = (key < S && row < T && key <= row + off) ? p : 0.f;
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

// ---------------------------------------------------------------------------
// Host launchers
// ---------------------------------------------------------------------------

bool bad_shape(int B, int T, int S, int H, int KV) {
  return S < T || KV <= 0 || H % KV != 0;
}

template <int DH>
cudaError_t launch_fwd(cudaStream_t s, const void* q, const void* k, const void* v,
                       const void* slopes, void* o, void* lse, int B, int T, int S, int H, int KV,
                       float scale) {
  const long long blocks = (long long)((T + kBlockM - 1) / kBlockM) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = size_t(kBlockM + 4 * kBlockN) * (DH + 8) * sizeof(bf16);
  const cudaError_t err = cudaFuncSetAttribute(
      alibi_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  alibi_fwd_kernel<DH><<<int(blocks), kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(slopes), static_cast<bf16*>(o), static_cast<float*>(lse), B, T,
      S, H, KV, scale * kLog2e);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_delta(cudaStream_t s, const void* o, const void* dout, void* delta, int B,
                         int T, int H) {
  const long long rows = (long long)B * T * H;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  alibi_bwd_delta_kernel<DH><<<int(blocks), kThreads, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      rows, T, H);
  return cudaGetLastError();
}

template <int DH, bool DSLOPE>
cudaError_t launch_dkv(cudaStream_t s, const void* q, const void* k, const void* v,
                       const void* slopes, const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, void* dslope_part, int B, int T, int S, int H, int KV,
                       float scale) {
  const long long blocks = (long long)((S + kBlockN - 1) / kBlockN) * B * KV;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = size_t(6) * kBlockN * (DH + 8) * sizeof(bf16) +
                      (4 * kBlockM + kWarps) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      alibi_bwd_dkv_kernel<DH, DSLOPE>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  alibi_bwd_dkv_kernel<DH, DSLOPE><<<int(blocks), kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(slopes), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dslope_part), B, T, S, H, KV, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(cudaStream_t s, const void* q, const void* k, const void* v,
                      const void* slopes, const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int T, int S, int H, int KV, float scale) {
  const long long blocks = (long long)((T + kBlockM - 1) / kBlockM) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = size_t(6) * kBlockN * (DH + 8) * sizeof(bf16);
  const cudaError_t err = cudaFuncSetAttribute(
      alibi_bwd_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  alibi_bwd_dq_kernel<DH><<<int(blocks), kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(slopes), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq),
      B, T, S, H, KV, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sxt_alibi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B11: o (and lse [B, H, T] f32 when given) = ALiBi attention of q, k, v
// with per-head slopes [H] f32; causal, bottom-right diagonal (S >= T).
// scale is the softmax scale (Dh^-0.5). Returns cudaGetLastError().
int sxt_alibi_fwd_bf16(const void* q, const void* k, const void* v, const void* slopes, void* o,
                       void* lse, int B, int T, int S, int H, int KV, int Dh, float scale,
                       void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (bad_shape(B, T, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128)
    return static_cast<int>(launch_fwd<128>(s, q, k, v, slopes, o, lse, B, T, S, H, KV, scale));
  if (Dh == 64)
    return static_cast<int>(launch_fwd<64>(s, q, k, v, slopes, o, lse, B, T, S, H, KV, scale));
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta [B, H, T] f32 = rowsum(dout * o), the backward's first pass.
int sxt_alibi_bwd_delta_bf16(const void* o, const void* dout, void* delta, int B, int T, int H,
                             int Dh, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return static_cast<int>(launch_delta<128>(s, o, dout, delta, B, T, H));
  if (Dh == 64) return static_cast<int>(launch_delta<64>(s, o, dout, delta, B, T, H));
  return static_cast<int>(cudaErrorInvalidValue);
}

// B13: dk, dv [B, S, KV, Dh]; dslope_part [B, H, ceil(S / 64)] f32 of
// sum_ij dS_ij * j when not null.
int sxt_alibi_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* slopes,
                           const void* dout, const void* lse, const void* delta, void* dk,
                           void* dv, void* dslope_part, int B, int T, int S, int H, int KV,
                           int Dh, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (bad_shape(B, T, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ds = dslope_part != nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  if (Dh == 128)
    err = ds ? launch_dkv<128, true>(s, q, k, v, slopes, dout, lse, delta, dk, dv, dslope_part, B,
                                     T, S, H, KV, scale)
             : launch_dkv<128, false>(s, q, k, v, slopes, dout, lse, delta, dk, dv, nullptr, B,
                                      T, S, H, KV, scale);
  else if (Dh == 64)
    err = ds ? launch_dkv<64, true>(s, q, k, v, slopes, dout, lse, delta, dk, dv, dslope_part, B,
                                    T, S, H, KV, scale)
             : launch_dkv<64, false>(s, q, k, v, slopes, dout, lse, delta, dk, dv, nullptr, B, T,
                                     S, H, KV, scale);
  return static_cast<int>(err);
}

// B12: dq [B, T, H, Dh].
int sxt_alibi_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* slopes,
                          const void* dout, const void* lse, const void* delta, void* dq, int B,
                          int T, int S, int H, int KV, int Dh, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (bad_shape(B, T, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128)
    return static_cast<int>(
        launch_dq<128>(s, q, k, v, slopes, dout, lse, delta, dq, B, T, S, H, KV, scale));
  if (Dh == 64)
    return static_cast<int>(
        launch_dq<64>(s, q, k, v, slopes, dout, lse, delta, dq, B, T, S, H, KV, scale));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
