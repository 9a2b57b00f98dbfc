// The tensor-core paged decode shared by the paged decode kernel (B2,
// paged_attention.cu) and the split-K decode kernel of the fused decode
// layer (B5, fused_decode.cu), and the tile code the paged extend kernel
// (B3, paged_attention.cu) shares with them: the staging of 64-position K/V
// tiles of a block-paged pool by cp.async (bf16, or one-byte rows widened
// to bf16 in shared memory), the warp-level online softmax over m16n8k16
// MMAs in the log2 domain, and the decode of one split of one (sequence,
// kv head) over the whole query-head group. paged_attention.cu's header
// says what bounds these kernels and how the design answers it.
//
// decode_split<DH, KIND, KSPLIT, FOLD>: one block (sequence b, kv head,
// split s) of 128 threads; the split is logical positions [s * split_len,
// min(len, (s + 1) * split_len)). It writes the output itself when the
// sequence has one split, else its f32 (acc, m, l) partials. With FOLD the
// last of a (sequence, kv head)'s live splits to finish merges them, in
// split order, and writes the output: it finds that it is last through
// the (sequence, kv head)'s counter (__threadfence, then atomicAdd), which
// it resets to 0 for the next call. Live splits are those that start
// before the sequence's end, and split 0 (which writes zeros for an empty
// sequence); the others return at once. Without FOLD a merge kernel
// (merge_partials) combines the partials. The merge's formula is the TPU
// kernel's, in base 2: m_g = max m, w = 2^(m - m_g), out = sum(w * acc) /
// max(sum(w * l), 1e-30), each sum in split order, so two runs give equal
// bits. The counter is the only atomic; no sum uses one.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sync.cuh"     // cp_async16, ldsm_x4(_trans), mma_bf16, split_bf16x2
#include "paged_tile.cuh"   // TK, kNeg, storage kinds, kv_row_bytes, e4m3x2_to_float2

namespace {
namespace pdec {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// 4-byte async copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// 2^x (MUFU.EX2; flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The shared-memory layout of the staged K/V tiles of (DH, KIND).
template <int DH, int KIND>
struct Tiles {
  static constexpr bool kScaled = KvStore<KIND>::kScaled;
  static constexpr int kLd = DH + 8;                           // bf16 row pitch, elements
  static constexpr int kRowBytes = DH * KvStore<KIND>::kBytes; // a stored row
  static constexpr int kPitch = kv_row_bytes<DH, KIND>();      // a staged row, bytes
  // a stage: K rows, V rows, then (one-byte pools) K and V row scales
  static constexpr int kStage = 2 * TK * kPitch + (kScaled ? 2 * TK * 4 : 0);
  // two stages, then (one-byte pools) the widened bf16 K and V tiles
  static constexpr int kBytes = 2 * kStage + (kScaled ? 2 * TK * kLd * 2 : 0);
};

// Issue the cp.async copies of positions [p0, p0 + n) of one (sequence,
// kv head) into a stage: raw K and V rows and a one-byte pool's row
// scales. Rows t >= n are zero-filled (scales too). Table entries below 0
// are read as block 0. Each of the block's NW warps stages RW = 64 / NW
// rows: lane l < RW looks up its row's pool row once (one table read, one
// division) and hands it to the lanes that copy the row's 16-byte
// vectors. All threads call it; the caller commits.
template <int DH, int KIND, int NW = kWarps>
__device__ __forceinline__ void stage_kv(unsigned char* stage, const unsigned char* kpool,
                                         const unsigned char* vpool, const float* kscale,
                                         const float* vscale, const int* __restrict__ trow,
                                         int kv, int KV, int bs, int p0, int n, int warp,
                                         int lane) {
  using T = Tiles<DH, KIND>;
  constexpr int RW = TK / NW;               // rows a warp stages
  constexpr int VPR = T::kRowBytes / 16;   // 16-byte vectors a row
  constexpr int ITERS = (RW * VPR + 31) / 32;
  unsigned char* ks = stage;
  unsigned char* vs = stage + TK * T::kPitch;
  const int tl = warp * RW + lane % RW;
  int prow = 0;   // the pool row (block, kv head, offset) of tile row tl
  if (tl < n) {
    const int pos = p0 + tl;
    prow = (max(trow[pos / bs], 0) * KV + kv) * bs + pos % bs;
  }
#pragma unroll
  for (int k = 0; k < ITERS; ++k) {
    const int j = lane + 32 * k;
    const int r = min(j / VPR, RW - 1), c = (j % VPR) * 16;
    const int pr = __shfl_sync(0xffffffffu, prow, r);
    const int t = warp * RW + r;
    if (j < RW * VPR) {
      const bool ok = t < n;
      const size_t off = size_t(pr) * T::kRowBytes + c;
      cp_async16(ks + t * T::kPitch + c, kpool + off, ok);
      cp_async16(vs + t * T::kPitch + c, vpool + off, ok);
    }
  }
  if constexpr (T::kScaled) {
    float* kss = reinterpret_cast<float*>(vs + TK * T::kPitch);
    if (lane < RW) {
      cp_async4(kss + tl, kscale + prow, tl < n);
      cp_async4(kss + TK + tl, vscale + prow, tl < n);
    }
  }
}

// Eight stored one-byte values -> eight bf16 (exact for int8 and e4m3).
template <int KIND>
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  const uint32_t w[2] = {raw.x, raw.y};
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t pair = (w[k / 2] >> (16 * (k % 2))) & 0xffffu;
    __nv_bfloat162 h;
    if constexpr (KIND == KvInt8) {
      h = __floats2bfloat162_rn(float(static_cast<int8_t>(pair & 0xffu)),
                                float(static_cast<int8_t>(pair >> 8)));
    } else {
      h = __float22bfloat162_rn(e4m3x2_to_float2(static_cast<uint16_t>(pair)));
    }
    o[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Widen a one-byte stage's K and V rows into the bf16 tiles kw / vw.
template <int DH, int KIND, int NT = kThreads>
__device__ __forceinline__ void widen_kv(const unsigned char* stage, __nv_bfloat16* kw,
                                         __nv_bfloat16* vw, int tid) {
  using T = Tiles<DH, KIND>;
  constexpr int V8 = DH / 8;
  for (int i = tid; i < 2 * TK * V8; i += NT) {
    const int which = i / (TK * V8), j = i % (TK * V8);
    const int t = j / V8, c = (j % V8) * 8;
    const uint2 raw =
        *reinterpret_cast<const uint2*>(stage + (which * TK + t) * T::kPitch + c);
    *reinterpret_cast<uint4*>((which ? vw : kw) + t * T::kLd + c) = widen8<KIND>(raw);
  }
}

// The online-softmax state of a warp's 16 query rows: rows g (lo) and
// g + 8 (hi) of the mma fragment (g = lane / 4), and their O accumulators.
template <int DH>
struct Rows {
  float m[2], l[2];
  float o[DH / 8][4];
  __device__ __forceinline__ void init() {
    m[0] = m[1] = kNeg;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  }
};

// One warp: its 16 query rows (qw, pitch DH + 8; or the caller's A
// fragments qa, QREG) against keys [k0, k0 + NK) of a staged bf16 tile
// whose key 0 is logical position p0. Key j is visible to row lo / hi when
// p0 + j < lim[0 / 1]; `masked` is false when every key of the slice is
// visible to both rows. kss / vss are a one-byte pool's row scales
// (SCALED), sl the rows' ALiBi slopes (alibi); scores are kept in the log2
// domain: scale_log2 = Dh^-0.5 log2(e), slopes times log2(e), m in log2
// units.
template <int DH, bool SCALED, int NK, bool QREG = false>
__device__ __forceinline__ void attend(Rows<DH>& r, const __nv_bfloat16* qw,
                                       const uint32_t (*qa)[4], const __nv_bfloat16* kt,
                                       const __nv_bfloat16* vt, const float* kss,
                                       const float* vss, int k0, int p0, const int (&lim)[2],
                                       const float (&sl)[2], bool alibi, bool masked,
                                       float scale_log2, int lane) {
  constexpr int LD = DH + 8, KSTEPS = DH / 16, NT = NK / 8;
  const int tq = lane % 4;
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  const __nv_bfloat16* qfrag = qw + ((lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
  const __nv_bfloat16* kfrag = kt + (k0 + (lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
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
      uint32_t b[4];
      ldsm_x4(b, kfrag + np * 16 * LD + kk * 16);
      mma_bf16(s[2 * np], qf, b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf, b[2], b[3]);
    }
  }

  // scores in the log2 domain: scale (and the K row scale), bias, mask;
  // row max (e < 2: lo, else hi)
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = k0 + n * 8 + tq * 2 + (e & 1), h = e >> 1;
      float x = s[n][e] * scale_log2;
      if constexpr (SCALED) x *= kss[j];
      if (alibi) x = fmaf(sl[h], float(p0 + j), x);
      if (masked && p0 + j >= lim[h]) x = kNeg;
      s[n][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  // p = 2^(x - m); a row with no visible key so far keeps m = kNeg and
  // alpha = 2^0 = 1 over its zero sums
  float mn[2], al[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mn[h] = fmaxf(r.m[h], mx[h]);
    al[h] = ex2(r.m[h] - mn[h]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = k0 + n * 8 + tq * 2 + (e & 1), h = e >> 1;
      float p = masked && p0 + j >= lim[h] ? 0.f : ex2(s[n][e] - mn[h]);
      sum[h] += p;
      if constexpr (SCALED) p *= vss[j];
      s[n][e] = p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    r.l[h] = r.l[h] * al[h] + sum[h];
    r.m[h] = mn[h];
  }
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    r.o[d][0] *= al[0];
    r.o[d][1] *= al[0];
    r.o[d][2] *= al[1];
    r.o[d][3] *= al[1];
  }

  // O += P V: the S accumulators of two 8-key tiles are one A operand
  const __nv_bfloat16* vfrag = vt + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t ph[4], pl[4];
    split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, vfrag + kk * 16 * LD + dp * 16);
      mma_bf16(r.o[2 * dp], ph, b[0], b[1]);
      mma_bf16(r.o[2 * dp], pl, b[0], b[1]);
      mma_bf16(r.o[2 * dp + 1], ph, b[2], b[3]);
      mma_bf16(r.o[2 * dp + 1], pl, b[2], b[3]);
    }
  }
}

// The bf16 K / V tiles and the row scales of stage `stage` (widening a
// one-byte stage into kw / vw first: the caller syncs after).
struct TileView {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* ks;
  const float* vs;
};

template <int DH, int KIND, int NT = kThreads>
__device__ __forceinline__ TileView view_tile(const unsigned char* stage, __nv_bfloat16* kw,
                                              __nv_bfloat16* vw, int tid) {
  using T = Tiles<DH, KIND>;
  if constexpr (T::kScaled) {
    widen_kv<DH, KIND, NT>(stage, kw, vw, tid);
    const float* ks = reinterpret_cast<const float*>(stage + 2 * TK * T::kPitch);
    return {kw, vw, ks, ks + TK};
  } else {
    return {reinterpret_cast<const __nv_bfloat16*>(stage),
            reinterpret_cast<const __nv_bfloat16*>(stage + TK * T::kPitch), nullptr, nullptr};
  }
}

// ---------------------------------------------------------------------------
// Decode: one query token per sequence. KSPLIT (G <= 16): the warps take
// the four 16-key slices of each tile; else warp w takes row tiles w, w +
// 4, ... of the pass.
// ---------------------------------------------------------------------------

template <int DH, bool KSPLIT>
struct DecodeShape {
  static constexpr int kRowTiles = KSPLIT ? 1 : (DH <= 96 ? 2 : 1);   // row tiles a warp holds
  static constexpr int kPassRows = KSPLIT ? 16 : 16 * kWarps * kRowTiles;
  static constexpr int kMergeLd = DH + 4;   // the KSPLIT merge's f32 row pitch
  static constexpr int kMergeBytes = KSPLIT ? (2 * kWarps * 16 + kWarps * 16 * kMergeLd) * 4 : 0;
};

// Dynamic shared memory of a decode block: Q's pass rows, then the ring
// (reused by the KSPLIT merge and by FOLD's merge).
template <int DH, int KIND, bool KSPLIT>
struct DecodeSmem {
  using T = Tiles<DH, KIND>;
  using D = DecodeShape<DH, KSPLIT>;
  static constexpr int kQ = D::kPassRows * T::kLd * 2;
  static constexpr int kRing = T::kBytes > D::kMergeBytes ? T::kBytes : D::kMergeBytes;
  static constexpr int kBytes = kQ + kRing;
};

template <int DH, int KIND, bool KSPLIT, bool FOLD>
__device__ __forceinline__ void decode_split(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpool_,
    const void* __restrict__ vpool_, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ kv_len, const float* __restrict__ slopes,
    __nv_bfloat16* __restrict__ out, float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int* __restrict__ counters, int H, int KV, int bs, int W,
    int split_len, float scale) {
  using T = Tiles<DH, KIND>;
  using D = DecodeShape<DH, KSPLIT>;
  constexpr int LD = T::kLd, RT = D::kRowTiles, PR = D::kPassRows;
  const int b = blockIdx.x, kv = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int G = H / KV;
  const int len = min(kv_len[b], W * bs);
  const int p_lo = s * split_len, p_hi = min(len, p_lo + split_len);
  // FOLD given the counters: the last live split merges. Live splits are
  // those that start before the end, and (when folding) split 0
  const bool fold = FOLD && counters != nullptr;
  const int live = fold ? max(1, min(S, (len + split_len - 1) / split_len)) : S;
  if (S > 1 && p_lo >= p_hi && !(fold && s == 0)) return;   // the merge reads no such split
  const bool direct = S == 1 || (fold && live == 1);         // write the output here
  const int ntile = p_hi > p_lo ? (p_hi - p_lo + TK - 1) / TK : 0;
  const unsigned char* kpool = static_cast<const unsigned char*>(kpool_);
  const unsigned char* vpool = static_cast<const unsigned char*>(vpool_);
  const int* trow = table + size_t(b) * W;
  const bool alibi = slopes != nullptr;
  const int lim[2] = {p_hi, p_hi};

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [PR][LD]
  unsigned char* ring = smem + PR * LD * 2;                      // two stages
  __nv_bfloat16* kw = reinterpret_cast<__nv_bfloat16*>(ring + 2 * T::kStage);
  __nv_bfloat16* vw = kw + TK * LD;                              // (one-byte pools)

  for (int r0 = 0; r0 < G; r0 += PR) {   // one pass for G <= PR
    const int rows = min(PR, G - r0);
    const size_t h0 = size_t(kv) * G + r0;   // the pass's first query head
    for (int i = tid; i < PR * (DH / 8); i += kThreads) {
      const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      const bool ok = r < rows;
      cp_async16(qs + r * LD + c, ok ? q + (size_t(b) * H + h0 + r) * DH + c : q, ok);
    }
    cp_async_commit();
    if (ntile > 0) {
      stage_kv<DH, KIND>(ring, kpool, vpool, kscale, vscale, trow, kv, KV, bs, p_lo,
                         min(TK, p_hi - p_lo), warp, lane);
      cp_async_commit();
    }

    Rows<DH> st[RT];
    float sl[RT][2];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      st[i].init();
      const int rt = KSPLIT ? 0 : warp + kWarps * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rt * 16 + g + 8 * h;
        sl[i][h] = alibi && r < rows ? slopes[h0 + r] * kLog2e : 0.f;
      }
    }

    for (int it = 0; it < ntile; ++it) {
      const int p0 = p_lo + it * TK;
      cp_async_wait<0>();   // tile it (and Q)
      // everyone's copies of tile it are visible, and everyone is done with
      // tile it - 1, whose stage the next tile fills while this one computes
      __syncthreads();
      if (it + 1 < ntile) {
        stage_kv<DH, KIND>(ring + ((it + 1) & 1) * T::kStage, kpool, vpool, kscale, vscale, trow,
                           kv, KV, bs, p0 + TK, min(TK, p_hi - p0 - TK), warp, lane);
        cp_async_commit();
      }
      const TileView tv = view_tile<DH, KIND>(ring + (it & 1) * T::kStage, kw, vw, tid);
      if constexpr (T::kScaled) __syncthreads();
      const bool masked = p0 + TK > p_hi;
      if constexpr (KSPLIT) {
        attend<DH, T::kScaled, 16>(st[0], qs, nullptr, tv.k, tv.v, tv.ks, tv.vs, warp * 16, p0,
                                   lim, sl[0], alibi, masked, scale * kLog2e, lane);
      } else {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int rt = warp + kWarps * i;
          if (rt * 16 < rows)
            attend<DH, T::kScaled, TK>(st[i], qs + rt * 16 * LD, nullptr, tv.k, tv.v, tv.ks,
                                       tv.vs, 0, p0, lim, sl[i], alibi, masked, scale * kLog2e,
                                       lane);
        }
      }
    }
    cp_async_wait<0>();   // (no tile: Q's copy)
    __syncthreads();      // every warp is done with the ring (the KSPLIT merge reuses it)

    // row r of the pass: unnormalised o over columns [d, d + 2), m, l
    auto emit = [&](int r, int d, float o0, float o1, float m, float l) {
      const size_t h = h0 + r;
      if (direct) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t(b) * H + h) * DH + d) =
            __floats2bfloat162_rn(o0 * inv, o1 * inv);
      } else {
        const size_t row = (size_t(b) * S + s) * H + h;
        *reinterpret_cast<float2*>(o_part + row * DH + d) = make_float2(o0, o1);
        if (d == 0) {
          m_part[row] = m;
          l_part[row] = l;
        }
      }
    };
    if constexpr (KSPLIT) {
      // the four warps' states of the same 16 rows, merged in warp order
      float* mw = reinterpret_cast<float*>(ring);   // [4][16]
      float* lw = mw + kWarps * 16;                 // [4][16]
      float* ow = lw + kWarps * 16;                 // [4][16][kMergeLd]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (tq == 0) {
          mw[r] = st[0].m[h];
          lw[r] = st[0].l[h];
        }
#pragma unroll
        for (int d = 0; d < DH / 8; ++d)
          *reinterpret_cast<float2*>(ow + r * D::kMergeLd + d * 8 + tq * 2) =
              make_float2(st[0].o[d][2 * h], st[0].o[d][2 * h + 1]);
      }
      __syncthreads();
      for (int i = tid; i < rows * (DH / 2); i += kThreads) {
        const int r = i / (DH / 2), d = (i % (DH / 2)) * 2;
        float m = kNeg;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, mw[w * 16 + r]);
        float l = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f = exp2f(mw[w * 16 + r] - m);
          const float2 ov = *reinterpret_cast<const float2*>(ow + (w * 16 + r) * D::kMergeLd + d);
          l += f * lw[w * 16 + r];
          o0 += f * ov.x;
          o1 += f * ov.y;
        }
        emit(r, d, o0, o1, m, l);
      }
    } else {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int rt = warp + kWarps * i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rt * 16 + g + 8 * h;
          if (r >= rows) continue;
#pragma unroll
          for (int d = 0; d < DH / 8; ++d)
            emit(r, d * 8 + tq * 2, st[i].o[d][2 * h], st[i].o[d][2 * h + 1], st[i].m[h],
                 st[i].l[h]);
        }
      }
    }
    __syncthreads();   // before the next pass restages Q and the ring
  }
  if constexpr (FOLD) {
    if (!fold || direct) return;
    // every thread's partials reach L2 before its block is counted; the
    // ring is free (the last pass ended at a barrier)
    __threadfence();
    __syncthreads();
    int* flag = reinterpret_cast<int*>(ring);
    if (tid == 0) {
      int* counter = counters + size_t(b) * KV + kv;
      const int last = atomicAdd(counter, 1) == live - 1;
      if (last) atomicExch(counter, 0);   // every live split has counted: ready for the next call
      *flag = last;
    }
    __syncthreads();
    if (!*flag) return;
    __threadfence();   // the other splits' partials, seen after their counts
    // per query head of the group: m_g and sum(w * l); the weights w in
    // shared memory where they fit (else recomputed: the same bits)
    constexpr int kRingBytes = DecodeSmem<DH, KIND, KSPLIT>::kRing;
    float* mg_s = reinterpret_cast<float*>(ring + 16);   // [G]
    float* l_s = mg_s + G;                               // [G]
    float* w_s = l_s + G;                                // [live][G]
    const bool staged = 16 + 4 * (2 + live) * G <= kRingBytes;
    const size_t hb = size_t(b) * S * H + size_t(kv) * G;   // row (b, s = 0, the group's head 0)
    for (int r = tid; r < G; r += kThreads) {
      float mg = kNeg;
      for (int j = 0; j < live; ++j) mg = fmaxf(mg, __ldcg(m_part + hb + r + size_t(j) * H));
      float l = 0.f;
      for (int j = 0; j < live; ++j) {
        const size_t at = hb + r + size_t(j) * H;
        const float w = exp2f(__ldcg(m_part + at) - mg);
        l += w * __ldcg(l_part + at);
        if (staged) w_s[j * G + r] = w;
      }
      mg_s[r] = mg;
      l_s[r] = l;
    }
    __syncthreads();
    for (int i = tid; i < G * (DH / 4); i += kThreads) {
      const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < live; ++j) {
        const size_t at = hb + r + size_t(j) * H;
        const float w = staged ? w_s[j * G + r] : exp2f(__ldcg(m_part + at) - mg_s[r]);
        const float4 x = __ldcg(reinterpret_cast<const float4*>(o_part + at * DH + d));
        o[0] += w * x.x;
        o[1] += w * x.y;
        o[2] += w * x.z;
        o[3] += w * x.w;
      }
      const float den = fmaxf(l_s[r], 1e-30f);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0] / den, o[1] / den);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2] / den, o[3] / den);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out + (size_t(b) * H + size_t(kv) * G + r) * DH + d) = packed;
    }
  }
}

// Merge of the splits of one (sequence b, query head h) at column d: split
// s of sequence b exists when s * split_len < len (the formula above, in
// split order).
__device__ __forceinline__ void merge_partials(const float* __restrict__ o_part,
                                               const float* __restrict__ m_part,
                                               const float* __restrict__ l_part,
                                               const int* __restrict__ kv_len,
                                               __nv_bfloat16* __restrict__ out, int S, int H,
                                               int Dh, int cap, int split_len, int b, int h,
                                               int d) {
  const int len = min(kv_len[b], cap);
  const int n = len > 0 ? min(S, (len + split_len - 1) / split_len) : 0;
  const size_t r0 = size_t(b) * S * H + h;   // row (b, s=0, h); rows of s step by H
  float mg = kNeg;
  for (int s = 0; s < n; ++s) mg = fmaxf(mg, m_part[r0 + size_t(s) * H]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < n; ++s) {
    const size_t r = r0 + size_t(s) * H;
    const float w = exp2f(m_part[r] - mg);
    l += w * l_part[r];
    o += w * o_part[r * Dh + d];
  }
  out[(size_t(b) * H + h) * Dh + d] = __float2bfloat16(o / fmaxf(l, 1e-30f));
}

}  // namespace pdec
}  // namespace
