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
// q head h reads kv head h / G (G = H / KV, the _repeat_kv convention);
// the softmax scale is Dh^-0.5; softmax and accumulation are in f32.
// ALiBi adds slope_h * j to the scaled score of key position j, in f32
// and before the running max. j is the logical sequence position the
// tile loop walks (table entry j / bs, offset j % bs), never a pool slot:
// a bias of ~1,450 at j = 2048 (slope 2^-0.5) must not be rounded, and a
// shift that differs between blocks would not cancel in the softmax.
// A one-byte pool is dequantized in registers: each element read from the
// staged tile becomes float(q) * scale of its row (paged_tile.cuh), the
// rounding point of the TPU kernels' kb * s[:, None]; all G query heads of
// a kv head read the same scale row.
//
// What bounds them on the H100: both read every visible K/V row of the
// pool once per (sequence, kv head), so decode is bound by bytes (G query
// rows per K/V row is far below the ~295 flop/byte ridge of the bf16 tensor
// cores). Extend reuses each K/V row for G*TC query rows and has more
// arithmetic, but this first version computes on the CUDA cores in f32,
// so at long chunks its own arithmetic, not memory, is what limits it.
// Design: one thread block per (sequence, kv head[, tile of chunk rows])
// walks the block table in tiles of 64 positions up to the last visible
// position. The TPU kernel's sequential grid axis over the table becomes
// this in-block loop, so padded table entries past the sequence's length
// are never read. Each tile of K and V is staged once in shared memory
// (16-byte loads, rows padded by 16 bytes so the row-strided reads hit
// distinct banks) and reused by all G (decode) or G*TC (extend) query rows
// of that kv head; a one-byte pool's tile is staged at that width (half
// the bytes of a bf16 tile) with its 64 row scales. Masked scores use the
// finite -1e30 sentinel of the TPU
// kernels and masked probabilities are exactly 0, and the output divides
// by max(l, 1e-30): a fully masked row gives 0, never NaN. Tensor-core MMA,
// TMA staging and split-K over long contexts are later work.
//
// Any query-head group G = H / KV. A decode block takes a chunk of at most
// 1024 / Dh query heads of one kv head (a third grid axis over the chunks),
// so each thread keeps at most 8 f32 accumulators: Falcon-7B's 71 heads of
// 64 over one kv head make 5 chunks (4 x 16 + 7), each reading the kv
// head's tiles again (from L2: a layer's K/V at 8 rows of ~1,250 positions
// is ~2.6 MB). A group that fits one chunk (G * Dh <= 1024) launches as
// before, one block per (sequence, kv head). The extend kernel tiles a kv
// head's flattened query rows by 64: up to 64 heads, a tile is TC = 64 / G
// chunk rows of every head (g-major); past 64 heads, a tile is 64
// consecutive rows of the c-major order (c, g), so it spans at most two
// chunk rows, each row with its own head and causal limit.
//
// Head dims 64, 128 and 256 (GPT-J-6B), and 80 (Pythia-2.8b) and 96
// (Phi-3-mini). At 256 the extend kernel's staged Q, K and V tiles and its
// P tile take ~118 KB of dynamic shared memory (bf16 pool; set_smem raises
// the limit), and each thread keeps 4 x 16 f32 accumulators, so it runs one
// block an SM. A built head dim is a multiple of 16, so a stored row (Dh
// bf16 or Dh bytes) and a staged row are whole 16-byte vectors; at 80 and
// 96 a decode block takes 12 and 10 query heads (960 columns), and an
// extend thread owns 5 and 6 output columns, read and stored one at a
// time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_tile.cuh"   // TK, kNeg, storage kinds, load_kv_tile, converters

namespace {

// ---------------------------------------------------------------------------
// Decode: one query token per sequence. Block (b, kv, head chunk), 128
// threads; the chunk is query heads [z * GC, min(G, (z + 1) * GC)) of kv
// head kv. A group that fits one block runs the CHUNKED = false instance,
// whose code is that of the kernel before head chunks (the whole group,
// G = H / KV, known to the compiler as such).
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 128;
constexpr int kDecodeMaxAcc = kDecodeCols / kDecodeThreads;   // per thread

template <int DH, int KIND, bool CHUNKED>
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpool,
    const void* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ kv_len, const float* __restrict__ slopes,
    __nv_bfloat16* __restrict__ out, int H, int KV, int bs, int W, float scale, int GC) {
  constexpr int NT = kDecodeThreads, LDB = kv_row_bytes<DH, KIND>();
  constexpr int EB = KvStore<KIND>::kBytes;
  constexpr bool SCALED = KvStore<KIND>::kScaled;
  const int b = blockIdx.x, kv = blockIdx.y, tid = threadIdx.x;
  // the block's query heads and the first of them
  const int G = CHUNKED ? min(GC, H / KV - int(blockIdx.z) * GC) : H / KV;
  const size_t h0 = size_t(kv) * (H / KV) + (CHUNKED ? size_t(blockIdx.z) * GC : 0);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;                              // [TK] rows of LDB bytes
  unsigned char* vs = ks + TK * LDB;
  float* kss = reinterpret_cast<float*>(vs + TK * LDB);  // [TK] row scales (one-byte pools)
  float* vss = kss + TK;
  float* qs = vss + TK;                                  // [G][DH], pre-scaled
  float* ss = qs + G * DH;                               // [G][TK] scores, then p
  float* ms = ss + G * TK;                               // [G] running max
  float* ls = ms + G;                                    // [G] running sum
  float* as = ls + G;                                    // [G] tile rescale

  const int len = min(kv_len[b], W * bs);
  const int* trow = table + size_t(b) * W;
  const __nv_bfloat16* qb = q + (size_t(b) * H + h0) * DH;
  for (int i = tid; i < G * DH; i += NT) qs[i] = __bfloat162float(qb[i]) * scale;
  for (int g = tid; g < G; g += NT) {
    ms[g] = kNeg;
    ls[g] = 0.f;
  }
  float acc[kDecodeMaxAcc];
#pragma unroll
  for (int k = 0; k < kDecodeMaxAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int p0 = 0; p0 < len; p0 += TK) {
    const int n = min(TK, len - p0);
    load_kv_tile<DH, KIND>(ks, vs, kss, vss, kpool, vpool, kscale, vscale, trow, kv, KV, bs,
                           p0, n, tid, NT);
    __syncthreads();

    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, t = i % TK;
      float s = kNeg;
      if (t < n) {
        const float* qr = qs + g * DH;
        const unsigned char* kr = ks + t * LDB;
        const float sk = SCALED ? kss[t] : 1.f;
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < DH; c += 8) {
          float kf[8];
          kv8_to_float<KIND>(kr + c * EB, kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) a += qr[c + e] * (SCALED ? kf[e] * sk : kf[e]);
        }
        s = slopes ? a + slopes[int(h0) + g] * float(p0 + t) : a;
      }
      ss[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per query head, two positions per lane
    for (int g = warp; g < G; g += NT / 32) {
      float* sr = ss + g * TK;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0v = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1v = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      float sum = p0v + p1v;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sr[lane] = p0v;
      sr[lane + 32] = p1v;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kDecodeMaxAcc; ++k) {
      const int o = tid + k * NT;
      if (o < G * DH) {
        const int g = o / DH, d = o % DH;
        const float* pr = ss + g * TK;
        float a = acc[k] * as[g];
        for (int t = 0; t < n; ++t) {
          const float vf = kv1_to_float<KIND>(vs + t * LDB, d);
          a += pr[t] * (SCALED ? vf * vss[t] : vf);
        }
        acc[k] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kDecodeMaxAcc; ++k) {
    const int o = tid + k * NT;
    if (o < G * DH) {
      const int g = o / DH, d = o % DH;
      const float inv = 1.f / fmaxf(ls[g], 1e-30f);
      out[(size_t(b) * H + h0 + g) * DH + d] = __float2bfloat16(acc[k] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Extend: a C-token chunk per sequence. Block (b, kv, tile), 256 threads as
// 16 x 16. A kv head's query rows are numbered u = cb * G * TC + g * TC + ci
// for chunk row c = cb * TC + ci of head kv*G + g (TC = 64 / G up to 64
// heads, else 1), and tile z holds rows [z * RT, (z + 1) * RT): RT = G * TC
// rows up to 64 heads (one block of TC chunk rows, g-major), else 64. Thread
// (ty, tx) owns tile rows ty + 16 i and, for scores, positions tx + 16 j of
// the key tile (i, j < 4); for the output, columns [tx * DH/16,
// (tx + 1) * DH/16). Row c of sequence b sees positions < start[b] + c + 1
// (causal within the chunk), capped at the table's W * bs.
// ---------------------------------------------------------------------------

constexpr int kExtendThreads = 256;
constexpr int kExtendRows = 64;

template <int DH, int KIND>
__global__ void __launch_bounds__(kExtendThreads) paged_extend_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpool,
    const void* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ start, const float* __restrict__ slopes,
    __nv_bfloat16* __restrict__ out, int C, int H, int KV, int bs, int W, int TC, int RT,
    float scale) {
  constexpr int NT = kExtendThreads, LD = DH + 8, PLD = TK + 1, CPT = DH / 16;
  constexpr int LDB = kv_row_bytes<DH, KIND>(), EB = KvStore<KIND>::kBytes;
  constexpr bool SCALED = KvStore<KIND>::kScaled;
  const int b = blockIdx.x, kv = blockIdx.y, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int G = H / KV;
  const int GT = G * TC;                                  // rows of one block of TC chunk rows
  const int u0 = blockIdx.z * RT;                         // the tile's first row
  const int R = min(RT, (C + TC - 1) / TC * GT - u0);     // the tile's rows
  // tile row r -> (head g, chunk row c); c >= C is a padding row
  auto head_of = [&](int r) { return (u0 + r) % GT / TC; };
  auto row_of = [&](int r) { return (u0 + r) / GT * TC + (u0 + r) % GT % TC; };
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [64][LD]
  unsigned char* ks = reinterpret_cast<unsigned char*>(qs + kExtendRows * LD);  // [TK][LDB]
  unsigned char* vs = ks + TK * LDB;                            // [TK][LDB]
  float* kss = reinterpret_cast<float*>(vs + TK * LDB);         // [TK] row scales
  float* vss = kss + TK;
  float* ps = vss + TK;                                         // [64][PLD]

  const int st = start[b];
  const int cap = W * bs;
  const int c_last = min((u0 + R - 1) / GT * TC + TC, C) - 1;   // the tile's last chunk row
  const int lim_cta = min(st + c_last + 1, cap);
  const int* trow = table + size_t(b) * W;

  for (int i = tid; i < kExtendRows * (DH / 8); i += NT) {
    const int r = i / (DH / 8), cc = (i % (DH / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) {
      const int g = head_of(r), c = row_of(r);
      if (c < C)
        val = *reinterpret_cast<const uint4*>(
            q + ((size_t(b) * C + c) * H + size_t(kv) * G + g) * DH + cc);
    }
    *reinterpret_cast<uint4*>(qs + r * LD + cc) = val;
  }

  int lim[4];
  float m[4], l[4], sl[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int c = r < R ? row_of(r) : C;
    lim[i] = c < C ? min(st + c + 1, cap) : 0;
    sl[i] = (slopes && r < R) ? slopes[kv * G + head_of(r)] : 0.f;
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[i][e] = 0.f;
  }
  __syncthreads();

  for (int p0 = 0; p0 < lim_cta; p0 += TK) {
    const int n = min(TK, lim_cta - p0);
    load_kv_tile<DH, KIND>(ks, vs, kss, vss, kpool, vpool, kscale, vscale, trow, kv, KV, bs,
                           p0, n, tid, NT);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < DH; c += 8) {
      float qf[4][8], kf[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) bf16x8_to_float(qs + (ty + 16 * i) * LD + c, qf[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv8_to_float<KIND>(ks + (tx + 16 * j) * LDB + c * EB, kf[j]);
        if constexpr (SCALED) {
          const float sk = kss[tx + 16 * j];
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[j][e] *= sk;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[i][j] += qf[i][e] * kf[j][e];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = p0 + tx + 16 * j;
        s[i][j] = pos < lim[i] ? s[i][j] * scale + sl[i] * float(pos) : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tx + 16 * j;
        const float p = p0 + t < lim[i] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(ty + 16 * i) * PLD + t] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o, 16);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      float vf[CPT];
      const unsigned char* vr = vs + t * LDB;
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        vf[e] = kv1_to_float<KIND>(vr, tx * CPT + e);
        if constexpr (SCALED) vf[e] *= vss[t];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * PLD + t];
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[i][e] += p * vf[e];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= R) continue;
    const int g = head_of(r), c = row_of(r);
    if (c >= C) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t(b) * C + c) * H + size_t(kv) * G + g) * DH + tx * CPT;
#pragma unroll
    for (int e = 0; e < CPT; ++e) orow[e] = __float2bfloat16(acc[i][e] * inv);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Bytes of a staged K and V tile plus their row scales.
size_t kv_tile_smem(int kind, int Dh) {
  return size_t(2) * TK * (size_t(Dh) * (kind == KvBf16 ? 2 : 1) + 16) +
         size_t(2) * TK * sizeof(float);
}

size_t decode_smem(int kind, int GC, int Dh) {
  return kv_tile_smem(kind, Dh) + size_t(GC * Dh + GC * TK + 3 * GC) * sizeof(float);
}

size_t extend_smem(int kind, int Dh) {
  return size_t(kExtendRows) * (Dh + 8) * sizeof(__nv_bfloat16) + kv_tile_smem(kind, Dh) +
         size_t(kExtendRows) * (TK + 1) * sizeof(float);
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

template <int DH, int KIND>
cudaError_t launch_decode(const PagedArgs& a, dim3 grid, size_t smem, cudaStream_t s, int H,
                          int KV, int bs, int W, int GC, float scale) {
  const auto kernel = grid.z > 1 ? paged_decode_kernel<DH, KIND, true>
                                 : paged_decode_kernel<DH, KIND, false>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kDecodeThreads, smem, s>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.table, a.lens, a.slopes, a.out, H, KV, bs, W, scale, GC);
  return cudaSuccess;
}

template <int DH, int KIND>
cudaError_t launch_extend(const PagedArgs& a, dim3 grid, size_t smem, cudaStream_t s, int C,
                          int H, int KV, int bs, int W, int TC, int RT, float scale) {
  const cudaError_t err = set_smem(paged_extend_kernel<DH, KIND>, smem);
  if (err != cudaSuccess) return err;
  paged_extend_kernel<DH, KIND><<<grid, kExtendThreads, smem, s>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.table, a.lens, a.slopes, a.out, C, H, KV, bs, W, TC, RT,
      scale);
  return cudaSuccess;
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
// f32 scale planes). Returns cudaGetLastError() after the launch (0 on
// success).
int sxt_paged_decode(const void* q, const void* k, const void* v, const void* k_scale,
                     const void* v_scale, const void* table, const void* kv_len,
                     const void* slopes, void* out, int kind, int B, int H, int KV, int Dh,
                     int bs, int W, float scale, void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || bad_kind(kind, k_scale, v_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const int GC = decode_chunk(G, Dh);
  const PagedArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const int*>(table), static_cast<const int*>(kv_len),
                    static_cast<const float*>(slopes), static_cast<__nv_bfloat16*>(out)};
  const cudaError_t err =
      dispatch<Decode>(Dh, kind, a, dim3(B, KV, (G + GC - 1) / GC), decode_smem(kind, GC, Dh),
                       static_cast<cudaStream_t>(stream), H, KV, bs, W, GC, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  const PagedArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const int*>(table), static_cast<const int*>(start),
                    static_cast<const float*>(slopes), static_cast<__nv_bfloat16*>(out)};
  const cudaError_t err =
      dispatch<Extend>(Dh, kind, a, dim3(B, KV, (rows + RT - 1) / RT), extend_smem(kind, Dh),
                       static_cast<cudaStream_t>(stream), C, H, KV, bs, W, TC, RT, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
