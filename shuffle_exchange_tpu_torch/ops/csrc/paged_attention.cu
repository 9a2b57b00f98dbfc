// Paged attention for Hopper (sm_90a): decode and chunked-prefill extend
// over a block-paged bf16 KV pool, behind a plain C interface loaded with
// ctypes (ops/_build.py builds this file with nvcc at first use).
//
// Replaces the TPU kernels
//   shuffle_exchange_tpu/ops/paged_attention.py:paged_decode_attention_pallas
//   shuffle_exchange_tpu/ops/paged_attention.py:paged_extend_attention_pallas
//
// Layouts (all contiguous):
//   q       decode [B, 1, H, Dh] / extend [B, C, H, Dh]   bf16
//   k, v    one layer of the pool [nblk, KV, bs, Dh]       bf16
//   table   [B, W] int32 block ids (-1 is read as block 0)
//   kv_len  [B] int32 (decode) / start [B] int32 (extend)
//   out     same shape as q, bf16
// q head h reads kv head h / G (G = H / KV, the _repeat_kv convention);
// the softmax scale is Dh^-0.5; softmax and accumulation are in f32.
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
// of that kv head. Masked scores use the finite -1e30 sentinel of the TPU
// kernels and masked probabilities are exactly 0, and the output divides
// by max(l, 1e-30): a fully masked row gives 0, never NaN. Tensor-core MMA,
// TMA staging and split-K over long contexts are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_tile.cuh"   // TK, kNeg, load_kv_tile, bf16x8_to_float

namespace {

// ---------------------------------------------------------------------------
// Decode: one query token per sequence. Block (b, kv), 128 threads.
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 128;
constexpr int kDecodeMaxAcc = 8;    // G * Dh <= 8 * 128

template <int DH>
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kpool,
    const __nv_bfloat16* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out, int H, int KV,
    int bs, int W, float scale) {
  constexpr int NT = kDecodeThreads, LD = DH + 8;
  const int b = blockIdx.x, kv = blockIdx.y, tid = threadIdx.x;
  const int G = H / KV;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + TK * LD;
  float* qs = reinterpret_cast<float*>(vs + TK * LD);   // [G][DH], pre-scaled
  float* ss = qs + G * DH;                               // [G][TK] scores, then p
  float* ms = ss + G * TK;                               // [G] running max
  float* ls = ms + G;                                    // [G] running sum
  float* as = ls + G;                                    // [G] tile rescale

  const int len = min(kv_len[b], W * bs);
  const int* trow = table + size_t(b) * W;
  const __nv_bfloat16* qb = q + (size_t(b) * H + size_t(kv) * G) * DH;
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
    load_kv_tile<DH>(ks, vs, kpool, vpool, trow, kv, KV, bs, p0, n, tid, NT);
    __syncthreads();

    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, t = i % TK;
      float s = kNeg;
      if (t < n) {
        const float* qr = qs + g * DH;
        const __nv_bfloat16* kr = ks + t * LD;
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < DH; c += 8) {
          float kf[8];
          bf16x8_to_float(kr + c, kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) a += qr[c + e] * kf[e];
        }
        s = a;
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
        for (int t = 0; t < n; ++t) a += pr[t] * __bfloat162float(vs[t * LD + d]);
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
      out[(size_t(b) * H + size_t(kv) * G + g) * DH + d] = __float2bfloat16(acc[k] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Extend: a C-token chunk per sequence. Block (b, kv, tile of TC chunk
// rows), 256 threads as 16 x 16; the tile's R = G * TC <= 64 query rows are
// g-major (row r is head kv*G + r / TC, chunk row c0 + r % TC). Thread
// (ty, tx) owns rows ty + 16 i and, for scores, positions tx + 16 j of the
// tile (i, j < 4); for the output, columns [tx * DH/16, (tx + 1) * DH/16).
// Row c of sequence b sees positions < start[b] + c + 1 (causal within the
// chunk), capped at the table's W * bs.
// ---------------------------------------------------------------------------

constexpr int kExtendThreads = 256;
constexpr int kExtendRows = 64;

template <int DH>
__global__ void __launch_bounds__(kExtendThreads) paged_extend_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kpool,
    const __nv_bfloat16* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ start, __nv_bfloat16* __restrict__ out, int C, int H,
    int KV, int bs, int W, int TC, float scale) {
  constexpr int NT = kExtendThreads, LD = DH + 8, PLD = TK + 1, CPT = DH / 16;
  const int b = blockIdx.x, kv = blockIdx.y, c0 = blockIdx.z * TC, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int G = H / KV;
  const int R = G * TC;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [64][LD]
  __nv_bfloat16* ks = qs + kExtendRows * LD;                    // [TK][LD]
  __nv_bfloat16* vs = ks + TK * LD;                             // [TK][LD]
  float* ps = reinterpret_cast<float*>(vs + TK * LD);           // [64][PLD]

  const int st = start[b];
  const int cap = W * bs;
  const int c_last = min(c0 + TC, C) - 1;
  const int lim_cta = min(st + c_last + 1, cap);
  const int* trow = table + size_t(b) * W;

  for (int i = tid; i < kExtendRows * (DH / 8); i += NT) {
    const int r = i / (DH / 8), cc = (i % (DH / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) {
      const int g = r / TC, c = c0 + r % TC;
      if (c < C)
        val = *reinterpret_cast<const uint4*>(
            q + ((size_t(b) * C + c) * H + size_t(kv) * G + g) * DH + cc);
    }
    *reinterpret_cast<uint4*>(qs + r * LD + cc) = val;
  }

  int lim[4];
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int c = c0 + (r < R ? r % TC : 0);
    lim[i] = (r < R && c < C) ? min(st + c + 1, cap) : 0;
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[i][e] = 0.f;
  }
  __syncthreads();

  for (int p0 = 0; p0 < lim_cta; p0 += TK) {
    const int n = min(TK, lim_cta - p0);
    load_kv_tile<DH>(ks, vs, kpool, vpool, trow, kv, KV, bs, p0, n, tid, NT);
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
      for (int j = 0; j < 4; ++j) bf16x8_to_float(ks + (tx + 16 * j) * LD + c, kf[j]);
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
        const bool ok = p0 + tx + 16 * j < lim[i];
        s[i][j] = ok ? s[i][j] * scale : kNeg;
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
      const __nv_bfloat16* vr = vs + t * LD + tx * CPT;
#pragma unroll
      for (int e = 0; e < CPT; ++e) vf[e] = __bfloat162float(vr[e]);
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
    const int g = r / TC, c = c0 + r % TC;
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

}  // namespace

extern "C" {

const char* sxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared-memory bytes of one decode block (the wrapper checks G * Dh <= 1024).
size_t sxt_paged_decode_smem(int H, int KV, int Dh) {
  const int G = H / KV;
  return size_t(2) * TK * (Dh + 8) * sizeof(__nv_bfloat16) +
         size_t(G * Dh + G * TK + 3 * G) * sizeof(float);
}

size_t sxt_paged_extend_smem(int Dh) {
  return size_t(kExtendRows + 2 * TK) * (Dh + 8) * sizeof(__nv_bfloat16) +
         size_t(kExtendRows) * (TK + 1) * sizeof(float);
}

// Returns cudaGetLastError() after the launch (0 on success).
int sxt_paged_decode_bf16(const void* q, const void* k, const void* v, const void* table,
                          const void* kv_len, void* out, int B, int H, int KV, int Dh,
                          int bs, int W, float scale, void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || (H / KV) * Dh > kDecodeThreads * kDecodeMaxAcc)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, KV);
  const size_t smem = sxt_paged_decode_smem(H, KV, Dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* tp = static_cast<const int*>(table);
  const auto* lp = static_cast<const int*>(kv_len);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (Dh == 128) {
    err = set_smem(paged_decode_kernel<128>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    paged_decode_kernel<128><<<grid, kDecodeThreads, smem, s>>>(qp, kp, vp, tp, lp, op, H, KV,
                                                               bs, W, scale);
  } else if (Dh == 64) {
    err = set_smem(paged_decode_kernel<64>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    paged_decode_kernel<64><<<grid, kDecodeThreads, smem, s>>>(qp, kp, vp, tp, lp, op, H, KV,
                                                              bs, W, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int sxt_paged_extend_bf16(const void* q, const void* k, const void* v, const void* table,
                          const void* start, void* out, int B, int C, int H, int KV, int Dh,
                          int bs, int W, float scale, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > kExtendRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const int TC = kExtendRows / G;
  const dim3 grid(B, KV, (C + TC - 1) / TC);
  const size_t smem = sxt_paged_extend_smem(Dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* tp = static_cast<const int*>(table);
  const auto* sp = static_cast<const int*>(start);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (Dh == 128) {
    err = set_smem(paged_extend_kernel<128>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    paged_extend_kernel<128><<<grid, kExtendThreads, smem, s>>>(qp, kp, vp, tp, sp, op, C, H,
                                                               KV, bs, W, TC, scale);
  } else if (Dh == 64) {
    err = set_smem(paged_extend_kernel<64>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    paged_extend_kernel<64><<<grid, kExtendThreads, smem, s>>>(qp, kp, vp, tp, sp, op, C, H,
                                                              KV, bs, W, TC, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
