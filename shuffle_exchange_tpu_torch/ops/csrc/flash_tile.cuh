// Tile code of the flash-attention kernels: the mma.sync block shape and
// constants (kNeg, kLog2e, kLn2, which the wgmma bodies of wgmma_flash.cuh
// share), the staging of a 64-row tile into shared memory by cp.async and
// of one query tile (Q, dO, lse, delta) for the mask forms' dk/dv pass
// (flash_attention.cu), and the delta row sum of the backward's first pass
// (flash_bwd_delta_kernel, dense and ALiBi alike).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sync.cuh"   // cp_async16, ldsm_x4, mma_bf16, split_bf16x2, ...

namespace {

constexpr int kBlockM = 64;             // query rows per block, 16 per warp
constexpr int kBlockN = 64;             // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;          // finite mask sentinel (as the TPU kernels)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Stage rows [0, 64) of a [rows, DH] tile whose rows lie `stride` elements
// apart; rows >= valid are zero-filled. One commit group per caller.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int stride, int valid, const __nv_bfloat16* safe,
                                          int tid) {
  constexpr int VPR = DH / 8, LD = DH + 8;
  constexpr int ITERS = kBlockN * VPR / kThreads;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + size_t(r) * stride + c : safe, ok);
  }
}

// Stage one 64-query tile of head h for a dk/dv pass: Q and dO rows by
// cp.async (the caller commits), lse (into the log2 domain) and delta by
// plain loads; rows past T read as zero.
template <int DH>
__device__ __forceinline__ void stage_queries(
    __nv_bfloat16* qdst, __nv_bfloat16* dodst, float* lsedst, float* deldst,
    const __nv_bfloat16* q, const __nv_bfloat16* dout, const float* lse, const float* delta,
    int b, int h, int q0, int T, int H, int tid) {
  const int qstride = H * DH;
  const size_t off = (size_t(b) * T + q0) * qstride + size_t(h) * DH;
  load_tile<DH>(qdst, q + off, qstride, T - q0, q, tid);
  load_tile<DH>(dodst, dout + off, qstride, T - q0, dout, tid);
  if (tid < kBlockM) {
    const int row = q0 + tid;
    const bool ok = row < T;
    const size_t so = (size_t(b) * H + h) * T + (ok ? row : 0);
    lsedst[tid] = ok ? lse[so] * kLog2e : 0.f;
    deldst[tid] = ok ? delta[so] : 0.f;
  }
}

// delta[b, h, t] = sum_d dout[b, t, h, d] * out[b, t, h, d] for the row of
// the [B*T*H, DH] views that the calling warp owns (kWarps rows a block), a
// fixed butterfly order for the sum.
template <int DH>
__device__ __forceinline__ void delta_row(const __nv_bfloat16* __restrict__ o,
                                          const __nv_bfloat16* __restrict__ dout,
                                          float* __restrict__ delta, long long rows, int T,
                                          int H) {
  constexpr int PER = DH / 32;   // elements a lane: 2 or 4
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* op = o + row * DH + lane * PER;
  const __nv_bfloat16* dp = dout + row * DH + lane * PER;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + i));
    const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dp + i));
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bt = row / H;
    const int h = int(row % H), t = int(bt % T);
    const long long b = bt / T;
    delta[(b * H + h) * T + t] = acc;
  }
}

}  // namespace
