// Helpers shared by the paged-attention kernels (paged_attention.cu and
// fused_decode.cu): the key tile, the finite mask sentinel, the staging of
// one tile of a block-paged bf16 K/V pool into shared memory, and the
// unpacking of eight bf16 values.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;            // key positions per tile
constexpr float kNeg = -1e30f;    // finite mask sentinel (as the TPU kernels)

// Stage positions [p0, p0 + n) of one (sequence, kv head) into shared
// memory; rows t >= n are zero-filled so no uninitialised value ever meets
// a zero probability (0 * NaN would poison the sum). Table entries below 0
// are read as block 0.
template <int DH>
__device__ __forceinline__ void load_kv_tile(
    __nv_bfloat16* ks, __nv_bfloat16* vs, const __nv_bfloat16* __restrict__ kpool,
    const __nv_bfloat16* __restrict__ vpool, const int* __restrict__ trow, int kv,
    int KV, int bs, int p0, int n, int tid, int nthreads) {
  constexpr int VPR = DH / 8;       // 16-byte vectors per row
  constexpr int LD = DH + 8;        // padded shared-memory row, in bf16
  for (int i = tid; i < TK * VPR; i += nthreads) {
    const int t = i / VPR, c = (i % VPR) * 8;
    uint4 kval = make_uint4(0u, 0u, 0u, 0u), vval = make_uint4(0u, 0u, 0u, 0u);
    if (t < n) {
      const int pos = p0 + t;
      int blk = trow[pos / bs];
      blk = blk < 0 ? 0 : blk;
      const size_t off = ((size_t(blk) * KV + kv) * bs + pos % bs) * DH + c;
      kval = *reinterpret_cast<const uint4*>(kpool + off);
      vval = *reinterpret_cast<const uint4*>(vpool + off);
    }
    *reinterpret_cast<uint4*>(ks + t * LD + c) = kval;
    *reinterpret_cast<uint4*>(vs + t * LD + c) = vval;
  }
}

__device__ __forceinline__ void bf16x8_to_float(uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ void bf16x8_to_float(const __nv_bfloat16* p, float* f) {
  bf16x8_to_float(*reinterpret_cast<const uint4*>(p), f);
}

}  // namespace
