// Helpers shared by the paged-attention kernels (paged_attention.cu and
// fused_decode.cu, through paged_decode.cuh): the key tile, the finite mask
// sentinel, the pool's storage kinds, the bytes of a staged row, and the
// conversion of stored values to f32.
//
// Storage kinds: a bf16 pool, or a one-byte pool (int8, or e4m3 fp8) with
// f32 scale planes [nblk, KV, bs], one scale per stored (token, kv head)
// row. A tile is staged at storage width: its raw rows (each padded by 16
// bytes, so row-strided reads hit distinct banks) and, for a one-byte
// pool, its rows' scales.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;            // key positions per tile
constexpr float kNeg = -1e30f;    // finite mask sentinel (as the TPU kernels)

enum KvKind { KvBf16 = 0, KvInt8 = 1, KvFp8 = 2 };

template <int KIND>
struct KvStore {
  static constexpr int kBytes = KIND == KvBf16 ? 2 : 1;   // bytes a stored element
  static constexpr bool kScaled = KIND != KvBf16;         // rows carry an f32 scale
};

// Bytes of one staged row in shared memory: the row's bytes plus 16.
template <int DH, int KIND>
__host__ __device__ constexpr int kv_row_bytes() {
  return DH * KvStore<KIND>::kBytes + 16;
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

// Two e4m3 bytes (the low byte first) -> two floats, exactly: every e4m3
// value is a half.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint16_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two),
                                                   __NV_E4M3);
  return __half22float2(__half2(h));
}

}  // namespace
