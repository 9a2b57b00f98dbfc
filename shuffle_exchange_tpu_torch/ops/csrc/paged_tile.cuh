// Helpers shared by the paged-attention kernels (paged_attention.cu and
// fused_decode.cu): the key tile, the finite mask sentinel, the decode
// kernels' query-head chunk, the pool's storage kinds, the staging of one tile of a block-paged K/V pool into
// shared memory, and the conversion of stored values to f32.
//
// Storage kinds: a bf16 pool, or a one-byte pool (int8, or e4m3 fp8) with
// f32 scale planes [nblk, KV, bs], one scale per stored (token, kv head)
// row. A tile is staged at storage width: its raw rows (each padded by 16
// bytes, so row-strided reads hit distinct banks) and, for a one-byte
// pool, its rows' scales. A value is dequantized when it is converted to
// f32, as float(q) * scale, which is the TPU kernels' kb * s[:, None]
// rounding point; nothing is rounded back to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;            // key positions per tile
constexpr float kNeg = -1e30f;    // finite mask sentinel (as the TPU kernels)
// Query-head columns (heads x Dh) one decode block accumulates: 8 f32 a
// thread at 128 threads, in the paged decode and the split-K decode kernels.
constexpr int kDecodeCols = 1024;

// Query heads a decode block takes: the whole group G, or kDecodeCols / Dh
// of it (Falcon-7B's 71 heads of 64 over one kv head: blocks of 16).
inline int decode_chunk(int G, int Dh) { return G < kDecodeCols / Dh ? G : kDecodeCols / Dh; }

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

// Stage positions [p0, p0 + n) of one (sequence, kv head) into shared
// memory: raw rows into ks / vs, and for a one-byte pool the rows' scales
// into kss / vss. Rows t >= n are zero-filled with scale 1, so no
// uninitialised value ever meets a zero probability (0 * NaN would poison
// the sum). Table entries below 0 are read as block 0.
template <int DH, int KIND>
__device__ __forceinline__ void load_kv_tile(
    unsigned char* ks, unsigned char* vs, float* kss, float* vss, const void* kpool_,
    const void* vpool_, const float* __restrict__ kscale, const float* __restrict__ vscale,
    const int* __restrict__ trow, int kv, int KV, int bs, int p0, int n, int tid,
    int nthreads) {
  constexpr int RB = DH * KvStore<KIND>::kBytes;   // bytes of a stored row
  constexpr int VPR = RB / 16;                     // 16-byte vectors per row
  constexpr int LDB = kv_row_bytes<DH, KIND>();
  const unsigned char* kpool = static_cast<const unsigned char*>(kpool_);
  const unsigned char* vpool = static_cast<const unsigned char*>(vpool_);
  for (int i = tid; i < TK * VPR; i += nthreads) {
    const int t = i / VPR, c = (i % VPR) * 16;
    uint4 kval = make_uint4(0u, 0u, 0u, 0u), vval = make_uint4(0u, 0u, 0u, 0u);
    if (t < n) {
      const int pos = p0 + t;
      int blk = trow[pos / bs];
      blk = blk < 0 ? 0 : blk;
      const size_t off = ((size_t(blk) * KV + kv) * bs + pos % bs) * RB + c;
      kval = *reinterpret_cast<const uint4*>(kpool + off);
      vval = *reinterpret_cast<const uint4*>(vpool + off);
    }
    *reinterpret_cast<uint4*>(ks + t * LDB + c) = kval;
    *reinterpret_cast<uint4*>(vs + t * LDB + c) = vval;
  }
  if constexpr (KvStore<KIND>::kScaled) {
    for (int t = tid; t < TK; t += nthreads) {
      float a = 1.f, b = 1.f;
      if (t < n) {
        const int pos = p0 + t;
        int blk = trow[pos / bs];
        blk = blk < 0 ? 0 : blk;
        const size_t at = (size_t(blk) * KV + kv) * bs + pos % bs;
        a = kscale[at];
        b = vscale[at];
      }
      kss[t] = a;
      vss[t] = b;
    }
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

// Two e4m3 bytes (the low byte first) -> two floats, exactly: every e4m3
// value is a half.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint16_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two),
                                                   __NV_E4M3);
  return __half22float2(__half2(h));
}

// Eight stored values starting at p (element-aligned: 16 bytes for bf16,
// 8 for the one-byte kinds) -> f32, not yet scaled.
template <int KIND>
__device__ __forceinline__ void kv8_to_float(const unsigned char* p, float* f) {
  if constexpr (KIND == KvBf16) {
    bf16x8_to_float(*reinterpret_cast<const uint4*>(p), f);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (KIND == KvInt8) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[4 * h + e] = float(static_cast<int8_t>((w[h] >> (8 * e)) & 0xffu));
      } else {
        const float2 lo = e4m3x2_to_float2(static_cast<uint16_t>(w[h] & 0xffffu));
        const float2 hi = e4m3x2_to_float2(static_cast<uint16_t>(w[h] >> 16));
        f[4 * h] = lo.x;
        f[4 * h + 1] = lo.y;
        f[4 * h + 2] = hi.x;
        f[4 * h + 3] = hi.y;
      }
    }
  }
}

// Stored element d of a staged row -> f32, not yet scaled.
template <int KIND>
__device__ __forceinline__ float kv1_to_float(const unsigned char* row, int d) {
  if constexpr (KIND == KvBf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  } else if constexpr (KIND == KvInt8) {
    return float(reinterpret_cast<const int8_t*>(row)[d]);
  } else {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(row[d]),
                                                 __NV_E4M3);
    return __half2float(__half(h));
  }
}

}  // namespace
