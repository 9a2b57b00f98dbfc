// Weight-only quantized GEMV with a split reduction, shared by the
// quantized matmul (quant_matmul.cu, rows <= 8) and the quantized fused MLP
// (fused_decode.cu). Storage formats of a weight [K, N] (QuantizedMatrix in
// ops/quant_matmul.py):
//   int8  q int8 [K, N]
//   int4  q uint8 [K/2, N]: within each K-group of gs rows, row r < gs/2
//         shares a byte with row r + gs/2, low nibble first; a nibble is a
//         two's-complement value in [-8, 7]
//   fp8   q e4m3 [K, N]
// with f32 scales [K/gs, N]; the weight is q * s, dequantized in registers.
//
// part[s, b, col0 + n] = sum over the rows d of split s of x[b, d] * w[d, n],
// for one 64-column tile of one of up to two matrices sharing x. A split
// covers whole scale groups (chunk is a multiple of gs), so each group's
// scales are loaded once per thread. ROUND_W rounds each dequantized weight
// to bf16 before the product (the rounding point of the JAX default
// quant_matmul: dequantize in f32, cast to the activation dtype); without
// it the weight stays f32 (the JAX fused MLP kernel's dot(bf16, f32)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

enum QFormat { kQInt8 = 0, kQInt4 = 1, kQFp8 = 2 };

constexpr int kQThreads = 256;
constexpr int kQTN = 64;                 // output columns per block
constexpr int kQTPR = kQTN / 8;          // threads per weight row (8 columns each)
constexpr int kQRG = kQThreads / kQTPR;  // row groups per block
constexpr int kQMaxRows = 8;             // activation rows per launch
constexpr int kQChunk = 1024;            // reduction rows per block, at most
constexpr int kQUnroll = 4;              // weight rows in flight per thread

struct QMats {
  const uint8_t* q[2];
  const float* s[2];
  int n[2];
  int tiles[2];
  int col0[2];
};

__device__ __forceinline__ float fp8_to_float(uint32_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(byte);
  return float(v);
}

// The value of byte e (0..7) of raw for logical row half `hi` (int4 only:
// 0 the low nibble, 1 the high one).
template <int FMT>
__device__ __forceinline__ float q_value(uint2 raw, int e, int hi) {
  const uint32_t word = e < 4 ? raw.x : raw.y;
  const uint32_t byte = (word >> (8 * (e & 3))) & 0xFFu;
  if (FMT == kQInt8) return float(static_cast<int8_t>(byte));
  if (FMT == kQFp8) return fp8_to_float(byte);
  const int nib = int((byte >> (4 * hi)) & 0xFu);
  return float((nib ^ 8) - 8);
}

template <bool ROUND_W>
__device__ __forceinline__ float deq(float q, float s) {
  const float w = q * s;
  return ROUND_W ? __bfloat162float(__float2bfloat16(w)) : w;
}

QMats make_qmats(const void* q0, const void* s0, int n0, const void* q1, const void* s1,
                 int n1) {
  QMats m;
  const void* qs[2] = {q0, q1};
  const void* ss[2] = {s0, s1};
  const int ns[2] = {n0, n1};
  int col = 0;
  for (int i = 0; i < 2; ++i) {
    m.q[i] = static_cast<const uint8_t*>(qs[i]);
    m.s[i] = static_cast<const float*>(ss[i]);
    m.n[i] = ns[i];
    m.tiles[i] = (ns[i] + kQTN - 1) / kQTN;
    m.col0[i] = col;
    col += ns[i];
  }
  return m;
}

// A split of K rows into `splits` chunks of `chunk` rows: each chunk whole
// scale groups, at most kQChunk rows, none empty.
bool bad_qsplit(int K, int gs, int splits, int chunk) {
  return gs < 1 || K % gs || chunk % gs || splits < 1 || chunk < 1 || chunk > kQChunk ||
         (long long)splits * chunk < K || (long long)(splits - 1) * chunk >= K;
}

template <int FMT, bool ROUND_W>
__global__ void __launch_bounds__(kQThreads) quant_gemv_kernel(
    const __nv_bfloat16* __restrict__ x, int B, int K, int gs, int chunk, QMats mats, int ncols,
    float* __restrict__ part) {
  __shared__ __align__(16) float xs[kQMaxRows * kQChunk];   // x chunk; then the reduction
  const int tid = threadIdx.x;
  int t = blockIdx.x, m = 0;
  if (t >= mats.tiles[0]) {
    t -= mats.tiles[0];
    m = 1;
  }
  const uint8_t* __restrict__ q = mats.q[m];
  const float* __restrict__ sc = mats.s[m];
  const int N = mats.n[m];
  const int n0 = t * kQTN;
  const int s = blockIdx.y;
  const int d0 = s * chunk;
  const int rows = min(K, d0 + chunk) - d0;

  for (int i = tid; i < kQMaxRows * chunk; i += kQThreads) {
    const int b = i / chunk, d = i % chunk;
    xs[i] = (b < B && d < rows) ? __bfloat162float(x[size_t(b) * K + d0 + d]) : 0.f;
  }
  __syncthreads();

  const int lc = tid % kQTPR, rg = tid / kQTPR;
  const int c = n0 + lc * 8;
  const bool col_ok = c < N;
  float acc[kQMaxRows][8];
#pragma unroll
  for (int b = 0; b < kQMaxRows; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0.f;

  // int4 walks the packed rows of a group: each yields logical rows r and
  // r + gs/2 of the group
  const int prows = FMT == kQInt4 ? gs / 2 : gs;
  for (int g0 = 0; g0 < rows; g0 += gs) {
    const int grp = (d0 + g0) / gs;
    float scale[8];
    if (col_ok) {
      const float4 s0 = *reinterpret_cast<const float4*>(sc + size_t(grp) * N + c);
      const float4 s1 = *reinterpret_cast<const float4*>(sc + size_t(grp) * N + c + 4);
      scale[0] = s0.x, scale[1] = s0.y, scale[2] = s0.z, scale[3] = s0.w;
      scale[4] = s1.x, scale[5] = s1.y, scale[6] = s1.z, scale[7] = s1.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) scale[e] = 0.f;
    }
    const size_t prow0 = FMT == kQInt4 ? size_t(d0 + g0) / 2 : size_t(d0 + g0);
    for (int r = rg; r < prows; r += kQRG * kQUnroll) {
      uint2 raw[kQUnroll];
#pragma unroll
      for (int u = 0; u < kQUnroll; ++u) {
        const int rr = r + u * kQRG;
        raw[u] = (col_ok && rr < prows)
                     ? __ldg(reinterpret_cast<const uint2*>(q + (prow0 + rr) * N + c))
                     : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kQUnroll; ++u) {
        const int rr = r + u * kQRG;
        if (rr < prows) {
#pragma unroll
          for (int h = 0; h < (FMT == kQInt4 ? 2 : 1); ++h) {
            const float* xr = xs + g0 + rr + h * (gs / 2);
            float w[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) w[e] = deq<ROUND_W>(q_value<FMT>(raw[u], e, h), scale[e]);
#pragma unroll
            for (int b = 0; b < kQMaxRows; ++b) {
              const float xv = xr[b * chunk];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[b][e] += xv * w[e];
            }
          }
        }
      }
    }
  }

  // the row groups of one warp share columns: fold them with shuffles,
  // then the warps through shared memory
#pragma unroll
  for (int b = 0; b < kQMaxRows; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int o = kQTPR; o < 32; o <<= 1) acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], o);
  __syncthreads();   // every thread is done with the x chunk
  float* red = xs;   // [warps][kQMaxRows][kQTN]
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kQTPR) {
#pragma unroll
    for (int b = 0; b < kQMaxRows; ++b)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * kQMaxRows + b) * kQTN + lane * 8 + e] = acc[b][e];
  }
  __syncthreads();
  for (int i = tid; i < B * kQTN; i += kQThreads) {
    const int b = i / kQTN, cc = i % kQTN;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kQThreads / 32; ++wp) sum += red[(wp * kQMaxRows + b) * kQTN + cc];
    if (n0 + cc < N) part[(size_t(s) * B + b) * ncols + mats.col0[m] + n0 + cc] = sum;
  }
}

// Launch the GEMV for format `fmt` (rows B <= kQMaxRows).
template <bool ROUND_W>
cudaError_t launch_quant_gemv(int fmt, dim3 grid, cudaStream_t s, const __nv_bfloat16* x, int B,
                              int K, int gs, int chunk, const QMats& mats, int ncols,
                              float* part) {
  if (fmt == kQInt8)
    quant_gemv_kernel<kQInt8, ROUND_W><<<grid, kQThreads, 0, s>>>(x, B, K, gs, chunk, mats, ncols,
                                                                  part);
  else if (fmt == kQInt4)
    quant_gemv_kernel<kQInt4, ROUND_W><<<grid, kQThreads, 0, s>>>(x, B, K, gs, chunk, mats, ncols,
                                                                  part);
  else if (fmt == kQFp8)
    quant_gemv_kernel<kQFp8, ROUND_W><<<grid, kQThreads, 0, s>>>(x, B, K, gs, chunk, mats, ncols,
                                                                 part);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace
