// Weight-only quantized matmul for Hopper (sm_90a): out [M, N] bf16 =
// x [M, K] bf16 @ dequantize(q, scales), behind a plain C interface loaded
// with ctypes (ops/_build.py builds this file with nvcc at first use).
//
// Replaces the TPU kernel
//   shuffle_exchange_tpu/ops/quant_matmul.py:_quant_matmul_pallas
// and, on the card, the JAX default path it stands beside (dequantize into
// the dot, which XLA fuses so the weights cross HBM at storage width).
// Storage formats (int8, packed int4, e4m3 fp8, f32 scales [K/gs, N]):
// see quant_gemv.cuh.
//
// Rounding: each weight is dequantized as q * s in f32 and rounded to bf16
// before the product, the JAX default's rounding point; products are
// summed in f32 and the result cast once. The kernel then differs from
// quant_matmul_reference (ops/quant_matmul.py) in summation order only.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode rows
// (M <= 8) the weight bytes, 1 byte an element (half of one for int4) plus
// 4 / gs of scales: 16.8 MB for Llama-3-8B's [4096, 4096] int8 wq, 5.0 us.
// Those rows take the split-K GEMV of quant_gemv.cuh (64-column tiles,
// reduction chunks of whole scale groups, enough blocks for two an SM, f32
// partials added in a fixed order by quant_out_kernel below, so two runs give
// equal bits). Above 8 rows (extend chunks, mixed ticks, a put() of 8
// prompts padded to 1024 = 8192 rows) the work turns to operations: 2 M K N
// flops, ~0.97 ms at M = 8192, K 4096, N 14336. Those rows take a tiled
// tensor-core kernel: 128 x 128 output tiles, 8 warps of 32 x 64, K steps of
// 32 rows that never cross a scale group. Each step copies the x tile and
// the raw weight tile (int8 / fp8 32 rows, int4 16 packed rows) and the
// group's scale row into shared memory with cp.async, three steps in flight,
// then all threads dequantize the raw tile into a bf16 tile, and the warps
// run mma.sync m16n8k16 (bf16, f32 accumulators) from ldmatrix fragments.
// An int4 step pairs packed rows p with logical rows p and p + gs/2 of the
// group, so its x tile takes two 16-column pieces of the group. Ragged M and
// N are masked (zero-filled loads, guarded stores); nothing is padded on the
// host. A grid of fewer tiles than the card has SMs (a tick's 256 chunk rows
// against a [4096, 1024] weight is 16 tiles) splits K across blocks: each
// split writes f32 partials that quant_out_kernel adds in split order. wgmma,
// TMA and a producer warp are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_gemv.cuh"   // formats, q_value, the split-K GEMV
#include "mma_sync.cuh"     // cp_async16, ldsm_x4, mma_bf16, ...

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kStages = 3;                // K steps in flight
constexpr int kMmaThreads = 256;          // 8 warps: 4 along M x 2 along N
constexpr int kLDA = kBK + 8;             // padded x tile row, in bf16 (80 bytes)
constexpr int kLDB = kBN + 8;             // padded bf16 weight tile row (272 bytes)

struct Stage {
  __nv_bfloat16 a[kBM * kLDA];   // x tile [128][32 + 8]
  uint8_t q[kBK * kBN];          // raw weight rows [32][128] (int4: 16 packed rows)
  float s[kBN];                  // the step's scale row
};

// Issue the copies of K step `step` into `st` (the caller commits).
template <int FMT>
__device__ __forceinline__ void load_step(Stage& st, const __nv_bfloat16* __restrict__ x,
                                          const uint8_t* __restrict__ q,
                                          const float* __restrict__ sc, int M, int K, int N,
                                          int gs, int m0, int n0, int step, int tid) {
  const int grp = step * kBK / gs;
  // the x columns of the step's two 16-row halves
  int col[2];
  if (FMT == kQInt4) {
    const int off = step * (kBK / 2) - grp * (gs / 2);   // packed row offset in the group
    col[0] = grp * gs + off;
    col[1] = col[0] + gs / 2;
  } else {
    col[0] = step * kBK;
    col[1] = col[0] + kBK / 2;
  }
  // x: 128 rows x 4 vectors of 8 bf16
  for (int i = tid; i < kBM * 4; i += kMmaThreads) {
    const int r = i / 4, v = i % 4;
    const bool ok = m0 + r < M;
    const __nv_bfloat16* src = x + size_t(ok ? m0 + r : 0) * K + col[v / 2] + (v % 2) * 8;
    cp_async16(st.a + r * kLDA + v * 8, src, ok);
  }
  // raw weight rows: 128 bytes = 8 vectors a row
  const int qrows = FMT == kQInt4 ? kBK / 2 : kBK;
  const size_t qrow0 = FMT == kQInt4 ? size_t(step) * (kBK / 2) : size_t(step) * kBK;
  for (int i = tid; i < qrows * 8; i += kMmaThreads) {
    const int r = i / 8, v = i % 8;
    const bool ok = n0 + v * 16 < N;
    cp_async16(st.q + r * kBN + v * 16, q + (qrow0 + r) * N + (ok ? n0 + v * 16 : 0), ok);
  }
  // scales: 128 f32 = 32 vectors
  if (tid < kBN / 4) {
    const bool ok = n0 + tid * 4 < N;
    cp_async16(st.s + tid * 4, sc + size_t(grp) * N + (ok ? n0 + tid * 4 : 0), ok);
  }
}

constexpr size_t kMmaSmem = kStages * sizeof(Stage) + size_t(kBK) * kLDB * sizeof(__nv_bfloat16);

// Block (column tile, row tile, K split): out (or, split, part[split]) =
// the split's K steps of x @ deq(q).
template <int FMT>
__global__ void __launch_bounds__(kMmaThreads) quant_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ sc, __nv_bfloat16* __restrict__ out, float* __restrict__ part,
    int M, int K, int N, int gs, int split_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  // the dequantized weight tile [32][136]
  __nv_bfloat16* bt = reinterpret_cast<__nv_bfloat16*>(smem + kStages * sizeof(Stage));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int wm = warp % 4, wn = warp / 4;    // warp tile: rows wm*32, columns wn*64
  const int s0 = blockIdx.z * split_steps;
  const int steps = min(K / kBK - s0, split_steps);

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one commit group per step, empty past the split's end, so the wait
  // below always leaves the newer kStages - 1 steps in flight
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) load_step<FMT>(stage[i], x, q, sc, M, K, N, gs, m0, n0, s0 + i, tid);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int ahead = step + kStages - 1;
    if (ahead < steps)
      load_step<FMT>(stage[ahead % kStages], x, q, sc, M, K, N, gs, m0, n0, s0 + ahead, tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Stage& st = stage[step % kStages];

    // dequantize: thread -> (row kr, 16 columns); bf16(q * s)
    {
      const int kr = tid / 8, c0 = (tid % 8) * 16;
      const int hi = FMT == kQInt4 ? kr / 16 : 0;
      const int qr = FMT == kQInt4 ? kr % 16 : kr;
      const uint4 raw = *reinterpret_cast<const uint4*>(st.q + qr * kBN + c0);
      const uint2 lo2 = make_uint2(raw.x, raw.y), hi2 = make_uint2(raw.z, raw.w);
      union {
        __nv_bfloat162 h[4];
        uint4 u;
      } w0, w1;
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        w0.h[e / 2] = __floats2bfloat162_rn(q_value<FMT>(lo2, e, hi) * st.s[c0 + e],
                                            q_value<FMT>(lo2, e + 1, hi) * st.s[c0 + e + 1]);
        w1.h[e / 2] = __floats2bfloat162_rn(q_value<FMT>(hi2, e, hi) * st.s[c0 + 8 + e],
                                            q_value<FMT>(hi2, e + 1, hi) * st.s[c0 + 9 + e]);
      }
      *reinterpret_cast<uint4*>(bt + kr * kLDB + c0) = w0.u;
      *reinterpret_cast<uint4*>(bt + kr * kLDB + c0 + 8) = w1.u;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], st.a + (wm * 32 + i * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLDA +
                           kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, bt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLDB + wn * 64 +
                             np * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * np], af[i], r[0], r[1]);
          mma_bf16(acc[i][2 * np + 1], af[i], r[2], r[3]);
        }
      }
    }
    __syncthreads();   // done with this stage and the bf16 tile before they are refilled
  }

  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn * 64 + j * 8 + tq * 2;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + h * 8;
        if (row >= M) continue;
        if (part == nullptr)
          *reinterpret_cast<__nv_bfloat162*>(out + size_t(row) * N + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        else
          *reinterpret_cast<float2*>(part + (size_t(blockIdx.z) * M + row) * N + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// Sum of split partials [S, B, N] in split order, cast to bf16.
__global__ void quant_out_kernel(const float* __restrict__ part, int S, int B, int N,
                                 __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += part[size_t(s) * B * N + i];
  out[i] = __float2bfloat16(sum);
}

template <int FMT>
cudaError_t launch_mma(cudaStream_t s, const __nv_bfloat16* x, const uint8_t* q, const float* sc,
                       __nv_bfloat16* out, float* part, int M, int K, int N, int gs, int splits,
                       int split_steps) {
  const cudaError_t err = cudaFuncSetAttribute(
      quant_mma_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kMmaSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  quant_mma_kernel<FMT><<<grid, kMmaThreads, kMmaSmem, s>>>(x, q, sc, out, part, M, K, N, gs,
                                                            split_steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sxt_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [M, N] bf16 = x [M, K] bf16 @ (q * scales) with format fmt (0 int8,
// 1 packed int4, 2 e4m3) and group size gs. The reduction over K runs in
// `splits` chunks of `chunk` rows, with f32 partials in part [splits, M, N]
// (unused when splits is 1 above 8 rows). M <= 8 runs the GEMV, whose chunks
// are whole groups; larger M the tensor-core kernel, whose chunks are whole
// 32-row steps. Needs K % gs == 0, gs % 32 == 0 and N % 16 == 0.
int sxt_quant_matmul_bf16(const void* x, const void* q, const void* scales, void* out,
                          void* part, int M, int K, int N, int gs, int fmt, int splits, int chunk,
                          void* stream) {
  if (M <= 0) return 0;
  if (gs % 32 || K % gs || N % 16 || fmt < 0 || fmt > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const float*>(scales);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M <= kQMaxRows) {
    if (part == nullptr || bad_qsplit(K, gs, splits, chunk))
      return static_cast<int>(cudaErrorInvalidValue);
    const QMats mats = make_qmats(q, scales, N, nullptr, nullptr, 0);
    const cudaError_t err =
        launch_quant_gemv<true>(fmt, dim3(mats.tiles[0], splits), s, xp, M, K, gs, chunk, mats,
                                N, static_cast<float*>(part));
    if (err != cudaSuccess) return static_cast<int>(err);
    quant_out_kernel<<<(M * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), splits,
                                                         M, N, op);
    return static_cast<int>(cudaGetLastError());
  }
  if (chunk % kBK || splits < 1 || (long long)splits * chunk < K ||
      (long long)(splits - 1) * chunk >= K || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  cudaError_t err;
  if (fmt == kQInt8)
    err = launch_mma<kQInt8>(s, xp, qp, sp, op, pp, M, K, N, gs, splits, chunk / kBK);
  else if (fmt == kQInt4)
    err = launch_mma<kQInt4>(s, xp, qp, sp, op, pp, M, K, N, gs, splits, chunk / kBK);
  else
    err = launch_mma<kQFp8>(s, xp, qp, sp, op, pp, M, K, N, gs, splits, chunk / kBK);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  quant_out_kernel<<<(M * N + 255) / 256, 256, 0, s>>>(pp, splits, M, N, op);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
