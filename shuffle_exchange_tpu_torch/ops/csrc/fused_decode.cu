// The fused decode layer for Hopper (sm_90a): QKV projection + biases +
// RoPE (+ the pool append, when a pool is given), split-K paged
// flash-decode (with ALiBi slopes), and norm + MLP + residual over bf16 or
// quantized weights, behind a plain C interface loaded with
// ctypes (ops/_build.py builds this file with nvcc at first use). Each C
// entry point launches all of its kernels on the caller's stream and
// returns cudaGetLastError().
//
// Replaces the TPU kernels
//   shuffle_exchange_tpu/ops/fused_decode.py:fused_qkv_rope_pallas
//   shuffle_exchange_tpu/ops/fused_decode.py:fused_paged_decode_attention_pallas
//   shuffle_exchange_tpu/ops/fused_decode.py:fused_mlp_pallas
//   shuffle_exchange_tpu/ops/fused_decode.py:fused_mlp_quant_pallas
//
// Layouts (all contiguous, bf16 unless noted):
//   y, resid      [B, D] activation rows (one token per sequence)
//   wq, wk, wv    [D, H*Dh], [D, KV*Dh], [D, KV*Dh]   (stored [in, out])
//   w_gate, w_up  [D, F];  w_down [F, D];  ln_w, ln_b [D]
//   bq, bk, bv    [H*Dh], [KV*Dh], [KV*Dh] (null: no q/k/v biases)
//   b_up, b_down  [F], [D] (null: no fc biases)
//   cos, sin      [B, rd/2] f32 rope rows at each row's position, rd <= Dh
//                 the rotated columns of a head (rd < Dh: partial rotary,
//                 GPT-NeoX / Pythia; the rest pass through; null: no RoPE,
//                 the learned-position and ALiBi families)
//   slopes        [H] f32 ALiBi slopes (null: none)
//   pool k / v    one layer [nblk, KV, bs, Dh] (the QKV append: bf16; the
//                 split-K decode: bf16, or int8 / e4m3 with f32 scale planes
//                 k_scale / v_scale [nblk, KV, bs]);  table [B, W] int32
//                 (-1 is read as block 0);  pos / kv_len [B] int32
//
// What bounds them on the H100 (3.35 TB/s, 989 TFLOP/s bf16): the QKV and
// MLP products multiply at most 8 rows by each weight, 2 flops per weight
// byte against the card's ~295 flop/byte ridge, so their bound is the
// weight bytes: 50.3 MB a Llama-3-8B layer for QKV (15.0 us), 352.3 MB for
// the MLP (105.2 us); GPT-J-6B's MLP without its norm (D 4096, F 16384,
// fc biases) 268.5 MB (80.1 us). The design question is how to keep enough SMs
// reading. Answer: a skinny-GEMV kernel (gemv_partial_kernel) tiles the
// output columns by 64 AND splits the reduction dimension into chunks of
// at most 1024 rows, so a Llama layer gives 384 (QKV), 1,792 (gate/up) and
// 896 (down) blocks, several per SM. Each thread streams one 16-byte
// vector (8 columns) of a weight row, four rows in flight, and keeps the
// f32 sums of 8 columns x 8 activation rows in registers; the activation
// chunk sits in shared memory as f32. A block writes its f32 partial sums
// (6.3 MB a Llama layer at 8 rows, written once and read once: about 3% of
// the weight bytes); a small epilogue
// kernel adds the partials in a fixed order (results do not change from
// run to run) and applies what follows: RoPE and the pool append for QKV,
// silu(g)*u for the MLP's first half, the residual for its second half.
// Batches above 8 rows run in groups of 8 (the weights are read once per
// group).
//
// Split-K decode attention is bound by the K/V bytes it reads, as the
// paged decode kernel (B2) in paged_attention.cu is, and below ~10 us by
// latency: how many SMs a launch keeps busy and how fast each block gets
// its tiles. Its first design (dot products in f32 on the CUDA cores, one
// thread per output element walking every staged key for P V, a wide group
// cut into head chunks that each re-read the kv head's tiles, a second
// launch to merge) ran at 1.2-2.6x one SDPA call. It now runs B2's decode
// body (paged_decode.cuh: decode_split), over JAX's table-entry splits:
// one block per (sequence, kv head, split) holds the whole query-head group
// (Q as bf16 rows padded to 16-row MMA tiles; past 128 heads at head_dim
// <= 96, or 64 above, the block walks its split again for the next heads),
// 64-position K/V tiles come through the block table by cp.async into a
// double buffer and are read once by every head, S = Q K^T and O += P V are
// m16n8k16 MMAs with f32 accumulators, the softmax runs in the log2 domain
// with ALiBi's slope * j added in f32 at the logical position j, and P
// enters P V as bf16 hi + lo terms. One-byte pools are staged at storage
// width and widened to bf16 in shared memory (exact); the K row scale
// multiplies S's column and the V row scale P's column, in f32. The merge
// folds into the kernel: the last split of each (sequence, kv head) to
// finish merges all of its live splits in split order (B5's formula, base
// 2: m_g = max m, w = 2^(m - m_g), out = sum(w * acc) / max(sum(w * l),
// 1e-30)), found through a per-(sequence, kv head) counter that it resets
// for the next call; a sequence in one split writes its output directly.
// That saves a launch where the grid is about one wave and the partials
// are few. One block reading a wide group's partials in series is slower
// than a second launch over the whole card (1.6x at Falcon-7B's 71 heads of
// 64 in 16 splits), and past ~4 blocks an SM the fold ran up to 5% slower, so
// the wrapper passes the counters only up to 16K partial values a
// (sequence, kv head) and 4 blocks an SM (ops/fused_decode.py: folds), and
// without them group_merge_kernel merges.
// The wrapper picks the split count from B2's rule (attention_splits).
//
// Rounding points (those of the TPU kernels): QKV sums in f32, the bias
// added in f32 (bf16 biases read exactly), RoPE in f32, one cast to bf16,
// and the pool gets the cast value; the MLP normalises with f32 statistics
// (RMSNorm, or layernorm with the population variance and its bias) and
// rounds yn to bf16, or takes yn = y as given (norm "none", the shared
// layernorm of GPT-J's parallel blocks: y is already that norm's bf16
// output, which is where the TPU kernel rounds it), sums the products in f32, adds the up bias in f32,
// rounds a = act(g)*u (gated) or act(u) to bf16, sums the down product in
// f32, adds the residual and then the down bias in f32 and casts once.
// The activations are those of the TPU kernel's FUSABLE_ACTIVATIONS: silu
// (swiglu when gated), relu and the tanh gelu (gelu_new,
// gelu_pytorch_tanh). In the bf16 GEMVs, tensor-core MMA, TMA and
// pipelining are later work.
//
// The quantized MLP (int8 / packed int4 / e4m3 weights with f32 scales per
// (K-group, column), the storage of ops/quant_matmul.py) has the same norm,
// gate and activation forms, without fc biases, on mma_gemv.cuh's
// tensor-core GEMV (the CUDA-core split-K GEMV of quant_gemv.cuh it replaced,
// in five launches, reached 21% of the bound): two launches a pass of
// up to 16 rows. The up GEMV normalises its rows into the A operand (each
// block computes the rows' statistics itself, in a fixed order), multiplies
// by [w_gate | w_up] (or w_up alone, the plain MLP) and writes a =
// bf16(act(g) * u); the down GEMV multiplies a by w_down and adds the
// residual. Split chunks fold in the tile's last block, in split order.
// The weights are read at storage width and widened to bf16 exactly; each
// scale group's products x * q are summed in f32 on the tensor cores and
// the group sum is multiplied by its f32 scale, so q * s is never rounded
// (the JAX kernel's weight blocks stay f32 and dot(bf16, f32) promotes):
// only yn and a are rounded to bf16. Its bound at 8
// rows of Llama-3-8B is the weight bytes: 176.2 MB of int8 and 2.8 MB of
// scales at group 256, 53.4 us (int4 and its scales: 27.1 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "paged_decode.cuh"  // pdec::decode_split (B2's decode body), merge_partials
#include "paged_tile.cuh"    // TK, kNeg, storage kinds, converters
#include "mma_gemv.cuh"      // tcg:: the tensor-core GEMV (B7's products; shared with B16)
#include "quant_gemv.cuh"    // kQInt8 / kQInt4 / kQFp8

namespace {

// ---------------------------------------------------------------------------
// Skinny GEMV with a split reduction: part[s, b, col0 + n] =
//   sum over d in chunk s of x[b, d] * W[d, n], for one 64-column tile.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTN = 64;                 // output columns per block
constexpr int kTPR = kTN / 8;           // threads per weight row (8 columns each)
constexpr int kRG = kThreads / kTPR;    // row groups per block
constexpr int kMaxRows = 8;             // activation rows per launch
constexpr int kChunk = 1024;            // reduction rows per block, at most
constexpr int kUnroll = 4;              // weight rows in flight per thread

// Up to three weight matrices that share x; the blocks' x index walks
// their column tiles in order, and each matrix's columns land at col0 in
// the partial sums' column space.
struct Mats {
  const __nv_bfloat16* w[3];
  int n[3];
  int tiles[3];
  int col0[3];
};

__global__ void __launch_bounds__(kThreads) gemv_partial_kernel(
    const __nv_bfloat16* __restrict__ x, int B, int K, int chunk, Mats mats, int ncols,
    float* __restrict__ part) {
  __shared__ __align__(16) float xs[kMaxRows * kChunk];   // x chunk; then the reduction
  const int tid = threadIdx.x;
  int t = blockIdx.x, m = 0;
  while (m < 2 && t >= mats.tiles[m]) {
    t -= mats.tiles[m];
    ++m;
  }
  const __nv_bfloat16* __restrict__ w = mats.w[m];
  const int N = mats.n[m];
  const int n0 = t * kTN;
  const int s = blockIdx.y;
  const int d0 = s * chunk;
  const int rows = min(K, d0 + chunk) - d0;

  for (int i = tid; i < kMaxRows * chunk; i += kThreads) {
    const int b = i / chunk, d = i % chunk;
    xs[i] = (b < B && d < rows) ? __bfloat162float(x[size_t(b) * K + d0 + d]) : 0.f;
  }
  __syncthreads();

  const int lc = tid % kTPR, rg = tid / kTPR;
  const int c = n0 + lc * 8;
  const bool col_ok = c < N;
  const __nv_bfloat16* __restrict__ wcol = w + size_t(d0) * N + c;
  float acc[kMaxRows][8];
#pragma unroll
  for (int b = 0; b < kMaxRows; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0.f;

  for (int r = rg; r < rows; r += kRG * kUnroll) {
    uint4 wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * kRG;
      wv[u] = (col_ok && rr < rows)
                  ? __ldg(reinterpret_cast<const uint4*>(wcol + size_t(rr) * N))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * kRG;
      if (rr < rows) {
        float wf[8];
        bf16x8_to_float(wv[u], wf);
#pragma unroll
        for (int b = 0; b < kMaxRows; ++b) {
          const float xv = xs[b * chunk + rr];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[b][e] += xv * wf[e];
        }
      }
    }
  }

  // the row groups of one warp share columns: fold them with shuffles,
  // then the warps through shared memory
#pragma unroll
  for (int b = 0; b < kMaxRows; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int o = kTPR; o < 32; o <<= 1)
        acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], o);
  __syncthreads();   // every thread is done with the x chunk
  float* red = xs;   // [warps][kMaxRows][kTN]
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kTPR) {
#pragma unroll
    for (int b = 0; b < kMaxRows; ++b)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * kMaxRows + b) * kTN + lane * 8 + e] = acc[b][e];
  }
  __syncthreads();
  for (int i = tid; i < B * kTN; i += kThreads) {
    const int b = i / kTN, cc = i % kTN;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kThreads / 32; ++wp) sum += red[(wp * kMaxRows + b) * kTN + cc];
    if (n0 + cc < N) part[(size_t(s) * B + b) * ncols + mats.col0[m] + n0 + cc] = sum;
  }
}

// Sum of the split partials of one column, in split order.
__device__ __forceinline__ float sum_splits(const float* __restrict__ part, int S, int B,
                                            int ncols, int b, int col) {
  float x = 0.f;
  for (int s = 0; s < S; ++s) x += part[(size_t(s) * B + b) * ncols + col];
  return x;
}

// ---------------------------------------------------------------------------
// QKV epilogue: block (row b, head of [q heads | k heads | v heads]), Dh
// threads. Adds the partials and the head's bias, applies rotate-half RoPE
// in f32 to the first rd columns of q and k when cos is given (the partner
// of column d < rd is d +- rd/2 of the same head; columns >= rd pass
// through), casts, writes q/k/v and, given a pool, appends k/v to it at
// (table[b, pos/bs], h, pos % bs).
// ---------------------------------------------------------------------------

__global__ void qkv_epilogue_kernel(
    const float* __restrict__ part, int S, int B, int ncols, const __nv_bfloat16* __restrict__ bq,
    const __nv_bfloat16* __restrict__ bk, const __nv_bfloat16* __restrict__ bv,
    const float* __restrict__ cos, const float* __restrict__ sin, const int* __restrict__ table,
    const int* __restrict__ pos, __nv_bfloat16* __restrict__ pool_k,
    __nv_bfloat16* __restrict__ pool_v, __nv_bfloat16* __restrict__ q,
    __nv_bfloat16* __restrict__ k, __nv_bfloat16* __restrict__ v, int H, int KV, int Dh, int rd,
    int bs, int W) {
  extern __shared__ float xh[];   // [Dh]
  const int b = blockIdx.x, head = blockIdx.y, d = threadIdx.x;
  float x = sum_splits(part, S, B, ncols, b, head * Dh + d);
  const bool is_v = head >= H + KV;
  if (bq != nullptr) {   // the three biases go together
    const __nv_bfloat16* bias = head < H ? bq + head * Dh
                                : is_v   ? bv + (head - H - KV) * Dh
                                         : bk + (head - H) * Dh;
    x += __bfloat162float(bias[d]);
  }
  if (!is_v && cos != nullptr) {   // uniform over the block: the sync is safe
    xh[d] = x;
    __syncthreads();
    if (d < rd) {
      const int half = rd / 2;
      const float c = cos[b * half + d % half], sn = sin[b * half + d % half];
      x = d < half ? x * c - xh[d + half] * sn : x * c + xh[d - half] * sn;
    }
  }
  const __nv_bfloat16 o = __float2bfloat16(x);
  if (head < H) {
    q[(size_t(b) * H + head) * Dh + d] = o;
    return;
  }
  const int h = is_v ? head - H - KV : head - H;
  (is_v ? v : k)[(size_t(b) * KV + h) * Dh + d] = o;
  if (pool_k == nullptr) return;   // no pool: q/k/v only
  const int p = pos[b];
  int blk = table[size_t(b) * W + min(p / bs, W - 1)];
  blk = blk < 0 ? 0 : blk;
  (is_v ? pool_v : pool_k)[((size_t(blk) * KV + h) * bs + p % bs) * Dh + d] = o;
}

// ---------------------------------------------------------------------------
// MLP pieces: the row norm (f32 statistics, yn rounded to bf16), the
// activation epilogue (a = bf16(act(g) * u) gated, bf16(act(u)) not) and
// the residual epilogue.
// ---------------------------------------------------------------------------

enum NormKind { kRmsNorm = 0, kLayerNorm = 1, kNoNorm = 2 };
enum Act { kSilu = 0, kRelu = 1, kGeluTanh = 2 };

// Sum of one value over the block's threads, returned to all of them.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();   // red may still be read from a previous call
  if (tid % 32 == 0) red[tid / 32] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += red[i];
  return total;
}

// RMSNorm: x * rsqrt(mean(x^2) + eps) * w. Layernorm: (x - mean) *
// (1 / sqrt(var + eps)) * w + b with the population variance (the TPU
// kernel's jnp.var), mean and variance in two passes over the row; b may
// be null (a zero bias).
__global__ void __launch_bounds__(kThreads) norm_rows_kernel(
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ yn, int D, float eps,
    int kind) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const __nv_bfloat16* row = y + size_t(b) * D;
  if (kind == kRmsNorm) {
    float ss = 0.f;
    for (int i = tid; i < D; i += kThreads) {
      const float xv = __bfloat162float(row[i]);
      ss += xv * xv;
    }
    const float inv = rsqrtf(block_sum(ss, red) / D + eps);
    for (int i = tid; i < D; i += kThreads)
      yn[size_t(b) * D + i] =
          __float2bfloat16(__bfloat162float(row[i]) * inv * __bfloat162float(w[i]));
    return;
  }
  float sx = 0.f;
  for (int i = tid; i < D; i += kThreads) sx += __bfloat162float(row[i]);
  const float mean = block_sum(sx, red) / D;
  float sd = 0.f;
  for (int i = tid; i < D; i += kThreads) {
    const float dv = __bfloat162float(row[i]) - mean;
    sd += dv * dv;
  }
  const float inv = 1.f / sqrtf(block_sum(sd, red) / D + eps);
  for (int i = tid; i < D; i += kThreads) {
    const float bv = bias != nullptr ? __bfloat162float(bias[i]) : 0.f;
    yn[size_t(b) * D + i] = __float2bfloat16(
        (__bfloat162float(row[i]) - mean) * inv * __bfloat162float(w[i]) + bv);
  }
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kRelu) return fmaxf(x, 0.f);
  if (act == kGeluTanh)
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return x / (1.f + expf(-x));   // silu
}

// Partials [S, B, 2F] (gated: g in [0, F), u in [F, 2F)) or [S, B, F]
// (u only); b_up may be null.
__global__ void act_epilogue_kernel(const float* __restrict__ part, int S, int B, int F,
                                    int gated, int act, const __nv_bfloat16* __restrict__ b_up,
                                    __nv_bfloat16* __restrict__ a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * F) return;
  const int b = i / F, n = i % F;
  const int ncols = gated ? 2 * F : F;
  float u = sum_splits(part, S, B, ncols, b, gated ? F + n : n);
  if (b_up != nullptr) u += __bfloat162float(b_up[n]);
  a[i] = __float2bfloat16(gated ? activate(sum_splits(part, S, B, ncols, b, n), act) * u
                                : activate(u, act));
}

// out = resid + down + b_down (b_down may be null), in f32, one cast.
__global__ void residual_epilogue_kernel(const float* __restrict__ part, int S, int B, int D,
                                         const __nv_bfloat16* __restrict__ resid,
                                         const __nv_bfloat16* __restrict__ b_down,
                                         __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * D) return;
  float o = __bfloat162float(resid[i]) + sum_splits(part, S, B, D, i / D, i % D);
  if (b_down != nullptr) o += __bfloat162float(b_down[i % D]);
  out[i] = __float2bfloat16(o);
}

// ---------------------------------------------------------------------------
// The quantized MLP (B7) on mma_gemv.cuh's tensor-core GEMV: a pass of up to
// 16 rows is two launches. mma_gemv_mlp_up_kernel normalises the rows on the
// way into the A operand (every block the same statistics, in the same
// order), multiplies by w_gate and w_up (a tile: 128 columns of each, warps
// 0-3 the gate's, 4-7 the up matrix's; plain: w_up alone) and writes a =
// bf16(act(g) * u)
// (plain: bf16(act(u))), folding its split partials in the tile's last
// block. mma_gemv_mlp_down_kernel multiplies a by w_down and writes
// bf16(resid + down), folded likewise.
// ---------------------------------------------------------------------------

struct MlpQuantCall {
  const __nv_bfloat16* y;      // the pass's rows [B, D]
  const __nv_bfloat16* ln_w;
  const __nv_bfloat16* ln_b;   // null: no layernorm bias
  const __nv_bfloat16* resid;  // [B, D]
  const uint8_t* qg;           // null: the plain MLP
  const uint8_t* qu;
  const uint8_t* qd;
  const float* sg;
  const float* su;
  const float* sd;
  __nv_bfloat16* a;            // [B, F]
  __nv_bfloat16* out;          // [B, D]
  float* part1;                // [s1, B, 2F] (plain: [s1, B, F]); null with one split
  float* part2;                // [s2, B, D]; null with one split
  int* counters;               // a tile each, zero between calls
  int B, D, F, gs, s1, c1, s2, c2, act;
  float eps;
};

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mean and 1 / std of rows [0, B) (RMSNorm: mean 0, rsqrt(mean(x^2) + eps);
// layernorm: 1 / sqrt(var + eps), the population variance in a second pass):
// warp w takes rows w, w + 8; a lane sums its 8-column pieces in order, the
// warp adds the lanes by shuffles.
template <int NORM>
__device__ __forceinline__ void row_stats(const __nv_bfloat16* __restrict__ y, int B, int D,
                                          float eps, float* mean, float* inv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < B; r += tcg::kWarps) {
    const __nv_bfloat16* row = y + size_t(r) * D;
    float sum = 0.f;
    for (int k = 8 * lane; k < D; k += 256) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack2(w[i]);
        sum += NORM == kRmsNorm ? f.x * f.x : f.x;
        sum += NORM == kRmsNorm ? f.y * f.y : f.y;
      }
    }
    sum = warp_sum(sum);
    float m = 0.f, iv;
    if (NORM == kRmsNorm) {
      iv = rsqrtf(sum / D + eps);
    } else {
      m = sum / D;
      float sd = 0.f;
      for (int k = 8 * lane; k < D; k += 256) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = unpack2(w[i]);
          sd += (f.x - m) * (f.x - m);
          sd += (f.y - m) * (f.y - m);
        }
      }
      iv = 1.f / sqrtf(warp_sum(sd) / D + eps);
    }
    if (lane == 0) {
      mean[r] = m;
      inv[r] = iv;
    }
  }
}

// The first GEMV's A operand: rows of y normalised as norm_rows_kernel does
// (RMSNorm: x * inv * w; layernorm: (x - mean) * inv * w + b), rounded to
// bf16.
template <int NORM>
struct RowsNormed {
  const __nv_bfloat16* y;
  const __nv_bfloat16* w;
  const __nv_bfloat16* b;
  const float* mean;
  const float* inv;
  int ld, rows;

  __device__ __forceinline__ uint32_t norm2(int r, uint32_t yv, uint32_t wv, uint32_t bv) const {
    const float2 f = unpack2(yv), g = unpack2(wv), h = unpack2(bv);
    if (NORM == kRmsNorm)
      return tcg::pack2(f.x * inv[r] * g.x, f.y * inv[r] * g.y);
    return tcg::pack2((f.x - mean[r]) * inv[r] * g.x + h.x, (f.y - mean[r]) * inv[r] * g.y + h.y);
  }
  // the normalised pair at columns k, k + 1 of row r (k even)
  __device__ __forceinline__ uint32_t load2(int r, int k) const {
    if (r >= rows) return 0u;
    const uint32_t yv = __ldg(reinterpret_cast<const uint32_t*>(y + size_t(r) * ld + k));
    const uint32_t wv = __ldg(reinterpret_cast<const uint32_t*>(w + k));
    const uint32_t bv = b != nullptr ? __ldg(reinterpret_cast<const uint32_t*>(b + k)) : 0u;
    return norm2(r, yv, wv, bv);
  }
};

// The items of one of the MLP's GEMVs: (split, 128-column tile), the tile
// fastest. In the gated up GEMV warps 0-3 multiply the gate's tile and
// warps 4-7 the same tile of the up matrix, each a quarter of the chunk.
template <class Rows>
struct MlpGemv {
  const CUtensorMap* m0;   // the matrix's map (the gated up GEMV: the gate's)
  const CUtensorMap* m1;   // the up matrix's map (the gated up GEMV's warps 4-7)
  const float* s0;
  const float* s1;
  Rows xr;
  int items, N, K, gs, splits, chunk, tiles, parts;   // parts: 8, or 4 (gated)

  __device__ int units(int item) const { return tcg::chunk_stages(item / tiles, chunk, K); }
  __device__ tcg::Geo geo(int item, int lane, int warp) const {
    tcg::Geo g;
    g.tile = item % tiles;
    g.split = item / tiles;
    g.map = parts == 4 && warp >= 4 ? m1 : m0;
    g.c0 = g.tile * tcg::kTileCols;
    g.batch = 0;
    g.col = g.c0 + tcg::kLaneCols * (lane >> 2);
    g.s = nullptr;
    g.col_ok = g.col < N;
    g.u0 = g.split * chunk / tcg::kStageRows;
    g.row0 = 0;
    g.rows = xr.rows;
    g.grp = 0;
    return g;
  }
  __device__ Rows rows_of(const tcg::Geo&) const { return xr; }
  // scales of scale group `grp` for the lane's accumulator columns 32 t + 16 e + j
  __device__ const float* fold_scales(const tcg::Geo& g, int lane, int warp, int grp,
                                      int e) const {
    const int col = g.c0 + tcg::kLaneCols * (2 * (lane & 3) + e);
    return col < N ? (parts == 4 && warp >= 4 ? s1 : s0) + size_t(grp) * N + col : nullptr;
  }
};

// a = bf16(act(g) * u) (gated) or bf16(act(u)) for rows [0, c.B) of y
// normalised (NORM) over [w_gate | w_up].
template <int FMT, int NORM>
__global__ void __launch_bounds__(tcg::kThreads, 1) mma_gemv_mlp_up_kernel(
    const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
    const MlpQuantCall c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tcg::Smem sm = tcg::smem_layout(smem_raw);
  float *red = sm.red, *mean = sm.mean, *inv = sm.inv;
  int* flag = sm.meta;
  const bool gated = c.qg != nullptr;
  const int F = c.F, B = c.B, splits = c.s1;
  const int tiles = (F + tcg::kTileCols - 1) / tcg::kTileCols;
  using Rows = typename std::conditional<NORM == kNoNorm, tcg::RowsPlain, RowsNormed<NORM>>::type;
  Rows xr;
  if constexpr (NORM == kNoNorm)
    xr = tcg::RowsPlain{c.y, c.D, B, c.D};
  else
    xr = RowsNormed<NORM>{c.y, c.ln_w, NORM == kLayerNorm ? c.ln_b : nullptr, mean, inv, c.D, B};
  const MlpGemv<Rows> p{&map0, &map1, gated ? c.sg : c.su, c.su, xr, splits * tiles, F, c.D,
                        c.gs, splits, c.c1, tiles, gated ? tcg::kWarps / 2 : tcg::kWarps};
  auto pre = [&] {
    if constexpr (NORM != kNoNorm) {
      row_stats<NORM>(c.y, B, c.D, c.eps, mean, inv);
      __syncthreads();
    }
  };
  auto done = [&](int, const tcg::Geo& g, const float (&acc)[16][4]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __syncthreads();   // the last item's sums are read
    tcg::write_red<FMT>(red, warp, lane, acc, B);
    __syncthreads();
    // gated: the gate's sums are warps 0-3's, the up matrix's warps 4-7's
    const int ncols = gated ? 2 * F : F, half = tcg::kWarps / 2;
    if (splits > 1) {
      for (int i = threadIdx.x; i < B * tcg::kTileCols; i += tcg::kThreads) {
        const int r = i / tcg::kTileCols, t = i % tcg::kTileCols, n = g.c0 + t;
        if (n >= F) continue;
        float* row = c.part1 + (size_t(g.split) * B + r) * ncols;
        if (gated) {
          row[n] = tcg::red_sum(red, r, t, 0, half);
          row[F + n] = tcg::red_sum(red, r, t, half, tcg::kWarps);
        } else {
          row[n] = tcg::red_sum(red, r, t);
        }
      }
      if (!tcg::last_of_tile(c.counters + g.tile, splits, flag)) return;
    }
    for (int i = threadIdx.x; i < B * tcg::kTileCols; i += tcg::kThreads) {
      const int r = i / tcg::kTileCols, t = i % tcg::kTileCols, n = g.c0 + t;
      if (n >= F) continue;
      float gv = 0.f, u = 0.f;
      if (splits == 1) {
        u = gated ? tcg::red_sum(red, r, t, half, tcg::kWarps) : tcg::red_sum(red, r, t);
        if (gated) gv = tcg::red_sum(red, r, t, 0, half);
      } else {
#pragma unroll 4
        for (int s = 0; s < splits; ++s) {
          const float* row = c.part1 + (size_t(s) * B + r) * ncols;
          u += __ldcg(row + (gated ? F : 0) + n);
          if (gated) gv += __ldcg(row + n);
        }
      }
      c.a[size_t(r) * F + n] =
          __float2bfloat16(gated ? activate(gv, c.act) * u : activate(u, c.act));
    }
  };
  tcg::run<FMT, false, true>(p, sm, pre, done);
}

// out = bf16(resid + a @ w_down) for rows [0, c.B).
template <int FMT>
__global__ void __launch_bounds__(tcg::kThreads, 1) mma_gemv_mlp_down_kernel(
    const __grid_constant__ CUtensorMap map, const MlpQuantCall c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tcg::Smem sm = tcg::smem_layout(smem_raw);
  float* red = sm.red;
  int* flag = sm.meta;
  const int D = c.D, B = c.B, splits = c.s2;
  const int tiles = (D + tcg::kTileCols - 1) / tcg::kTileCols;
  const MlpGemv<tcg::RowsPlain> p{&map, &map, c.sd, nullptr, tcg::RowsPlain{c.a, c.F, B, c.F},
                                  splits * tiles, D, c.F, c.gs, splits, c.c2, tiles, tcg::kWarps};
  auto done = [&](int, const tcg::Geo& g, const float (&acc)[16][4]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __syncthreads();   // the last item's sums are read
    tcg::write_red<FMT>(red, warp, lane, acc, B);
    __syncthreads();
    const int cells = B * tcg::kTileCols;
    if (splits > 1) {
      for (int i = threadIdx.x; i < cells; i += tcg::kThreads) {
        const int r = i / tcg::kTileCols, t = i % tcg::kTileCols, n = g.c0 + t;
        if (n < D) c.part2[(size_t(g.split) * B + r) * D + n] = tcg::red_sum(red, r, t);
      }
      if (!tcg::last_of_tile(c.counters + g.tile, splits, flag)) return;
    }
    for (int i = threadIdx.x; i < cells; i += tcg::kThreads) {
      const int r = i / tcg::kTileCols, t = i % tcg::kTileCols, n = g.c0 + t;
      if (n >= D) continue;
      float v = 0.f;
      if (splits == 1)
        v = tcg::red_sum(red, r, t);
      else
#pragma unroll 4
        for (int s = 0; s < splits; ++s) v += __ldcg(c.part2 + (size_t(s) * B + r) * D + n);
      c.out[size_t(r) * D + n] = __float2bfloat16(__bfloat162float(c.resid[size_t(r) * D + n]) + v);
    }
  };
  tcg::run<FMT, false, true>(p, sm, [] {}, done);
}

// The map of a [K, N] weight's storage (int4: [K / 2, N] packed rows) in
// one-byte boxes of 32 rows (int4: 16 packed rows) of 128 columns.
cudaError_t mlp_map(CUtensorMap* map, const uint8_t* q, int fmt, int K, int N) {
  const bool int4 = fmt == kQInt4;
  return tcg::box_map(map, q, false, 1, int4 ? K / 2 : K, N, int4 ? 16 : tcg::kStageRows,
                      tcg::kTileCols);
}

// One pass of up to 16 rows: the up GEMV (its norm form), then the down GEMV.
template <int FMT>
cudaError_t mlp_quant_pass(const MlpQuantCall& c, int norm, int blocks1, int blocks2,
                           cudaStream_t s) {
  const bool gated = c.qg != nullptr;
  CUtensorMap m0, m1, md;
  cudaError_t err = mlp_map(&m0, gated ? c.qg : c.qu, FMT, c.D, c.F);
  if (err == cudaSuccess) err = mlp_map(&m1, c.qu, FMT, c.D, c.F);
  if (err == cudaSuccess) err = mlp_map(&md, c.qd, FMT, c.F, c.D);
  if (err != cudaSuccess) return err;
  auto up = norm == kRmsNorm     ? mma_gemv_mlp_up_kernel<FMT, kRmsNorm>
            : norm == kLayerNorm ? mma_gemv_mlp_up_kernel<FMT, kLayerNorm>
                                 : mma_gemv_mlp_up_kernel<FMT, kNoNorm>;
  err = cudaFuncSetAttribute(up, cudaFuncAttributeMaxDynamicSharedMemorySize, tcg::kSmemBytes);
  if (err != cudaSuccess) return err;
  up<<<blocks1, tcg::kThreads, tcg::kSmemBytes, s>>>(m0, m1, c);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mma_gemv_mlp_down_kernel<FMT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, tcg::kSmemBytes);
  if (err != cudaSuccess) return err;
  mma_gemv_mlp_down_kernel<FMT><<<blocks2, tcg::kThreads, tcg::kSmemBytes, s>>>(md, c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Split-K paged decode: block (sequence b, kv head, split s), 128 threads,
// over positions [s * spb * bs, min((s + 1) * spb * bs, kv_len)): the table
// entries [s * spb, (s + 1) * spb) of JAX's num_splits. The body is
// paged_decode.cuh's decode_split, B2's: the whole query-head group of the
// kv head in one block, tensor cores, each K/V tile staged once. Given the
// counters, the last live split of each (sequence, kv head) merges the
// partials (FOLD); without them group_merge_kernel does, in a second
// launch.
// ---------------------------------------------------------------------------

template <int DH, int KIND, bool KSPLIT>
__global__ void __launch_bounds__(pdec::kThreads) group_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpool,
    const void* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ kv_len, const float* __restrict__ slopes,
    __nv_bfloat16* __restrict__ out, float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int* __restrict__ counters, int H, int KV, int bs, int W,
    int split_len, float scale) {
  pdec::decode_split<DH, KIND, KSPLIT, true>(q, kpool, vpool, kscale, vscale, table, kv_len,
                                             slopes, out, o_part, m_part, l_part, counters, H, KV,
                                             bs, W, split_len, scale);
}

// Merge of the splits without the counters: block (b, h), Dh threads.
__global__ void group_merge_kernel(const float* __restrict__ o_part,
                                   const float* __restrict__ m_part,
                                   const float* __restrict__ l_part,
                                   const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
                                   int S, int H, int Dh, int cap, int split_len) {
  pdec::merge_partials(o_part, m_part, l_part, kv_len, out, S, H, Dh, cap, split_len, blockIdx.x,
                       blockIdx.y, threadIdx.x);
}


Mats make_mats(const void* w0, int n0, const void* w1, int n1, const void* w2, int n2) {
  Mats m;
  const void* ws[3] = {w0, w1, w2};
  const int ns[3] = {n0, n1, n2};
  int col = 0;
  for (int i = 0; i < 3; ++i) {
    m.w[i] = static_cast<const __nv_bfloat16*>(ws[i]);
    m.n[i] = ns[i];
    m.tiles[i] = (ns[i] + kTN - 1) / kTN;
    m.col0[i] = col;
    col += ns[i];
  }
  return m;
}

int total_tiles(const Mats& m) { return m.tiles[0] + m.tiles[1] + m.tiles[2]; }

// The MLP's first GEMV input for rows [b0, b0 + nb): the norm kernel's yn,
// or, without a norm, the rows of y as given (no launch, no copy).
const __nv_bfloat16* norm_input(const void* y, int b0, int D, const void* ln_w,
                                const void* ln_b, __nv_bfloat16* yn, int nb, float eps, int norm,
                                cudaStream_t s) {
  const __nv_bfloat16* rows = static_cast<const __nv_bfloat16*>(y) + size_t(b0) * D;
  if (norm == kNoNorm) return rows;
  norm_rows_kernel<<<nb, kThreads, 0, s>>>(rows, static_cast<const __nv_bfloat16*>(ln_w),
                                           static_cast<const __nv_bfloat16*>(ln_b), yn, D, eps,
                                           norm);
  return yn;
}

bool bad_split(int K, int splits, int chunk) {
  return splits < 1 || chunk < 1 || chunk > kChunk || (long long)splits * chunk < K ||
         (long long)(splits - 1) * chunk >= K;
}

// The operands of one split-K decode call.
struct DecodeCall {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lens;
  const float* slopes;
  __nv_bfloat16* out;
  float* o;
  float* m;
  float* l;
  int* counters;
  int H, KV, bs, W, split_len;
  float scale;
};

template <int DH, int KIND, bool KSPLIT>
cudaError_t launch_group_decode_as(const DecodeCall& c, dim3 grid, cudaStream_t s) {
  using Sm = pdec::DecodeSmem<DH, KIND, KSPLIT>;
  // the folded merge's m_g and sums, a flag and (where they fit) the weights
  if (c.counters != nullptr && 16 + 8LL * (c.H / c.KV) > Sm::kRing) return cudaErrorInvalidValue;
  const auto kernel = group_decode_kernel<DH, KIND, KSPLIT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, pdec::kThreads, Sm::kBytes, s>>>(c.q, c.k, c.v, c.ks, c.vs, c.table, c.lens,
                                                  c.slopes, c.out, c.o, c.m, c.l, c.counters,
                                                  c.H, c.KV, c.bs, c.W, c.split_len, c.scale);
  return cudaSuccess;
}

// The instance for (Dh, storage kind): the four warps split each key tile
// where the group is one 16-row MMA tile (G <= 16), as in B2.
template <int DH>
cudaError_t launch_group_decode(int kind, const DecodeCall& c, dim3 grid, cudaStream_t s) {
  const bool ksplit = c.H / c.KV <= 16;
  switch (kind) {
    case KvBf16:
      return ksplit ? launch_group_decode_as<DH, KvBf16, true>(c, grid, s)
                    : launch_group_decode_as<DH, KvBf16, false>(c, grid, s);
    case KvInt8:
      return ksplit ? launch_group_decode_as<DH, KvInt8, true>(c, grid, s)
                    : launch_group_decode_as<DH, KvInt8, false>(c, grid, s);
    case KvFp8:
      return ksplit ? launch_group_decode_as<DH, KvFp8, true>(c, grid, s)
                    : launch_group_decode_as<DH, KvFp8, false>(c, grid, s);
    default:
      return cudaErrorInvalidValue;
  }
}


}  // namespace

extern "C" {

const char* sxt_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// QKV + biases + RoPE + append. part: f32 workspace [splits, min(B, 8),
// (H + 2 KV) * Dh]; the reduction over D runs in `splits` chunks of `chunk`
// rows. Null biases: none; null cos / sin: no RoPE, else cos / sin are
// [B, rd/2] and rotate the first rd columns of each head (rd even, at most
// Dh); null pools (and null table / pos): no pool row is written.
int sxt_fused_qkv_rope_bf16(const void* y, const void* wq, const void* wk, const void* wv,
                            const void* bq, const void* bk, const void* bv,
                            const void* cos, const void* sin, const void* table,
                            const void* pos, void* pool_k, void* pool_v, void* q, void* k,
                            void* v, void* part, int B, int D, int H, int KV, int Dh, int rd,
                            int bs, int W, int splits, int chunk, void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV || Dh % 8 || Dh > 1024 || bad_split(D, splits, chunk) ||
      (cos != nullptr && (rd <= 0 || rd % 2 || rd > Dh)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Nq = H * Dh, Nkv = KV * Dh, ncols = Nq + 2 * Nkv, half = rd / 2;
  const Mats mats = make_mats(wq, Nq, wk, Nkv, wv, Nkv);
  for (int b0 = 0; b0 < B; b0 += kMaxRows) {
    const int nb = B - b0 < kMaxRows ? B - b0 : kMaxRows;
    gemv_partial_kernel<<<dim3(total_tiles(mats), splits), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y) + size_t(b0) * D, nb, D, chunk, mats, ncols,
        static_cast<float*>(part));
    qkv_epilogue_kernel<<<dim3(nb, H + 2 * KV), Dh, Dh * sizeof(float), s>>>(
        static_cast<const float*>(part), splits, nb, ncols,
        static_cast<const __nv_bfloat16*>(bq), static_cast<const __nv_bfloat16*>(bk),
        static_cast<const __nv_bfloat16*>(bv),
        cos ? static_cast<const float*>(cos) + size_t(b0) * half : nullptr,
        sin ? static_cast<const float*>(sin) + size_t(b0) * half : nullptr,
        table ? static_cast<const int*>(table) + size_t(b0) * W : nullptr,
        pos ? static_cast<const int*>(pos) + b0 : nullptr,
        static_cast<__nv_bfloat16*>(pool_k), static_cast<__nv_bfloat16*>(pool_v),
        static_cast<__nv_bfloat16*>(q) + size_t(b0) * Nq,
        static_cast<__nv_bfloat16*>(k) + size_t(b0) * Nkv,
        static_cast<__nv_bfloat16*>(v) + size_t(b0) * Nkv, H, KV, Dh, rd, bs, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Split-K paged decode. kind: 0 bf16 pool (k_scale = v_scale = null), 1
// int8, 2 e4m3 (with the f32 scale planes). The table's W entries split
// into `splits` runs of spb = ceil(W / splits) entries, none empty. With
// splits > 1: o_part [B, splits, H, Dh] and m_part / l_part [B, splits, H]
// f32, and counters [B, KV] int32, all zero (the kernel leaves them zero),
// or null to merge in a second kernel. Any G = H / KV.
int sxt_fused_paged_decode(const void* q, const void* k, const void* v, const void* k_scale,
                           const void* v_scale, const void* table, const void* kv_len,
                           const void* slopes, void* out, void* o_part, void* m_part,
                           void* l_part, void* counters, int kind, int B, int H, int KV, int Dh,
                           int bs, int W, int splits, float scale, void* stream) {
  if (B <= 0) return 0;
  const int spb = splits < 1 ? 0 : (W + splits - 1) / splits;
  if (KV <= 0 || H % KV || splits < 1 || W < 1 || bs < 1 || (splits - 1) * spb >= W ||
      kind < KvBf16 || kind > KvFp8 || (kind == KvBf16) != (k_scale == nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (splits > 1 && (o_part == nullptr || m_part == nullptr || l_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeCall c{static_cast<const __nv_bfloat16*>(q), k, v,
                     static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                     static_cast<const int*>(table), static_cast<const int*>(kv_len),
                     static_cast<const float*>(slopes), static_cast<__nv_bfloat16*>(out),
                     static_cast<float*>(o_part), static_cast<float*>(m_part),
                     static_cast<float*>(l_part), splits > 1 ? static_cast<int*>(counters) : nullptr,
                     H, KV, bs, W, spb * bs, scale};
  const dim3 grid(B, KV, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Dh == 256)   // GPT-J-6B
    err = launch_group_decode<256>(kind, c, grid, s);
  else if (Dh == 128)
    err = launch_group_decode<128>(kind, c, grid, s);
  else if (Dh == 64)
    err = launch_group_decode<64>(kind, c, grid, s);
  else if (Dh == 96)   // Phi-3-mini
    err = launch_group_decode<96>(kind, c, grid, s);
  else if (Dh == 80)   // Pythia-2.8b
    err = launch_group_decode<80>(kind, c, grid, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1 && c.counters == nullptr)
    group_merge_kernel<<<dim3(B, H), Dh, 0, s>>>(c.o, c.m, c.l, c.lens, c.out, splits, H, Dh,
                                                 W * bs, spb * bs);
  return static_cast<int>(cudaGetLastError());
}


// Norm + MLP + residual: gated (w_gate given: act(g) * u) or plain (w_gate
// null: act(u)); norm 0 RMSNorm, 1 layernorm (ln_b may be null), 2 none
// (yn = y; ln_w and ln_b are not read, and the yn workspace is unused); act 0
// silu, 1 relu, 2 tanh gelu; b_up / b_down may be null. Workspaces for
// min(B, 8) rows: yn bf16 [., D], a bf16 [., F], part1 f32 [s1, ., 2F]
// (gated) or [s1, ., F], part2 f32 [s2, ., D].
int sxt_fused_mlp_bf16(const void* resid, const void* y, const void* ln_w, const void* ln_b,
                       const void* w_gate, const void* w_up, const void* w_down,
                       const void* b_up, const void* b_down, void* out, void* yn, void* a,
                       void* part1, void* part2, int B, int D, int F, int s1, int chunk1, int s2,
                       int chunk2, int norm, int act, float eps, void* stream) {
  if (B <= 0) return 0;
  if (D % 8 || F % 8 || bad_split(D, s1, chunk1) || bad_split(F, s2, chunk2) || norm < 0 ||
      norm > kNoNorm || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gated = w_gate != nullptr;
  const Mats up = gated ? make_mats(w_gate, F, w_up, F, nullptr, 0)
                        : make_mats(w_up, F, nullptr, 0, nullptr, 0);
  const Mats down = make_mats(w_down, D, nullptr, 0, nullptr, 0);
  auto* ynp = static_cast<__nv_bfloat16*>(yn);
  auto* ap = static_cast<__nv_bfloat16*>(a);
  auto* p1 = static_cast<float*>(part1);
  auto* p2 = static_cast<float*>(part2);
  for (int b0 = 0; b0 < B; b0 += kMaxRows) {
    const int nb = B - b0 < kMaxRows ? B - b0 : kMaxRows;
    const __nv_bfloat16* xin = norm_input(y, b0, D, ln_w, ln_b, ynp, nb, eps, norm, s);
    gemv_partial_kernel<<<dim3(total_tiles(up), s1), kThreads, 0, s>>>(
        xin, nb, D, chunk1, up, gated ? 2 * F : F, p1);
    act_epilogue_kernel<<<(nb * F + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        p1, s1, nb, F, gated, act, static_cast<const __nv_bfloat16*>(b_up), ap);
    gemv_partial_kernel<<<dim3(total_tiles(down), s2), kThreads, 0, s>>>(ap, nb, F, chunk2,
                                                                         down, D, p2);
    residual_epilogue_kernel<<<(nb * D + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        p2, s2, nb, D, static_cast<const __nv_bfloat16*>(resid) + size_t(b0) * D,
        static_cast<const __nv_bfloat16*>(b_down), static_cast<__nv_bfloat16*>(out) + size_t(b0) * D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Norm + MLP + residual over quantized weights of format fmt (0 int8, 1
// packed int4, 2 e4m3) and group size gs: q* the storage, s* the f32
// scales [K/gs, N]. Gated when qg is given (act(g) * u), plain (act(u))
// when qg and sg are null; norm, act and ln_b as sxt_fused_mlp_bf16; no fc
// biases (the JAX kernel takes none). Passes of up to 16 rows, each the two
// tensor-core GEMV launches: the up GEMV on `blocks1` persistent blocks over
// s1 chunks of chunk1 rows of D, the down GEMV on `blocks2` over s2 chunks
// of chunk2 rows of F (chunks of whole scale groups). Workspaces: a bf16
// [min(B, 16), F]; with several splits part1 f32 [s1, min(B, 16), 2F]
// (plain: F), part2 [s2, min(B, 16), D] and counters int32 (one a column
// tile of either GEMV), zero between calls (the kernels leave them zero).
int sxt_fused_mlp_quant_bf16(const void* resid, const void* y, const void* ln_w, const void* ln_b,
                             const void* qg, const void* sg, const void* qu, const void* su,
                             const void* qd, const void* sd, void* out, void* a, void* part1,
                             void* part2, void* counters, int B, int D, int F, int gs, int fmt,
                             int s1, int chunk1, int s2, int chunk2, int blocks1, int blocks2,
                             int norm, int act, float eps, void* stream) {
  if (B <= 0) return 0;
  auto bad = [gs](int K, int splits, int chunk, void* part) {
    return splits < 1 || chunk < 1 || chunk % gs || (long long)splits * chunk < K ||
           (long long)(splits - 1) * chunk >= K || (splits > 1 && part == nullptr);
  };
  if (gs < 32 || gs % 32 || D % gs || F % gs || D % 16 || F % 16 || fmt < 0 || fmt > 2 ||
      bad(D, s1, chunk1, part1) || bad(F, s2, chunk2, part2) || blocks1 < 1 || blocks2 < 1 ||
      ((s1 > 1 || s2 > 1) && counters == nullptr) || norm < 0 || norm > kNoNorm || act < 0 ||
      act > 2 || (qg == nullptr) != (sg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MlpQuantCall c{static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(ln_w),
                 static_cast<const __nv_bfloat16*>(ln_b), static_cast<const __nv_bfloat16*>(resid),
                 static_cast<const uint8_t*>(qg), static_cast<const uint8_t*>(qu),
                 static_cast<const uint8_t*>(qd), static_cast<const float*>(sg),
                 static_cast<const float*>(su), static_cast<const float*>(sd),
                 static_cast<__nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(out),
                 static_cast<float*>(part1), static_cast<float*>(part2),
                 static_cast<int*>(counters), 0, D, F, gs, s1, chunk1, s2, chunk2, act, eps};
  for (int b0 = 0; b0 < B; b0 += tcg::kRows) {
    MlpQuantCall pass = c;
    pass.B = B - b0 < tcg::kRows ? B - b0 : tcg::kRows;
    pass.y = c.y + size_t(b0) * D;
    pass.resid = c.resid + size_t(b0) * D;
    pass.out = c.out + size_t(b0) * D;
    cudaError_t err;
    if (fmt == kQInt8)
      err = mlp_quant_pass<kQInt8>(pass, norm, blocks1, blocks2, s);
    else if (fmt == kQInt4)
      err = mlp_quant_pass<kQInt4>(pass, norm, blocks1, blocks2, s);
    else
      err = mlp_quant_pass<kQFp8>(pass, norm, blocks1, blocks2, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
