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
// gelu_pytorch_tanh). In the GEMVs, tensor-core MMA, TMA and pipelining
// are later work.
//
// The quantized MLP (int8 / packed int4 / e4m3 weights with f32 scales per
// (K-group, column), the storage of ops/quant_matmul.py) keeps that
// structure and its norm, gate and activation forms, without fc biases:
// norm rows, the split GEMV over [w_gate | w_up] (or w_up alone for the
// plain MLP, F columns), the activation epilogue, the split GEMV over
// w_down, the residual epilogue. Its GEMV
// (quant_gemv.cuh) reads the weights at storage width and dequantizes them
// in registers as q * s in f32, which is the JAX kernel's rounding point:
// its weight blocks stay f32 and dot(bf16, f32) promotes, so only yn and a
// are rounded to bf16. A split covers whole scale groups. Its bound at 8
// rows of Llama-3-8B is the weight bytes: 176.2 MB of int8 and 2.8 MB of
// scales at group 256, 53.4 us (int4 and its scales: 27.1 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_decode.cuh"  // pdec::decode_split (B2's decode body), merge_partials
#include "paged_tile.cuh"    // TK, kNeg, storage kinds, converters
#include "quant_gemv.cuh"    // formats, the quantized split-K GEMV

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
// biases (the JAX kernel takes none). Workspaces as sxt_fused_mlp_bf16;
// each split chunk is whole scale groups.
int sxt_fused_mlp_quant_bf16(const void* resid, const void* y, const void* ln_w, const void* ln_b,
                             const void* qg, const void* sg, const void* qu, const void* su,
                             const void* qd, const void* sd, void* out, void* yn, void* a,
                             void* part1, void* part2, int B, int D, int F, int gs, int fmt,
                             int s1, int chunk1, int s2, int chunk2, int norm, int act, float eps,
                             void* stream) {
  if (B <= 0) return 0;
  if (gs % 32 || D % 16 || F % 16 || fmt < 0 || fmt > 2 || bad_qsplit(D, gs, s1, chunk1) ||
      bad_qsplit(F, gs, s2, chunk2) || norm < 0 || norm > kNoNorm || act < 0 || act > 2 ||
      (qg == nullptr) != (sg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gated = qg != nullptr;
  const QMats up = gated ? make_qmats(qg, sg, F, qu, su, F) : make_qmats(qu, su, F, nullptr,
                                                                         nullptr, 0);
  const QMats down = make_qmats(qd, sd, D, nullptr, nullptr, 0);
  auto* ynp = static_cast<__nv_bfloat16*>(yn);
  auto* ap = static_cast<__nv_bfloat16*>(a);
  auto* p1 = static_cast<float*>(part1);
  auto* p2 = static_cast<float*>(part2);
  for (int b0 = 0; b0 < B; b0 += kMaxRows) {
    const int nb = B - b0 < kMaxRows ? B - b0 : kMaxRows;
    const __nv_bfloat16* xin = norm_input(y, b0, D, ln_w, ln_b, ynp, nb, eps, norm, s);
    cudaError_t err = launch_quant_gemv<false>(fmt, dim3(up.tiles[0] + up.tiles[1], s1), s, xin,
                                               nb, D, gs, chunk1, up, gated ? 2 * F : F, p1);
    if (err != cudaSuccess) return static_cast<int>(err);
    act_epilogue_kernel<<<(nb * F + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        p1, s1, nb, F, gated, act, nullptr, ap);
    err = launch_quant_gemv<false>(fmt, dim3(down.tiles[0], s2), s, ap, nb, F, gs, chunk2, down,
                                   D, p2);
    if (err != cudaSuccess) return static_cast<int>(err);
    residual_epilogue_kernel<<<(nb * D + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        p2, s2, nb, D, static_cast<const __nv_bfloat16*>(resid) + size_t(b0) * D, nullptr,
        static_cast<__nv_bfloat16*>(out) + size_t(b0) * D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
