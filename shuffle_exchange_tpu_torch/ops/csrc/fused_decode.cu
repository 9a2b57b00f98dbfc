// The fused decode layer for Hopper (sm_90a): QKV projection + RoPE + pool
// append, split-K paged flash-decode, and RMSNorm + SwiGLU MLP + residual,
// behind a plain C interface loaded with ctypes (ops/_build.py builds this
// file with nvcc at first use). Each C entry point launches all of its
// kernels on the caller's stream and returns cudaGetLastError().
//
// Replaces the TPU kernels
//   shuffle_exchange_tpu/ops/fused_decode.py:fused_qkv_rope_pallas
//   shuffle_exchange_tpu/ops/fused_decode.py:fused_paged_decode_attention_pallas
//   shuffle_exchange_tpu/ops/fused_decode.py:fused_mlp_pallas
//
// Layouts (all contiguous, bf16 unless noted):
//   y, resid      [B, D] activation rows (one token per sequence)
//   wq, wk, wv    [D, H*Dh], [D, KV*Dh], [D, KV*Dh]   (stored [in, out])
//   w_gate, w_up  [D, F];  w_down [F, D];  ln_w [D]
//   cos, sin      [B, Dh/2] f32 rope rows at each row's position
//   pool k / v    one layer [nblk, KV, bs, Dh];  table [B, W] int32 (-1 is
//                 read as block 0);  pos / kv_len [B] int32
//
// What bounds them on the H100 (3.35 TB/s, 989 TFLOP/s bf16): the QKV and
// MLP products multiply at most 8 rows by each weight, 2 flops per weight
// byte against the card's ~295 flop/byte ridge, so their bound is the
// weight bytes: 50.3 MB a Llama-3-8B layer for QKV (15.0 us), 352.3 MB for
// the MLP (105.2 us). The design question is how to keep enough SMs
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
// paged decode kernel in paged_attention.cu is. One block per (sequence,
// kv head, split) walks its split's share of the block table up to
// ceil(kv_len / bs), never reading padded entries, stages 64-position K/V
// tiles in shared memory once for the G query heads of its group, and
// holds (m, l, acc) in f32; the split count fills the SMs (the wrapper
// picks it), and a merge kernel combines the splits:
//   m_g = max m;  w = exp(m - m_g);  out = sum(w*acc) / max(sum(w*l), 1e-30).
// q is scaled in f32 before the dot, P stays f32, masked scores are -1e30,
// and a split past the sequence's end contributes m = -1e30, l = 0.
//
// Rounding points (those of the TPU kernels): QKV sums in f32, bias-free
// RoPE in f32, one cast to bf16, and the pool gets the cast value; the MLP
// normalises with f32 statistics and rounds yn to bf16, sums both products
// in f32, rounds a = silu(g)*u to bf16, sums the down product in f32, adds
// the residual in f32 and casts once. Tensor-core MMA, TMA and pipelining
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_tile.cuh"   // TK, kNeg, load_kv_tile, bf16x8_to_float

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
// threads. Adds the partials, applies rotate-half RoPE in f32 to q and k
// (the partner of column d is d +- Dh/2 of the same head), casts, writes
// q/k/v and appends k/v to the pool at (table[b, pos/bs], h, pos % bs).
// ---------------------------------------------------------------------------

__global__ void qkv_epilogue_kernel(
    const float* __restrict__ part, int S, int B, int ncols, const float* __restrict__ cos,
    const float* __restrict__ sin, const int* __restrict__ table, const int* __restrict__ pos,
    __nv_bfloat16* __restrict__ pool_k, __nv_bfloat16* __restrict__ pool_v,
    __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ k,
    __nv_bfloat16* __restrict__ v, int H, int KV, int Dh, int bs, int W) {
  extern __shared__ float xh[];   // [Dh]
  const int b = blockIdx.x, head = blockIdx.y, d = threadIdx.x;
  float x = sum_splits(part, S, B, ncols, b, head * Dh + d);
  const bool is_v = head >= H + KV;
  if (!is_v) {
    xh[d] = x;
    __syncthreads();
    const int half = Dh / 2;
    const float c = cos[b * half + d % half], sn = sin[b * half + d % half];
    x = d < half ? x * c - xh[d + half] * sn : x * c + xh[d - half] * sn;
  }
  const __nv_bfloat16 o = __float2bfloat16(x);
  if (head < H) {
    q[(size_t(b) * H + head) * Dh + d] = o;
    return;
  }
  const int h = is_v ? head - H - KV : head - H;
  (is_v ? v : k)[(size_t(b) * KV + h) * Dh + d] = o;
  const int p = pos[b];
  int blk = table[size_t(b) * W + min(p / bs, W - 1)];
  blk = blk < 0 ? 0 : blk;
  (is_v ? pool_v : pool_k)[((size_t(blk) * KV + h) * bs + p % bs) * Dh + d] = o;
}

// ---------------------------------------------------------------------------
// MLP pieces: row RMSNorm (f32 statistics, yn rounded to bf16), the SwiGLU
// epilogue (a = bf16(silu(g) * u)) and the residual epilogue.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) norm_rows_kernel(
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ yn, int D, float eps) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const __nv_bfloat16* row = y + size_t(b) * D;
  float ss = 0.f;
  for (int i = tid; i < D; i += kThreads) {
    const float xv = __bfloat162float(row[i]);
    ss += xv * xv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tid % 32 == 0) red[tid / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += red[i];
  const float inv = rsqrtf(total / D + eps);
  for (int i = tid; i < D; i += kThreads)
    yn[size_t(b) * D + i] =
        __float2bfloat16(__bfloat162float(row[i]) * inv * __bfloat162float(w[i]));
}

__global__ void swiglu_epilogue_kernel(const float* __restrict__ part, int S, int B, int F,
                                       __nv_bfloat16* __restrict__ a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * F) return;
  const int b = i / F, n = i % F;
  const float g = sum_splits(part, S, B, 2 * F, b, n);
  const float u = sum_splits(part, S, B, 2 * F, b, F + n);
  a[i] = __float2bfloat16(g / (1.f + expf(-g)) * u);
}

__global__ void residual_epilogue_kernel(const float* __restrict__ part, int S, int B, int D,
                                         const __nv_bfloat16* __restrict__ resid,
                                         __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * D) return;
  out[i] = __float2bfloat16(__bfloat162float(resid[i]) + sum_splits(part, S, B, D, i / D, i % D));
}

// ---------------------------------------------------------------------------
// Split-K paged decode: block (sequence b, kv head, split s), 128 threads,
// over positions [s * spb * bs, min((s + 1) * spb * bs, kv_len)).
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecMaxAcc = 8;    // G * Dh <= 8 * 128

template <int DH>
__global__ void __launch_bounds__(kDecThreads) split_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kpool,
    const __nv_bfloat16* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ kv_len, float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int H, int KV, int bs, int W, int spb, float scale) {
  constexpr int NT = kDecThreads, LD = DH + 8;
  const int b = blockIdx.x, kv = blockIdx.y, s = blockIdx.z, S = gridDim.z, tid = threadIdx.x;
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
  const int p_lo = s * spb * bs;
  const int p_hi = min(len, (s + 1) * spb * bs);
  const int* trow = table + size_t(b) * W;
  const __nv_bfloat16* qb = q + (size_t(b) * H + size_t(kv) * G) * DH;
  for (int i = tid; i < G * DH; i += NT) qs[i] = __bfloat162float(qb[i]) * scale;
  for (int g = tid; g < G; g += NT) {
    ms[g] = kNeg;
    ls[g] = 0.f;
  }
  float acc[kDecMaxAcc];
#pragma unroll
  for (int k = 0; k < kDecMaxAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int p0 = p_lo; p0 < p_hi; p0 += TK) {
    const int n = min(TK, p_hi - p0);
    load_kv_tile<DH>(ks, vs, kpool, vpool, trow, kv, KV, bs, p0, n, tid, NT);
    __syncthreads();

    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, t = i % TK;
      float sc = kNeg;
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
        sc = a;
      }
      ss[i] = sc;
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
    for (int k = 0; k < kDecMaxAcc; ++k) {
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

  const size_t row0 = (size_t(b) * S + s) * H + size_t(kv) * G;   // [B, S, H] row of head g=0
#pragma unroll
  for (int k = 0; k < kDecMaxAcc; ++k) {
    const int o = tid + k * NT;
    if (o < G * DH) o_part[(row0 + o / DH) * DH + o % DH] = acc[k];
  }
  for (int g = tid; g < G; g += NT) {
    m_part[row0 + g] = ms[g];
    l_part[row0 + g] = ls[g];
  }
}

// Merge of the splits: block (b, h), Dh threads.
__global__ void split_merge_kernel(const float* __restrict__ o_part,
                                   const float* __restrict__ m_part,
                                   const float* __restrict__ l_part,
                                   __nv_bfloat16* __restrict__ out, int S, int H, int Dh) {
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const size_t r0 = size_t(b) * S * H + h;   // row (b, s=0, h); rows of s step by H
  float mg = kNeg;
  for (int s = 0; s < S; ++s) mg = fmaxf(mg, m_part[r0 + size_t(s) * H]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t r = r0 + size_t(s) * H;
    const float w = expf(m_part[r] - mg);
    l += w * l_part[r];
    o += w * o_part[r * Dh + d];
  }
  out[(size_t(b) * H + h) * Dh + d] = __float2bfloat16(o / fmaxf(l, 1e-30f));
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

bool bad_split(int K, int splits, int chunk) {
  return splits < 1 || chunk < 1 || chunk > kChunk || (long long)splits * chunk < K ||
         (long long)(splits - 1) * chunk >= K;
}

template <int DH>
cudaError_t launch_split_decode(dim3 grid, size_t smem, cudaStream_t s,
                                const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const int* table, const int* kv_len,
                                float* o_part, float* m_part, float* l_part, int H, int KV,
                                int bs, int W, int spb, float scale) {
  const cudaError_t err = cudaFuncSetAttribute(
      split_decode_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  split_decode_kernel<DH><<<grid, kDecThreads, smem, s>>>(q, k, v, table, kv_len, o_part,
                                                          m_part, l_part, H, KV, bs, W, spb,
                                                          scale);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* sxt_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// QKV + RoPE + append. part: f32 workspace [splits, min(B, 8), (H + 2 KV) * Dh];
// the reduction over D runs in `splits` chunks of `chunk` rows.
int sxt_fused_qkv_rope_bf16(const void* y, const void* wq, const void* wk, const void* wv,
                            const void* cos, const void* sin, const void* table,
                            const void* pos, void* pool_k, void* pool_v, void* q, void* k,
                            void* v, void* part, int B, int D, int H, int KV, int Dh, int bs,
                            int W, int splits, int chunk, void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV || Dh % 8 || Dh > 1024 || bad_split(D, splits, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Nq = H * Dh, Nkv = KV * Dh, ncols = Nq + 2 * Nkv, half = Dh / 2;
  const Mats mats = make_mats(wq, Nq, wk, Nkv, wv, Nkv);
  for (int b0 = 0; b0 < B; b0 += kMaxRows) {
    const int nb = B - b0 < kMaxRows ? B - b0 : kMaxRows;
    gemv_partial_kernel<<<dim3(total_tiles(mats), splits), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y) + size_t(b0) * D, nb, D, chunk, mats, ncols,
        static_cast<float*>(part));
    qkv_epilogue_kernel<<<dim3(nb, H + 2 * KV), Dh, Dh * sizeof(float), s>>>(
        static_cast<const float*>(part), splits, nb, ncols,
        static_cast<const float*>(cos) + size_t(b0) * half,
        static_cast<const float*>(sin) + size_t(b0) * half,
        static_cast<const int*>(table) + size_t(b0) * W, static_cast<const int*>(pos) + b0,
        static_cast<__nv_bfloat16*>(pool_k), static_cast<__nv_bfloat16*>(pool_v),
        static_cast<__nv_bfloat16*>(q) + size_t(b0) * Nq,
        static_cast<__nv_bfloat16*>(k) + size_t(b0) * Nkv,
        static_cast<__nv_bfloat16*>(v) + size_t(b0) * Nkv, H, KV, Dh, bs, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Split-K paged decode. o_part f32 [B, splits, H, Dh], m_part / l_part f32
// [B, splits, H]; splits * spb >= W with spb = ceil(W / splits).
int sxt_fused_paged_decode_bf16(const void* q, const void* k, const void* v, const void* table,
                                const void* kv_len, void* out, void* o_part, void* m_part,
                                void* l_part, int B, int H, int KV, int Dh, int bs, int W,
                                int splits, float scale, void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV || (H / KV) * Dh > kDecThreads * kDecMaxAcc || splits < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const int spb = (W + splits - 1) / splits;
  const dim3 grid(B, KV, splits);
  const size_t smem = size_t(2) * TK * (Dh + 8) * sizeof(__nv_bfloat16) +
                      size_t(G * Dh + G * TK + 3 * G) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* tp = static_cast<const int*>(table);
  const auto* lp = static_cast<const int*>(kv_len);
  auto* op = static_cast<float*>(o_part);
  auto* mp = static_cast<float*>(m_part);
  auto* lsp = static_cast<float*>(l_part);
  cudaError_t err;
  if (Dh == 128)
    err = launch_split_decode<128>(grid, smem, s, qp, kp, vp, tp, lp, op, mp, lsp, H, KV, bs, W,
                                   spb, scale);
  else if (Dh == 64)
    err = launch_split_decode<64>(grid, smem, s, qp, kp, vp, tp, lp, op, mp, lsp, H, KV, bs, W,
                                  spb, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_merge_kernel<<<dim3(B, H), Dh, 0, s>>>(op, mp, lsp, static_cast<__nv_bfloat16*>(out),
                                               splits, H, Dh);
  return static_cast<int>(cudaGetLastError());
}

// RMSNorm + SwiGLU MLP + residual. Workspaces for min(B, 8) rows: yn bf16
// [., D], a bf16 [., F], part1 f32 [s1, ., 2F], part2 f32 [s2, ., D].
int sxt_fused_mlp_bf16(const void* resid, const void* y, const void* ln_w, const void* w_gate,
                       const void* w_up, const void* w_down, void* out, void* yn, void* a,
                       void* part1, void* part2, int B, int D, int F, int s1, int chunk1, int s2,
                       int chunk2, float eps, void* stream) {
  if (B <= 0) return 0;
  if (D % 8 || F % 8 || bad_split(D, s1, chunk1) || bad_split(F, s2, chunk2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mats up = make_mats(w_gate, F, w_up, F, nullptr, 0);
  const Mats down = make_mats(w_down, D, nullptr, 0, nullptr, 0);
  auto* ynp = static_cast<__nv_bfloat16*>(yn);
  auto* ap = static_cast<__nv_bfloat16*>(a);
  auto* p1 = static_cast<float*>(part1);
  auto* p2 = static_cast<float*>(part2);
  for (int b0 = 0; b0 < B; b0 += kMaxRows) {
    const int nb = B - b0 < kMaxRows ? B - b0 : kMaxRows;
    norm_rows_kernel<<<nb, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y) + size_t(b0) * D,
        static_cast<const __nv_bfloat16*>(ln_w), ynp, D, eps);
    gemv_partial_kernel<<<dim3(total_tiles(up), s1), kThreads, 0, s>>>(ynp, nb, D, chunk1, up,
                                                                       2 * F, p1);
    swiglu_epilogue_kernel<<<(nb * F + kThreads - 1) / kThreads, kThreads, 0, s>>>(p1, s1, nb,
                                                                                  F, ap);
    gemv_partial_kernel<<<dim3(total_tiles(down), s2), kThreads, 0, s>>>(ap, nb, F, chunk2,
                                                                         down, D, p2);
    residual_epilogue_kernel<<<(nb * D + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        p2, s2, nb, D, static_cast<const __nv_bfloat16*>(resid) + size_t(b0) * D,
        static_cast<__nv_bfloat16*>(out) + size_t(b0) * D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
