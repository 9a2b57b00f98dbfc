// Flash attention forward for Hopper (sm_90a): causal or full masks,
// grouped-query heads read from unexpanded K/V, optional segment ids,
// behind a plain C interface loaded with ctypes (ops/_build.py builds this
// file with nvcc at first use).
//
// Replaces the forward of the TPU kernels
//   shuffle_exchange_tpu/ops/flash_attention.py:pallas_attention
//     (the stock flash kernel: MHA, causal/full, segment ids)
//   shuffle_exchange_tpu/ops/flash_attention.py:splash_attention_gqa
//     (GQA with unexpanded K/V, causal/full masks, segment ids)
//
// Layouts (contiguous, bf16; the JAX package's [batch, seq, heads, Dh]):
//   q, o    [B, T, H, Dh];  k, v  [B, S, KV, Dh];  seg  [B, T] int32 or null
// Query head h reads kv head h / (H / KV) (the _repeat_kv convention), so
// one kernel serves MHA (H == KV) and GQA. Causal masking needs T == S
// (query i sees keys j <= i); the wrapper refuses causal T != S.
//
// What it computes (reference_attention, the plain version): scores
// q.k * Dh^-0.5 in f32; masked scores -1e30 (causal, segment ids that
// differ, keys past S); softmax in f32, online across key tiles; output
// rounded to bf16 once.
//
// What bounds it on the H100: 4*B*H*Dh*(visible pairs) flops against
// q + o + k + v bytes. At the prefill's shapes (T = S ~ 1024, Dh 128) that
// is ~600 flops per byte, above the ~295 flop/byte ridge of the bf16 tensor
// cores, so the tensor cores bound it. Design (FlashAttention-2 shape on
// mma.sync): one block per (64-row query tile, head, sequence), 4 warps of
// 16 query rows each; a loop over 64-key K/V tiles up to the causal limit
// (tiles wholly above the diagonal are never loaded), K/V staged with
// cp.async into a double buffer while the previous tile computes; QK^T and
// PV as m16n8k16 bf16 MMAs with f32 accumulators, operands from shared
// memory by ldmatrix (rows padded by 16 bytes: conflict-free); the running
// max and sum stay in registers. The causal query tiles are issued
// longest first, so the short tiles fill the tail.
//
// P.V precision: P is split into two bf16 terms, P = hi + lo with
// hi = bf16(P) and lo = bf16(P - hi), and both are multiplied by V, so P
// keeps ~16 significant bits where one bf16 operand would keep 8. That
// puts the kernel within one bf16 step of the plain version with P in f32
// (the card check) and costs half again the tensor-core work (P.V runs
// twice). wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;             // query rows per block, 16 per warp
constexpr int kBlockN = 64;             // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;          // finite mask sentinel (as the TPU kernels)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !valid (src is then
// a valid but unread address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16x2 hi = bf16(x) and lo = bf16(x - hi); x0 in the low half.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

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

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    __nv_bfloat16* __restrict__ o, int B, int T, int S, int H, int KV, int causal,
    float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int KSTEPS = DH / 16;     // k-steps of QK^T
  constexpr int NT = kBlockN / 8;     // 8-key column tiles of S
  constexpr int DT = DH / 8;          // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [64][LD]
  __nv_bfloat16* ks = qs + kBlockM * LD;                         // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * kBlockN * LD;                     // [2][64][LD]

  // longest causal query tiles first; heads of one kv group side by side
  const int nqt = (T + kBlockM - 1) / kBlockM;
  const int BH = B * H;
  const int rank = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int qt = causal ? nqt - 1 - rank : rank;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kBlockM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;   // mma row group, column pair

  const int qstride = H * DH, kstride = KV * DH;
  const __nv_bfloat16* qb = q + (size_t(b) * T + q0) * qstride + size_t(h) * DH;
  const __nv_bfloat16* kb = k + size_t(b) * S * kstride + size_t(kvh) * DH;
  const __nv_bfloat16* vb = v + size_t(b) * S * kstride + size_t(kvh) * DH;
  const int n_s = (S + kBlockN - 1) / kBlockN;
  const int n_kv = causal ? min(qt + 1, n_s) : n_s;

  load_tile<DH>(qs, qb, qstride, T - q0, q, tid);
  load_tile<DH>(ks, kb, kstride, S, k, tid);
  load_tile<DH>(vs, vb, kstride, S, v, tid);
  cp_async_commit();

  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const int* segb = seg ? seg + size_t(b) * T : nullptr;
  const int seg_lo = segb ? segb[min(r_lo, T - 1)] : 0;
  const int seg_hi = segb ? segb[min(r_hi, T - 1)] : 0;

  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
  uint32_t qa[KSTEPS][4];

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {   // prefetch the next tile into the other buffer
      const int nb = (j + 1) & 1, k0n = (j + 1) * kBlockN;
      load_tile<DH>(ks + nb * kBlockN * LD, kb + size_t(k0n) * kstride, kstride, S - k0n, k, tid);
      load_tile<DH>(vs + nb * kBlockN * LD, vb + size_t(k0n) * kstride, kstride, S - k0n, v, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(qa[kk], qs + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16 +
                            (lane / 16) * 8);
    }
    const __nv_bfloat16* kt = ks + (j & 1) * kBlockN * LD;
    const __nv_bfloat16* vt = vs + (j & 1) * kBlockN * LD;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, kt + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                       ((lane / 8) % 2) * 8);
        mma_bf16(sacc[2 * np], qa[kk], r[0], r[1]);
        mma_bf16(sacc[2 * np + 1], qa[kk], r[2], r[3]);
      }
    }

    // scale into the log2 domain, mask, row max (rows r_lo: e < 2, r_hi: e >= 2)
    const int k0 = j * kBlockN;
    const bool masked_tile = (causal && j == qt) || k0 + kBlockN > S || segb != nullptr;
    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[n][e] * scale_log2;
        if (masked_tile) {
          const int key = k0 + n * 8 + tq * 2 + (e & 1);
          const int row = e < 2 ? r_lo : r_hi;
          bool ok = key < S && !(causal && key > row);
          if (ok && segb) ok = segb[key] == (e < 2 ? seg_lo : seg_hi);
          s = ok ? s : kNeg;
        }
        sacc[n][e] = s;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, s);
        else
          mx_hi = fmaxf(mx_hi, s);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sacc[n][e] - (e < 2 ? mn_lo : mn_hi));
        sacc[n][e] = p;
        if (e < 2)
          sum_lo += p;
        else
          sum_hi += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      oacc[d][0] *= al_lo;
      oacc[d][1] *= al_lo;
      oacc[d][2] *= al_hi;
      oacc[d][3] *= al_hi;
    }

    // O += P V: the S accumulators of two key tiles are one A operand
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(sacc[2 * kk][0], sacc[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(sacc[2 * kk][2], sacc[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, vt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                             (lane / 16) * 8);
        mma_bf16(oacc[2 * dp], ph, r[0], r[1]);
        mma_bf16(oacc[2 * dp], pl, r[0], r[1]);
        mma_bf16(oacc[2 * dp + 1], ph, r[2], r[3]);
        mma_bf16(oacc[2 * dp + 1], pl, r[2], r[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer before it is refilled
  }

  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + tq * 2;
    if (r_lo < T)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t(b) * T + r_lo) * H + h) * DH + col) =
          __floats2bfloat162_rn(oacc[d][0] * inv_lo, oacc[d][1] * inv_lo);
    if (r_hi < T)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t(b) * T + r_hi) * H + h) * DH + col) =
          __floats2bfloat162_rn(oacc[d][2] * inv_hi, oacc[d][3] * inv_hi);
  }
}

template <int DH>
cudaError_t launch(int blocks, cudaStream_t s, const void* q, const void* k, const void* v,
                   const void* seg, void* o, int B, int T, int S, int H, int KV, int causal,
                   float scale_log2) {
  const size_t smem = size_t(kBlockM + 4 * kBlockN) * (DH + 8) * sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DH><<<blocks, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(o), B, T, S, H, KV, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sxt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// o = attention(q, k, v) as described above; seg may be null. scale is the
// softmax scale (Dh^-0.5). Returns cudaGetLastError() after the launch.
int sxt_flash_attention_bf16(const void* q, const void* k, const void* v, const void* seg,
                             void* o, int B, int T, int S, int H, int KV, int Dh, int causal,
                             float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV || (causal && T != S))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)((T + kBlockM - 1) / kBlockM) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  if (Dh == 128)
    return static_cast<int>(launch<128>(int(blocks), s, q, k, v, seg, o, B, T, S, H, KV,
                                         causal, scale_log2));
  if (Dh == 64)
    return static_cast<int>(launch<64>(int(blocks), s, q, k, v, seg, o, B, T, S, H, KV,
                                        causal, scale_log2));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
