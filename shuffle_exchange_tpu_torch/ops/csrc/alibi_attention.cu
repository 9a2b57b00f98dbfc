// ALiBi flash attention, forward and backward, for Hopper (sm_90a): causal,
// with a per-head slope bias, grouped-query heads read from unexpanded K/V,
// behind a plain C interface loaded with ctypes (ops/_build.py builds this
// file with nvcc at first use).
//
// Replaces the TPU kernels of shuffle_exchange_tpu/ops/alibi_attention.py:
//   B11  _alibi_flash_fwd_impl (kernel _alibi_fwd_kernel): out and lse
//   B12  _flash_bwd_impl, the dq pass (_alibi_dq_kernel)
//   B13  _flash_bwd_impl, the dk/dv pass (_alibi_dkv_kernel), with the
//        slope cotangent
//
// Layouts (contiguous, bf16; the JAX package's [batch, seq, heads, Dh]):
//   q, o, dout  [B, T, H, Dh];  k, v  [B, S, KV, Dh];  slopes  [H] f32
//   lse, delta  [B, H, T] f32;  dslope partials  [B, H, ceil(S / 64)] f32
// Query head h reads kv head h / (H / KV) (the _repeat_kv convention).
//
// What it computes (reference_alibi_attention_lse, the plain version):
// scores q.k * Dh^-0.5 in f32 plus slope_h * j on the ABSOLUTE key position
// j, formed and added in f32 (at S = 2048 BLOOM's first slope makes the bias
// ~1447, where bf16 resolves 8); the causal diagonal aligned bottom-right:
// query i sees keys j <= i + S - T (S >= T); softmax in f32, online across
// key tiles; out rounded to bf16 once; lse the natural log-sum-exp of each
// row's biased scores, as the TPU kernel writes it.
//
// What bounds it on the H100: 4 * pairs * H * Dh flops (forward) and
// 10 * pairs * H * Dh (backward) against a few bytes per element of q, k,
// v: at BLOOM's training shape (T = S = 2047, Dh 128) ~1,000 flops a byte,
// far above the ~295 flop/byte ridge, so the tensor cores bound it, and
// what keeps a kernel from them is the elementwise work between its
// products. Design: these are the ALiBi form of the dense flash kernels'
// warp-specialised wgmma bodies (wgmma_flash.cuh; flash_attention.cu's
// header describes them): two consumer warpgroups and a producer thread
// feeding TMA tiles through a ring of mbarrier-guarded slots, scores and
// products by wgmma in f32, P and dS entering their products as bf16 hi +
// lo terms. What the ALiBi form adds is local to the elementwise code:
//   - the bias enters the log2 domain through the FMA that scales the score
//     there: t = s * Dh^-0.5 log2(e) + slope_h log2(e) j, one f32 value a
//     lane for each of its 16 columns of a 64-key tile (per key row in the
//     dk/dv pass, each query head of the group with its own slope); the
//     forward's running max is over t and p = 2^(t - m), so the lse it
//     writes is the log-sum-exp of the biased scores; the backward forms
//     P = 2^(s * Dh^-0.5 log2(e) + (slope_h log2(e) j - lse_i log2(e))),
//     the bias less the row's lse first: both are ~slope_h j where P
//     matters, so that difference is exact and the one rounding left is
//     at the small final magnitude (a steep head's dslope, which cancels
//     a thousandfold, feels every rounding of P);
//   - the diagonal is bottom-right (off = S - T): a block loads the tiles
//     up to key q0 + BM - 1 + off, a consumer computes those up to its own
//     rows' diagonal, and the dk/dv pass starts each key tile at query tile
//     max(0, (k0 - off) / 64); only tiles the diagonal or the end of S
//     crosses are masked (a masked p is exactly 0; a zero key from TMA's
//     fill past S would still score slope_h * j, so keys past S are masked
//     in-kernel), and a query row past T takes lse = +1e30 in the backward,
//     so its P is exactly 0 with no mask;
//   - the slope cotangent dslope_h = sum_ij dS_ij * j: each thread sums dS
//     over its queries for each of its two keys across a head's query
//     tiles in order, then at the head's last tile the sums times j are
//     added lanes by butterfly and warps in order: under the key split
//     (head dim 64: a block is 128 keys, 64 a consumer) each consumer
//     writes its own 64-key tile's partial, under the query split (128:
//     a block is 64 keys, each consumer 32 of a tile's queries) consumer
//     0's warps then consumer 1's; the wrapper sums the
//     [B, H, ceil(S / 64)] partials in a fixed order.
// The backward is the dense backward's three passes: delta = rowsum(dout *
// out) (flash_bwd_delta_kernel, the dense pass itself), dk/dv (+ dslope),
// then dq. No atomics anywhere, so two runs give equal bits. Blocks go by
// chunks of 16 (sequence, kv head) groups and longest first within a chunk
// (wgmma_flash.cuh: kAlibiChunk), so a grid of a few waves (BLOOM's
// prefill, a short batch) ends on short tiles. The kernels carry names of
// their own (alibi_wg_*), so a profile tells B11-B13 from the dense
// B14 / B15.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_flash.cuh"   // the wgmma bodies and shapes, the delta pass, tensor maps

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// Kernels: the ALiBi instances of the wgmma bodies
// ---------------------------------------------------------------------------

// B11. The tail maps of the body (head dims 80 / 96) are unread here.
template <int DH>
__global__ void __launch_bounds__(kWgBlockThreads, 1) alibi_wg_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ slopes,
    bf16* __restrict__ o, float* __restrict__ lse, int B, int T, int S, int H, int KV,
    float scale_log2) {
  wg_fwd<DH, kAlibi>(qmap, kmap, vmap, qmap, kmap, vmap, nullptr, o, lse, B, T, S, H, KV, 1,
                     scale_log2, Alibi{slopes, S - T, nullptr});
}

// B12.
template <int DH>
__global__ void __launch_bounds__(kWgBlockThreads, 1) alibi_wg_dq_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ slopes, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int B, int T, int S, int H, int KV,
    float scale, float scale_log2) {
  wg_dq<DH, kAlibi>(qmap, domap, kmap, vmap, lse, delta, nullptr, dq, B, T, S, H, KV, 1, scale,
                    scale_log2, Alibi{slopes, S - T, nullptr});
}

// B13 at head dim 128: the query split.
template <int DH, Form F>
__global__ void __launch_bounds__(kWgBlockThreads, 1) alibi_wg_dkv_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ slopes, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dslope_part, int B, int T, int S, int H, int KV, float scale,
    float scale_log2) {
  wg_dkv<DH, F>(qmap, domap, kmap, vmap, lse, delta, nullptr, dk, dv, B, T, S, H, KV, 1, scale,
                scale_log2, Alibi{slopes, S - T, dslope_part});
}

// B13 at head dim 64: the key split.
template <int DH, Form F>
__global__ void __launch_bounds__(kWgBlockThreads, 1) alibi_wg_dkv_keys_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ slopes, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dslope_part, int B, int T, int S, int H, int KV, float scale,
    float scale_log2) {
  wg_dkv_keys<DH, F>(qmap, domap, kmap, vmap, lse, delta, nullptr, dk, dv, B, T, S, H, KV, 1,
                     scale, scale_log2, Alibi{slopes, S - T, dslope_part});
}

// ---------------------------------------------------------------------------
// Host launchers
// ---------------------------------------------------------------------------

bool bad_shape(int B, int T, int S, int H, int KV) {
  return S < T || KV <= 0 || H % KV != 0;
}

template <int DH>
cudaError_t launch_fwd(cudaStream_t s, const void* q, const void* k, const void* v,
                       const void* slopes, void* o, void* lse, int B, int T, int S, int H, int KV,
                       float scale) {
  using Sh = WgFwd<DH>;
  const long long blocks = (long long)((T + Sh::BM - 1) / Sh::BM) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  const long long qcols = (long long)H * DH, kcols = (long long)KV * DH;
  cudaError_t err = tile_map_3d(&qm, q, B, T, qcols, Sh::BM);
  if (err == cudaSuccess) err = tile_map_3d(&km, k, B, S, kcols, Sh::BN);
  if (err == cudaSuccess) err = tile_map_3d(&vm, v, B, S, kcols, Sh::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(alibi_wg_fwd_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return err;
  alibi_wg_fwd_kernel<DH><<<int(blocks), kWgBlockThreads, Sh::SMEM, s>>>(
      qm, km, vm, static_cast<const float*>(slopes), static_cast<bf16*>(o),
      static_cast<float*>(lse), B, T, S, H, KV, scale * kLog2e);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_delta(cudaStream_t s, const void* o, const void* dout, void* delta, int B,
                         int T, int H) {
  const long long rows = (long long)B * T * H;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<DH><<<int(blocks), kThreads, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      rows, T, H);
  return cudaGetLastError();
}

// The dk/dv pass reads 64-row boxes of everything.
template <int DH, bool DSLOPE>
cudaError_t launch_dkv(cudaStream_t s, const void* q, const void* k, const void* v,
                       const void* slopes, const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, void* dslope_part, int B, int T, int S, int H, int KV,
                       float scale) {
  using Sh = WgDkv<DH>;
  constexpr Form F = DSLOPE ? kAlibiDslope : kAlibi;
  const long long blocks = (long long)((S + Sh::BN - 1) / Sh::BN) * B * KV;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap qm, dom, km, vm;
  const long long qcols = (long long)H * DH, kcols = (long long)KV * DH;
  cudaError_t err = tile_map_3d(&qm, q, B, T, qcols, 64);
  if (err == cudaSuccess) err = tile_map_3d(&dom, dout, B, T, qcols, 64);
  if (err == cudaSuccess) err = tile_map_3d(&km, k, B, S, kcols, 64);
  if (err == cudaSuccess) err = tile_map_3d(&vm, v, B, S, kcols, 64);
  // the key split at 64, the query split at 128
  auto* kernel = [] {
    if constexpr (Sh::KEY_SPLIT) return alibi_wg_dkv_keys_kernel<DH, F>;
    else return alibi_wg_dkv_kernel<DH, F>;
  }();
  const int smem = Sh::SMEM + (DSLOPE ? Sh::RED_BYTES : 0);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<int(blocks), kWgBlockThreads, smem, s>>>(
      qm, dom, km, vm, static_cast<const float*>(slopes), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dslope_part), B, T, S, H, KV, scale, scale * kLog2e);
  return cudaGetLastError();
}

// The dq pass reads BM-row boxes of Q and dO, 64-row boxes of K and V.
template <int DH>
cudaError_t launch_dq(cudaStream_t s, const void* q, const void* k, const void* v,
                      const void* slopes, const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int T, int S, int H, int KV, float scale) {
  using Sh = WgDq<DH>;
  const long long blocks = (long long)((T + Sh::BM - 1) / Sh::BM) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap qm, dom, km, vm;
  const long long qcols = (long long)H * DH, kcols = (long long)KV * DH;
  cudaError_t err = tile_map_3d(&qm, q, B, T, qcols, Sh::BM);
  if (err == cudaSuccess) err = tile_map_3d(&dom, dout, B, T, qcols, Sh::BM);
  if (err == cudaSuccess) err = tile_map_3d(&km, k, B, S, kcols, Sh::BN);
  if (err == cudaSuccess) err = tile_map_3d(&vm, v, B, S, kcols, Sh::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(alibi_wg_dq_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return err;
  alibi_wg_dq_kernel<DH><<<int(blocks), kWgBlockThreads, Sh::SMEM, s>>>(
      qm, dom, km, vm, static_cast<const float*>(slopes), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), B, T, S, H, KV, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sxt_alibi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B11: o (and lse [B, H, T] f32 when given) = ALiBi attention of q, k, v
// with per-head slopes [H] f32; causal, bottom-right diagonal (S >= T).
// scale is the softmax scale (Dh^-0.5). Returns cudaGetLastError().
int sxt_alibi_fwd_bf16(const void* q, const void* k, const void* v, const void* slopes, void* o,
                       void* lse, int B, int T, int S, int H, int KV, int Dh, float scale,
                       void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (bad_shape(B, T, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128)
    return static_cast<int>(launch_fwd<128>(s, q, k, v, slopes, o, lse, B, T, S, H, KV, scale));
  if (Dh == 64)
    return static_cast<int>(launch_fwd<64>(s, q, k, v, slopes, o, lse, B, T, S, H, KV, scale));
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta [B, H, T] f32 = rowsum(dout * o), the backward's first pass.
int sxt_alibi_bwd_delta_bf16(const void* o, const void* dout, void* delta, int B, int T, int H,
                             int Dh, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return static_cast<int>(launch_delta<128>(s, o, dout, delta, B, T, H));
  if (Dh == 64) return static_cast<int>(launch_delta<64>(s, o, dout, delta, B, T, H));
  return static_cast<int>(cudaErrorInvalidValue);
}

// B13: dk, dv [B, S, KV, Dh]; dslope_part [B, H, ceil(S / 64)] f32 of
// sum_ij dS_ij * j when not null.
int sxt_alibi_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* slopes,
                           const void* dout, const void* lse, const void* delta, void* dk,
                           void* dv, void* dslope_part, int B, int T, int S, int H, int KV,
                           int Dh, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (bad_shape(B, T, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ds = dslope_part != nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  if (Dh == 128)
    err = ds ? launch_dkv<128, true>(s, q, k, v, slopes, dout, lse, delta, dk, dv, dslope_part, B,
                                     T, S, H, KV, scale)
             : launch_dkv<128, false>(s, q, k, v, slopes, dout, lse, delta, dk, dv, nullptr, B,
                                      T, S, H, KV, scale);
  else if (Dh == 64)
    err = ds ? launch_dkv<64, true>(s, q, k, v, slopes, dout, lse, delta, dk, dv, dslope_part, B,
                                    T, S, H, KV, scale)
             : launch_dkv<64, false>(s, q, k, v, slopes, dout, lse, delta, dk, dv, nullptr, B, T,
                                     S, H, KV, scale);
  return static_cast<int>(err);
}

// B12: dq [B, T, H, Dh].
int sxt_alibi_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* slopes,
                          const void* dout, const void* lse, const void* delta, void* dq, int B,
                          int T, int S, int H, int KV, int Dh, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (bad_shape(B, T, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128)
    return static_cast<int>(
        launch_dq<128>(s, q, k, v, slopes, dout, lse, delta, dq, B, T, S, H, KV, scale));
  if (Dh == 64)
    return static_cast<int>(
        launch_dq<64>(s, q, k, v, slopes, dout, lse, delta, dq, B, T, S, H, KV, scale));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
