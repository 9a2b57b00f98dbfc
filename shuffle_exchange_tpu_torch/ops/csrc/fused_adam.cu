// Fused AdamW for Hopper (sm_90a): one in-place pass over a leaf's f32
// parameter, gradient and two moments, behind a plain C interface loaded
// with ctypes (ops/_build.py builds this file with nvcc at first use).
//
// Replaces the TPU kernel
//   shuffle_exchange_tpu/ops/fused_adam.py:fused_adamw_update
//
// What it computes, per element (g is first multiplied by gscale, the
// global-norm clip coefficient, 1 when there is no clipping):
//   m = b1 m + (1 - b1) g            (1 - beta passed in, rounded once)
//   v = b2 v + (1 - b2) g^2
//   p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)
// with bc1 = 1 - b1^step and bc2 = 1 - b2^step computed by the caller.
//
// What bounds it on the H100: bytes. 16 bytes are read and 12 written per
// element for a dozen operations, so the least time is 28 B an element over
// the memory rate. The design is one pass with 16-byte loads and stores: a
// grid-stride loop over float4 groups, and a scalar tail for a length that
// is not a multiple of 4. (The TPU kernel pads every leaf to rows of 128
// lanes; nothing here needs that.) The pass allocates nothing and keeps no
// sums, so two runs give equal bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct AdamScalars {
  float lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2, gscale;   // omb: 1 - beta, rounded once
};

__device__ __forceinline__ void adamw_one(float& p, float g, float& m, float& v,
                                          const AdamScalars& s) {
  g *= s.gscale;
  m = s.b1 * m + s.omb1 * g;
  v = s.b2 * v + s.omb2 * g * g;
  const float m_hat = m / s.bc1;
  const float v_hat = v / s.bc2;
  p = p - s.lr * (m_hat / (sqrtf(v_hat) + s.eps) + s.wd * p);
}

__global__ void __launch_bounds__(kThreads) fused_adamw_kernel(
    float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
    float* __restrict__ v, long long n, AdamScalars s) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 pv = p4[i], mv = m4[i], vv = v4[i];
    const float4 gv = g4[i];
    adamw_one(pv.x, gv.x, mv.x, vv.x, s);
    adamw_one(pv.y, gv.y, mv.y, vv.y, s);
    adamw_one(pv.z, gv.z, mv.z, vv.z, s);
    adamw_one(pv.w, gv.w, mv.w, vv.w, s);
    p4[i] = pv;
    m4[i] = mv;
    v4[i] = vv;
  }
  // the tail (n % 4 elements) goes to the first threads of block 0
  const long long t = n4 * 4 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) adamw_one(p[t], g[t], m[t], v[t], s);
}

}  // namespace

extern "C" {

const char* sxt_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// In-place AdamW on n contiguous f32 elements (all four pointers 16-byte
// aligned). omb1 and omb2 are 1 - b1 and 1 - b2 as the caller rounds them
// (taken in double, then to f32: 1.0f - 0.999f is off by 1e-5 relative).
// Returns cudaGetLastError() after the launch.
int sxt_fused_adamw_f32(void* p, const void* g, void* m, void* v, long long n, float lr,
                        float b1, float b2, float omb1, float omb2, float eps, float wd,
                        float bc1, float bc2, float gscale, int sms, void* stream) {
  if (n <= 0) return 0;
  const long long groups = (n / 4 + kThreads - 1) / kThreads;
  long long blocks = groups < 1 ? 1 : groups;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 16;   // grid-stride beyond this
  if (blocks > cap) blocks = cap;
  const AdamScalars s = {lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2, gscale};
  fused_adamw_kernel<<<int(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(m),
      static_cast<float*>(v), n, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
