// Pieces shared by the RMSNorm kernels (rmsnorm_fwd.cu, rmsnorm_bwd.cu):
// the element conversions, the 16-byte vector, and the row entries' block
// of 256 threads per row with its reduction and weight loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int E>
struct alignas(sizeof(T) * E) Pack {
  T v[E];
};

constexpr int kRowThreads = 256;  // row entries: one block per row
constexpr int kMaxD = 8192;  // row entries: the widest row

// Sum over the block of kRowThreads; every thread gets the total.  The
// first barrier lets a second call reuse `red`.
__device__ __forceinline__ float row_sum(float v) {
  __shared__ float red[kRowThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) t += red[w];
  return t;
}

// the E f32 weights of the 16-byte vector c of a row
template <int E>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int c, float (&wf)[E]) {
  const float4* wv = reinterpret_cast<const float4*>(w + c * E);
#pragma unroll
  for (int u = 0; u < E / 4; ++u) {
    const float4 q4 = wv[u];
    wf[4 * u] = q4.x; wf[4 * u + 1] = q4.y; wf[4 * u + 2] = q4.z; wf[4 * u + 3] = q4.w;
  }
}

}  // namespace
