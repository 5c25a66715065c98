// Fused LayerNorm-Modulate (AdaLN) forward for Hopper (sm_90a).
//
// Replaces: repro/kernels/fused_adaln/adaln.py, adaln_fwd_pallas (body
// _fwd_kernel): fp32 LayerNorm statistics over D, then
//     y = (x - mu) * rstd * (1 + scale[b]) + shift[b]
// written in x's dtype, with mu and rstd [B, S] f32 kept for the backward.
//
// Bound on the H100: memory.  Per row it reads D elements of x and writes D
// elements of y (plus 8 bytes of statistics) for ~8 flops an element, far
// below the ~295 flops a byte where the card turns compute-bound.  The least
// time is (read x + write y) / 3.35 TB/s.
//
// Design: one block (a warp group, 128 threads) per row of [B*S, D].  Each
// thread loads its share of the row with 16-byte loads into registers, so x
// is read from device memory exactly once: the mean and then the variance
// (two-pass, as the reference computes it) are block reductions over those
// registers, and the normalised row is written straight back with 16-byte
// stores.  The normalised intermediate never exists in memory.  scale and
// shift are read in fp32 per sample, 16 bytes at a time (rows of a
// [B, 6, D] modulation tensor, hence the batch stride).  Any S is taken:
// rows are independent, so there is no tile of S to divide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // one warp group per row
constexpr int kMaxChunks = 8;  // 16-byte chunks per thread: D <= 8192 bf16, 4096 f32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Sum over the block; every thread gets the total.  `red` is reused by
// consecutive calls, hence the barrier before it is written.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adaln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ shift, T* __restrict__ y,
                 float* __restrict__ mu_out, float* __restrict__ rstd_out,
                 int S, int D, long long scale_stride, long long shift_stride,
                 float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  const long long row = blockIdx.x;  // row of [B*S, D]
  const long long b = row / S;
  const int nchunks = D / V;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);

  float v[kMaxChunks][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < nchunks) {
      const uint4 raw = xr[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] = to_f32(e[j]);
        sum += v[i][j];
      }
    }
  }
  __shared__ float red[kThreads / 32];
  const float mean = block_sum(sum, red) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    if (threadIdx.x + i * kThreads < nchunks) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / D + eps);

  const float* sc = scale + b * scale_stride;
  const float* sh = shift + b * shift_stride;
  uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < nchunks) {
      // the chunk's V modulation values, with 16-byte loads
      float scv[V], shv[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        *reinterpret_cast<float4*>(scv + j) = *reinterpret_cast<const float4*>(sc + c * V + j);
        *reinterpret_cast<float4*>(shv + j) = *reinterpret_cast<const float4*>(sh + c * V + j);
      }
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j)
        e[j] = from_f32<T>((v[i][j] - mean) * rstd * (1.f + scv[j]) + shv[j]);
      yr[c] = raw;
    }
  }
  if (threadIdx.x == 0) {
    mu_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

}  // namespace

// x, y: [rows, D] contiguous (rows = B*S), bf16 (is_bf16) or f32; scale,
// shift: f32 rows of D with batch strides; mu, rstd: [rows] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int adaln_fwd(const void* x, const void* scale, const void* shift,
                         void* y, void* mu, void* rstd, int rows, int S, int D,
                         long long scale_stride, long long shift_stride,
                         float eps, int is_bf16, void* stream) {
  const dim3 grid(rows), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    adaln_fwd_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(mu), static_cast<float*>(rstd), S, D,
        scale_stride, shift_stride, eps);
  } else {
    adaln_fwd_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<float*>(y),
        static_cast<float*>(mu), static_cast<float*>(rstd), S, D,
        scale_stride, shift_stride, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
