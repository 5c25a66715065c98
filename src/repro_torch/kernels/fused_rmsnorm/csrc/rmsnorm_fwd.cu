// RMSNorm forward for Hopper (sm_90a), two C entries.
//
// Replaces: repro/kernels/fused_rmsnorm/rmsnorm.py, rms_fwd_pallas (body
// _fwd_kernel):
//     y = x * rsqrt(mean(x^2) + eps) * w,   rstd kept in f32.
// The JAX model calls it on per-head q and k rows (QK-norm) and on model
// rows of d_model (the LM's norm1, norm2 and final_norm).
//
// * qk_rms_fwd: one launch normalises q and k together (the paper's
//   QNorm+KNorm fusion): blockIdx.y picks the tensor.
// * rms_fwd: rows of any d that is a multiple of 8, up to 8192.
//
// Bound on the H100: memory.  Each row is read once and written once for
// ~4 flops an element; the least time is (read x + write y + rstd) /
// 3.35 TB/s.
//
// Design of qk_rms_fwd: one warp per row of dh in {32, 64, 128}, each lane holding dh/32
// consecutive elements in registers (one vector load and one vector store
// per lane), the sum of squares a warp shuffle reduction.  q and k arrive as
// strided views of the fused qkv projection ([B, S, H, dh] with the head
// rows inside a wider token row), so the kernel takes (batch, token, head)
// strides and no copy is made; the outputs are contiguous [B, S, H, dh].
//
// Design of rms_fwd: one block of 256 threads per row.  A thread loads its
// 16-byte vectors of the row (8 bf16 or 4 f32; at most 4 or 8 of them for
// d = 8192) into registers in one pass, the sum of squares is reduced over
// the warp by shuffles and over the block's 8 warps through shared memory,
// and the same registers are scaled and stored: x is read from device
// memory once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = kWarps * 32;

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

struct Side {  // one of the two tensors
  const void* x;
  const float* w;
  void* y;
  float* rstd;
  int H;
  long long sb, ss, sh;  // element strides of x: batch, token, head
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
qk_rms_fwd_kernel(const Side q, const Side k, int B, int S, float eps) {
  constexpr int E = D / 32;  // elements per lane
  // pick the tensor field by field: a reference to one of the two
  // parameter structs would copy it to the stack
  const bool is_k = blockIdx.y != 0;
  const int H = is_k ? k.H : q.H;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;  // rows < 2^31
  if (row >= B * S * H) return;
  const int lane = threadIdx.x % 32;
  const int h = row % H, bs = row / H;
  const int s = bs % S, b = bs / S;
  const T* src = static_cast<const T*>(is_k ? k.x : q.x) +
                 b * (is_k ? k.sb : q.sb) + s * (is_k ? k.ss : q.ss) + h * (is_k ? k.sh : q.sh);
  const float* w = is_k ? k.w : q.w;

  const Pack<T, E> in = *reinterpret_cast<const Pack<T, E>*>(src + lane * E);
  float v[E];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    v[j] = to_f32(in.v[j]);
    ss += v[j] * v[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float rstd = rsqrtf(ss / D + eps);

  Pack<T, E> out;
#pragma unroll
  for (int j = 0; j < E; ++j) out.v[j] = from_f32<T>(v[j] * rstd * w[lane * E + j]);
  T* dst = static_cast<T*>(is_k ? k.y : q.y) + static_cast<long long>(row) * D;
  *reinterpret_cast<Pack<T, E>*>(dst + lane * E) = out;
  if (lane == 0) (is_k ? k.rstd : q.rstd)[row] = rstd;
}

template <typename T>
cudaError_t launch(int D, Side q, Side k, int B, int S, float eps, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * S * (q.H > k.H ? q.H : k.H);
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps), 2), block(kThreads);
  switch (D) {
    case 32: qk_rms_fwd_kernel<T, 32><<<grid, block, 0, st>>>(q, k, B, S, eps); break;
    case 64: qk_rms_fwd_kernel<T, 64><<<grid, block, 0, st>>>(q, k, B, S, eps); break;
    case 128: qk_rms_fwd_kernel<T, 128><<<grid, block, 0, st>>>(q, k, B, S, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

constexpr int kRowThreads = 256;
constexpr int kMaxD = 8192;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
rms_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
               float* __restrict__ rstd_out, int D, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kMaxVec = kMaxD / E / kRowThreads;  // vectors a thread holds
  const long long row = blockIdx.x;
  const T* src = x + row * D;
  const int nvec = D / E;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  Pack<T, E> v[kMaxVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < nvec) {
      v[i] = *reinterpret_cast<const Pack<T, E>*>(src + c * E);
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const float f = to_f32(v[i].v[u]);
        ss += f * f;
      }
    }
  }
  __shared__ float part[kRowThreads / 32];
  __shared__ float rstd_s;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float tot = lane < kRowThreads / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    if (lane == 0) {
      rstd_s = rsqrtf(tot / D + eps);
      rstd_out[row] = rstd_s;
    }
  }
  __syncthreads();
  const float r = rstd_s;
  T* dst = y + row * D;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < nvec) {
      const float4* wv = reinterpret_cast<const float4*>(w + c * E);
      float wf[E];
#pragma unroll
      for (int u = 0; u < E / 4; ++u) {
        const float4 q4 = wv[u];
        wf[4 * u] = q4.x; wf[4 * u + 1] = q4.y; wf[4 * u + 2] = q4.z; wf[4 * u + 3] = q4.w;
      }
      Pack<T, E> o;
#pragma unroll
      for (int u = 0; u < E; ++u) o.v[u] = from_f32<T>(to_f32(v[i].v[u]) * r * wf[u]);
      *reinterpret_cast<Pack<T, E>*>(dst + c * E) = o;
    }
  }
}

}  // namespace

// x: contiguous [N, D] rows (D % 8 == 0, D <= 8192, 16-byte aligned);
// w: [D] f32; y: contiguous [N, D] in x's dtype; rstd: [N] f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int rms_fwd(const void* x, const void* w, void* y, void* rstd, int N, int D,
                       float eps, int is_bf16, void* stream) {
  if (D % 8 != 0 || D > kMaxD || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  const float* wf = static_cast<const float*>(w);
  if (is_bf16) {
    rms_fwd_kernel<__nv_bfloat16><<<N, kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wf, static_cast<__nv_bfloat16*>(y), r, D, eps);
  } else {
    rms_fwd_kernel<float><<<N, kRowThreads, 0, st>>>(
        static_cast<const float*>(x), wf, static_cast<float*>(y), r, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [B, S, Hq, D] and k: [B, S, Hk, D] with the given element strides
// (last axis contiguous); yq, yk: contiguous outputs of the same shapes;
// rq, rk: [B*S*H] f32.  Returns cudaGetLastError() after the launch.
extern "C" int qk_rms_fwd(const void* q, const void* k, const void* wq,
                          const void* wk, void* yq, void* yk, void* rq, void* rk,
                          int B, int S, int Hq, int Hk, int D,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          float eps, int is_bf16, void* stream) {
  const Side sq{q, static_cast<const float*>(wq), yq, static_cast<float*>(rq), Hq, q_sb, q_ss, q_sh};
  const Side sk{k, static_cast<const float*>(wk), yk, static_cast<float*>(rk), Hk, k_sb, k_ss, k_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(D, sq, sk, B, S, eps, st)
                                  : launch<float>(D, sq, sk, B, S, eps, st);
  return static_cast<int>(err);
}
