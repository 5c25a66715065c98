// RMSNorm forward for Hopper (sm_90a), three C entries.
//
// Replaces: repro/kernels/fused_rmsnorm/rmsnorm.py, rms_fwd_pallas (body
// _fwd_kernel):
//     y = x * rsqrt(mean(x^2) + eps) * w,   rstd kept in f32,
// and gated_rms_fwd_pallas (body _gated_fwd_kernel), K13:
//     y = x * rsqrt(mean(x^2) + eps) * w * silu(g),   rstd kept in f32.
// The JAX model calls the first on per-head q and k rows (QK-norm) and on
// model rows of d_model (the LM's norm1, norm2 and final_norm), the second
// on rows of d_inner (the Mamba-2 mixer's gate + norm before out_proj).
//
// * qk_rms_fwd: one launch normalises q and k together (the paper's
//   QNorm+KNorm fusion): blockIdx.y picks the tensor.
// * rms_fwd, gated_rms_fwd: rows of any d that is a multiple of 8, up to
//   8192.
//
// Bound on the H100: memory.  Each row is read once and written once for
// ~4 flops an element (K13: x and g read, y written, ~10 flops); the least
// time is (read x [+ g] + write y + rstd) / 3.35 TB/s.
//
// Design of qk_rms_fwd: one warp per row of dh in {32, 64, 128}, each lane holding dh/32
// consecutive elements in registers (one vector load and one vector store
// per lane), the sum of squares a warp shuffle reduction.  q and k arrive as
// strided views of the fused qkv projection ([B, S, H, dh] with the head
// rows inside a wider token row), so the kernel takes (batch, token, head)
// strides and no copy is made; the outputs are contiguous [B, S, H, dh].
//
// Design of rms_fwd and gated_rms_fwd: one block of 256 threads per row.
// A thread loads its 16-byte vectors of the row (8 bf16 or 4 f32; at most
// 4 or 8 of them for d = 8192) into registers in one pass, the sum of
// squares is reduced over the warp by shuffles and over the block's 8 warps
// through shared memory, and the same registers are scaled and stored: x
// is read from device memory once.  K13 reads each 16-byte vector of the
// gate only in the store pass, where it is used, so it too is read once and
// never held beside x.  The gate arrives as the z slice of the mixer's
// in_proj output (rows of d_inner inside rows of 2 d_inner + 2 d_state +
// heads), so x and g each take a row stride and no copy is made.

#include <stdint.h>

#include "rmsnorm_common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = kWarps * 32;

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

// 1 / sqrt(mean of squares + eps) of a row from each thread's share of the
// sum of squares; every thread gets it, and thread 0 stores it at *out.
__device__ __forceinline__ float row_rstd(float ss, int D, float eps, float* out) {
  const float r = rsqrtf(row_sum(ss) / D + eps);
  if (threadIdx.x == 0) *out = r;
  return r;
}

// Loads the row's 16-byte vectors into v and returns this thread's sum of
// squares.
template <typename T, int E, int NV>
__device__ __forceinline__ float load_row(const T* __restrict__ src, int nvec, Pack<T, E> (&v)[NV]) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
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
  return ss;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
rms_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
               float* __restrict__ rstd_out, int D, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kMaxVec = kMaxD / E / kRowThreads;  // vectors a thread holds
  const long long row = blockIdx.x;
  const int nvec = D / E;
  Pack<T, E> v[kMaxVec];
  const float r = row_rstd(load_row(x + row * D, nvec, v), D, eps, rstd_out + row);
  T* dst = y + row * D;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < nvec) {
      float wf[E];
      load_w(w, c, wf);
      Pack<T, E> o;
#pragma unroll
      for (int u = 0; u < E; ++u) o.v[u] = from_f32<T>(to_f32(v[i].v[u]) * r * wf[u]);
      *reinterpret_cast<Pack<T, E>*>(dst + c * E) = o;
    }
  }
}

// K13: y = x * rstd * w * silu(g), in that order of products (the JAX
// kernel's); silu(g) = g * sigmoid(g) in f32.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
gated_rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ w,
                     T* __restrict__ y, float* __restrict__ rstd_out, int D,
                     long long x_stride, long long g_stride, float eps) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kMaxVec = kMaxD / E / kRowThreads;
  const long long row = blockIdx.x;
  const int nvec = D / E;
  Pack<T, E> v[kMaxVec];
  const float r = row_rstd(load_row(x + row * x_stride, nvec, v), D, eps, rstd_out + row);
  const T* gs = g + row * g_stride;
  T* dst = y + row * D;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < nvec) {
      float wf[E];
      load_w(w, c, wf);
      const Pack<T, E> gp = *reinterpret_cast<const Pack<T, E>*>(gs + c * E);
      Pack<T, E> o;
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const float gf = to_f32(gp.v[u]);
        const float silu = gf * (1.f / (1.f + expf(-gf)));
        o.v[u] = from_f32<T>(to_f32(v[i].v[u]) * r * wf[u] * silu);
      }
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

// K13.  x, g: N rows of D (D % 8 == 0, D <= 8192) with row strides x_stride
// and g_stride in elements (each row 16-byte aligned, its elements
// contiguous); w: [D] f32; y: contiguous [N, D] in x's dtype; rstd: [N] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int gated_rms_fwd(const void* x, const void* g, const void* w, void* y, void* rstd,
                             int N, int D, long long x_stride, long long g_stride, float eps,
                             int is_bf16, void* stream) {
  if (D % 8 != 0 || D > kMaxD || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  const float* wf = static_cast<const float*>(w);
  if (is_bf16) {
    gated_rms_fwd_kernel<__nv_bfloat16><<<N, kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), wf,
        static_cast<__nv_bfloat16*>(y), r, D, x_stride, g_stride, eps);
  } else {
    gated_rms_fwd_kernel<float><<<N, kRowThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), wf, static_cast<float*>(y), r,
        D, x_stride, g_stride, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
