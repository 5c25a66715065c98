// Joint q/k RMSNorm backward (QK-norm) for Hopper (sm_90a): K5 (dx) and K6
// (dw), each for q and k in one launch.
//
// Replaces: repro/kernels/fused_rmsnorm/rmsnorm.py, rms_bwd_dx_pallas (body
// _bwd_dx_kernel) and rms_bwd_dw_pallas (body _bwd_dw_kernel), which the
// JAX model runs once for q and once for k:
//     x_hat = x * rstd,  dxhat = dy * w
//     dx = rstd * (dxhat - x_hat * mean(dxhat * x_hat))      (per row)
//     dw = sum_rows dy * x_hat                               ([dh] f32)
// from K4's residuals (x, w, rstd).  blockIdx.y picks the tensor.
//
// Bound on the H100: memory.  K5 reads dy and x and writes dx once; K6
// reads dy and x once and writes 2 * dh floats.  The least time of each is
// its bytes / 3.35 TB/s.
//
// K5 design: one warp per row of dh in {32, 64, 128}, each lane holding
// dh/32 consecutive elements (one vector load of dy, one of x, one store of
// dx), the row mean a warp shuffle reduction.  x arrives as the strided
// [B, S, H, dh] view of the fused qkv projection that K4 took (no copy);
// dy and dx are contiguous.
// K6 design: the D-tile coalesced reduction of K3 on narrow rows.  A block
// of 256 threads covers 256 / dh rows at a time with its threads across dh,
// marching down a chunk of rows in fp32 registers; the row groups of the
// block are added in a fixed order through shared memory, each block writes
// one partial row, and a second kernel adds the partials of each tensor in
// chunk order.  No atomics: the sums are the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // K5: rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowChunk = 512;  // K6: rows per partial sum
constexpr int kDwThreads = 256;

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
  const void* dy;     // [rows, D] contiguous
  const void* x;      // [B, S, H, D] strided
  const float* w;     // [D]
  const float* rstd;  // [rows]
  void* dx;           // [rows, D] contiguous (K5)
  float* dw;          // [D] (K6)
  int H;
  long long sb, ss, sh;  // element strides of x: batch, token, head
};

// element offset of row (b, s, h) of x
__device__ __forceinline__ long long x_offset(int row, int S, int H, long long sb,
                                              long long ss, long long sh) {
  const int h = row % H, bs = row / H;
  return static_cast<long long>(bs / S) * sb + static_cast<long long>(bs % S) * ss +
         static_cast<long long>(h) * sh;
}

// ---------------------------------------------------------------------------
// K5: dx, one warp per row
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
qk_rms_bwd_dx_kernel(const Side q, const Side k, int B, int S) {
  constexpr int E = D / 32;  // elements per lane
  // pick the tensor field by field: a reference to one of the two
  // parameter structs would copy it to the stack
  const bool is_k = blockIdx.y != 0;
  const int H = is_k ? k.H : q.H;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;  // rows < 2^31
  if (row >= B * S * H) return;
  const int lane = threadIdx.x % 32;
  const T* xs = static_cast<const T*>(is_k ? k.x : q.x) +
                x_offset(row, S, H, is_k ? k.sb : q.sb, is_k ? k.ss : q.ss, is_k ? k.sh : q.sh);
  const T* dys = static_cast<const T*>(is_k ? k.dy : q.dy) + static_cast<long long>(row) * D;
  const float* w = is_k ? k.w : q.w;
  const float r = (is_k ? k.rstd : q.rstd)[row];

  const Pack<T, E> xin = *reinterpret_cast<const Pack<T, E>*>(xs + lane * E);
  const Pack<T, E> din = *reinterpret_cast<const Pack<T, E>*>(dys + lane * E);
  float xh[E], dxh[E];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    xh[j] = to_f32(xin.v[j]) * r;
    dxh[j] = to_f32(din.v[j]) * w[lane * E + j];
    m += dxh[j] * xh[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m += __shfl_xor_sync(0xffffffffu, m, o);
  m /= D;

  Pack<T, E> out;
#pragma unroll
  for (int j = 0; j < E; ++j) out.v[j] = from_f32<T>(r * (dxh[j] - xh[j] * m));
  T* dst = static_cast<T*>(is_k ? k.dx : q.dx) + static_cast<long long>(row) * D;
  *reinterpret_cast<Pack<T, E>*>(dst + lane * E) = out;
}

// ---------------------------------------------------------------------------
// K6: dw — pass 1, partial sums over a chunk of rows
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
qk_rms_bwd_dw_partial_kernel(const Side q, const Side k, int B, int S, int D, float* part) {
  const bool is_k = blockIdx.y != 0;
  const int H = is_k ? k.H : q.H;
  const int rows = B * S * H;
  const int groups = kDwThreads / D;  // rows in flight
  const int c = threadIdx.x % D, rg = threadIdx.x / D;
  const T* x = static_cast<const T*>(is_k ? k.x : q.x);
  const T* dy = static_cast<const T*>(is_k ? k.dy : q.dy);
  const float* rstd = is_k ? k.rstd : q.rstd;
  const long long sb = is_k ? k.sb : q.sb, ss = is_k ? k.ss : q.ss, sh = is_k ? k.sh : q.sh;

  const int r0 = blockIdx.x * kRowChunk, r1 = min(r0 + kRowChunk, rows);
  float acc = 0.f;
  for (int row = r0 + rg; row < r1; row += groups) {
    const float d = to_f32(dy[static_cast<long long>(row) * D + c]);
    acc = fmaf(d, to_f32(x[x_offset(row, S, H, sb, ss, sh) + c]) * rstd[row], acc);
  }
  __shared__ float red[kDwThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  if (rg == 0) {
    float t = 0.f;
    for (int g = 0; g < groups; ++g) t += red[g * D + c];
    part[(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * D + c] = t;
  }
}

// pass 2: the partials of each tensor, added in chunk order
__global__ void qk_rms_bwd_dw_reduce_kernel(const float* __restrict__ part, float* dwq,
                                            float* dwk, int n_chunks, int D) {
  const int c = threadIdx.x, side = blockIdx.x;
  const float* p = part + static_cast<long long>(side) * n_chunks * D + c;
  float t = 0.f;
  for (int i = 0; i < n_chunks; ++i) t += p[static_cast<long long>(i) * D];
  (side ? dwk : dwq)[c] = t;
}

template <typename T>
cudaError_t launch_dx(int D, Side q, Side k, int B, int S, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * S * (q.H > k.H ? q.H : k.H);
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps), 2), block(kThreads);
  switch (D) {
    case 32: qk_rms_bwd_dx_kernel<T, 32><<<grid, block, 0, st>>>(q, k, B, S); break;
    case 64: qk_rms_bwd_dx_kernel<T, 64><<<grid, block, 0, st>>>(q, k, B, S); break;
    case 128: qk_rms_bwd_dx_kernel<T, 128><<<grid, block, 0, st>>>(q, k, B, S); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(int D, Side q, Side k, int B, int S, float* part, int n_chunks,
                      cudaStream_t st) {
  if (D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
  qk_rms_bwd_dw_partial_kernel<T><<<dim3(n_chunks, 2), kDwThreads, 0, st>>>(q, k, B, S, D, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qk_rms_bwd_dw_reduce_kernel<<<2, D, 0, st>>>(part, q.dw, k.dw, n_chunks, D);
  return cudaGetLastError();
}

Side side(const void* dy, const void* x, const void* w, const void* rstd, void* dx, void* dw,
          int H, long long sb, long long ss, long long sh) {
  return Side{dy, x, static_cast<const float*>(w), static_cast<const float*>(rstd), dx,
              static_cast<float*>(dw), H, sb, ss, sh};
}

}  // namespace

// K5.  dyq [B, S, Hq, D], dyk [B, S, Hk, D] contiguous; q, k: the forward's
// inputs with the given element strides (last axis contiguous); wq, wk:
// [D] f32; rq, rk: [B*S*H] f32; dq, dk: contiguous outputs in the input
// dtype.  Returns cudaGetLastError() after the launch.
extern "C" int qk_rms_bwd_dx(const void* dyq, const void* dyk, const void* q, const void* k,
                             const void* wq, const void* wk, const void* rq, const void* rk,
                             void* dq, void* dk, int B, int S, int Hq, int Hk, int D,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             int is_bf16, void* stream) {
  const Side sq = side(dyq, q, wq, rq, dq, nullptr, Hq, q_sb, q_ss, q_sh);
  const Side sk = side(dyk, k, wk, rk, dk, nullptr, Hk, k_sb, k_ss, k_sh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_dx<__nv_bfloat16>(D, sq, sk, B, S, st)
                                  : launch_dx<float>(D, sq, sk, B, S, st);
  return static_cast<int>(err);
}

// K6.  Arguments as K5 (no w, no dx); part: scratch of 2 * n_chunks * D
// f32 with n_chunks = ceil(B * S * max(Hq, Hk) / 512); dwq, dwk: [D] f32.
// Two launches (partials, then their fixed-order sum).
extern "C" int qk_rms_bwd_dw(const void* dyq, const void* dyk, const void* q, const void* k,
                             const void* rq, const void* rk, void* part, void* dwq, void* dwk,
                             int n_chunks, int B, int S, int Hq, int Hk, int D,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             int is_bf16, void* stream) {
  const Side sq = side(dyq, q, nullptr, rq, nullptr, dwq, Hq, q_sb, q_ss, q_sh);
  const Side sk = side(dyk, k, nullptr, rk, nullptr, dwk, Hk, k_sb, k_ss, k_sh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  const cudaError_t err = is_bf16 ? launch_dw<__nv_bfloat16>(D, sq, sk, B, S, pp, n_chunks, st)
                                  : launch_dw<float>(D, sq, sk, B, S, pp, n_chunks, st);
  return static_cast<int>(err);
}
