// Fused LayerNorm-Modulate (AdaLN) forward for Hopper (sm_90a): K1.
//
// Replaces: repro/kernels/fused_adaln/adaln.py, adaln_fwd_pallas (body
// _fwd_kernel): fp32 LayerNorm statistics over D, then
//     y = (x - mu) * rstd * (1 + scale[b]) + shift[b]
// written in x's dtype, with mu and rstd [B, S] f32 kept for the backward.
//
// Bound on the H100: memory.  Per row it reads D elements of x and writes D
// elements of y (plus 8 bytes of statistics) for ~8 flops an element, far
// below the ~295 flops a byte where the card turns compute-bound.  The least
// time is (read x + write y + the modulation once) / 3.35 TB/s.
//
// Design.  A block of 8 warps takes a run of rows of ONE sample (grid
// (blocks per sample, B); the wrapper's fwd_row_blocks sizes the run so
// that about three blocks sit on each SM).  It first stages the sample's
// 1 + scale and shift as f32 in shared memory, once: every row of the run
// reads them from there, not from L2.  Each row then belongs to one team of
// W warps (W = 1 up to 256 16-byte chunks a row, D 2048 in bf16; 2 or 4
// above): a lane holds its chunks (at most NC) in registers, so x is read
// from device memory once, and the mean and then the variance (two-pass,
// as the reference computes them) are warp shuffle reductions (with a
// named barrier across the team's warps for W > 1): no block barrier per
// row.  The next row's chunks are loaded into a second set of registers
// before the current row reduces, so a warp always has a row in flight.
// y leaves in 16-byte stores, mu and rstd once per row; x and y take the
// evict-first cache hint (each is touched once here).  Any S is taken: a
// block's run ends at its sample's last row.
//
// Tried and dropped: whole rows by cp.async.bulk into a per-warp ring of
// three shared-memory stages on mbarriers, in place of the second register
// set: slower at [4, 6240] and [1, 7877], where a warp has few rows to
// overlap (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Sum over a team of W warps; every lane of the team gets the total.  For
// W > 1 the warps' sums meet in red[team][slot][W] behind the team's named
// barrier.  Two slots (mean, variance) make reuse safe: a warp writes a
// slot again only after the team's next barrier, which every warp reaches
// after reading that slot.
template <int W>
__device__ __forceinline__ float team_sum(float v, float* red, int team, int slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (W > 1) {
    float* r = red + (team * 2 + slot) * W;
    if (threadIdx.x % 32 == 0) r[(threadIdx.x / 32) % W] = v;
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + team), "r"(32 * W) : "memory");
    v = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) v += r[i];
  }
  return v;
}

// The lane's chunks of one row: chunk tl + i * 32 W for i < NC, where it
// exists.  x is read once, so its lines are marked to leave L2 first.
template <int NC, int W>
__device__ __forceinline__ void load_row(uint4 (&v)[NC], const uint4* row, int tl, int nch) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = tl + i * 32 * W;
    if (c < nch) v[i] = __ldcs(row + c);  // read once: evict first
  }
}

template <typename T, int W, int NC>
__global__ void __launch_bounds__(kThreads)
adaln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ shift, T* __restrict__ y,
                 float* __restrict__ mu_out, float* __restrict__ rstd_out, int S, int D,
                 int rows_per_block, long long scale_stride, long long shift_stride, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int Q = V / 4;  // float4s of modulation per chunk
  constexpr int kTeams = kWarps / W;
  constexpr int kLanes = 32 * W;
  // (1 + scale), then shift, each as [Q][nch] float4: the lanes of a warp
  // read consecutive float4s, free of bank conflicts
  extern __shared__ float4 mod[];
  __shared__ float red[kTeams * 2 * W];
  const int nch = D / V;
  const long long b = blockIdx.y;
  {
    const float4* sc = reinterpret_cast<const float4*>(scale + b * scale_stride);
    const float4* sh = reinterpret_cast<const float4*>(shift + b * shift_stride);
    for (int i = threadIdx.x; i < D / 4; i += kThreads) {
      const int at = (i % Q) * nch + i / Q;
      float4 a = __ldg(sc + i);
      a.x += 1.f; a.y += 1.f; a.z += 1.f; a.w += 1.f;
      mod[at] = a;
      mod[Q * nch + at] = __ldg(sh + i);
    }
  }
  __syncthreads();

  const int team = threadIdx.x / kLanes, tl = threadIdx.x % kLanes;
  const int s0 = blockIdx.x * rows_per_block, s1 = min(s0 + rows_per_block, S);
  const uint4* xb = reinterpret_cast<const uint4*>(x + b * S * D);
  uint4* yb = reinterpret_cast<uint4*>(y + b * S * D);
  uint4 cur[NC], nxt[NC];
  int s = s0 + team;
  if (s < s1) load_row<NC, W>(cur, xb + static_cast<long long>(s) * nch, tl, nch);
  for (; s < s1; s += kTeams) {
    if (s + kTeams < s1)
      load_row<NC, W>(nxt, xb + static_cast<long long>(s + kTeams) * nch, tl, nch);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (tl + i * kLanes < nch) {
        const T* e = reinterpret_cast<const T*>(&cur[i]);
#pragma unroll
        for (int j = 0; j < V; ++j) sum += to_f32(e[j]);
      }
    }
    const float mean = team_sum<W>(sum, red, team, 0) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (tl + i * kLanes < nch) {
        const T* e = reinterpret_cast<const T*>(&cur[i]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = to_f32(e[j]) - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(team_sum<W>(sq, red, team, 1) / D + eps);
    uint4* yr = yb + static_cast<long long>(s) * nch;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = tl + i * kLanes;
      if (c < nch) {
        const T* e = reinterpret_cast<const T*>(&cur[i]);
        float4 m4[2 * Q];  // the chunk's V values of 1 + scale, then of shift
#pragma unroll
        for (int q = 0; q < 2 * Q; ++q) m4[q] = mod[q * nch + c];
        const float* m = reinterpret_cast<const float*>(m4);
        uint4 raw;
        T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = from_f32<T>((to_f32(e[j]) - mean) * rstd * m[j] + m[V + j]);
        __stcs(yr + c, raw);  // written once: evict first
      }
    }
    if (tl == 0) {
      mu_out[b * S + s] = mean;
      rstd_out[b * S + s] = rstd;
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) cur[i] = nxt[i];
  }
}

template <typename T, int W, int NC>
cudaError_t launch(const void* x, const void* scale, const void* shift, void* y, void* mu,
                   void* rstd, int B, int S, int D, int rows_per_block, int blocks_per_sample,
                   long long scale_stride, long long shift_stride, float eps, cudaStream_t st) {
  const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        adaln_fwd_kernel<T, W, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  adaln_fwd_kernel<T, W, NC><<<dim3(blocks_per_sample, B), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(y), static_cast<float*>(mu),
      static_cast<float*>(rstd), S, D, rows_per_block, scale_stride, shift_stride, eps);
  return cudaGetLastError();
}

// The team width W and the chunks a lane holds (NC, rounded up to 4, 6 or
// 8) for a row of nch 16-byte chunks (fwd_team in the CPU tests mirrors it).
template <typename T>
cudaError_t dispatch(const void* x, const void* scale, const void* shift, void* y, void* mu,
                     void* rstd, int B, int S, int D, int rows_per_block, int blocks_per_sample,
                     long long scale_stride, long long shift_stride, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int nch = D / V;
  if (D % V != 0 || nch < 1 || nch > 4 * 32 * 8) return cudaErrorInvalidValue;
  const int W = nch <= 256 ? 1 : nch <= 512 ? 2 : 4;
  const int per = (nch + 32 * W - 1) / (32 * W);
#define ARGS x, scale, shift, y, mu, rstd, B, S, D, rows_per_block, blocks_per_sample, \
             scale_stride, shift_stride, eps, st
  if (W == 1) {
    if (per <= 4) return launch<T, 1, 4>(ARGS);
    if (per <= 6) return launch<T, 1, 6>(ARGS);
    return launch<T, 1, 8>(ARGS);
  }
  if (W == 2) return per <= 6 ? launch<T, 2, 6>(ARGS) : launch<T, 2, 8>(ARGS);
  return per <= 6 ? launch<T, 4, 6>(ARGS) : launch<T, 4, 8>(ARGS);
#undef ARGS
}

}  // namespace

// x, y: [B, S, D] contiguous, bf16 (is_bf16) or f32, D a multiple of the
// 16-byte vector, at most 1024 vectors; scale, shift: f32 rows of D with
// batch strides, 16-byte aligned; mu, rstd: [B, S] f32.  Each block takes
// rows_per_block rows of one sample: grid (blocks_per_sample, B), with
// blocks_per_sample = ceil(S / rows_per_block).  Returns cudaGetLastError()
// after the launch.
extern "C" int adaln_fwd(const void* x, const void* scale, const void* shift, void* y, void* mu,
                         void* rstd, int B, int S, int D, int rows_per_block,
                         int blocks_per_sample, long long scale_stride, long long shift_stride,
                         float eps, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || rows_per_block < 1 ||
      static_cast<long long>(rows_per_block) * blocks_per_sample < S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, scale, shift, y, mu, rstd, B, S, D, rows_per_block,
                                        blocks_per_sample, scale_stride, shift_stride, eps, st)
              : dispatch<float>(x, scale, shift, y, mu, rstd, B, S, D, rows_per_block,
                                blocks_per_sample, scale_stride, shift_stride, eps, st);
  return static_cast<int>(err);
}
