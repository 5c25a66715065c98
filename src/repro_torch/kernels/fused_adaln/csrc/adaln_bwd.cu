// Fused LayerNorm-Modulate (AdaLN) backward for Hopper (sm_90a): K2 (dx),
// K3 (d scale, d shift) and K10 (the same sums, naive access).
//
// Replaces: repro/kernels/fused_adaln/adaln.py, adaln_bwd_dx_pallas (body
// _bwd_dx_kernel), adaln_bwd_dmod_pallas (body _bwd_dmod_kernel) and
// adaln_bwd_dmod_naive_pallas (body _bwd_dmod_naive_kernel):
//     x_hat = (x - mu) * rstd,   dxhat = dy * (1 + scale[b])
//     dx     = (dxhat - mean(dxhat) - x_hat * mean(dxhat * x_hat)) * rstd
//     dshift = sum_s dy,   dscale = sum_s dy * x_hat          ([B, D] f32)
// from K1's residuals (x, scale, mu, rstd); statistics in fp32.
//
// Bound on the H100: memory.  K2 reads dy and x and writes dx once (a few
// flops an element); K3 reads dy and x once and writes 2 * B * D floats.
// The least time of each is its bytes / 3.35 TB/s.
//
// K2 design: one block (a warp group) per row of [B*S, D], as K1: each
// thread holds its share of the row (dy and x, 16-byte loads) in registers,
// the two row means are block reductions over those registers, and dx is
// written straight back.  The number of 16-byte chunks a thread holds is a
// template parameter picked from D at launch, so D = 1536 keeps 2, not 8.
//
// K3 design: the paper's D-tile coalesced reduction.  Threads run across D
// (16 bytes each, neighbouring threads on neighbouring addresses) and
// march down a chunk of rows, summing in fp32 registers; each (sample,
// row chunk) block writes one partial row per output, and a second kernel
// adds the partials of each sample in a fixed order.  No atomics: the sums
// are the same bits on every run.  The TPU kernel keeps its accumulator
// resident across a sequential S grid axis; here the chunks run in
// parallel and the fixed-order second pass takes the place of that axis.
//
// K10 design: the paper's Fig. 1 "naive access", kept on purpose as the
// partner K3 is measured against.  As in the TPU kernel (one grid step per
// sample over the whole [S, D] slab), one block per sample sweeps all S
// rows: no D-tiling across blocks, no split over S, no cluster, so only B
// blocks run on the 132 SMs and each streams 2 * S * D elements alone.
// Within that access the block is tuned to feed its one SM: up to 992
// consumer threads own 16-byte columns in row groups (5 groups of 192 at
// D 1536 in bf16), and a producer warp streams whole runs of rows of dy
// and x by cp.async.bulk into two shared-memory stages of about 100 KB on
// mbarriers, each stage's mu and rstd staged once beside them by 4-byte
// cp.async.  Each group sums its rows in order in fp32 registers and the
// groups' sums are added in group order at the end: deterministic, no
// atomics.  Its ceiling is one SM's shared-memory traffic (each byte
// written by the copy and read once), not the card's memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

constexpr int kThreads = 128;  // K2: one warp group per row
constexpr int kRowChunk = 32;  // K3: rows per partial sum
constexpr int kMaxDmodThreads = 256;

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

// ---------------------------------------------------------------------------
// K2: dx, one block per row
// ---------------------------------------------------------------------------

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads)
adaln_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                    const float* __restrict__ mu, const float* __restrict__ rstd,
                    const float* __restrict__ scale, T* __restrict__ dx,
                    int S, int D, long long scale_stride) {
  constexpr int V = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const long long b = row / S;
  const int nchunks = D / V;
  const float m = mu[row], r = rstd[row];
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * D);
  const float* sc = scale + b * scale_stride;

  float xh[CH][V], dxh[CH][V];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < nchunks) {
      const uint4 rx = xr[c], rd = dyr[c];
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* ed = reinterpret_cast<const T*>(&rd);
      float scv[V];
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(scv + j) = *reinterpret_cast<const float4*>(sc + c * V + j);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xh[i][j] = (to_f32(ex[j]) - m) * r;
        dxh[i][j] = to_f32(ed[j]) * (1.f + scv[j]);
        s1 += dxh[i][j];
        s2 += dxh[i][j] * xh[i][j];
      }
    }
  }
  __shared__ float red[kThreads / 32];
  const float m1 = block_sum(s1, red) / D;
  const float m2 = block_sum(s2, red) / D;
  uint4* dxr = reinterpret_cast<uint4*>(dx + row * D);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < nchunks) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = from_f32<T>((dxh[i][j] - m1 - xh[i][j] * m2) * r);
      dxr[c] = raw;
    }
  }
}

template <typename T>
cudaError_t launch_dx(const void* dy, const void* x, const void* mu, const void* rstd,
                      const void* scale, void* dx, int rows, int S, int D,
                      long long scale_stride, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int per_thread = (D / V + kThreads - 1) / kThreads;
  const dim3 grid(rows), block(kThreads);
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const float* mup = static_cast<const float*>(mu);
  const float* rp = static_cast<const float*>(rstd);
  const float* sp = static_cast<const float*>(scale);
  T* dxp = static_cast<T*>(dx);
#define K2_LAUNCH(CH) \
  adaln_bwd_dx_kernel<T, CH><<<grid, block, 0, st>>>(dyp, xp, mup, rp, sp, dxp, S, D, scale_stride)
  if (per_thread <= 1) K2_LAUNCH(1);
  else if (per_thread <= 2) K2_LAUNCH(2);
  else if (per_thread <= 4) K2_LAUNCH(4);
  else if (per_thread <= 8) K2_LAUNCH(8);
  else return cudaErrorInvalidValue;
#undef K2_LAUNCH
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3: d scale, d shift — pass 1, partial sums over a chunk of rows
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxDmodThreads)
adaln_bwd_dmod_partial_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                              const float* __restrict__ mu, const float* __restrict__ rstd,
                              float* __restrict__ part_scale, float* __restrict__ part_shift,
                              int S, int D) {
  constexpr int V = 16 / sizeof(T);
  const int chunk = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int r0 = chunk * kRowChunk, r1 = min(r0 + kRowChunk, S);
  const long long base = static_cast<long long>(b) * S;
  for (int c = threadIdx.x; c < D / V; c += blockDim.x) {
    float ash[V], asc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) ash[j] = asc[j] = 0.f;
    for (int s = r0; s < r1; ++s) {
      const long long row = base + s;
      const float m = mu[row], r = rstd[row];
      const uint4 rx = reinterpret_cast<const uint4*>(x + row * D)[c];
      const uint4 rd = reinterpret_cast<const uint4*>(dy + row * D)[c];
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* ed = reinterpret_cast<const T*>(&rd);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = to_f32(ed[j]);
        ash[j] += d;
        asc[j] = fmaf(d, (to_f32(ex[j]) - m) * r, asc[j]);
      }
    }
    const long long o = (static_cast<long long>(b) * n_chunks + chunk) * D + c * V;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      *reinterpret_cast<float4*>(part_shift + o + j) = make_float4(ash[j], ash[j + 1], ash[j + 2], ash[j + 3]);
      *reinterpret_cast<float4*>(part_scale + o + j) = make_float4(asc[j], asc[j + 1], asc[j + 2], asc[j + 3]);
    }
  }
}

// pass 2: the partials of each sample, added in chunk order
__global__ void adaln_bwd_dmod_reduce_kernel(const float* __restrict__ part_scale,
                                             const float* __restrict__ part_shift,
                                             float* __restrict__ dscale, float* __restrict__ dshift,
                                             int n_chunks, int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (c >= D) return;
  float sc = 0.f, sh = 0.f;
  const long long base = static_cast<long long>(b) * n_chunks * D + c;
  for (int k = 0; k < n_chunks; ++k) {
    sc += part_scale[base + static_cast<long long>(k) * D];
    sh += part_shift[base + static_cast<long long>(k) * D];
  }
  dscale[static_cast<long long>(b) * D + c] = sc;
  dshift[static_cast<long long>(b) * D + c] = sh;
}

template <typename T>
cudaError_t launch_dmod(const void* dy, const void* x, const void* mu, const void* rstd,
                        void* part_scale, void* part_shift, void* dscale, void* dshift,
                        int B, int S, int D, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int n_chunks = (S + kRowChunk - 1) / kRowChunk;
  const int groups = D / V;
  const int threads = min(kMaxDmodThreads, (groups + 31) / 32 * 32);
  adaln_bwd_dmod_partial_kernel<T><<<dim3(n_chunks, B), threads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<float*>(part_scale),
      static_cast<float*>(part_shift), S, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adaln_bwd_dmod_reduce_kernel<<<dim3((D + 255) / 256, B), 256, 0, st>>>(
      static_cast<const float*>(part_scale), static_cast<const float*>(part_shift),
      static_cast<float*>(dscale), static_cast<float*>(dshift), n_chunks, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10: d scale, d shift with naive access — one block per sample
// ---------------------------------------------------------------------------

constexpr int kNaiveMaxThreads = 1024;
constexpr int kNaiveStages = 2;  // K10's ring: one stage in flight while the other is summed

// 4 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(sm90::smem_u32(dst)), "l"(src) : "memory");
}

// The block of sample b: `groups` row groups of consumer threads, then one
// producer warp.  A consumer owns CPT 16-byte columns of a row (c, c + cpg,
// ... with cpg the consumers of a group; CPT is 2 only where a row has more
// columns than 992 threads); a stage holds `rows` consecutive rows of dy
// and of x (rows a multiple of groups) and their mu, rstd, in a ring of
// kNaiveStages slots.  The producer warp fills slot after slot: lane 0 two
// cp.async.bulk copies a stage (rows s .. s + rows - 1 of a sample are one
// run of rows * D elements) and one arrival with their transaction bytes
// on the slot's `full` barrier; its lanes the stage's mu and rstd by
// 4-byte cp.async, each lane arriving once its copies have landed.  It
// refills a slot once every consumer warp has arrived on the slot's
// `empty` barrier.  Group g sums rows g, g + groups, ... in order in fp32
// registers, x_hat by one fma (x * rstd - mu * rstd); at the end the
// groups' sums are added in group order through shared memory.
template <typename T, int CPT>
__global__ void __launch_bounds__(kNaiveMaxThreads)
adaln_bwd_dmod_naive_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                            const float* __restrict__ mu, const float* __restrict__ rstd,
                            float* __restrict__ dscale, float* __restrict__ dshift, int S, int D,
                            int groups, int rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int stages = kNaiveStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cols = D / V, cpg = (cols + CPT - 1) / CPT;
  const int tid = threadIdx.x, lane = tid % 32, b = blockIdx.x;
  const int n_cons = (groups * cpg + 31) / 32;  // consumer warps; the producer warp follows
  const bool producer = tid >= n_cons * 32;
  const int grp = tid / cpg, c = tid % cpg;  // grp >= groups: no group
  const long long stage_elems = static_cast<long long>(rows) * D;
  T* ring = reinterpret_cast<T*>(smem);  // [stages][dy, x][rows * D]
  float* mus = reinterpret_cast<float*>(ring + 2 * stages * stage_elems);  // [stages][rows]
  float* rss = mus + stages * rows;                                         // [stages][rows]
  uint64_t* full = reinterpret_cast<uint64_t*>(rss + stages * rows);  // 8-byte aligned
  uint64_t* empty = full + stages;
  const int n_stages = (S + rows - 1) / rows;
  const long long base = static_cast<long long>(b) * S;
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      sm90::mbar_init(full + st, 1 + 32);  // lane 0's bytes, the producer lanes' mu / rstd copies
      sm90::mbar_init(empty + st, n_cons);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  float ash[CPT][V], asc[CPT][V];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) ash[k][j] = asc[k][j] = 0.f;
  if (producer) {
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % stages, s0 = i * rows, nr = min(rows, S - s0);
      if (i >= stages) sm90::mbar_wait(empty + st, ((i / stages) - 1) & 1);  // the slot is consumed
      if (lane == 0) {
        const uint32_t bytes = static_cast<uint32_t>(nr) * D * sizeof(T);
        sm90::mbar_expect_tx(full + st, 2 * bytes);
        sm90::bulk_load(ring + 2 * st * stage_elems, dy + (base + s0) * D, bytes, full + st);
        sm90::bulk_load(ring + (2 * st + 1) * stage_elems, x + (base + s0) * D, bytes, full + st);
      }
      for (int r = lane; r < nr; r += 32) {
        cp_async4(mus + st * rows + r, mu + base + s0 + r);
        cp_async4(rss + st * rows + r, rstd + base + s0 + r);
      }
      sm90::cp_async_arrive(full + st);
    }
  } else {
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % stages;
      sm90::mbar_wait(full + st, (i / stages) & 1);
      const int nr = min(rows, S - i * rows);
      const T* dys = ring + 2 * st * stage_elems;
      const T* xs = dys + stage_elems;
      for (int r = grp < groups ? grp : nr; r < nr; r += groups) {
        const float rs = rss[st * rows + r], mr = -mus[st * rows + r] * rs;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int ck = c + k * cpg;
          if (CPT > 1 && ck >= cols) break;
          const uint4 rd = *reinterpret_cast<const uint4*>(dys + r * D + ck * V);
          const uint4 rx = *reinterpret_cast<const uint4*>(xs + r * D + ck * V);
          const T* ed = reinterpret_cast<const T*>(&rd);
          const T* ex = reinterpret_cast<const T*>(&rx);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float d = to_f32(ed[j]);
            ash[k][j] += d;
            asc[k][j] = fmaf(d, fmaf(to_f32(ex[j]), rs, mr), asc[k][j]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + st);
    }
  }
  __syncthreads();  // every stage is consumed: the ring is free

  const long long o = static_cast<long long>(b) * D;
  float* red = reinterpret_cast<float*>(smem);  // [groups][shift, scale][D]
  if (grp < groups) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int ck = c + k * cpg;
      if (CPT > 1 && ck >= cols) break;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[(2 * grp) * D + ck * V + j] = ash[k][j];
        red[(2 * grp + 1) * D + ck * V + j] = asc[k][j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < D; e += blockDim.x) {
    float sh = red[e], sc = red[D + e];
    for (int gq = 1; gq < groups; ++gq) {
      sh += red[2 * gq * D + e];
      sc += red[(2 * gq + 1) * D + e];
    }
    dshift[o + e] = sh;
    dscale[o + e] = sc;
  }
}

// shared memory of K10's block: the ring, its mu / rstd and barriers, or
// the groups' sums at the end, whichever is larger
template <typename T>
size_t naive_smem(int D, int groups, int rows) {
  constexpr int stages = kNaiveStages;
  const size_t ring = 2 * static_cast<size_t>(stages) * rows * D * sizeof(T) +
                      2 * static_cast<size_t>(stages) * rows * sizeof(float);
  const size_t bars = (ring + 7) / 8 * 8 + 2 * static_cast<size_t>(stages) * sizeof(uint64_t);
  const size_t red = 2 * static_cast<size_t>(groups) * D * sizeof(float);
  return bars > red ? bars : red;
}

template <typename T, int CPT>
cudaError_t launch_naive_cpt(const void* dy, const void* x, const void* mu, const void* rstd,
                             void* dscale, void* dshift, int B, int S, int D, int threads,
                             int groups, int rows, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(adaln_bwd_dmod_naive_kernel<T, CPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  adaln_bwd_dmod_naive_kernel<T, CPT><<<B, threads, smem, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<float*>(dscale), static_cast<float*>(dshift),
      S, D, groups, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dmod_naive(const void* dy, const void* x, const void* mu, const void* rstd,
                              void* dscale, void* dshift, int B, int S, int D, int threads,
                              int groups, int rows, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int cols = D / V;
  const int cpt = cols > kNaiveMaxThreads - 32 ? 2 : 1;
  const int cpg = (cols + cpt - 1) / cpt;
  if (cols > 2 * (kNaiveMaxThreads - 32) || groups < 1 ||
      threads != (groups * cpg + 31) / 32 * 32 + 32 || threads > kNaiveMaxThreads ||
      rows < groups || rows % groups != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = naive_smem<T>(D, groups, rows);
  if (smem > 232448) return cudaErrorInvalidValue;
  return cpt == 1 ? launch_naive_cpt<T, 1>(dy, x, mu, rstd, dscale, dshift, B, S, D, threads,
                                           groups, rows, smem, st)
                  : launch_naive_cpt<T, 2>(dy, x, mu, rstd, dscale, dshift, B, S, D, threads,
                                           groups, rows, smem, st);
}

}  // namespace

// K2.  dy, x, dx: [rows, D] contiguous (rows = B*S), bf16 (is_bf16) or
// f32; mu, rstd: [rows] f32; scale: f32 rows of D with a batch stride.
// Returns cudaGetLastError() after the launch.
extern "C" int adaln_bwd_dx(const void* dy, const void* x, const void* mu, const void* rstd,
                            const void* scale, void* dx, int rows, int S, int D,
                            long long scale_stride, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dx<__nv_bfloat16>(dy, x, mu, rstd, scale, dx, rows, S, D, scale_stride, st)
              : launch_dx<float>(dy, x, mu, rstd, scale, dx, rows, S, D, scale_stride, st);
  return static_cast<int>(err);
}

// K3.  dy, x: [B, S, D] contiguous; mu, rstd: [B, S] f32; part_scale,
// part_shift: scratch of B * ceil(S / 32) * D f32 each; dscale,
// dshift: [B, D] f32.  Two launches (partials, then their fixed-order sum).
extern "C" int adaln_bwd_dmod(const void* dy, const void* x, const void* mu, const void* rstd,
                              void* part_scale, void* part_shift, void* dscale, void* dshift,
                              int B, int S, int D, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dmod<__nv_bfloat16>(dy, x, mu, rstd, part_scale, part_shift, dscale,
                                           dshift, B, S, D, st)
              : launch_dmod<float>(dy, x, mu, rstd, part_scale, part_shift, dscale, dshift,
                                   B, S, D, st);
  return static_cast<int>(err);
}

// K10.  dy, x: [B, S, D] contiguous, 16-byte aligned; mu, rstd: [B, S]
// f32; dscale, dshift: [B, D] f32.  The block's walk (adaln.py
// naive_plan): `groups` row groups of consumers and a producer warp
// (`threads` in all), stages of `rows` rows (a multiple of groups) in a
// ring of two.  One launch of B blocks.
extern "C" int adaln_bwd_dmod_naive(const void* dy, const void* x, const void* mu,
                                    const void* rstd, void* dscale, void* dshift, int B, int S,
                                    int D, int threads, int groups, int rows, int is_bf16,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dmod_naive<__nv_bfloat16>(dy, x, mu, rstd, dscale, dshift, B, S, D,
                                                 threads, groups, rows, st)
              : launch_dmod_naive<float>(dy, x, mu, rstd, dscale, dshift, B, S, D, threads,
                                         groups, rows, st);
  return static_cast<int>(err);
}
