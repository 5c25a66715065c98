// RMSNorm backward for Hopper (sm_90a): K5 (dx) and K6 (dw), on per-head
// q and k rows (QK-norm, both tensors in one launch) and on model rows.
//
// Replaces: repro/kernels/fused_rmsnorm/rmsnorm.py, rms_bwd_dx_pallas (body
// _bwd_dx_kernel) and rms_bwd_dw_pallas (body _bwd_dw_kernel), which the
// JAX model runs once for q and once for k, on the rows of each RMSNorm of
// the residual stream (norm1, final_norm) and, for the Mamba-2 mixer's
// gated norm, on the gate-scaled cotangent dy * silu(g):
//     x_hat = x * rstd,  dxhat = dy * w
//     dx = rstd * (dxhat - x_hat * mean(dxhat * x_hat))      (per row)
//     dw = sum_rows dy * x_hat                               ([D] f32)
// from K4's (or K13's) residuals (x, w, rstd).
//
// Bound on the H100: memory.  K5 reads dy and x and writes dx once; K6
// reads dy and x once and writes D floats (2 * dh for q/k).  The least time
// of each is its bytes / 3.35 TB/s.
//
// q/k entries.  K5: one warp per row of dh in {32, 64, 128}, each lane
// holding dh/32 consecutive elements (one vector load of dy, one of x, one
// store of dx), the row mean a warp shuffle reduction.  x arrives as the
// strided [B, S, H, dh] view of the fused qkv projection that K4 took (no
// copy); dy and dx are contiguous; blockIdx.y picks the tensor.  K6: a
// block of 256 threads sums a chunk of rows of one tensor.  A row takes
// dh / 8 lanes (bf16; dh / 4 in f32), one 16-byte vector each, so the block
// has 16 lane groups at dh 128 in bf16 (more at dh 32 and 64); each group
// walks its own contiguous run of rows, tokens outer and heads inner, so
// x's strided address advances by adds (no division per row), and loads
// four rows' vectors and their rstd (one float4) before it adds them into
// f32 registers.  The groups' sums are added in group order through shared
// memory into one partial row a block; a second kernel adds each tensor's
// partials in a fixed order (eight interleaved groups, then the groups in
// order).  The chunk is sized so that about 264 blocks a tensor fill the
// 132 SMs (the wrapper's qk_dw_chunks); 132 or 528 were slower, and eight
// rows in flight no faster than four (PERF.md).
//
// Row entries (rows of any D that is a multiple of 8 up to 8192).  K5: one
// block of 256 threads per row, as K4 on rows: a thread holds its 16-byte
// vectors of dy and x in registers, the row mean is a block reduction over
// them, and dx is written from the same registers.  K6: pass 1 gives each
// block a chunk of 32 rows and 128 16-byte columns; a thread sums its
// column's products down the chunk in f32 registers (neighbouring threads
// on neighbouring addresses) and writes one partial; pass 2 adds the
// partials of 32 columns per block, eight fixed groups of chunks in
// registers and then the eight group sums in a fixed order.
//
// No atomics anywhere: the sums are the same bits on every run.

#include <stdint.h>

#include "rmsnorm_common.cuh"

namespace {

constexpr int kWarps = 8;  // K5: rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kDwThreads = 256;  // K6 q/k pass 1
constexpr int kDwUnroll = 4;  // K6 q/k: rows a lane group loads before it adds them

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

// The rows of a tensor, walked as tokens (b, s) outer and heads h inner:
// row r = (b S + s) H + h, the order of dy and rstd.  Stepping to the next
// row moves x's offset by its head stride, and by the token and batch
// strides at the wraps: no division per row.
struct RowWalk {
  int h, s;
  long long off;  // element offset of the row's x
  __device__ RowWalk(int r, int S, int H, long long sb, long long ss, long long sh) {
    const int bs = r / H, b = bs / S;
    h = r - bs * H;
    s = bs - b * S;
    off = b * sb + s * ss + h * sh;
  }
  __device__ __forceinline__ void next(int S, int H, long long sb, long long ss, long long sh) {
    off += sh;
    if (++h == H) {
      h = 0;
      off += ss - H * sh;
      if (++s == S) {
        s = 0;
        off += sb - S * ss;
      }
    }
  }
};

// A block of 256 threads covers one chunk of `chunk` rows of one tensor
// (blockIdx.y).  A row takes L = D / E lanes, one 16-byte vector each, so
// the block holds G = 256 / L lane groups (16 at dh 128 in bf16); group g
// sums the contiguous run of chunk / G rows at r0 + g chunk / G, in row
// order, kDwUnroll rows at a time: their rstd in float4s, their dy and x
// vectors all loaded before the first is added.  The groups' sums are
// then added in group order through shared memory, and the block writes
// one partial row.  chunk is a multiple of G kDwUnroll (qk_dw_chunks in the
// wrapper), so every run starts on a float4 of rstd.
template <typename T, int D>
__global__ void __launch_bounds__(kDwThreads)
qk_rms_bwd_dw_partial_kernel(const Side q, const Side k, int B, int S, int chunk, float* part) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int L = D / E;  // lanes per row
  constexpr int G = kDwThreads / L;  // lane groups
  const bool is_k = blockIdx.y != 0;
  const int H = is_k ? k.H : q.H;
  const T* __restrict__ x = static_cast<const T*>(is_k ? k.x : q.x);
  const T* __restrict__ dy = static_cast<const T*>(is_k ? k.dy : q.dy);
  const float* __restrict__ rstd = is_k ? k.rstd : q.rstd;
  const long long sb = is_k ? k.sb : q.sb, ss = is_k ? k.ss : q.ss, sh = is_k ? k.sh : q.sh;
  const int rows = B * S * H;
  const int lane = threadIdx.x % L, g = threadIdx.x / L;
  const int run = chunk / G;
  const long long first = static_cast<long long>(blockIdx.x) * chunk + static_cast<long long>(g) * run;
  const int r0 = static_cast<int>(min(first, static_cast<long long>(rows)));
  const int r1 = static_cast<int>(min(first + run, static_cast<long long>(rows)));

  float acc[E];
#pragma unroll
  for (int u = 0; u < E; ++u) acc[u] = 0.f;
  if (r0 < r1) {
    RowWalk w(r0, S, H, sb, ss, sh);
    int r = r0;
    for (; r + kDwUnroll <= r1; r += kDwUnroll) {
      float rr[kDwUnroll];
#pragma unroll
      for (int j = 0; j < kDwUnroll; j += 4) {
        const float4 rv = *reinterpret_cast<const float4*>(rstd + r + j);
        rr[j] = rv.x; rr[j + 1] = rv.y; rr[j + 2] = rv.z; rr[j + 3] = rv.w;
      }
      Pack<T, E> xv[kDwUnroll], dv[kDwUnroll];
#pragma unroll
      for (int j = 0; j < kDwUnroll; ++j) {
        xv[j] = *reinterpret_cast<const Pack<T, E>*>(x + w.off + lane * E);
        dv[j] = *reinterpret_cast<const Pack<T, E>*>(dy + static_cast<long long>(r + j) * D + lane * E);
        w.next(S, H, sb, ss, sh);
      }
#pragma unroll
      for (int j = 0; j < kDwUnroll; ++j) {
#pragma unroll
        for (int u = 0; u < E; ++u)
          acc[u] = fmaf(to_f32(dv[j].v[u]), to_f32(xv[j].v[u]) * rr[j], acc[u]);
      }
    }
    for (; r < r1; ++r) {  // the tensor's last rows
      const float rr = rstd[r];
      const Pack<T, E> xv = *reinterpret_cast<const Pack<T, E>*>(x + w.off + lane * E);
      const Pack<T, E> dv = *reinterpret_cast<const Pack<T, E>*>(dy + static_cast<long long>(r) * D + lane * E);
#pragma unroll
      for (int u = 0; u < E; ++u) acc[u] = fmaf(to_f32(dv.v[u]), to_f32(xv.v[u]) * rr, acc[u]);
      w.next(S, H, sb, ss, sh);
    }
  }
  __shared__ float red[G][D];
#pragma unroll
  for (int u = 0; u < E; ++u) red[g][lane * E + u] = acc[u];
  __syncthreads();
  if (threadIdx.x < D) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) t += red[i][threadIdx.x];
    part[(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * D + threadIdx.x] = t;
  }
}

// Pass 2 of K6 (rows and q/k): each column's partials in a fixed order.
// Group k of kRedGroups takes chunks k, k + kRedGroups, ...; then the group
// sums are added in order.  A block covers kRedCols columns.
constexpr int kRedCols = 32;
constexpr int kRedGroups = 8;

__device__ __forceinline__ void dw_reduce(const float* __restrict__ part, float* __restrict__ dw,
                                          int n_chunks, int D) {
  __shared__ float red[kRedGroups][kRedCols];
  const int col = threadIdx.x % kRedCols, grp = threadIdx.x / kRedCols;
  const int c = blockIdx.x * kRedCols + col;
  float t = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int k = grp; k < n_chunks; k += kRedGroups) t += part[static_cast<long long>(k) * D + c];
  }
  red[grp][col] = t;
  __syncthreads();
  if (grp == 0 && c < D) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kRedGroups; ++k) s += red[k][col];
    dw[c] = s;
  }
}

// q/k pass 2: blockIdx.y picks the tensor
__global__ void __launch_bounds__(kRedCols * kRedGroups)
qk_rms_bwd_dw_reduce_kernel(const float* __restrict__ part, float* dwq, float* dwk, int n_chunks,
                            int D) {
  const int side = blockIdx.y;
  dw_reduce(part + static_cast<long long>(side) * n_chunks * D, side ? dwk : dwq, n_chunks, D);
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

template <typename T, int D>
cudaError_t launch_dw_d(Side q, Side k, int B, int S, float* part, int chunk, int n_chunks,
                        cudaStream_t st) {
  constexpr int G = kDwThreads / (D * static_cast<int>(sizeof(T)) / 16);
  if (chunk % (G * kDwUnroll) != 0) return cudaErrorInvalidValue;
  qk_rms_bwd_dw_partial_kernel<T, D><<<dim3(n_chunks, 2), kDwThreads, 0, st>>>(q, k, B, S, chunk,
                                                                               part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qk_rms_bwd_dw_reduce_kernel<<<dim3((D + kRedCols - 1) / kRedCols, 2), kRedCols * kRedGroups, 0,
                                st>>>(part, q.dw, k.dw, n_chunks, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(int D, Side q, Side k, int B, int S, float* part, int chunk, int n_chunks,
                      cudaStream_t st) {
  switch (D) {
    case 32: return launch_dw_d<T, 32>(q, k, B, S, part, chunk, n_chunks, st);
    case 64: return launch_dw_d<T, 64>(q, k, B, S, part, chunk, n_chunks, st);
    case 128: return launch_dw_d<T, 128>(q, k, B, S, part, chunk, n_chunks, st);
    default: return cudaErrorInvalidValue;
  }
}

Side side(const void* dy, const void* x, const void* w, const void* rstd, void* dx, void* dw,
          int H, long long sb, long long ss, long long sh) {
  return Side{dy, x, static_cast<const float*>(w), static_cast<const float*>(rstd), dx,
              static_cast<float*>(dw), H, sb, ss, sh};
}

// ---------------------------------------------------------------------------
// Row entries: K5 dx, one block per row
// ---------------------------------------------------------------------------

constexpr int kDwRows = 32;  // K6 rows: rows per partial sum (pass 1)
constexpr int kDwCols = 128;  // K6 rows: 16-byte columns per block (pass 1)

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
rms_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ rstd, T* __restrict__ dx, int D) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kMaxVec = kMaxD / E / kRowThreads;  // vectors a thread holds
  const long long row = blockIdx.x;
  const int nvec = D / E;
  const float r = rstd[row];
  Pack<T, E> xv[kMaxVec], dv[kMaxVec];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < nvec) {
      xv[i] = *reinterpret_cast<const Pack<T, E>*>(x + row * D + c * E);
      dv[i] = *reinterpret_cast<const Pack<T, E>*>(dy + row * D + c * E);
      float wf[E];
      load_w(w, c, wf);
#pragma unroll
      for (int u = 0; u < E; ++u) m += (to_f32(dv[i].v[u]) * wf[u]) * (to_f32(xv[i].v[u]) * r);
    }
  }
  m = row_sum(m) / D;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < nvec) {
      float wf[E];
      load_w(w, c, wf);
      Pack<T, E> o;
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const float xh = to_f32(xv[i].v[u]) * r, dxh = to_f32(dv[i].v[u]) * wf[u];
        o.v[u] = from_f32<T>(r * (dxh - xh * m));
      }
      *reinterpret_cast<Pack<T, E>*>(dx + row * D + c * E) = o;
    }
  }
}

// ---------------------------------------------------------------------------
// Row entries: K6 dw — pass 1, partial sums over a chunk of rows
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kDwCols)
rms_bwd_dw_partial_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                          const float* __restrict__ rstd, float* __restrict__ part, int N, int D) {
  constexpr int E = 16 / sizeof(T);
  const int c = blockIdx.y * kDwCols + threadIdx.x;  // 16-byte column
  if (c >= D / E) return;
  const int r0 = blockIdx.x * kDwRows, r1 = min(r0 + kDwRows, N);
  float acc[E];
#pragma unroll
  for (int u = 0; u < E; ++u) acc[u] = 0.f;
#pragma unroll 4
  for (int row = r0; row < r1; ++row) {
    const float r = rstd[row];
    const long long o = static_cast<long long>(row) * D + c * E;
    const Pack<T, E> xv = *reinterpret_cast<const Pack<T, E>*>(x + o);
    const Pack<T, E> dv = *reinterpret_cast<const Pack<T, E>*>(dy + o);
#pragma unroll
    for (int u = 0; u < E; ++u) acc[u] = fmaf(to_f32(dv.v[u]), to_f32(xv.v[u]) * r, acc[u]);
  }
  float* dst = part + static_cast<long long>(blockIdx.x) * D + c * E;
#pragma unroll
  for (int u = 0; u < E; u += 4)
    *reinterpret_cast<float4*>(dst + u) = make_float4(acc[u], acc[u + 1], acc[u + 2], acc[u + 3]);
}

// K6 rows pass 2
__global__ void __launch_bounds__(kRedCols * kRedGroups)
rms_bwd_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int n_chunks,
                         int D) {
  dw_reduce(part, dw, n_chunks, D);
}

template <typename T>
cudaError_t launch_row_dw(const void* dy, const void* x, const void* rstd, void* part, void* dw,
                          int N, int D, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const int n_chunks = (N + kDwRows - 1) / kDwRows;
  const dim3 grid(n_chunks, (D / E + kDwCols - 1) / kDwCols);
  rms_bwd_dw_partial_kernel<T><<<grid, kDwCols, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(rstd),
      static_cast<float*>(part), N, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_bwd_dw_reduce_kernel<<<(D + kRedCols - 1) / kRedCols, kRedCols * kRedGroups, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), n_chunks, D);
  return cudaGetLastError();
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

// K6.  Arguments as K5 (no w, no dx); rq, rk 16-byte aligned; chunk: rows
// per partial sum, a multiple of the lane groups times kDwUnroll; part:
// scratch of 2 * n_chunks * D f32 with n_chunks = ceil(B * S * max(Hq, Hk)
// / chunk); dwq, dwk: [D] f32.  Two launches (partials, then their
// fixed-order sum).
extern "C" int qk_rms_bwd_dw(const void* dyq, const void* dyk, const void* q, const void* k,
                             const void* rq, const void* rk, void* part, void* dwq, void* dwk,
                             int chunk, int n_chunks, int B, int S, int Hq, int Hk, int D,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             int is_bf16, void* stream) {
  const Side sq = side(dyq, q, nullptr, rq, nullptr, dwq, Hq, q_sb, q_ss, q_sh);
  const Side sk = side(dyk, k, nullptr, rk, nullptr, dwk, Hk, k_sb, k_ss, k_sh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  const cudaError_t err = is_bf16 ? launch_dw<__nv_bfloat16>(D, sq, sk, B, S, pp, chunk, n_chunks, st)
                                  : launch_dw<float>(D, sq, sk, B, S, pp, chunk, n_chunks, st);
  return static_cast<int>(err);
}

// K5 on rows.  dy, x, dx: contiguous [N, D] rows (D % 8 == 0, D <= 8192,
// 16-byte aligned), dy and dx in x's dtype; w: [D] f32; rstd: [N] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int rms_bwd_dx(const void* dy, const void* x, const void* w, const void* rstd, void* dx,
                          int N, int D, int is_bf16, void* stream) {
  if (D % 8 != 0 || D > kMaxD || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* r = static_cast<const float*>(rstd);
  if (is_bf16) {
    rms_bwd_dx_kernel<__nv_bfloat16><<<N, kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(x), wf, r,
        static_cast<__nv_bfloat16*>(dx), D);
  } else {
    rms_bwd_dx_kernel<float><<<N, kRowThreads, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x), wf, r,
        static_cast<float*>(dx), D);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6 on rows.  dy, x: contiguous [N, D] as K5; rstd: [N] f32; part:
// scratch of ceil(N / 32) * D f32; dw: [D] f32.  Two launches (partials,
// then their fixed-order sum).
extern "C" int rms_bwd_dw(const void* dy, const void* x, const void* rstd, void* part, void* dw,
                          int N, int D, int is_bf16, void* stream) {
  if (D % 8 != 0 || D > kMaxD || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_row_dw<__nv_bfloat16>(dy, x, rstd, part, dw, N, D, st)
                                  : launch_row_dw<float>(dy, x, rstd, part, dw, N, D, st);
  return static_cast<int>(err);
}
