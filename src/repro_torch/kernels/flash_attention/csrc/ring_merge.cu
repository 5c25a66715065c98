// The log-sum-exp merge of ring attention (K11) for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention/ring.py, _merge (the streaming
// fp32 merge of one ring hop's partial result, :90-103) and the
// normalisation that ends _ring_fwd_loop (:195-198).  The TPU ring ran both
// as XLA elementwise ops between the per-hop Pallas calls.
//
// ring_merge updates the running state of each (batch, head, query) row in
// place from one hop's block result (o_t, lse_t):
//     m' = max(m, lse_t),  alpha = exp(m - m'),  beta = exp(lse_t - m'),
//     s' = s * alpha + beta,  num' = num * alpha + beta * o_t;
// ring_finalize turns the state into the output and its log-sum-exp, in
// place: num <- num / max(s, LSE_FLOOR), m <- m + log(max(s, LSE_FLOOR)).
// The arithmetic is _merge's, in fp32, each product and sum rounded on its
// own (__fmul_rn / __fadd_rn: no fused multiply-add), with no atomics.
// NEG_INF is the finite -2e38 of the flash kernels, never -inf: a row that a
// hop masks completely arrives as (o = 0, lse = -2e38), and m - m' is formed
// before the exp, so two such constants cancel to exp(0) = 1, not a NaN.
//
// Bound on the H100: memory.  A row moves its dh-wide f32 num (read and
// written) and o_t (read) and three f32 statistics for 3 dh + 2 flops an
// element, so the least time is the bytes over 3.35 TB/s.
//
// Design: dh / 4 lanes own a row, one float4 of num and o_t each, so a warp
// covers 32 / (dh / 4) rows; rows are taken in the statistics' [B, Hq, Sq]
// order, so a warp's statistics are adjacent words and each row's dh values
// are one contiguous run of the [B, Sq, Hq, dh] state.  Every lane of a row
// reads the row's m, s and lse_t (one broadcast load), the warp
// synchronises, and then only the row's first lane writes m and s back, so
// the in-place update has no read-after-write race.  A fused elementwise
// pass like this would serve as well in Triton; the port builds every
// kernel from CUDA C++ with nvcc, so this one is CUDA too.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float LSE_FLOOR = 1e-37f;

struct Rows {
  long long n;  // B * Hq * Sq
  int Hq, Sq;
};

// row r = (b * Hq + h) * Sq + sq of the statistics -> its offset in
// [B, Sq, Hq, dh] (in units of DH floats)
__device__ __forceinline__ long long state_row(long long r, const Rows& p) {
  const long long sq = r % p.Sq, bh = r / p.Sq;
  const long long h = bh % p.Hq, b = bh / p.Hq;
  return (b * p.Sq + sq) * p.Hq + h;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
merge_kernel(float* m, float* s, float* num, const float* o, const float* lse, const Rows p) {
  constexpr int L = DH / 4;  // lanes per row
  const long long gt = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long r = gt / L;
  const int c = static_cast<int>(gt % L);
  const bool valid = r < p.n;
  float m0 = 0.f, s0 = 0.f, lt = 0.f;
  if (valid) {
    m0 = m[r];
    s0 = s[r];
    lt = lse[r];
  }
  __syncwarp();  // every lane has read m and s before the first lane writes
  if (!valid) return;
  const float mn = fmaxf(m0, lt);
  const float alpha = expf(m0 - mn), beta = expf(lt - mn);
  const long long off = state_row(r, p) * DH;
  float4* np_ = reinterpret_cast<float4*>(num + off) + c;
  const float4 ov = reinterpret_cast<const float4*>(o + off)[c];
  float4 nv = *np_;
  nv.x = __fadd_rn(__fmul_rn(nv.x, alpha), __fmul_rn(beta, ov.x));
  nv.y = __fadd_rn(__fmul_rn(nv.y, alpha), __fmul_rn(beta, ov.y));
  nv.z = __fadd_rn(__fmul_rn(nv.z, alpha), __fmul_rn(beta, ov.z));
  nv.w = __fadd_rn(__fmul_rn(nv.w, alpha), __fmul_rn(beta, ov.w));
  *np_ = nv;
  if (c == 0) {
    m[r] = mn;
    s[r] = __fadd_rn(__fmul_rn(s0, alpha), beta);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(float* m, const float* s, float* num, const Rows p) {
  constexpr int L = DH / 4;
  const long long gt = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long r = gt / L;
  const int c = static_cast<int>(gt % L);
  if (r >= p.n) return;
  const float den = fmaxf(s[r], LSE_FLOOR);
  float4* np_ = reinterpret_cast<float4*>(num + state_row(r, p) * DH) + c;
  float4 nv = *np_;
  nv.x = __fdiv_rn(nv.x, den);
  nv.y = __fdiv_rn(nv.y, den);
  nv.z = __fdiv_rn(nv.z, den);
  nv.w = __fdiv_rn(nv.w, den);
  *np_ = nv;
  if (c == 0) m[r] = __fadd_rn(m[r], logf(den));  // only this lane reads or writes m[r]
}

unsigned blocks_for(const Rows& p, int dh) {
  const long long threads = p.n * (dh / 4);
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// m, s, lse: contiguous [B, Hq, Sq] f32; num, o: contiguous [B, Sq, Hq, dh]
// f32; dh in {32, 64, 128}.  Updates m, s and num in place.  Returns
// cudaGetLastError() after the launch.
extern "C" int ring_merge(void* m, void* s, void* num, const void* o, const void* lse,
                          long long rows, int Hq, int Sq, int dh, void* stream) {
  const Rows p{rows, Hq, Sq};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* sf = static_cast<float*>(s);
  float* nf = static_cast<float*>(num);
  const float* of = static_cast<const float*>(o);
  const float* lf = static_cast<const float*>(lse);
  const unsigned grid = blocks_for(p, dh);
  switch (dh) {
    case 32: merge_kernel<32><<<grid, kThreads, 0, st>>>(mf, sf, nf, of, lf, p); break;
    case 64: merge_kernel<64><<<grid, kThreads, 0, st>>>(mf, sf, nf, of, lf, p); break;
    case 128: merge_kernel<128><<<grid, kThreads, 0, st>>>(mf, sf, nf, of, lf, p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same layouts: num <- num / max(s, LSE_FLOOR) (the output) and
// m <- m + log(max(s, LSE_FLOOR)) (its log-sum-exp), in place.
extern "C" int ring_finalize(void* m, const void* s, void* num, long long rows, int Hq, int Sq,
                             int dh, void* stream) {
  const Rows p{rows, Hq, Sq};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  const float* sf = static_cast<const float*>(s);
  float* nf = static_cast<float*>(num);
  const unsigned grid = blocks_for(p, dh);
  switch (dh) {
    case 32: finalize_kernel<32><<<grid, kThreads, 0, st>>>(mf, sf, nf, p); break;
    case 64: finalize_kernel<64><<<grid, kThreads, 0, st>>>(mf, sf, nf, p); break;
    case 128: finalize_kernel<128><<<grid, kThreads, 0, st>>>(mf, sf, nf, p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
