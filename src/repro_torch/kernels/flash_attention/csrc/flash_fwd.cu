// Segment-aware flash-attention forward for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention/flash.py,
// flash_attention_fwd_pallas (body _fwd_kernel): blocked attention with an
// fp32 online softmax, segment-id masking (equal ids see each other; -1 is
// an id like any other, so padding attends padding), an optional causal
// mask, GQA (q head h reads kv head h / (Hq / Hkv)), and a skip of every
// (q tile, kv tile) pair whose segment-id ranges do not overlap or that the
// causal triangle excludes.  Returns out and the fp32 log-sum-exp rows.
//
// Bound on the H100: at the serving shapes (S = 6240, dh = 128) the work is
// 4 * dh flops per visible (q, k) pair against 2 * dh bytes per row, so the
// tensor cores bound it, and only the tiles that run count.
//
// Design: one block of 4 warps per (q tile of 64 rows, head, batch); each
// warp owns 16 q rows.  The TPU's sequential kv grid axis becomes a loop
// over the live kv tiles of 64 inside the block, carrying the fp32
// (m, l, acc) state in registers.  bf16 inputs go through mma.sync
// m16n8k16 with fp32 accumulation, operands fetched with ldmatrix (V
// transposed on load): S = Q K^T lands in the accumulator layout, the
// softmax runs on those registers (row statistics shared by the 4 lanes of
// a quad through shuffles, exp2 on log2-scaled scores), and P is re-packed
// as bf16 straight into the A operand of P V, so neither S nor P touches
// shared memory.  K and V tiles stream in with cp.async, one buffer each:
// K of the next live tile loads during the softmax and P V of this one, V
// during the next scores.  A tile whose keys all share the q tile's single
// segment, with no ragged edge or causal cut, skips the mask arithmetic.
// The f32 path keeps the same fragment ownership but forms each product
// with SIMT FMAs, so its products are exact fp32.  The kernel takes the
// model's [B, S, H, dh] layout through strides (q, k, v are views of the
// fused projections), masks the ragged edge itself (zero-filled rows past
// S), and writes out in [B, Sq, Hq, dh].  NEG_INF is the finite -2e38 and
// a row that sees no key ends with l = 0, giving exact zeros through the
// LSE_FLOOR guard.  For bf16 inputs the output may be written in f32
// instead (out_f32): the training forward keeps the unrounded output as the
// residual of the backward's delta rows.  The tiles, fragments and masks
// are shared with the backward kernels (flash_common.cuh).  Not yet used:
// wgmma, TMA, warp specialisation.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_seg;   // [B, Sq] or null (one segment)
  const int* kv_seg;  // [B, Skv] or null
  void* out;          // [B, Sq, Hq, dh], q's dtype or f32
  float* lse;         // [B, Hq, Sq]
  int Hq, Hkv, Sq, Skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  float scale;
  int causal;
};

template <typename T, int DH>
constexpr int smem_bytes() { return 3 * tile_bytes<T, DH>() + staging_bytes<T>(); }

// OT: the output's type, T or f32 (the training residual).
template <typename T, typename OT, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = row_ld<T, DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + BK * LD);  // f32 path only
  __shared__ int qseg_s[BQ];

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* qseg = p.q_seg ? p.q_seg + static_cast<long long>(b) * p.Sq : nullptr;
  const int* kseg = p.kv_seg ? p.kv_seg + static_cast<long long>(b) * p.Skv : nullptr;

  int n_tiles = (p.Skv + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  int q_lo = 0, q_hi = 0, seg_a = 0, seg_b = 0;
  if (qseg) {
    // rows past Sq repeat the last real id, so ranges cover real rows only
    for (int i = threadIdx.x; i < BQ; i += kThreads) qseg_s[i] = qseg[min(q0 + i, p.Sq - 1)];
    __syncthreads();
    seg_a = qseg_s[warp * 16 + g];
    seg_b = qseg_s[warp * 16 + g + 8];
    warp_range(qseg_s[lane], qseg_s[lane + 32], q_lo, q_hi);
  }
  int k_lo = 0, k_hi = 0;
  int j = next_live(kseg, 0, n_tiles, p.Skv, q_lo, q_hi, lane, k_lo, k_hi);
  if (j < n_tiles) {  // K(j) and V(j) in flight while Q loads
    load_tile_async<T, DH>(Ks, kg, p.k_ss, j * BK, p.Skv);
    load_tile_async<T, DH>(Vs, vg, p.v_ss, j * BK, p.Skv);
  }
  load_tile<T, DH>(Qs, qg, p.q_ss, q0, p.Sq);

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float scale2 = p.scale * LOG2E;  // scores in log2 units: exp2 below
  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  // Pipeline, one buffer each: K(j+1) loads during softmax and P V of tile
  // j, V(j+1) during the scores of tile j+1.
  while (j < n_tiles) {
    const int k0 = j * BK;
    // every key of the tile visible to every row of the block: no mask
    const bool full = (!kseg || (q_lo == q_hi && k_lo == k_hi && q_lo == k_lo)) &&
                      k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= q0);
    int nk_lo = 0, nk_hi = 0;
    const int jn = next_live(kseg, j + 1, n_tiles, p.Skv, q_lo, q_hi, lane, nk_lo, nk_hi);

    cp_async_wait<1>();  // K(j) has landed; V(j) may still be in flight
    __syncthreads();
    float s[8][4];
    scores<T, DH>(s, Qs + warp * 16 * LD, Ks, g, t);
    __syncthreads();  // every warp is done with Ks
    if (jn < n_tiles) load_tile_async<T, DH>(Ks, kg, p.k_ss, jn * BK, p.Skv);

    uint32_t live = 0xffffffffu;  // bit nt * 4 + e: entry visible
    if (!full) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + nt * 8 + 2 * t + (e & 1);
          bool ok = c < p.Skv;
          if (p.causal) ok = ok && (e < 2 ? row_a : row_b) >= c;
          if (kseg) ok = ok && kseg[min(c, p.Skv - 1)] == (e < 2 ? seg_a : seg_b);
          if (!ok) live &= ~(1u << (nt * 4 + e));
        }
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = (live >> (nt * 4 + e)) & 1u ? s[nt][e] * scale2 : NEG_INF;
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float corr_a = exp2f(m_a - mx_a), corr_b = exp2f(m_b - mx_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked entries are exact zeros: exp(NEG_INF - NEG_INF) guard
        const float pe = (live >> (nt * 4 + e)) & 1u
                             ? exp2f(s[nt][e] - (e < 2 ? mx_a : mx_b)) : 0.f;
        s[nt][e] = pe;
        if (e < 2) sum_a += pe; else sum_b += pe;
      }
    }
    l_a = l_a * corr_a + quad_sum(sum_a);
    l_b = l_b * corr_b + quad_sum(sum_b);
    m_a = mx_a;
    m_b = mx_b;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      acc[d][0] *= corr_a;
      acc[d][1] *= corr_a;
      acc[d][2] *= corr_b;
      acc[d][3] *= corr_b;
    }

    if (jn < n_tiles) cp_async_wait<1>();  // V(j) has landed, K(jn) may not
    else cp_async_wait<0>();
    __syncthreads();
    accumulate<T, DH>(acc, s, Vs, Ps + warp * 16 * PLD, g, t);
    __syncthreads();  // every warp is done with Vs
    if (jn < n_tiles) load_tile_async<T, DH>(Vs, vg, p.v_ss, jn * BK, p.Skv);
    j = jn;
    k_lo = nk_lo;
    k_hi = nk_hi;
  }

  // m is in log2 units; a row that saw no key keeps m = NEG_INF, l = 0
  const float den_a = fmaxf(l_a, LSE_FLOOR), den_b = fmaxf(l_b, LSE_FLOOR);
  const float lse_a = (m_a == NEG_INF ? NEG_INF : m_a * LN2) + logf(den_a);
  const float lse_b = (m_b == NEG_INF ? NEG_INF : m_b * LN2) + logf(den_b);
  OT* og = static_cast<OT*>(p.out);
  if (row_a < p.Sq) {
    OT* o = og + ((static_cast<long long>(b) * p.Sq + row_a) * p.Hq + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) store2(o + d * 8, acc[d][0] / den_a, acc[d][1] / den_a);
    if (t == 0) p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row_a] = lse_a;
  }
  if (row_b < p.Sq) {
    OT* o = og + ((static_cast<long long>(b) * p.Sq + row_b) * p.Hq + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) store2(o + d * 8, acc[d][2] / den_b, acc[d][3] / den_b);
    if (t == 0) p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row_b] = lse_b;
  }
}

template <typename T, typename OT, int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  constexpr int bytes = smem_bytes<T, DH>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, OT, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B), block(kThreads);
  flash_fwd_kernel<T, OT, DH><<<grid, block, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T, typename OT>
cudaError_t launch_dh(const Params& p, int B, int dh, cudaStream_t st) {
  switch (dh) {
    case 32: return launch<T, OT, 32>(p, B, st);
    case 64: return launch<T, OT, 64>(p, B, st);
    case 128: return launch<T, OT, 128>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, Sq, Hq, dh], k, v: [B, Skv, Hkv, dh], each with element strides
// (batch, token, head) and a contiguous last axis; q_seg [B, Sq] and
// kv_seg [B, Skv] int32, both null for one segment; out: contiguous
// [B, Sq, Hq, dh] in q's dtype, or f32 with out_f32 (the training
// residual of bf16 inputs); lse: [B, Hq, Sq] f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* q_seg, const void* kv_seg, void* out, void* lse,
                         int B, int Hq, int Hkv, int Sq, int Skv, int dh,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int causal, int is_bf16, int out_f32, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = !is_bf16 ? launch_dh<float, float>(p, B, dh, st)
                         : out_f32 ? launch_dh<__nv_bfloat16, float>(p, B, dh, st)
                                   : launch_dh<__nv_bfloat16, __nv_bfloat16>(p, B, dh, st);
  return static_cast<int>(err);
}
