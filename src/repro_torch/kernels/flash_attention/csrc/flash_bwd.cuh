// Segment-aware flash-attention backward for Hopper (sm_90a): K8 (dq) and
// K9 (dk, dv).  Their entry points are flash_bwd_dq.cu and
// flash_bwd_dkv.cu, one translation unit each, so that nvcc builds the two
// kernels' instantiations side by side.
//
// Replaces: repro/kernels/flash_attention/flash.py,
// flash_attention_bwd_dq_pallas (body _bwd_dq_kernel, a kv sweep) and
// flash_attention_bwd_dkv_pallas (body _bwd_dkv_kernel, a q sweep with the
// GQA group summed on chip).  Both recompute each live tile from the
// forward's residuals (q, k, v, lse) and the output gradient do:
//     p  = exp(s * scale - lse)            the forward's softmax tile
//     ds = p * (do v^T - delta)            d(scores), delta = sum(do * out)
//     dq = scale * sum_tiles ds k          (K8)
//     dv = sum_tiles p^T do,  dk = scale * sum_tiles ds^T q   (K9)
// Masked entries (other segment, causal cut, ragged edge) are exact zeros,
// which also covers rows that see no key: their lse is NEG_INF, so
// exp(s - lse) would be 1 without the mask (flash.py:233-236).  The tile
// skip is K7's (flash_common.cuh next_live, 64 x 64 tiles, the causal
// triangle), so the live tile pairs are the forward's.
//
// Bound on the H100: tensor-core operations.  K8 forms three 64 x 64 x dh
// products per live tile (q k^T, do v^T, ds k), K9 four (k q^T, v do^T,
// p^T do, ds^T q), against 2 * dh bytes per row of each operand.  In f32
// (the ring's backward hops) each product runs three times in TF32.
//
// Design: no atomics and no cross-block reduction, as on the TPU.
// K8: one block of 4 warps per (q tile of 64 rows, q head, batch), each
// warp owning 16 q rows, sweeping the live kv tiles with the dq
// accumulator in registers.  It also forms delta = sum(do * out) for its
// rows from the f32 output residual (fused here instead of a separate
// pass) and writes it for K9, which runs after it on the stream.
// K9: one block per (kv tile of 64 rows, kv head, batch), each warp owning
// 16 kv rows, sweeping the q heads of its GQA group and, for each, the live
// q tiles, with the dk and dv accumulators in registers.  It computes the
// transposed tiles directly (s^T = k q^T, dp^T = v do^T), so every product
// has the register-resident operand on the left and reuses the forward's
// fragment code: scores() for the two score-shaped products, accumulate()
// (the P V step of the forward) for the two accumulations.  In bf16, p and
// ds are rounded to bf16 as the A operand of their products; in f32 they
// stay f32 and every product is 3xTF32 mma.sync (flash_common.cuh), about
// 1e-6 from exact f32.  Operand tiles stream in with cp.async, one buffer
// each, the next tile's loads issued as soon as the current one's last
// reader is done.  Not yet used: wgmma, TMA, double buffers.

#pragma once

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // [B, Sq, Hq, dh] strided like q, q's dtype
  const float* out;    // [B, Sq, Hq, dh] contiguous f32 (K8)
  const float* lse;    // [B, Hq, Sq]
  float* delta;        // [B, Hq, Sq]: written by K8, read by K9
  const int* q_seg;    // [B, Sq] or null (one segment)
  const int* kv_seg;   // [B, Skv] or null
  void* dq;            // [B, Sq, Hq, dh] contiguous, q's dtype
  void* dk;            // [B, Skv, Hkv, dh] contiguous
  void* dv;
  int Hq, Hkv, Sq, Skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

template <typename T, int DH>
constexpr int smem_bytes() { return 4 * tile_bytes<T, DH>() + staging_bytes<T>(); }

// ---------------------------------------------------------------------------
// K8: dq (kv sweep)
// ---------------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = row_ld<T, DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = Qs + BQ * LD;  // do
  T* Ks = Os + BQ * LD;
  T* Vs = Ks + BK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + BK * LD);  // f32 path: P / dS staging
  __shared__ int qseg_s[BQ];
  __shared__ float delta_s[BQ];

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* qseg = p.q_seg ? p.q_seg + static_cast<long long>(b) * p.Sq : nullptr;
  const int* kseg = p.kv_seg ? p.kv_seg + static_cast<long long>(b) * p.Skv : nullptr;
  const long long lrow = (static_cast<long long>(b) * p.Hq + h) * p.Sq;  // lse / delta row base

  int n_tiles = (p.Skv + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  int q_lo = 0, q_hi = 0, seg_a = 0, seg_b = 0;
  if (qseg) {
    for (int i = threadIdx.x; i < BQ; i += kThreads) qseg_s[i] = qseg[min(q0 + i, p.Sq - 1)];
    __syncthreads();
    seg_a = qseg_s[warp * 16 + g];
    seg_b = qseg_s[warp * 16 + g + 8];
    warp_range(qseg_s[lane], qseg_s[lane + 32], q_lo, q_hi);
  }
  int k_lo = 0, k_hi = 0;
  int j = next_live(kseg, 0, n_tiles, p.Skv, q_lo, q_hi, lane, k_lo, k_hi);
  if (j < n_tiles) {  // K(j) and V(j) in flight while Q, do and delta load
    load_tile_async<T, DH>(Ks, kg, p.k_ss, j * BK, p.Skv);
    load_tile_async<T, DH>(Vs, vg, p.v_ss, j * BK, p.Skv);
  }
  load_tile<T, DH>(Qs, qg, p.q_ss, q0, p.Sq);
  load_tile<T, DH>(Os, dog, p.o_ss, q0, p.Sq);
  __syncthreads();

  // delta = sum(do * out) over dh for the warp's 16 rows, from the f32
  // output and the do tile; rows past Sq get 0 (their do is zero-filled)
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float acc = 0.f;
    if (row < p.Sq) {
      const float* o = p.out + ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * DH;
#pragma unroll
      for (int c = lane; c < DH; c += 32) acc = fmaf(to_f32(Os[(warp * 16 + r) * LD + c]), o[c], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      delta_s[warp * 16 + r] = acc;
      if (row < p.Sq) p.delta[lrow + row] = acc;
    }
  }
  __syncwarp();
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float delta_a = delta_s[warp * 16 + g], delta_b = delta_s[warp * 16 + g + 8];
  // lse in log2 units, as the scores below
  const float lse_a = row_a < p.Sq ? p.lse[lrow + row_a] * LOG2E : 0.f;
  const float lse_b = row_b < p.Sq ? p.lse[lrow + row_b] * LOG2E : 0.f;
  const float scale2 = p.scale * LOG2E;

  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  while (j < n_tiles) {
    const int k0 = j * BK;
    const bool full = (!kseg || (q_lo == q_hi && k_lo == k_hi && q_lo == k_lo)) &&
                      k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= q0);
    int nk_lo = 0, nk_hi = 0;
    const int jn = next_live(kseg, j + 1, n_tiles, p.Skv, q_lo, q_hi, lane, nk_lo, nk_hi);

    cp_async_wait<0>();  // K(j), V(j) have landed
    __syncthreads();
    float s[8][4], dp[8][4];
    scores<T, DH>(s, Qs + warp * 16 * LD, Ks, g, t);
    scores<T, DH>(dp, Os + warp * 16 * LD, Vs, g, t);
    __syncthreads();  // every warp is done with Vs
    if (jn < n_tiles) load_tile_async<T, DH>(Vs, vg, p.v_ss, jn * BK, p.Skv);

#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (!full) {
          const int c = k0 + nt * 8 + 2 * t + (e & 1);
          ok = c < p.Skv;
          if (p.causal) ok = ok && (e < 2 ? row_a : row_b) >= c;
          if (kseg) ok = ok && kseg[min(c, p.Skv - 1)] == (e < 2 ? seg_a : seg_b);
        }
        const float pe = ok ? exp2f(s[nt][e] * scale2 - (e < 2 ? lse_a : lse_b)) : 0.f;
        s[nt][e] = pe * (dp[nt][e] - (e < 2 ? delta_a : delta_b));  // ds
      }
    }
    accumulate<T, DH>(acc, s, Ks, Ps + warp * 16 * PLD, g, t);
    __syncthreads();  // every warp is done with Ks
    if (jn < n_tiles) load_tile_async<T, DH>(Ks, kg, p.k_ss, jn * BK, p.Skv);
    j = jn;
    k_lo = nk_lo;
    k_hi = nk_hi;
  }

  T* dqg = static_cast<T*>(p.dq);
  if (row_a < p.Sq) {
    T* o = dqg + ((static_cast<long long>(b) * p.Sq + row_a) * p.Hq + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) store2(o + d * 8, acc[d][0] * p.scale, acc[d][1] * p.scale);
  }
  if (row_b < p.Sq) {
    T* o = dqg + ((static_cast<long long>(b) * p.Sq + row_b) * p.Hq + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) store2(o + d * 8, acc[d][2] * p.scale, acc[d][3] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// K9: dk, dv (q sweep over the GQA group)
// ---------------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = row_ld<T, DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * LD;
  T* Qs = Vs + BK * LD;
  T* Os = Qs + BQ * LD;  // do
  float* Ps = reinterpret_cast<float*>(Os + BQ * LD);  // f32 path: P / dS staging
  __shared__ int kseg_s[BK];
  __shared__ int qseg_s[BQ];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int kv0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* qseg = p.q_seg ? p.q_seg + static_cast<long long>(b) * p.Sq : nullptr;
  const int* kseg = p.kv_seg ? p.kv_seg + static_cast<long long>(b) * p.Skv : nullptr;

  const int n_q = (p.Sq + BQ - 1) / BQ;
  // causal: q tile i sees this kv tile iff its last row reaches kv0
  const int i_first = p.causal ? kv0 / BQ : 0;
  int k_lo = 0, k_hi = 0, seg_a = 0, seg_b = 0;
  if (kseg) {
    for (int i = threadIdx.x; i < BK; i += kThreads) kseg_s[i] = kseg[min(kv0 + i, p.Skv - 1)];
    __syncthreads();
    seg_a = kseg_s[warp * 16 + g];
    seg_b = kseg_s[warp * 16 + g + 8];
    warp_range(kseg_s[lane], kseg_s[lane + 32], k_lo, k_hi);
  }
  load_tile<T, DH>(Ks, kg, p.k_ss, kv0, p.Skv);
  load_tile<T, DH>(Vs, vg, p.v_ss, kv0, p.Skv);

  const int row_a = kv0 + warp * 16 + g, row_b = row_a + 8;
  const float scale2 = p.scale * LOG2E;
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dog = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const long long lrow = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    int q_lo = 0, q_hi = 0;
    int i = next_live(qseg, i_first, n_q, p.Sq, k_lo, k_hi, lane, q_lo, q_hi);
    if (i < n_q) {
      load_tile_async<T, DH>(Qs, qg, p.q_ss, i * BQ, p.Sq);
      load_tile_async<T, DH>(Os, dog, p.o_ss, i * BQ, p.Sq);
    }
    while (i < n_q) {
      const int q0 = i * BQ;
      const bool full = (!qseg || (q_lo == q_hi && k_lo == k_hi && q_lo == k_lo)) &&
                        q0 + BQ <= p.Sq && kv0 + BK <= p.Skv && (!p.causal || q0 >= kv0 + BK - 1);
      int nq_lo = 0, nq_hi = 0;
      const int in = next_live(qseg, i + 1, n_q, p.Sq, k_lo, k_hi, lane, nq_lo, nq_hi);
      // the q tile's row data; every reader of the previous tile's is
      // past the barrier that ended the last iteration
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int row = q0 + r;
        lse_s[r] = row < p.Sq ? p.lse[lrow + row] * LOG2E : 0.f;
        delta_s[r] = row < p.Sq ? p.delta[lrow + row] : 0.f;
        if (qseg) qseg_s[r] = qseg[min(row, p.Sq - 1)];
      }
      cp_async_wait<0>();  // Q(i), do(i) have landed
      __syncthreads();
      float s[8][4], dp[8][4];
      scores<T, DH>(s, Ks + warp * 16 * LD, Qs, g, t);   // s^T: kv rows x q columns
      scores<T, DH>(dp, Vs + warp * 16 * LD, Os, g, t);  // dp^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nt * 8 + 2 * t + (e & 1);  // q row within the tile
          bool ok = true;
          if (!full) {
            const int c = q0 + cl;
            ok = c < p.Sq;
            if (p.causal) ok = ok && c >= (e < 2 ? row_a : row_b);
            if (qseg) ok = ok && qseg_s[cl] == (e < 2 ? seg_a : seg_b);
          }
          const float pe = ok ? exp2f(s[nt][e] * scale2 - lse_s[cl]) : 0.f;
          s[nt][e] = pe;
          dp[nt][e] = pe * (dp[nt][e] - delta_s[cl]);  // ds^T
        }
      }
      accumulate<T, DH>(dv, s, Os, Ps + warp * 16 * PLD, g, t);  // dv += p^T do
      __syncthreads();  // every warp is done with the do tile
      if (in < n_q) load_tile_async<T, DH>(Os, dog, p.o_ss, in * BQ, p.Sq);
      accumulate<T, DH>(dk, dp, Qs, Ps + warp * 16 * PLD, g, t);  // dk += ds^T q
      __syncthreads();  // every warp is done with the q tile
      if (in < n_q) load_tile_async<T, DH>(Qs, qg, p.q_ss, in * BQ, p.Sq);
      i = in;
      q_lo = nq_lo;
      q_hi = nq_hi;
    }
  }

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
  if (row_a < p.Skv) {
    const long long o = ((static_cast<long long>(b) * p.Skv + row_a) * p.Hkv + hk) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      store2(dkg + o + d * 8, dk[d][0] * p.scale, dk[d][1] * p.scale);
      store2(dvg + o + d * 8, dv[d][0], dv[d][1]);
    }
  }
  if (row_b < p.Skv) {
    const long long o = ((static_cast<long long>(b) * p.Skv + row_b) * p.Hkv + hk) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      store2(dkg + o + d * 8, dk[d][2] * p.scale, dk[d][3] * p.scale);
      store2(dvg + o + d * 8, dv[d][2], dv[d][3]);
    }
  }
}

// Which = 0 launches K8, 1 launches K9; a translation unit instantiates
// only the kernel its entry point names.
template <int Which, typename T, int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  constexpr int bytes = smem_bytes<T, DH>();
  const dim3 block(kThreads);
  if constexpr (Which == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, DH><<<dim3((p.Sq + BQ - 1) / BQ, p.Hq, B), block, bytes, st>>>(p);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, DH><<<dim3((p.Skv + BK - 1) / BK, p.Hkv, B), block, bytes, st>>>(p);
  }
  return cudaGetLastError();
}

template <int Which, typename T>
cudaError_t launch_dh(const Params& p, int B, int dh, cudaStream_t st) {
  switch (dh) {
    case 32: return launch<Which, T, 32>(p, B, st);
    case 64: return launch<Which, T, 64>(p, B, st);
    case 128: return launch<Which, T, 128>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int Which>
int run(Params& p, const void* q, const void* k, const void* v, const void* dout,
        const void* out, const void* lse, void* delta, const void* q_seg, const void* kv_seg,
        int B, int Hq, int Hkv, int Sq, int Skv, int dh, const long long* st,
        float scale, int causal, int is_bf16, void* stream) {
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.out = static_cast<const float*>(out);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_dh<Which, __nv_bfloat16>(p, B, dh, s)
                                  : launch_dh<Which, float>(p, B, dh, s);
  return static_cast<int>(err);
}

}  // namespace
