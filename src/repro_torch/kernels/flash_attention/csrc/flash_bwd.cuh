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
// skip is K7's rule (segment-id ranges that meet, the causal triangle) on
// each kernel's own tiles.  No atomics and no cross-block reduction: each
// output row is summed by one warp in a fixed order, so both kernels are
// bitwise repeatable.  K8 also forms delta = sum(do * out) for its rows
// from the f32 output residual and writes it for K9, which runs after it
// on the stream.
//
// Bound on the H100: tensor-core operations.  K8 forms three 64 x 64 x dh
// products per live 64 x 64 tile pair (q k^T, do v^T, ds k), K9 four (k q^T,
// v do^T, p^T do, ds^T q), against 2 * dh bytes per row of each operand.
//
// Design, bf16 inputs (every model path), namespace wg: K7's shape.  A
// persistent grid of at most one block per SM walks work items heaviest
// first, dealt in snake order (sm90.cuh item_index).  An item is 128
// resident rows of one head of one batch entry, loaded once by TMA: K8's
// are q and do (q-stationary, items from the last q tile down), K9's are k
// and v of one kv head (kv-stationary, items from the first kv tile up,
// the heaviest under the causal cut), into two resident buffers, so the
// next item's loads run beside this item's end.  A block is three
// warpgroups.  Warpgroup 2 is the producer: warp 0 walks the item's live
// streamed tiles of 64 rows (K8: k and v tiles; K9: for each q head of the
// GQA group, q and do tiles) and loads each pair by TMA into a ring of 2
// (dh 128) or 3 stages on mbarriers, with the tile's index and segment-id
// range; the tile's 64 segment ids (the mask) and, for K9, its lse and
// delta rows come from warp 0 in K8 and from warp 1 in K9.  The walk tests
// 32 tiles at a time against a table of each tile's id range, which a
// pre-pass launch writes.  After an item's last tile a stage carries -1
// and no data.  The producers give their registers (setmaxnreg) to
// warpgroups 0 and 1, the consumers, 64 resident rows each, which keep
// their f32 accumulators in registers (K8 dq, K9 dk and dv: dh / 2 a
// thread each).  Per tile, with r the resident rows:
//     S  = R_a T_a^T,  dP = R_b T_b^T      wgmma m64n64, both operands
//                                          K-major in shared memory
//     p, ds from S and dP in registers     (K8: s = q k^T, rows are q;
//                                          K9: s^T = k q^T, columns are q)
//     acc += F T                           wgmma m64 x dh, F (p^T or ds,
//                                          ds^T) rounded to bf16 in registers
//                                          as the A operand, the streamed
//                                          tile read MN-major through the
//                                          transpose bit
// K8: S = q k^T, dP = do v^T, dq += ds k.  K9: S = k q^T, dP = v do^T,
// dv += p^T do (issued as soon as p is ready, beside the ds arithmetic),
// dk += ds^T q.  Operands sit in the 128- (64-byte for dh 32) swizzle TMA
// writes, a dh-128 row as two boxes of 64 columns.  Only a warp whose rows
// see part of a tile pays for the mask, behind one uniform branch (a mask
// test inside the loop is if-converted and costs every tile).  K9 with
// too few kv items to fill the card (cross-attention's 512 text keys)
// splits each item's q sweep over blocks into f32 partial sums, which a
// second launch adds in a fixed order.  Registers that a wgmma reads or
// writes are pinned only before its issue and after its wait (an access
// between would serialise the wgmmas, ptxas C7514).  The accumulators are
// written from the registers once the item's last tile is done; the item
// buffer is released first, so the next item's loads run beside the stores.
//
// What bounds it now: each tile's products land within its iteration, and
// only the other warpgroup fills the gaps (issuing the next tile's S and
// dP beside a tile's last product made ptxas serialise the wgmmas, C7514
// and C7520); at dh 64 a tile's elementwise work weighs as much as its
// four products.
//
// f32 inputs (the ring's backward hops, and small checks) take the 64-row
// kernels below: 4 warps of 16 rows, one cp.async buffer per operand, a
// block barrier per stage, every product 3xTF32 mma.sync
// (flash_common.cuh), about 1e-6 from exact f32.  K8: one block per (q tile,
// q head, batch); K9: one block per (kv tile, kv head, batch) sweeping the
// heads of its GQA group, with the transposed tiles s^T = k q^T and dp^T =
// v do^T so every product has its register operand on the left.

#pragma once

#include "flash_common.cuh"
#include "../../csrc/sm90.cuh"

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
constexpr int smem_bytes() { return 4 * tile_bytes<T, DH>() + kStagingBytes; }

// ---------------------------------------------------------------------------
// f32 inputs, K8: dq (kv sweep)
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
// f32 inputs, K9: dk, dv (q sweep over the GQA group)
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

// ---------------------------------------------------------------------------
// bf16 inputs: 128 resident rows, TMA, wgmma, warp specialisation
// ---------------------------------------------------------------------------

namespace wg {

using namespace sm90;

constexpr int BR = 128;  // resident rows per item: two consumer warpgroups of 64
constexpr int BT = 64;   // rows of a streamed tile
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;  // the producer warpgroup last
// 128 x 40 + 256 x 232 = 384 x 168, the register file of a 384-thread block
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// producer warps: K9's second one stages each tile's row data
template <int Which>
constexpr int kProducers = Which == 0 ? 1 : 2;
constexpr int kRes = 2;  // resident buffers: the next item's loads beside this item's end

template <int DH>
struct Cfg {
  static constexpr int kBox = DH < 64 ? DH : 64;  // columns of one TMA box: at most 128 bytes
  static constexpr int kBoxes = DH / kBox;
  static constexpr int kRowBytes = 2 * kBox;
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : 2;  // wgmma's 128- / 64-byte swizzle
  static constexpr int kGroup = 8 * kRowBytes;  // 8 rows of a swizzle atom
  static constexpr int kItemBytes = BR * DH * 2;  // one resident operand
  static constexpr int kTileBytes = BT * DH * 2;  // one streamed operand
  static constexpr int kStages = DH == 128 ? 2 : 3;  // streamed tile pairs in flight
  // the resident buffers' two operands each, the stages' two streamed
  // operands; the barriers (resident full and empty per buffer; stage full
  // and empty); each stage's metadata (tile index or -1 at an item's end,
  // the tile's segment-id range) and row data (ids; K9: lse in log2 units,
  // delta)
  static constexpr int kBarOff = 2 * kRes * kItemBytes + 2 * kStages * kTileBytes;
  static constexpr int kMetaOff = kBarOff + 8 * (2 * kRes + 2 * kStages);
  static constexpr int kRowOff = kMetaOff + 16 * kStages;
  static constexpr int kBytes = kRowOff + 3 * 4 * BT * kStages + 1024;  // + the 1024-byte alignment
};

struct Params {
  CUtensorMap tq, tk, tv, tdo;  // [B, S, H, dh] bf16 views: resident 128-row boxes, streamed 64
  const int* q_seg;             // [B, Sq] or null (one segment)
  const int* kv_seg;            // [B, Skv] or null
  const __nv_bfloat16* dout;    // K8's delta: do, strided (o_sb, o_ss, o_sh)
  const float* out;             // K8's delta: [B, Sq, Hq, dh] f32
  const float* lse;             // [B, Hq, Sq]
  float* delta;                 // [B, Hq, Sq]: written by K8, read by K9
  void* dq;                     // [B, Sq, Hq, dh] bf16, contiguous
  void* dk;                     // [B, Skv, Hkv, dh] bf16, contiguous
  void* dv;
  float* part;                  // K9 with splits > 1: f32 partial dk, dv [2, splits, B, Skv, Hkv, dh]
  int2* ranges;                 // with segment ids: [B, n_st] the streamed tiles' (min, max) id
  long long o_sb, o_ss, o_sh;
  int B, Hq, Hkv, Sq, Skv;
  int splits;                   // K9: blocks that share one item's q sweep
  // host-computed invariants (constant-bank operands, no registers): the
  // items, the GQA group, the streamed tiles, the last resident and streamed row
  int n_items, group, n_st, last_res, last_str;
  float scale;
  int causal;
};

template <int DH>
struct Smem {
  using C = Cfg<DH>;
  unsigned char* base;
  // buffer r, j = 0, 1: K8 q, do; K9 k, v
  __device__ unsigned char* res(int r, int j) const { return base + (2 * r + j) * C::kItemBytes; }
  // stage s, j = 0, 1: K8 k, v; K9 q, do
  __device__ unsigned char* str(int s, int j) const {
    return base + 2 * kRes * C::kItemBytes + (2 * s + j) * C::kTileBytes;
  }
  __device__ uint64_t* bar() const { return reinterpret_cast<uint64_t*>(base + C::kBarOff); }
  __device__ uint64_t* item_full(int r) const { return bar() + r; }
  __device__ uint64_t* item_empty(int r) const { return bar() + kRes + r; }
  __device__ uint64_t* full(int s) const { return bar() + 2 * kRes + s; }
  __device__ uint64_t* empty(int s) const { return bar() + 2 * kRes + C::kStages + s; }
  __device__ int* meta(int s) const { return reinterpret_cast<int*>(base + C::kMetaOff) + 4 * s; }
  __device__ int* ids(int s) const { return reinterpret_cast<int*>(base + C::kRowOff) + 3 * BT * s; }
  __device__ float* lse(int s) const { return reinterpret_cast<float*>(ids(s) + BT); }
  __device__ float* delta(int s) const { return reinterpret_cast<float*>(ids(s) + 2 * BT); }
};

// One work item: 128 resident rows (r0) of one head (K8: q head h; K9: kv
// head hk) of one batch entry, numbered heaviest first with heads and batch
// fastest: K8's q tiles from the last down, K9's kv tiles from the first up
// (the causal cut gives the last q rows, and the first kv rows, the most
// partners).  n_tiles: K8's kv tiles that the causal cut leaves; K9's first
// q tile that sees the item (i_first).  K9's items come in `splits`
// consecutive parts, each sweeping its share of the q tiles.
struct Item {
  int r0, h, hk, b, n_tiles, split;
  const int* qseg;  // the batch entry's ids, or null
  const int* kseg;
};

template <int Which>
__device__ __forceinline__ Item item(const Params& p, int n) {
  Item it;
  it.split = 0;
  if constexpr (Which == 0) {
    const int n_r = (p.Sq + BR - 1) / BR, hb = p.Hq * p.B;
    it.r0 = (n_r - 1 - n / hb) * BR;
    it.h = n % p.Hq;
    it.b = n % hb / p.Hq;
    it.hk = it.h / (p.Hq / p.Hkv);
    it.n_tiles = (p.Skv + BT - 1) / BT;
    if (p.causal) it.n_tiles = min(it.n_tiles, (it.r0 + BR - 1) / BT + 1);
  } else {
    const int hb = p.Hkv * p.B;
    it.split = n % p.splits;
    n /= p.splits;
    it.r0 = n / hb * BR;
    it.hk = n % p.Hkv;
    it.h = it.hk;
    it.b = n % hb / p.Hkv;
    it.n_tiles = p.causal ? it.r0 / BT : 0;  // q tile i sees kv row r0 iff i BT + BT - 1 >= r0
  }
  it.qseg = p.q_seg ? p.q_seg + static_cast<long long>(it.b) * p.Sq : nullptr;
  it.kseg = p.kv_seg ? p.kv_seg + static_cast<long long>(it.b) * p.Skv : nullptr;
  return it;
}

// the host's share of the schedule: the invariants in Params
template <int Which>
void schedule(Params& p) {
  p.n_items = Which == 0 ? (p.Sq + BR - 1) / BR * p.Hq * p.B
                         : (p.Skv + BR - 1) / BR * p.Hkv * p.B * p.splits;
  p.group = p.Hq / p.Hkv;
  p.n_st = ((Which == 0 ? p.Skv : p.Sq) + BT - 1) / BT;
  p.last_res = (Which == 0 ? p.Sq : p.Skv) - 1;
  p.last_str = (Which == 0 ? p.Skv : p.Sq) - 1;
}

// The producer warps: every TMA load and the tile schedule.  For each of
// the block's items warp 0 loads the two resident operands once the
// previous item's are released; then each producer warp walks the item's
// live streamed tiles (the tile skip on the item's 128 rows by segment-id
// ranges, and the causal cut; K9 once per q head of the GQA group) and
// claims a stage for each: warp 0 writes the tile's metadata and loads the
// two operands by TMA, and the tile's row data (ids; K9: lse, delta) come
// from warp 0 in K8 and from warp 1 in K9, whose walk is the same.  Each
// warp runs on 40 registers: what it needs after a wait is fetched again
// (the tile's ids, from L1) rather than held across it.
// Role: kLoads (metadata, TMA), kRows (row data) or both; one instantiation
// per warp's role, so that each is allocated its registers alone.
constexpr int kLoads = 1, kRows = 2;

template <int Which, int DH, int Role>
__device__ __forceinline__ void produce(const Params& p, const Smem<DH>& sm) {
  using C = Cfg<DH>;
  const int lane = threadIdx.x % 32;
  constexpr bool loads = Role & kLoads, rows = Role & kRows;
  Ring<kRes> ib;
  Ring<C::kStages> st;
  for (int round = 0;; ++round) {
    const int n = item_index(round);
    if (n >= p.n_items) break;
    const Item it = item<Which>(p, n);
    const int* rseg = Which == 0 ? it.qseg : it.kseg;  // ids of the resident rows
    const int* sseg = Which == 0 ? it.kseg : it.qseg;  // of the streamed rows
    if (loads) mbar_wait(sm.item_empty(ib.i), ib.phase ^ 1);
    if (loads && lane == 0) {
      mbar_expect_tx(sm.item_full(ib.i), 2 * C::kItemBytes);
      const int hr = Which == 0 ? it.h : it.hk;
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load_4d(sm.res(ib.i, 0) + x * BR * C::kRowBytes, Which == 0 ? &p.tq : &p.tk,
                    sm.item_full(ib.i), x * C::kBox, it.r0, hr, it.b);
        tma_load_4d(sm.res(ib.i, 1) + x * BR * C::kRowBytes, Which == 0 ? &p.tdo : &p.tv,
                    sm.item_full(ib.i), x * C::kBox, it.r0, hr, it.b);
      }
    }
    ib.advance();
    int r_lo = 0, r_hi = 0;
    if (rseg) {
      int x[BR / 32];
      fetch_ids(x, rseg, it.r0, p.last_res + 1);
      id_range(x, r_lo, r_hi);
    }
    int j_first = Which == 0 ? 0 : it.n_tiles;
    int j_end = Which == 0 ? it.n_tiles : p.n_st;
    if (Which == 1 && p.splits > 1) {  // this part's share of the q tiles
      const int len = max(j_end - j_first, 0);
      j_end = j_first + len * (it.split + 1) / p.splits;
      j_first += len * it.split / p.splits;
    }
    for (int gi = 0; gi < (Which == 0 ? 1 : p.group); ++gi) {
      const int h = Which == 0 ? it.hk : it.hk * p.group + gi;  // the streamed operands' head
      // 32 tiles at a time: lane l tests tile j0 + l by its id range (the
      // tile skip: disjoint ranges), and the warp walks the live ones
      for (int j0 = j_first; j0 < j_end; j0 += 32) {
        int2 rg = make_int2(0, 0);
        if (sseg && j0 + lane < j_end) rg = p.ranges[it.b * p.n_st + j0 + lane];
        uint32_t live = __ballot_sync(0xffffffffu, j0 + lane < j_end &&
                                                       (!sseg || (rg.y >= r_lo && rg.x <= r_hi)));
        while (live) {
          const int bit = __ffs(live) - 1;
          live &= live - 1;
          const int j = j0 + bit;
          const int t_lo = __shfl_sync(0xffffffffu, rg.x, bit);
          const int t_hi = __shfl_sync(0xffffffffu, rg.y, bit);
          mbar_wait(sm.empty(st.i), st.phase ^ 1);
          if (rows) {
            const long long lrow = (static_cast<long long>(it.b) * p.Hq + h) * p.Sq;
#pragma unroll
            for (int m = 0; m < BT / 32; ++m) {
              const int row = j * BT + lane + 32 * m;
              if (sseg) sm.ids(st.i)[lane + 32 * m] = sseg[min(row, p.last_str)];
              if constexpr (Which == 1) {
                sm.lse(st.i)[lane + 32 * m] = row < p.Sq ? p.lse[lrow + row] * LOG2E : 0.f;
                sm.delta(st.i)[lane + 32 * m] = row < p.Sq ? p.delta[lrow + row] : 0.f;
              }
            }
            __syncwarp();  // the lanes' row data before lane 0's arrival releases it
            if (!loads && lane == 0) mbar_arrive(sm.full(st.i));
          }
          if (loads && lane == 0) {
            int* meta = sm.meta(st.i);
            meta[0] = j;
            meta[1] = t_lo;
            meta[2] = t_hi;
            mbar_expect_tx(sm.full(st.i), 2 * C::kTileBytes);
#pragma unroll
            for (int x = 0; x < C::kBoxes; ++x) {
              tma_load_4d(sm.str(st.i, 0) + x * BT * C::kRowBytes, Which == 0 ? &p.tk : &p.tq,
                          sm.full(st.i), x * C::kBox, j * BT, h, it.b);
              tma_load_4d(sm.str(st.i, 1) + x * BT * C::kRowBytes, Which == 0 ? &p.tv : &p.tdo,
                          sm.full(st.i), x * C::kBox, j * BT, h, it.b);
            }
          }
          st.advance();
        }
      }
    }
    // the item's end marker
    mbar_wait(sm.empty(st.i), st.phase ^ 1);
    if (loads && lane == 0) sm.meta(st.i)[0] = -1;
    if (lane == 0) mbar_arrive(sm.full(st.i));
    st.advance();
  }
}

// d = A B^T: the warpgroup's 64 resident rows (a_addr, in 128-row boxes)
// against a stage's 64 streamed rows (b_addr, 64-row boxes), both K-major
template <int DH>
__device__ __forceinline__ void issue_ss(float (&d)[BT / 2], uint32_t a_addr, uint32_t b_addr) {
  using C = Cfg<DH>;
  pin(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int x = kk * 16 / C::kBox, col = (kk * 16) % C::kBox * 2;  // box, byte column
    const uint64_t da = wgmma_desc(a_addr + x * BR * C::kRowBytes + col, C::kGroup, C::kGroup, C::kSwizzle);
    const uint64_t db = wgmma_desc(b_addr + x * BT * C::kRowBytes + col, C::kGroup, C::kGroup, C::kSwizzle);
    wgmma_ss_n64(d, da, db, kk > 0);
  }
  wgmma_commit();
}

// acc += F B: F [64, BT] bf16 in registers, B a stage's [BT, DH] streamed
// operand read MN-major, one box of at most 64 columns per product
template <int DH>
__device__ __forceinline__ void issue_rs(float (&acc)[DH / 2], uint32_t (&f)[BT / 16][4],
                                         uint32_t b_addr) {
  using C = Cfg<DH>;
  pin(acc);
  pin(f);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) {
      const uint64_t db = wgmma_desc(b_addr + x * BT * C::kRowBytes + kk * 16 * C::kRowBytes,
                                     C::kGroup, C::kGroup, C::kSwizzle);
      if constexpr (C::kBox == 64) wgmma_rs_n64(acc + 32 * x, f[kk], db, 1);
      else wgmma_rs_n32(acc, f[kk], db, 1);
    }
  }
  wgmma_commit();
}

// rows row_a and row_a + 8 of acc * mul into a contiguous [B, S, H, DH]
// output at (b, head), bf16 or f32
template <int DH, typename OT>
__device__ __forceinline__ void store_rows(OT* o, const float (&acc)[DH / 2], float mul,
                                           int b, int S, int H, int head, int row_a) {
  const int t = threadIdx.x % 4;
  if (row_a < S) {
    OT* r = o + ((static_cast<long long>(b) * S + row_a) * H + head) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) store2(r + d * 8, acc[4 * d] * mul, acc[4 * d + 1] * mul);
  }
  if (row_a + 8 < S) {
    OT* r = o + ((static_cast<long long>(b) * S + row_a + 8) * H + head) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) store2(r + d * 8, acc[4 * d + 2] * mul, acc[4 * d + 3] * mul);
  }
}

// The consumer warpgroups: 64 resident rows each of every item of the
// block, over every tile the producer schedules for it.
template <int Which, int DH>
__device__ __forceinline__ void consume(const Params& p, const Smem<DH>& sm) {
  using C = Cfg<DH>;
  const int wgi = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale2 = p.scale * LOG2E;  // exp(x scale) = 2^(x scale2)
  const int n_res = Which == 0 ? p.Sq : p.Skv, n_str = Which == 0 ? p.Skv : p.Sq;
  Ring<kRes> ib;
  Ring<C::kStages> st;
  for (int round = 0;; ++round) {
    const int n = item_index(round);
    if (n >= p.n_items) break;
    const Item it = item<Which>(p, n);
    const int* rseg = Which == 0 ? it.qseg : it.kseg;
    const bool segmented = rseg != nullptr;
    const int r0 = it.r0 + wgi * 64 + warp * 16;  // the warp's first resident row
    const int row_a = r0 + g, row_b = row_a + 8;
    int seg_a = 0, seg_b = 0, w_lo = 0, w_hi = 0;
    if (segmented) {
      seg_a = rseg[min(row_a, n_res - 1)];
      seg_b = rseg[min(row_b, n_res - 1)];
      warp_range(seg_a, seg_b, w_lo, w_hi);
    }
    // K8: the rows' lse (log2 units) and delta = sum(do * out), formed
    // here from the f32 output and written for K9; rows past Sq get 0.
    // Two lanes a row (lane 2r + x sums half x of the warp's row r with
    // 16-byte loads), so the warp's 16 rows load at once.
    float lse_a = 0.f, lse_b = 0.f, delta_a = 0.f, delta_b = 0.f;
    if constexpr (Which == 0) {
      const long long lrow = (static_cast<long long>(it.b) * p.Hq + it.h) * p.Sq;
      const int row = r0 + lane / 2, c0 = lane % 2 * (DH / 2);
      float acc = 0.f;
      if (row < p.Sq) {
        const uint4* d = reinterpret_cast<const uint4*>(
            p.dout + it.b * p.o_sb + row * p.o_ss + it.h * p.o_sh + c0);
        const float4* o = reinterpret_cast<const float4*>(
            p.out + ((static_cast<long long>(it.b) * p.Sq + row) * p.Hq + it.h) * DH + c0);
#pragma unroll
        for (int c = 0; c < DH / 16; ++c) {  // 8 columns a step
          const uint4 dv8 = d[c];
          const float4 x = o[2 * c], y = o[2 * c + 1];
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&dv8);
          const float2 a0 = __bfloat1622float2(h2[0]), a1 = __bfloat1622float2(h2[1]);
          const float2 a2 = __bfloat1622float2(h2[2]), a3 = __bfloat1622float2(h2[3]);
          acc = fmaf(a0.x, x.x, acc);
          acc = fmaf(a0.y, x.y, acc);
          acc = fmaf(a1.x, x.z, acc);
          acc = fmaf(a1.y, x.w, acc);
          acc = fmaf(a2.x, y.x, acc);
          acc = fmaf(a2.y, y.y, acc);
          acc = fmaf(a3.x, y.z, acc);
          acc = fmaf(a3.y, y.w, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (lane % 2 == 0 && row < p.Sq) p.delta[lrow + row] = acc;
      delta_a = __shfl_sync(0xffffffffu, acc, 2 * g);
      delta_b = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
      if (row_a < p.Sq) lse_a = p.lse[lrow + row_a] * LOG2E;
      if (row_b < p.Sq) lse_b = p.lse[lrow + row_b] * LOG2E;
    }

    constexpr int NA = DH / 2;
    float acc0[NA], acc1[Which == 0 ? 1 : NA];  // K8: dq; K9: dk, dv
#pragma unroll
    for (int i = 0; i < NA; ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (Which == 0 ? 1 : NA); ++i) acc1[i] = 0.f;

    mbar_wait(sm.item_full(ib.i), ib.phase);
    const uint32_t a0 = smem_u32(sm.res(ib.i, 0)) + wgi * 64 * C::kRowBytes;  // K8 q, K9 k
    const uint32_t a1 = smem_u32(sm.res(ib.i, 1)) + wgi * 64 * C::kRowBytes;  // K8 do, K9 v
    for (;;) {
      mbar_wait(sm.full(st.i), st.phase);
      const int* meta = sm.meta(st.i);
      const int j = meta[0];
      if (j < 0) break;
      const int c0 = j * BT;  // the tile's first streamed row: the scores' first column
      const uint32_t b0 = smem_u32(sm.str(st.i, 0)), b1 = smem_u32(sm.str(st.i, 1));
      float s[BT / 2], dp[BT / 2];
      uint32_t f[BT / 16][4];
      issue_ss<DH>(s, a0, b0);   // K8 q k^T, K9 k q^T
      issue_ss<DH>(dp, a1, b1);  // K8 do v^T, K9 v do^T
      // every score of the tile visible to every row of the warp: no mask
      const int t_lo = meta[1], t_hi = meta[2];
      bool full = (!segmented || (w_lo == w_hi && t_lo == t_hi && w_lo == t_lo)) &&
                  c0 + BT <= n_str;
      if (p.causal) full = full && (Which == 0 ? c0 + BT - 1 <= r0 : c0 >= r0 + 15);
      const int* ids = sm.ids(st.i);
      const float* lse_c = sm.lse(st.i);
      const float* delta_c = sm.delta(st.i);
      wgmma_wait<1>();  // S has landed
      pin(s);
      // p, with hidden entries exact zeros.  One uniform branch: the mask
      // is compiled into the second loop only, which tiles on a segment
      // boundary, the causal diagonal or the ragged edge take.
      if (full) {
#pragma unroll
        for (int i = 0; i < BT / 2; ++i) {
          const int cl = i / 4 * 8 + 2 * t + (i & 1);  // the entry's column in the tile
          const float l2 = Which == 0 ? (i % 4 < 2 ? lse_a : lse_b) : lse_c[cl];
          s[i] = ex2(fmaf(s[i], scale2, -l2));
        }
      } else {
#pragma unroll
        for (int i = 0; i < BT / 2; ++i) {
          const int cl = i / 4 * 8 + 2 * t + (i & 1);
          const bool top = i % 4 < 2;  // row a, else row b
          const int c = c0 + cl, r = top ? row_a : row_b;
          bool ok = c < n_str;
          if (p.causal) ok = ok && (Which == 0 ? r >= c : c >= r);
          if (segmented) ok = ok && ids[cl] == (top ? seg_a : seg_b);
          const float l2 = Which == 0 ? (top ? lse_a : lse_b) : lse_c[cl];
          s[i] = ok ? ex2(fmaf(s[i], scale2, -l2)) : 0.f;
        }
      }
      if constexpr (Which == 1) {
        to_bf16(f, s);
        issue_rs<DH>(acc1, f, b1);  // dv += p^T do, beside the ds arithmetic below
        wgmma_wait<1>();            // dP has landed
      } else {
        wgmma_wait<0>();
      }
      pin(dp);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const int cl = i / 4 * 8 + 2 * t + (i & 1);
        const float de = Which == 0 ? (i % 4 < 2 ? delta_a : delta_b) : delta_c[cl];
        dp[i] = s[i] * (dp[i] - de);  // ds
      }
      if constexpr (Which == 1) {
        wgmma_wait<0>();  // dv's product has read f
        pin(acc1);
        pin(f);
      }
      to_bf16(f, dp);
      issue_rs<DH>(acc0, f, b0);  // K8 dq += ds k, K9 dk += ds^T q
      wgmma_wait<0>();
      pin(acc0);
      pin(f);
      release(sm.empty(st.i));
      st.advance();
    }
    // the item's end marker, and its resident operands: every product
    // reading them has landed
    release(sm.empty(st.i));
    st.advance();
    release(sm.item_empty(ib.i));
    ib.advance();

    if constexpr (Which == 0) {
      store_rows<DH>(static_cast<__nv_bfloat16*>(p.dq), acc0, p.scale, it.b, p.Sq, p.Hq, it.h, row_a);
    } else {
      if (p.splits == 1) {
        store_rows<DH>(static_cast<__nv_bfloat16*>(p.dk), acc0, p.scale, it.b, p.Skv, p.Hkv, it.hk, row_a);
        store_rows<DH>(static_cast<__nv_bfloat16*>(p.dv), acc1, 1.f, it.b, p.Skv, p.Hkv, it.hk, row_a);
      } else {  // this part's sums, unscaled, for the second pass
        const long long n = static_cast<long long>(p.B) * p.Skv * p.Hkv * DH;
        store_rows<DH>(p.part + it.split * n, acc0, 1.f, it.b, p.Skv, p.Hkv, it.hk, row_a);
        store_rows<DH>(p.part + (p.splits + it.split) * n, acc1, 1.f, it.b, p.Skv, p.Hkv, it.hk, row_a);
      }
    }
  }
}

// Persistent: one block per SM (at most), walking its items (item_index).
// Which = 0: K8, 1: K9.
template <int Which, int DH>
__device__ __forceinline__ void run_block(const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<DH> sm{smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023)};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < kRes; ++r) {
      mbar_init(sm.item_full(r), 1);
      mbar_init(sm.item_empty(r), kConsumers * 4);
    }
#pragma unroll
    for (int s = 0; s < Cfg<DH>::kStages; ++s) {
      mbar_init(sm.full(s), kProducers<Which>);
      mbar_init(sm.empty(s), kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x / 128 == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x / 32 % 4;
    if (warp == 0) produce<Which, DH, kProducers<Which> == 1 ? kLoads | kRows : kLoads>(p, sm);
    if (warp == 1 && kProducers<Which> == 2) produce<Which, DH, kRows>(p, sm);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<Which, DH>(p, sm);
  }
}

// the two kernels under their own names (the profiles tell them apart)
template <int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_wg_kernel(__grid_constant__ const Params p) {
  run_block<0, DH>(p);
}
template <int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_wg_kernel(__grid_constant__ const Params p) {
  run_block<1, DH>(p);
}

// The pre-pass: the (min, max) segment id of each 64-row tile of ids [B, S]
// (rows past S repeat the last id, as fetch_ids), one warp a tile, for the
// producers' tile skip
template <typename Unused>
__global__ void __launch_bounds__(256) flash_bwd_tile_ranges_kernel(const int* seg, int B, int S,
                                                                   int n_tiles, int2* out) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (w >= B * n_tiles) return;
  int x[BT / 32], lo, hi;
  fetch_ids(x, seg + static_cast<long long>(w / n_tiles) * S, w % n_tiles * BT, S);
  id_range(x, lo, hi);
  if (threadIdx.x % 32 == 0) out[w] = make_int2(lo, hi);
}

// K9's second pass when its items are split: dk = scale * sum of the
// parts, dv = their sum, each summed in part order (bitwise repeatable)
// (a template, so that only K9's translation unit instantiates it)
template <typename OT>
__global__ void __launch_bounds__(256) flash_bwd_dkv_reduce_kernel(const float* part, int splits,
                                                                  long long n, float scale,
                                                                  OT* dk, OT* dv) {
  const long long n4 = n / 4;  // float4s per output
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < 2 * n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int w = i >= n4;  // 0: dk, 1: dv
    const long long e = i - w * n4;
    const float4* src = reinterpret_cast<const float4*>(part + w * splits * n) + e;
    float4 a = src[0];
    for (int s = 1; s < splits; ++s) {
      const float4 x = src[s * n4];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float mul = w ? 1.f : scale;
    OT* o = (w ? dv : dk) + 4 * e;
    store2(o, a.x * mul, a.y * mul);
    store2(o + 2, a.z * mul, a.w * mul);
  }
}

template <typename Kernel>
cudaError_t start(Kernel kernel, const Params& p, int n, int bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  kernel<<<min(n, sms), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int Which, int DH>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v, const void* dout,
                   const long long* st, cudaStream_t stream) {
  using C = Cfg<DH>;
  const int rq = Which == 0 ? BR : BT, rk = Which == 0 ? BT : BR;  // box rows
  cudaError_t err = bf16_map(&p.tq, q, p.B, p.Sq, p.Hq, DH, st[0], st[1], st[2], rq, C::kBox);
  if (err == cudaSuccess) err = bf16_map(&p.tk, k, p.B, p.Skv, p.Hkv, DH, st[3], st[4], st[5], rk, C::kBox);
  if (err == cudaSuccess) err = bf16_map(&p.tv, v, p.B, p.Skv, p.Hkv, DH, st[6], st[7], st[8], rk, C::kBox);
  if (err == cudaSuccess) err = bf16_map(&p.tdo, dout, p.B, p.Sq, p.Hq, DH, st[9], st[10], st[11], rq, C::kBox);
  if (err != cudaSuccess) return err;
  schedule<Which>(p);
  const int* sseg = Which == 0 ? p.kv_seg : p.q_seg;
  if (sseg && p.n_st > 0) {  // the streamed tiles' id ranges
    const int warps = p.B * p.n_st;
    flash_bwd_tile_ranges_kernel<void><<<(warps + 7) / 8, 256, 0, stream>>>(
        sseg, p.B, p.last_str + 1, p.n_st, p.ranges);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (Which == 0) {
    return start(flash_bwd_dq_wg_kernel<DH>, p, p.n_items, C::kBytes, stream);
  } else {
    err = start(flash_bwd_dkv_wg_kernel<DH>, p, p.n_items, C::kBytes, stream);
    if (err != cudaSuccess || p.splits == 1) return err;
    const long long n = static_cast<long long>(p.B) * p.Skv * p.Hkv * DH;
    const long long blocks = (2 * n / 4 + 255) / 256;
    flash_bwd_dkv_reduce_kernel<__nv_bfloat16><<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
        p.part, p.splits, n, p.scale, static_cast<__nv_bfloat16*>(p.dk),
        static_cast<__nv_bfloat16*>(p.dv));
    return cudaGetLastError();
  }
}

template <int Which>
cudaError_t launch_dh(Params& p, const void* q, const void* k, const void* v, const void* dout,
                      int dh, const long long* st, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<Which, 32>(p, q, k, v, dout, st, stream);
    case 64: return launch<Which, 64>(p, q, k, v, dout, st, stream);
    case 128: return launch<Which, 128>(p, q, k, v, dout, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

template <int Which>
int run(Params& p, const void* q, const void* k, const void* v, const void* dout,
        const void* out, const void* lse, void* delta, const void* q_seg, const void* kv_seg,
        void* ranges, void* part, int splits, int B, int Hq, int Hkv, int Sq, int Skv, int dh,
        const long long* st, float scale, int causal, int is_bf16, void* stream) {
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
  if (!is_bf16) return static_cast<int>(launch_dh<Which, float>(p, B, dh, s));
  wg::Params w{};
  w.q_seg = p.q_seg;
  w.kv_seg = p.kv_seg;
  w.dout = static_cast<const __nv_bfloat16*>(dout);
  w.out = p.out;
  w.lse = p.lse;
  w.delta = p.delta;
  w.dq = p.dq;
  w.dk = p.dk;
  w.dv = p.dv;
  w.part = static_cast<float*>(part);
  w.ranges = static_cast<int2*>(ranges);
  w.splits = splits;
  w.o_sb = st[9];
  w.o_ss = st[10];
  w.o_sh = st[11];
  w.B = B;
  w.Hq = Hq;
  w.Hkv = Hkv;
  w.Sq = Sq;
  w.Skv = Skv;
  w.scale = scale;
  w.causal = causal;
  return static_cast<int>(wg::launch_dh<Which>(w, q, k, v, dout, dh, st, s));
}

}  // namespace
