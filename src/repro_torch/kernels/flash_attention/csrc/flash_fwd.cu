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
// LSE_FLOOR guard.  Not yet used: wgmma, TMA, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // kv rows per tile
constexpr int kWarps = BQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int PLD = BK + 4;  // row stride of the f32 path's P staging
constexpr float NEG_INF = -2.0e38f;
constexpr float LSE_FLOOR = 1e-37f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_seg;   // [B, Sq] or null (one segment)
  const int* kv_seg;  // [B, Skv] or null
  void* out;          // [B, Sq, Hq, dh], q's dtype
  float* lse;         // [B, Hq, Sq]
  int Hq, Hkv, Sq, Skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  float scale;
  int causal;
};

template <typename T>
constexpr bool kBf16 = sizeof(T) == 2;

template <typename T, int DH>
__host__ __device__ constexpr int row_ld() { return DH + 16 / static_cast<int>(sizeof(T)); }  // 16-byte pad

template <typename T, int DH>
constexpr int smem_bytes() {
  return (BQ + 2 * BK) * row_ld<T, DH>() * static_cast<int>(sizeof(T)) +
         (kBf16<T> ? 0 : kWarps * 16 * PLD * static_cast<int>(sizeof(float)));
}

// rows [r0, r0 + n) of a [S, DH] strided matrix into shared memory with
// 16-byte loads; rows past S are zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride,
                                          int r0, int S, int n) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = DH / V;  // chunks per row
  constexpr int LD = row_ld<T, DH>();
  for (int i = threadIdx.x; i < n * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c * V);
    *reinterpret_cast<uint4*>(dst + r * LD + c * V) = val;
  }
}

// The same, asynchronously (cp.async, 16 bytes a thread, bypassing L1):
// rows past S are zero-filled by a zero source size.  Closes one group.
template <typename T, int DH>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long row_stride,
                                                int r0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = DH / V;
  constexpr int LD = row_ld<T, DH>();
  for (int i = threadIdx.x; i < BK * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < S;
    const T* g = in ? src + (r0 + r) * row_stride + c * V : src;
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LD + c * V));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(g), "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane L gives the address of
// row L % 8 of matrix L / 8.  .trans hands each lane a column pair instead
// of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Fragment ownership (the mma.sync m16n8k16 accumulator layout): in its
// warp's 16 rows a lane owns rows g = lane / 4 and g + 8, and in every
// 8-column tile nt the columns nt * 8 + 2 * t + {0, 1}, t = lane % 4.
// s[nt][0..1] belong to row g, s[nt][2..3] to row g + 8.

// s = Q_w K^T for the warp's 16 rows against the BK keys of the tile.
template <typename T, int DH>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const T* Qw, const T* Ks,
                                       int g, int t) {
  constexpr int LD = row_ld<T, DH>();
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  if constexpr (kBf16<T>) {
    const int lane = threadIdx.x % 32, mi = lane / 8, ri = lane % 8;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // A: rows 0-7 / 8-15 x cols 0-7 / 8-15 of the warp's 16 x 16 block
      uint32_t a[4];
      ldsm_x4(a, Qw + (ri + (mi & 1) * 8) * LD + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int nt = 0; nt < BK / 8; nt += 2) {
        // B of n-tiles nt and nt + 1: K rows are its columns
        uint32_t b[4];
        ldsm_x4(b, Ks + (nt * 8 + (mi >> 1) * 8 + ri) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[nt], a[0], a[1], a[2], a[3], b[0], b[1]);
        mma_bf16(s[nt + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
      }
    }
  } else {
#pragma unroll 4
    for (int kk = 0; kk < DH; ++kk) {
      const float qa = Qw[g * LD + kk], qb = Qw[(g + 8) * LD + kk];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const float k0 = Ks[(nt * 8 + 2 * t) * LD + kk];
        const float k1 = Ks[(nt * 8 + 2 * t + 1) * LD + kk];
        s[nt][0] = fmaf(qa, k0, s[nt][0]);
        s[nt][1] = fmaf(qa, k1, s[nt][1]);
        s[nt][2] = fmaf(qb, k0, s[nt][2]);
        s[nt][3] = fmaf(qb, k1, s[nt][3]);
      }
    }
  }
}

// acc += P V for the warp's 16 rows; p holds P in the fragment layout.
template <typename T, int DH>
__device__ __forceinline__ void accumulate_pv(float (&acc)[DH / 8][4], const float (&p)[BK / 8][4],
                                              const T* Vs, float* Pw, int g, int t) {
  constexpr int LD = row_ld<T, DH>();
  if constexpr (kBf16<T>) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the accumulator layout of two adjacent 8-column tiles is the A
      // operand layout of one 16-deep step
      const uint32_t a0 = pack_f32(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_f32(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const int lane = threadIdx.x % 32, mi = lane / 8, ri = lane % 8;
#pragma unroll
      for (int d = 0; d < DH / 8; d += 2) {
        // B of n-tiles d and d + 1 from V [kv][dh], transposed on load
        uint32_t b[4];
        ldsm_x4_trans(b, Vs + (kk * 16 + (mi & 1) * 8 + ri) * LD + (d + (mi >> 1)) * 8);
        mma_bf16(acc[d], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(acc[d + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
  } else {
    // stage the warp's P rows, then each lane reads full rows of it
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      Pw[g * PLD + nt * 8 + 2 * t] = p[nt][0];
      Pw[g * PLD + nt * 8 + 2 * t + 1] = p[nt][1];
      Pw[(g + 8) * PLD + nt * 8 + 2 * t] = p[nt][2];
      Pw[(g + 8) * PLD + nt * 8 + 2 * t + 1] = p[nt][3];
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float pa = Pw[g * PLD + j], pb = Pw[(g + 8) * PLD + j];
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        const float v0 = Vs[j * LD + d * 8 + 2 * t];
        const float v1 = Vs[j * LD + d * 8 + 2 * t + 1];
        acc[d][0] = fmaf(pa, v0, acc[d][0]);
        acc[d][1] = fmaf(pa, v1, acc[d][1]);
        acc[d][2] = fmaf(pb, v0, acc[d][2]);
        acc[d][3] = fmaf(pb, v1, acc[d][3]);
      }
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// min and max of seg[i] over i in [0, 64) across a warp (lane owns i and
// i + 32); every lane gets both.
__device__ __forceinline__ void warp_range(int x0, int x1, int& lo, int& hi) {
  lo = min(x0, x1);
  hi = max(x0, x1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// The first kv tile at or after j whose segment-id range meets the q tile's
// [q_lo, q_hi] (the tile skip), and that tile's range.  Entries past Skv
// repeat the last id, so a range covers real keys only.  Every warp reads
// the same ids and so walks the same tiles: control flow stays uniform.
__device__ __forceinline__ int next_live(const int* kseg, int j, int n_tiles, int Skv,
                                         int q_lo, int q_hi, int lane, int& k_lo, int& k_hi) {
  if (!kseg) return j;
  for (; j < n_tiles; ++j) {
    const int k0 = j * BK;
    warp_range(kseg[min(k0 + lane, Skv - 1)], kseg[min(k0 + lane + 32, Skv - 1)], k_lo, k_hi);
    if (k_hi >= q_lo && k_lo <= q_hi) break;
  }
  return j;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  static_assert(BK == 64, "warp_range covers 64 ids");
  constexpr int LD = row_ld<T, DH>();
  constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
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
  load_tile<T, DH>(Qs, qg, p.q_ss, q0, p.Sq, BQ);

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
    float s[BK / 8][4];
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
    accumulate_pv<T, DH>(acc, s, Vs, Ps + warp * 16 * PLD, g, t);
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
  T* og = static_cast<T*>(p.out);
  if (row_a < p.Sq) {
    T* o = og + ((static_cast<long long>(b) * p.Sq + row_a) * p.Hq + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) store2(o + d * 8, acc[d][0] / den_a, acc[d][1] / den_a);
    if (t == 0) p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row_a] = lse_a;
  }
  if (row_b < p.Sq) {
    T* o = og + ((static_cast<long long>(b) * p.Sq + row_b) * p.Hq + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) store2(o + d * 8, acc[d][2] / den_b, acc[d][3] / den_b);
    if (t == 0) p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row_b] = lse_b;
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  constexpr int bytes = smem_bytes<T, DH>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B), block(kThreads);
  flash_fwd_kernel<T, DH><<<grid, block, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int B, int dh, cudaStream_t st) {
  switch (dh) {
    case 32: return launch<T, 32>(p, B, st);
    case 64: return launch<T, 64>(p, B, st);
    case 128: return launch<T, 128>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, Sq, Hq, dh], k, v: [B, Skv, Hkv, dh], each with element strides
// (batch, token, head) and a contiguous last axis; q_seg [B, Sq] and
// kv_seg [B, Skv] int32, both null for one segment; out: contiguous
// [B, Sq, Hq, dh] in q's dtype; lse: [B, Hq, Sq] f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* q_seg, const void* kv_seg, void* out, void* lse,
                         int B, int Hq, int Hkv, int Sq, int Skv, int dh,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int causal, int is_bf16, void* stream) {
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
  const cudaError_t err = is_bf16 ? launch_dh<__nv_bfloat16>(p, B, dh, st)
                                  : launch_dh<float>(p, B, dh, st);
  return static_cast<int>(err);
}
