// Device helpers shared by the flash-attention kernels (flash_fwd.cu: K7,
// flash_bwd.cuh: K8 and K9).
//
// Tiles are 64 rows of a [S, DH] matrix held in shared memory with a
// 16-byte row pad (conflict-free ldmatrix).  A warp owns 16 rows of the
// left-hand operand; its products land in the mma.sync m16n8k16
// accumulator layout: a lane owns rows g = lane / 4 and g + 8, and in every
// 8-column tile nt the columns nt * 8 + 2 * t + {0, 1}, t = lane % 4;
// s[nt][0..1] belong to row g, s[nt][2..3] to row g + 8.  bf16 operands go
// through mma.sync with fp32 accumulation; the f32 path keeps the same
// fragment ownership but forms each product with SIMT FMAs, so its
// products are exact fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // kv rows per tile
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int PLD = 64 + 4;  // row stride of the f32 path's product staging
constexpr float NEG_INF = -2.0e38f;
constexpr float LSE_FLOOR = 1e-37f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(BQ == 64 && BK == 64, "warp_range and the fragment loops cover 64 rows");

template <typename T>
constexpr bool kBf16 = sizeof(T) == 2;

template <typename T, int DH>
__host__ __device__ constexpr int row_ld() { return DH + 16 / static_cast<int>(sizeof(T)); }

template <typename T, int DH>
constexpr int tile_bytes() { return 64 * row_ld<T, DH>() * static_cast<int>(sizeof(T)); }

// bytes of the f32 path's per-warp staging of a product operand
template <typename T>
constexpr int staging_bytes() { return kBf16<T> ? 0 : kWarps * 16 * PLD * static_cast<int>(sizeof(float)); }

// rows [r0, r0 + 64) of a [S, DH] strided matrix into shared memory with
// 16-byte loads; rows past S are zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride, int r0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = DH / V;  // chunks per row
  constexpr int LD = row_ld<T, DH>();
  for (int i = threadIdx.x; i < 64 * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c * V);
    *reinterpret_cast<uint4*>(dst + r * LD + c * V) = val;
  }
}

// The same, asynchronously (cp.async, 16 bytes a thread, bypassing L1):
// rows past S are zero-filled by a zero source size.  Closes one group.
template <typename T, int DH>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long row_stride, int r0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = DH / V;
  constexpr int LD = row_ld<T, DH>();
  for (int i = threadIdx.x; i < 64 * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < S;
    const T* g = in ? src + (r0 + r) * row_stride + c * V : src;
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LD + c * V));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(d), "l"(g), "r"(in ? 16 : 0));
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// s = A_w B^T: the warp's 16 rows of A (at Aw) against the 64 rows of B.
template <typename T, int DH>
__device__ __forceinline__ void scores(float (&s)[8][4], const T* Aw, const T* Bs, int g, int t) {
  constexpr int LD = row_ld<T, DH>();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  if constexpr (kBf16<T>) {
    const int lane = threadIdx.x % 32, mi = lane / 8, ri = lane % 8;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // A: rows 0-7 / 8-15 x cols 0-7 / 8-15 of the warp's 16 x 16 block
      uint32_t a[4];
      ldsm_x4(a, Aw + (ri + (mi & 1) * 8) * LD + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        // B^T of n-tiles nt and nt + 1: rows of B are its columns
        uint32_t b[4];
        ldsm_x4(b, Bs + (nt * 8 + (mi >> 1) * 8 + ri) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[nt], a[0], a[1], a[2], a[3], b[0], b[1]);
        mma_bf16(s[nt + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
      }
    }
  } else {
#pragma unroll 4
    for (int kk = 0; kk < DH; ++kk) {
      const float qa = Aw[g * LD + kk], qb = Aw[(g + 8) * LD + kk];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float k0 = Bs[(nt * 8 + 2 * t) * LD + kk];
        const float k1 = Bs[(nt * 8 + 2 * t + 1) * LD + kk];
        s[nt][0] = fmaf(qa, k0, s[nt][0]);
        s[nt][1] = fmaf(qa, k1, s[nt][1]);
        s[nt][2] = fmaf(qb, k0, s[nt][2]);
        s[nt][3] = fmaf(qb, k1, s[nt][3]);
      }
    }
  }
}

// acc += P C for the warp's 16 rows: p holds P [16, 64] in the fragment
// layout, Cs is a [64, DH] tile.  Pw: the warp's f32 staging (f32 path).
template <typename T, int DH>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4], const float (&p)[8][4],
                                           const T* Cs, float* Pw, int g, int t) {
  constexpr int LD = row_ld<T, DH>();
  if constexpr (kBf16<T>) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // the accumulator layout of two adjacent 8-column tiles is the A
      // operand layout of one 16-deep step
      const uint32_t a0 = pack_f32(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_f32(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const int lane = threadIdx.x % 32, mi = lane / 8, ri = lane % 8;
#pragma unroll
      for (int d = 0; d < DH / 8; d += 2) {
        // B of n-tiles d and d + 1 from C [64][DH], transposed on load
        uint32_t b[4];
        ldsm_x4_trans(b, Cs + (kk * 16 + (mi & 1) * 8 + ri) * LD + (d + (mi >> 1)) * 8);
        mma_bf16(acc[d], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(acc[d + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
  } else {
    // stage the warp's P rows, then each lane reads full rows of it
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      Pw[g * PLD + nt * 8 + 2 * t] = p[nt][0];
      Pw[g * PLD + nt * 8 + 2 * t + 1] = p[nt][1];
      Pw[(g + 8) * PLD + nt * 8 + 2 * t] = p[nt][2];
      Pw[(g + 8) * PLD + nt * 8 + 2 * t + 1] = p[nt][3];
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < 64; ++j) {
      const float pa = Pw[g * PLD + j], pb = Pw[(g + 8) * PLD + j];
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        const float v0 = Cs[j * LD + d * 8 + 2 * t];
        const float v1 = Cs[j * LD + d * 8 + 2 * t + 1];
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

// The first tile at or after j of a swept operand whose segment-id range
// meets the resident tile's [lo, hi] (the tile skip), and that tile's
// range.  Entries past S repeat the last id, so a range covers real rows
// only.  Every warp reads the same ids and so walks the same tiles: control
// flow stays uniform.  With no ids every tile is live.
__device__ __forceinline__ int next_live(const int* seg, int j, int n_tiles, int S,
                                         int lo, int hi, int lane, int& t_lo, int& t_hi) {
  if (!seg) return j;
  for (; j < n_tiles; ++j) {
    const int r0 = j * 64;
    warp_range(seg[min(r0 + lane, S - 1)], seg[min(r0 + lane + 32, S - 1)], t_lo, t_hi);
    if (t_hi >= lo && t_lo <= hi) break;
  }
  return j;
}

}  // namespace flash
