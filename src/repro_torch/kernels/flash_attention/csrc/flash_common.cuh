// Device helpers shared by the flash-attention kernels: the 64-row f32
// kernels (flash_fwd.cu: K7 on f32 inputs; flash_bwd.cuh: K8 and K9 on
// f32 inputs) and, for the fragment layout, the tile skip and the
// constants, the warp-specialised bf16 kernels beside them.
//
// Tiles are 64 rows of a [S, DH] matrix held in shared memory with a
// 16-byte row pad.  A warp owns 16 rows of the left-hand operand; its
// products land in the mma.sync m16n8 accumulator layout: a lane owns rows
// g = lane / 4 and g + 8, and in every 8-column tile nt the columns
// nt * 8 + 2 * t + {0, 1}, t = lane % 4; s[nt][0..1] belong to row g,
// s[nt][2..3] to row g + 8 (the layout of wgmma's accumulators too).  The
// f32 operands go through mma.sync m16n8k8 in TF32 three times (3xTF32):
// each operand x splits
// into hi = rna(x) and lo = rna(x - hi) (rna: to nearest, ties away, as
// cvt.rna.tf32.f32), 11 significant bits each, and every 8-deep step
// accumulates a_lo b_hi + a_hi b_lo, then a_hi b_hi; the dropped a_lo b_lo
// and the tensor cores' own sums leave a tile's product about 1e-6 from
// exact f32, where one TF32 pass (1e-3) would break the f32 reference's
// gates.  A sweep adds each tile's product to its running sum in f32
// (accumulate()).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // kv rows per tile
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = kWarps * 32;
// row stride of the f32 path's product staging: 72 = 8 mod 32 banks keeps
// its float2 stores and A-fragment loads free of bank conflicts
constexpr int PLD = 64 + 8;
constexpr float NEG_INF = -2.0e38f;
constexpr float LSE_FLOOR = 1e-37f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(BQ == 64 && BK == 64, "warp_range and the fragment loops cover 64 rows");

template <typename T, int DH>
__host__ __device__ constexpr int row_ld() { return DH + 16 / static_cast<int>(sizeof(T)); }

template <typename T, int DH>
constexpr int tile_bytes() { return 64 * row_ld<T, DH>() * static_cast<int>(sizeof(T)); }

// bytes of the per-warp staging of a product operand (accumulate())
constexpr int kStagingBytes = kWarps * 16 * PLD * static_cast<int>(sizeof(float));

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

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from 0,
// as cvt.rna.tf32.f32 rounds a finite x: half of the 13 dropped bits added
// to the magnitude, then cleared: two integer operations, where the cvt
// instruction made the f32 backward hop measurably slower.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a * b for one m16n8k8 tile, TF32 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// an f32 fragment as TF32 hi and lo parts: x = hi + lo to about 22 bits
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32(x[i]);
    lo[i] = tf32(x[i] - __uint_as_float(hi[i]));
  }
}

// d += a * b for one m16n8k8 tile of f32 operands, split beforehand
// (3xTF32): the two cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// d += a * b for one m16n8k16 tile, bf16 inputs, fp32 accumulators: a
// lane's a holds rows g, g + 8 at columns 2t, 2t + 1 (a[0], a[1]) and
// 2t + 8, 2t + 9 (a[2], a[3]); its b holds column g of B at rows 2t, 2t + 1
// (b[0]) and 2t + 8, 2t + 9 (b[1]), two values a register, the lower
// column or row in the low half
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8i to
// 8i + 7 give the addresses of matrix i's eight 16-byte rows, and r[i] is
// lane (g, t)'s pair (row 2t, column g), (row 2t + 1, column g) of matrix
// i: the mma B fragment of a row-major [k, n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// s = A_w B^T: the warp's 16 rows of A (at Aw) against the 64 rows of B;
// f32 operands (3xTF32).
template <typename T, int DH>
__device__ __forceinline__ void scores(float (&s)[8][4], const T* Aw, const T* Bs, int g, int t) {
  constexpr int LD = row_ld<T, DH>();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  // m16n8k8 steps: A rows g, g + 8 and columns t, t + 4 of the step; B
  // (column n of B^T is row n of B) rows nt * 8 + g, the same columns.
  // With row_ld = DH + 4 floats both reads hit 32 distinct banks.
#pragma unroll 2
  for (int kk = 0; kk < DH / 8; ++kk) {
    const float* a = Aw + kk * 8 + t;
    const float af[4] = {a[g * LD], a[(g + 8) * LD], a[g * LD + 4], a[(g + 8) * LD + 4]};
    uint32_t a_hi[4], a_lo[4];
    split_tf32(af, a_hi, a_lo);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* bp = Bs + (nt * 8 + g) * LD + kk * 8 + t;
      const float bf[2] = {bp[0], bp[4]};
      uint32_t b_hi[2], b_lo[2];
      split_tf32(bf, b_hi, b_lo);
      mma_3xtf32(s[nt], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// acc += P C for the warp's 16 rows: p holds P [16, 64] in the fragment
// layout, Cs is a [64, DH] f32 tile.  Pw: the warp's f32 staging.
template <typename T, int DH>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4], const float (&p)[8][4],
                                           const T* Cs, float* Pw, int g, int t) {
  constexpr int LD = row_ld<T, DH>();
  // stage the warp's P rows (the accumulator layout), then read them back
  // as m16n8k8 A fragments.  The 8-deep step's index k is a label: lane
  // (g, t) takes k = t from column 2t of the step and k = t + 4 from
  // column 2t + 1, in P and in C alike, so a float2 load gives a lane both
  // of a row's A entries, and C's rows 2t, 2t + 1 land on 32 distinct
  // banks (row_ld = 4 mod 32); P's float2 accesses are conflict-free with
  // PLD = 8 mod 32.  The tile's 64-deep product goes into a zeroed
  // partial, added to acc with one rounded f32 add: the tensor cores'
  // own accumulation does not round to nearest, and over the thousands
  // of tiles of a long sweep its error would build up in acc.
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    store2(Pw + g * PLD + nt * 8 + 2 * t, p[nt][0], p[nt][1]);
    store2(Pw + (g + 8) * PLD + nt * 8 + 2 * t, p[nt][2], p[nt][3]);
  }
  __syncwarp();
  constexpr int NC = DH / 8 < 8 ? DH / 8 : 8;  // 8-column blocks per partial
#pragma unroll
  for (int d0 = 0; d0 < DH / 8; d0 += NC) {
    float part[NC][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < 8; ++kk) {
      const float2 x = *reinterpret_cast<const float2*>(Pw + g * PLD + kk * 8 + 2 * t);
      const float2 y = *reinterpret_cast<const float2*>(Pw + (g + 8) * PLD + kk * 8 + 2 * t);
      const float af[4] = {x.x, y.x, x.y, y.y};
      uint32_t a_hi[4], a_lo[4];
      split_tf32(af, a_hi, a_lo);
      const float* c = Cs + (kk * 8 + 2 * t) * LD + d0 * 8 + g;
#pragma unroll
      for (int d = 0; d < NC; ++d) {
        const float bf[2] = {c[d * 8], c[LD + d * 8]};
        uint32_t b_hi[2], b_lo[2];
        split_tf32(bf, b_hi, b_lo);
        mma_3xtf32(part[d], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll
    for (int d = 0; d < NC; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d0 + d][e] += part[d][e];
  }
  __syncwarp();
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// min and max across a warp of each lane's x0 and x1 (seg[i] and
// seg[i + 32] for i = lane: a 64-row tile's range); every lane gets both.
__device__ __forceinline__ void warp_range(int x0, int x1, int& lo, int& hi) {
  lo = min(x0, x1);
  hi = max(x0, x1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// ids of rows r0 + lane + 32 m, m < N (a tile of 32 N rows); rows past S
// repeat the last id, so a range covers real rows only
template <int N>
__device__ __forceinline__ void fetch_ids(int (&x)[N], const int* seg, int r0, int S) {
#pragma unroll
  for (int m = 0; m < N; ++m) x[m] = seg[min(r0 + static_cast<int>(threadIdx.x % 32) + 32 * m, S - 1)];
}
// the warp's range of what fetch_ids fetched; every lane gets both ends
template <int N>
__device__ __forceinline__ void id_range(const int (&x)[N], int& lo, int& hi) {
  int mn = x[0], mx = x[0];
#pragma unroll
  for (int m = 1; m < N; ++m) {
    mn = min(mn, x[m]);
    mx = max(mx, x[m]);
  }
  warp_range(mn, mx, lo, hi);
}

// A [64, 16 N] accumulator (the mma / wgmma layout, two rows a lane) as the
// bf16 A fragments of N 16-deep steps: the layout of two adjacent 8-column
// blocks is that of one step
template <int N>
__device__ __forceinline__ void to_bf16(uint32_t (&f)[N][4], const float (&s)[8 * N]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    f[kk][0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
    f[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
    f[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
    f[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
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
