// Paged decode attention (K12) for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention/paged.py, paged_attention_pallas
// (body _paged_kernel): one new query token per decode slot attends the
// slot's cached tokens, which live in fixed-size pages of a shared pool
// addressed through the slot's page-table row:
//     out[b, h] = softmax_j(q[b, h] . k_j * scale) . v_j,   j < kv_lens[b],
// k_j and v_j read at page table[b, j / ps], offset j % ps, kv head
// h / (Hq / Hkv).  Statistics in f32, the output in q's dtype.  A page at
// or past ceil(kv_len / ps) is never read (the TPU kernel's page skip), the
// last page's slots at or past kv_len get probability exactly 0, and a
// slot with kv_len = 0 gives exact zeros (the LSE_FLOOR guard).
//
// Bound on the H100: memory.  Each live K and V page is read once for
// 4 * g flops an element (g = Hq / Hkv query heads share it), far below
// the card's 295 flops a byte; the least time is (live K/V pages + q +
// out) / 3.35 TB/s.
//
// Design: the page sweep is split over blocks (flash-decoding).  The
// wrapper fixes the split from shapes alone (paged.py split_plan): chunks
// of C pages, C * ps <= 256 tokens, n_chunks = ceil(pages_max / C) for
// each (slot, kv head), so the grid (n_chunks, Hkv, B) is known without
// reading kv_lens on the host.  A block whose chunk starts at or past the
// slot's live pages exits at once.  A live block's four warps take 64
// tokens of the chunk each: a warp looks up its pages (one table entry a
// lane, then shuffles) and keeps the group's g <= 16 query rows in
// registers as the A operand of mma.sync m16n8k16 (rows past g are zero).
// On bf16 both products run on the tensor cores, fed by the warp's own
// cp.async ring in shared memory: three slots of 16 rows, through which
// the warp streams its four K tiles and then its four V tiles (V's first
// tiles load while the last K tiles are multiplied).  S = Q K^T takes K's
// rows as B fragments, the softmax of the warp's 64 tokens stays in
// registers (quad shuffles), then O = P V with P rounded to bf16 as the A
// operand and V's fragments by ldmatrix.trans.  The ring keeps a block at
// 28 KB of shared memory at dh 64 and 52 KB at dh 128, so several blocks
// share an SM.  Rows past kv_len are not loaded but
// zero-filled (cp.async with a source size of 0) and take probability 0,
// so neither a stale value nor a NaN left in a page reaches the output.
// On f32 (on no path) a warp forms the same per-token state with SIMT
// products straight from the pool.  The block combines its warps' (m, l,
// acc) in warp order through shared memory.  A slot whose live pages fit
// one chunk writes its output there; otherwise each chunk writes its f32
// partial (acc, m, l) to the wrapper's scratch, and the last block of the
// (slot, head) to arrive (an atomic count, which that block resets to 0)
// merges the live chunks in order 0, 1, ...:
//     m = max m_c,  l = sum l_c 2^(m_c - m),  out = sum acc_c 2^(m_c - m) / max(l, LSE_FLOOR)
// (scores carry log2(e)), an empty part weighing exactly 0.  Whichever
// block merges, it reads the same partials in the same order: the result
// is bitwise repeatable.  One launch a call, no host read of kv_lens.

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSub = 64;  // tokens a warp takes of its chunk
constexpr int kTile = 16;  // bf16: rows of K or V a slot of a warp's ring holds
constexpr int kTiles = kSub / kTile;
constexpr int kStages = 3;  // slots of a warp's ring
constexpr int kChunkTokens = kWarps * kSub;  // the most tokens a chunk holds
constexpr int kMaxGroup = 16;  // query heads a kv head: the mma's 16 rows
constexpr int kMaxPage = 64;  // tokens per page
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int DH>
__host__ __device__ constexpr int kv_ld() { return DH + 16 / static_cast<int>(sizeof(T)); }

// A warp's shared memory.  bf16: its ring of K and V tiles [kStages][kTile]
// [kv_ld], which the warp's f32 accumulator [16][DH] takes over once the
// products are done.  f32: the accumulator [16][DH], then the
// probabilities [16][kSub].
template <typename T, int DH>
__host__ __device__ constexpr int region_bytes() {
  return std::is_same<T, float>::value
             ? (kMaxGroup * DH + kMaxGroup * kSub) * 4
             : (kStages * kTile * kv_ld<T, DH>() * static_cast<int>(sizeof(T)) > kMaxGroup * DH * 4
                    ? kStages * kTile * kv_ld<T, DH>() * static_cast<int>(sizeof(T))
                    : kMaxGroup * DH * 4);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct PagedParams {
  const void* q;        // [B, Hq, dh]
  const void* k_pages;  // [P, ps, Hkv, dh]
  const void* v_pages;
  const int* table;  // [B, pages_max]
  const int* lens;   // [B]
  void* out;         // [B, Hq, dh]
  float* part;       // [B, Hkv, n_chunks, g, dh + 2]: acc [g][dh], m [g], l [g]
  int* count;        // [B, Hkv]: live chunks done; zero between calls
  int Hq, Hkv, ps, pages_max, chunk_pages, n_chunks;
  float scale_log2;  // scale * log2(e): scores in base 2
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) paged_decode_chunk_kernel(const PagedParams p) {
  constexpr int LD = kv_ld<T, DH>();
  constexpr int RB = region_bytes<T, DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_w[kWarps][kMaxGroup], l_w[kWarps][kMaxGroup];
  __shared__ int is_last;

  const int chunk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = p.Hq / p.Hkv, ps = p.ps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(0, min(p.lens[b], p.pages_max * ps));
  const int n_pages = (len + ps - 1) / ps;  // the page skip: nothing at or past this is read
  const int n_live = (n_pages + p.chunk_pages - 1) / p.chunk_pages;
  T* og = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.Hq + hk * g) * DH;
  if (chunk >= n_live) {
    if (chunk == 0) {  // kv_len = 0: exact zeros
      for (int e = threadIdx.x; e < g * DH; e += kThreads) og[e] = from_f32<T>(0.f);
    }
    return;
  }

  const int c0 = chunk * p.chunk_pages * ps;  // the chunk's first token
  const int tok_end = min(len, c0 + p.chunk_pages * ps);
  const int w0 = c0 + warp * kSub;  // the warp's first token
  const int n_rows = max(0, min(kSub, tok_end - w0));  // its live tokens
  const long long slot_stride = static_cast<long long>(p.Hkv) * DH;  // elements
  const long long page_stride = ps * slot_stride;
  const T* kbase = static_cast<const T*>(p.k_pages) + static_cast<long long>(hk) * DH;
  const T* vbase = static_cast<const T*>(p.v_pages) + static_cast<long long>(hk) * DH;
  const T* qg = static_cast<const T*>(p.q) + (static_cast<long long>(b) * p.Hq + hk * g) * DH;
  unsigned char* region = smem + warp * RB;
  float* accw = reinterpret_cast<float*>(region);  // [16][DH] once the products are done

  // one live table entry a lane: the pages of the warp's live tokens (at
  // most kSub / 8 + 1 of them); a token's page is a shuffle away
  const int pg0 = w0 / ps;
  int my_page = 0;
  if (n_rows > 0 && pg0 + lane <= (w0 + n_rows - 1) / ps) {
    my_page = p.table[static_cast<long long>(b) * p.pages_max + pg0 + lane];
  }
  auto row_offset = [&](int r) {  // elements from a pool's base to row r of the warp
    const int tok = w0 + r;
    const int page = __shfl_sync(kFull, my_page, min(tok / ps - pg0, 31));
    return page * page_stride + (tok % ps) * slot_stride;
  };

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int CPR = DH / 8;  // 16-byte vectors a row
    const int gi = lane / 4, t = lane % 4;
    float acc[DH / 8][4];
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    float mrow[2] = {flash::NEG_INF, flash::NEG_INF}, lrow[2] = {0.f, 0.f};
    if (n_rows > 0) {  // warp-uniform
      // the warp's ring: kStages slots of kTile rows; items 0 .. kTiles - 1
      // are K's tiles, kTiles .. 2 kTiles - 1 V's.  Item j goes to slot
      // j % kStages in cp.async group j; a group is committed for every
      // j, empty past the last item, so "item j landed" is always
      // cp.async.wait_group kStages - 1 once item j + kStages - 1 is issued.
      T* ring = reinterpret_cast<T*>(region);
      auto load = [&](int j) {
        if (j < 2 * kTiles) {
          const T* base = j < kTiles ? kbase : vbase;
          const int r0 = (j % kTiles) * kTile;
          T* dst = ring + (j % kStages) * kTile * LD;
#pragma unroll
          for (int i = lane; i < kTile * CPR; i += 32) {
            const int r = i / CPR, c = i % CPR;
            const bool live = r0 + r < n_rows;  // rows past it are zero-filled, never read
            const long long off = row_offset(r0 + r);
            const T* src = live ? base + off + c * 8 : base;
            const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LD + c * 8));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                         :: "r"(d), "l"(src), "r"(live ? 16 : 0));
          }
        }
        asm volatile("cp.async.commit_group;\n" ::);
      };
#pragma unroll
      for (int j = 0; j < kStages; ++j) load(j);
      // the query rows gi, gi + 8 as A fragments (rows past g are zero)
      uint32_t qa[DH / 16][4];
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = kk * 16 + 2 * t + 8 * h;
          qa[kk][2 * h] = gi < g ? *reinterpret_cast<const uint32_t*>(qg + gi * DH + col) : 0u;
          qa[kk][2 * h + 1] =
              gi + 8 < g ? *reinterpret_cast<const uint32_t*>(qg + (gi + 8) * DH + col) : 0u;
        }
      }
      // S = Q K^T over the warp's 64 tokens, a K tile at a time: columns
      // nt * 8 + 2t + {0, 1}
      float s[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < kTiles; ++kt) {
        flash::cp_async_wait<kStages - 1>();
        __syncwarp();
        const T* ks = ring + (kt % kStages) * kTile * LD;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n) {
            const T* kr = ks + (n * 8 + gi) * LD + kk * 16 + 2 * t;
            flash::mma_bf16(s[kt * (kTile / 8) + n], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                            *reinterpret_cast<const uint32_t*>(kr + 8));
          }
        }
        __syncwarp();  // every lane is done with the slot
        load(kt + kStages);
      }
      // the warp's softmax state: rows gi (e = 0, 1) and gi + 8 (e = 2, 3)
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = nt * 8 + 2 * t + (e & 1) < n_rows;
          s[nt][e] = live ? s[nt][e] * p.scale_log2 : flash::NEG_INF;
          mrow[e / 2] = fmaxf(mrow[e / 2], s[nt][e]);
        }
      }
      mrow[0] = flash::quad_max(mrow[0]);
      mrow[1] = flash::quad_max(mrow[1]);
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = nt * 8 + 2 * t + (e & 1) < n_rows;
          s[nt][e] = live ? exp2f(s[nt][e] - mrow[e / 2]) : 0.f;
          lrow[e / 2] += s[nt][e];
        }
      }
      lrow[0] = flash::quad_sum(lrow[0]);
      lrow[1] = flash::quad_sum(lrow[1]);
      uint32_t pa[kSub / 16][4];
      flash::to_bf16<kSub / 16>(pa, reinterpret_cast<const float(&)[kSub / 2]>(s));
      // O = P V, a V tile (16 tokens) at a time: two 8-column tiles of V a
      // ldmatrix.x4
      const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int vt = 0; vt < kTiles; ++vt) {
        flash::cp_async_wait<kStages - 1>();
        __syncwarp();
        const T* vs = ring + ((kTiles + vt) % kStages) * kTile * LD;
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t bv[4];
          flash::ldmatrix_x4_trans(bv, vs + row * LD + np * 16 + (lane >> 4) * 8);
          flash::mma_bf16(acc[2 * np], pa[vt], bv[0], bv[1]);
          flash::mma_bf16(acc[2 * np + 1], pa[vt], bv[2], bv[3]);
        }
        __syncwarp();  // every lane is done with the slot
        load(kTiles + vt + kStages);
      }
      // the ring is idle (the groups past the last item are empty): the
      // accumulator takes it over
    }
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(accw + gi * DH + col) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(accw + (gi + 8) * DH + col) = make_float2(acc[nt][2], acc[nt][3]);
    }
    if (t == 0) {
      m_w[warp][gi] = mrow[0];
      m_w[warp][gi + 8] = mrow[1];
      l_w[warp][gi] = lrow[0];
      l_w[warp][gi + 8] = lrow[1];
    }
  } else {
    float* pw = accw + kMaxGroup * DH;  // [16][kSub] scores, then probabilities
    if (n_rows > 0) {  // warp-uniform
      // scores: lane takes tokens lane and lane + 32, every head of the group
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        const long long off = row_offset(r);
        for (int i = 0; i < g; ++i) {
          float sc = flash::NEG_INF;
          if (r < n_rows) {
            const float* kr = reinterpret_cast<const float*>(kbase) + off;
            const float* qi = reinterpret_cast<const float*>(qg) + i * DH;
            sc = 0.f;
#pragma unroll 4
            for (int d = 0; d < DH; d += 4) {
              const float4 kv = *reinterpret_cast<const float4*>(kr + d);
              const float4 qv = *reinterpret_cast<const float4*>(qi + d);
              sc += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
            }
            sc *= p.scale_log2;
          }
          pw[i * kSub + r] = sc;
        }
      }
      __syncwarp();
      for (int i = 0; i < g; ++i) {
        const float s0 = pw[i * kSub + lane], s1 = pw[i * kSub + lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float p0 = lane < n_rows ? exp2f(s0 - mx) : 0.f;
        const float p1 = lane + 32 < n_rows ? exp2f(s1 - mx) : 0.f;
        float sum = p0 + p1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        pw[i * kSub + lane] = p0;
        pw[i * kSub + lane + 32] = p1;
        if (lane == 0) {
          m_w[warp][i] = mx;
          l_w[warp][i] = sum;
        }
      }
      __syncwarp();
      // acc = P V: lanes across (head, column); g * DH is a multiple of 32
      for (int e = lane; e < g * DH; e += 32) {
        const int i = e / DH, d = e % DH;
        float a = 0.f;
        for (int r = 0; r < n_rows; ++r) {
          a += pw[i * kSub + r] * reinterpret_cast<const float*>(vbase)[row_offset(r) + d];
        }
        accw[e] = a;
      }
    } else {
      for (int e = lane; e < g * DH; e += 32) accw[e] = 0.f;
      if (lane < g) {
        m_w[warp][lane] = flash::NEG_INF;
        l_w[warp][lane] = 0.f;
      }
    }
  }
  __syncthreads();

  // the chunk: the warps' states combined in warp order
  const long long pbase =
      ((static_cast<long long>(b) * p.Hkv + hk) * p.n_chunks) * g * (DH + 2);
  const int per_chunk = g * (DH + 2);
  float* part = p.part + pbase + static_cast<long long>(chunk) * per_chunk;
  for (int e = threadIdx.x; e < g * DH; e += kThreads) {
    const int i = e / DH;
    float m = flash::NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_w[w][i]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_w[w][i];
      const float c = mw == flash::NEG_INF ? 0.f : exp2f(mw - m);  // an empty warp weighs 0
      l += l_w[w][i] * c;
      a += reinterpret_cast<const float*>(smem + w * RB)[e] * c;
    }
    if (n_live == 1) {
      og[e] = from_f32<T>(a / fmaxf(l, flash::LSE_FLOOR));
    } else {
      part[e] = a;
      if (e % DH == 0) {
        part[g * DH + i] = m;
        part[g * DH + g + i] = l;
      }
    }
  }
  if (n_live == 1) return;

  // the last chunk to arrive merges the live chunks in order
  __threadfence();
  __syncthreads();
  int* count = p.count + static_cast<long long>(b) * p.Hkv + hk;
  if (threadIdx.x == 0) is_last = atomicAdd(count, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) *count = 0;  // ready for the next call
  const float* parts = p.part + pbase;
  for (int e = threadIdx.x; e < g * DH; e += kThreads) {
    const int i = e / DH;
    float m = flash::NEG_INF;
    for (int c = 0; c < n_live; ++c) m = fmaxf(m, __ldcg(parts + c * per_chunk + g * DH + i));
    float l = 0.f, a = 0.f;
    for (int c = 0; c < n_live; ++c) {
      const float* pc = parts + c * per_chunk;
      const float mc = __ldcg(pc + g * DH + i);
      const float w = mc == flash::NEG_INF ? 0.f : exp2f(mc - m);
      l += __ldcg(pc + g * DH + g + i) * w;
      a += __ldcg(pc + e) * w;
    }
    og[e] = from_f32<T>(a / fmaxf(l, flash::LSE_FLOOR));
  }
}

template <typename T, int DH>
cudaError_t launch(const PagedParams& p, int B, cudaStream_t st) {
  constexpr int smem = kWarps * region_bytes<T, DH>();
  static unsigned long long attr_set = 0;  // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(attr_set >> dev & 1ull)) {
    e = cudaFuncSetAttribute(paged_decode_chunk_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set |= 1ull << dev;
  }
  paged_decode_chunk_kernel<T, DH><<<dim3(p.n_chunks, p.Hkv, B), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const PagedParams& p, int B, int dh, cudaStream_t st) {
  switch (dh) {
    case 64: return launch<T, 64>(p, B, st);
    case 128: return launch<T, 128>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: contiguous [B, Hq, dh]; k_pages, v_pages: contiguous [P, ps, Hkv, dh];
// table: [B, pages_max] int32 (every entry a valid page of the pool);
// lens: [B] int32; out: contiguous [B, Hq, dh] in q's dtype; part: f32
// scratch of B * Hkv * n_chunks * (Hq / Hkv) * (dh + 2); count: B * Hkv
// int32, zero, and left zero by the launch.  The split: chunks of
// chunk_pages pages (chunk_pages * ps <= 256), n_chunks * chunk_pages >=
// pages_max.  Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* table, const void* lens, void* out, void* part,
                            void* count, int B, int Hq, int Hkv, int dh, int ps, int pages_max,
                            int chunk_pages, int n_chunks, float scale, int is_bf16,
                            void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || ps < 8 || ps > kMaxPage ||
      ps % 8 != 0 || pages_max < 1 || chunk_pages < 1 || chunk_pages * ps > kChunkTokens ||
      static_cast<long long>(n_chunks) * chunk_pages < pages_max || n_chunks > 65535 ||
      Hkv > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PagedParams p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.table = static_cast<const int*>(table);
  p.lens = static_cast<const int*>(lens);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.count = static_cast<int*>(count);
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.ps = ps;
  p.pages_max = pages_max;
  p.chunk_pages = chunk_pages;
  p.n_chunks = n_chunks;
  p.scale_log2 = scale * flash::LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_dh<__nv_bfloat16>(p, B, dh, st)
                                  : launch_dh<float>(p, B, dh, st);
  return static_cast<int>(err);
}
