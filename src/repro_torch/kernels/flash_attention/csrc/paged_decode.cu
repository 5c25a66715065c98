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
// Design: one block of 8 warps per (kv head, slot), which copies the live
// part of its page-table row into shared memory once (so no tile's loads
// wait on a table load) and reads its kv_len.  The g query rows of the
// group sit in shared memory as f32, pre-scaled.  The TPU's sequential page axis becomes a
// loop over tiles of the live pages: a tile is the 64 / ps consecutive
// logical pages (64 tokens for pages of 16) whose K and V rows ([ps, dh]
// a page, rows padded by 16 bytes) stream in with cp.async while the block
// works on the previous tile (two stages), so a long context costs few
// round trips.  Per tile, one thread per (head, token) forms a score with
// SIMT f32 FMAs; one warp per head takes the tile's row max and sum with
// shuffles and carries the online-softmax state (m, l) in shared memory;
// then one thread per (head, dh column) rescales its f32 accumulator and
// adds p . v over the tile's live tokens.  Masked tokens are left out of
// the sum altogether, so stale values in a page never reach the output.
// At 8 slots and 8 kv heads the grid is 64 blocks on 132 SMs: splitting
// the page sweep over blocks (flash-decoding) is left for later.

#include "flash_common.cuh"

namespace {

constexpr int kPagedThreads = 256;
constexpr int kPagedWarps = kPagedThreads / 32;
constexpr int kMaxPage = 64;  // tokens per page
constexpr int kTile = 64;  // tokens per tile at most: the stats step covers 2 x 32 lanes
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100

template <typename T, int E>
struct alignas(sizeof(T) * E) Pack {
  T v[E];
};

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
  int Hq, Hkv, ps, pages_max;
  float scale;
};

template <typename T, int DH>
__host__ __device__ constexpr int kv_ld() { return DH + 16 / static_cast<int>(sizeof(T)); }

__host__ __device__ constexpr int tile_tokens(int ps) { return (kTile / ps) * ps; }

template <typename T, int DH>
size_t smem_bytes(int g, int ps, int pages_max) {
  const size_t tt = tile_tokens(ps);
  return 4 * tt * kv_ld<T, DH>() * sizeof(T) +
         (2 * static_cast<size_t>(g) * DH + static_cast<size_t>(g) * tt + 3 * g) * sizeof(float) +
         static_cast<size_t>(pages_max) * sizeof(int);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kPagedThreads) paged_decode_kernel(const PagedParams p) {
  constexpr int LD = kv_ld<T, DH>();
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int CPR = DH / V;        // vectors per row
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int g = p.Hq / p.Hkv, ps = p.ps;
  const int tt = tile_tokens(ps), ppt = tt / ps;  // tokens and pages per tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  T* tiles = reinterpret_cast<T*>(smem);  // [2 stages][K, V][tt][LD]
  float* qs = reinterpret_cast<float*>(tiles + 4 * tt * LD);  // [g][DH]
  float* acc = qs + g * DH;     // [g][DH]
  float* sc = acc + g * DH;     // [g][tt]: scores, then probabilities
  float* m_s = sc + g * tt;     // [g]
  float* l_s = m_s + g;         // [g]
  float* corr_s = l_s + g;      // [g]
  int* row = reinterpret_cast<int*>(corr_s + g);  // [pages_max]: the live table entries

  const int len = p.lens[b];
  int n_pages = (len + ps - 1) / ps;  // the page skip: nothing at or past this is read
  if (n_pages > p.pages_max) n_pages = p.pages_max;
  const int n_tiles = (n_pages + ppt - 1) / ppt;
  const int* table = p.table + static_cast<long long>(b) * p.pages_max;
  for (int j = threadIdx.x; j < n_pages; j += kPagedThreads) row[j] = table[j];
  __syncthreads();
  const long long slot_stride = static_cast<long long>(p.Hkv) * DH;  // elements
  const long long page_stride = ps * slot_stride;
  const T* kbase = static_cast<const T*>(p.k_pages) + static_cast<long long>(hk) * DH;
  const T* vbase = static_cast<const T*>(p.v_pages) + static_cast<long long>(hk) * DH;

  // K and V of the live pages of tile t into stage st; closes one
  // cp.async group.  Rows of pages past n_pages stay unloaded and unread.
  auto load_tile = [&](int t, int st) {
    const int j0 = t * ppt;
    const int rows = (min(n_pages, j0 + ppt) - j0) * ps;
    T* kd = tiles + st * 2 * tt * LD;
    for (int i = threadIdx.x; i < 2 * rows * CPR; i += kPagedThreads) {
      const int which = i / (rows * CPR);  // 0: K, 1: V
      const int r = (i / CPR) % rows, c = i % CPR;
      const long long off = static_cast<long long>(row[j0 + r / ps]) * page_stride;
      const T* src = (which ? vbase : kbase) + off + (r % ps) * slot_stride + c * V;
      const uint32_t d = static_cast<uint32_t>(
          __cvta_generic_to_shared(kd + which * tt * LD + r * LD + c * V));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (n_tiles > 0) load_tile(0, 0);
  const T* qg = static_cast<const T*>(p.q) + (static_cast<long long>(b) * p.Hq + hk * g) * DH;
  for (int e = threadIdx.x; e < g * DH; e += kPagedThreads) {
    qs[e] = flash::to_f32(qg[e]) * p.scale;
    acc[e] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += kPagedThreads) {
    m_s[i] = flash::NEG_INF;
    l_s[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, st ^ 1);
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = tiles + st * 2 * tt * LD;
    const T* vs = ks + tt * LD;
    // live tokens of this tile, >= 1: the context's end or the last page read
    const int valid = min(min(tt, len - t * tt), (n_pages - t * ppt) * ps);

    // scores of the tile: one thread per (head, token)
    for (int e = threadIdx.x; e < g * tt; e += kPagedThreads) {
      const int i = e / tt, r = e % tt;
      float s = flash::NEG_INF;
      if (r < valid) {
        const float* qi = qs + i * DH;
        const T* kr = ks + r * LD;
        s = 0.f;
#pragma unroll
        for (int c = 0; c < CPR; ++c) {
          const Pack<T, V> kv = *reinterpret_cast<const Pack<T, V>*>(kr + c * V);
#pragma unroll
          for (int u = 0; u < V; ++u) s += qi[c * V + u] * flash::to_f32(kv.v[u]);
        }
      }
      sc[e] = s;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int i = warp; i < g; i += kPagedWarps) {
      float* si = sc + i * tt;
      const float s0 = lane < tt ? si[lane] : flash::NEG_INF;
      const float s1 = lane + 32 < tt ? si[lane + 32] : flash::NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = lane < valid ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < valid ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < tt) si[lane] = p0;
      if (lane + 32 < tt) si[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[i] = corr;
        l_s[i] = l_s[i] * corr + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v over the live tokens: one thread per (head, column)
    for (int e = threadIdx.x; e < g * DH; e += kPagedThreads) {
      const int i = e / DH, d = e % DH;
      const float* pi = sc + i * tt;
      float a = acc[e] * corr_s[i];
      for (int r = 0; r < valid; ++r) a += pi[r] * flash::to_f32(vs[r * LD + d]);
      acc[e] = a;
    }
    __syncthreads();  // the next iteration's load overwrites this stage's buffers
  }
  __syncthreads();  // with no live tile, l_s was written by other threads

  T* og = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.Hq + hk * g) * DH;
  for (int e = threadIdx.x; e < g * DH; e += kPagedThreads) {
    og[e] = from_f32<T>(acc[e] / fmaxf(l_s[e / DH], flash::LSE_FLOOR));
  }
}

template <typename T, int DH>
cudaError_t launch(const PagedParams& p, int B, cudaStream_t st) {
  const size_t smem = smem_bytes<T, DH>(p.Hq / p.Hkv, p.ps, p.pages_max);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  paged_decode_kernel<T, DH><<<dim3(p.Hkv, B), kPagedThreads, smem, st>>>(p);
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
// lens: [B] int32; out: contiguous [B, Hq, dh] in q's dtype.  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* table, const void* lens, void* out,
                            int B, int Hq, int Hkv, int dh, int ps, int pages_max,
                            float scale, int is_bf16, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || ps < 8 || ps > kMaxPage || ps % 8 != 0 ||
      pages_max < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PagedParams p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.table = static_cast<const int*>(table);
  p.lens = static_cast<const int*>(lens);
  p.out = out;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.ps = ps;
  p.pages_max = pages_max;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_dh<__nv_bfloat16>(p, B, dh, st)
                                  : launch_dh<float>(p, B, dh, st);
  return static_cast<int>(err);
}
