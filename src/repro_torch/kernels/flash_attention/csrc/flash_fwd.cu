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
// Design, bf16 inputs (every model path): a persistent grid of at most
// one block per SM, each walking work items (a q tile of 128 rows of one
// head of one batch entry) heaviest first, dealt to the blocks in snake
// order.  The TPU's sequential kv grid axis becomes a loop over the live
// kv tiles of 128 rows.  A block is three warpgroups.  Warpgroup 2 is the
// producer: one warp walks each item's live tiles (the tile skip on the
// item's 128 rows by segment-id ranges, and the causal triangle) and
// issues TMA loads of Q into one of two buffers and of K and V into rings
// of 2 (dh 128) or 3 stages, each completing on an mbarrier; rows past S
// arrive zero-filled, and the next item's loads run while the consumers
// finish this one.  It gives its registers (setmaxnreg) to warpgroups 0
// and 1, the consumers, 64 q rows each, which keep the fp32 (m, l, O)
// state in registers.  S = Q K^T is a wgmma from shared memory, both
// operands K-major in the 128-byte swizzle TMA wrote (64-byte for dh 32; a
// dh-128 row is two boxes of 64 columns); the online softmax runs on the
// accumulator registers (row statistics shared by the 4 lanes of a quad,
// one FFMA and one ex2 per score); P is rounded to bf16 in registers as
// the A operand of O += P V, a wgmma that reads V MN-major through its
// transpose bit.  Tiles overlap: Q K(j+1)^T and P(j) V(j) are in flight
// together and the softmax of tile j+1 runs beside the second; O is
// rescaled once it has landed.  A K stage goes back to the producer after
// its tile's softmax (which reads the tile's kv ids from the stage), a V
// stage after its product.  Only a tile where some key is hidden from
// some row of a warp pays for the mask: its hidden scores become NEG_INF.
// The output is written from the registers in [B, Sq, Hq, dh], bf16 or
// f32 (out_f32: the training forward keeps the unrounded output as the
// residual of the backward's delta rows), the two from the same
// accumulators.  NEG_INF is the finite -2e38 and a row that sees no key
// ends with l = 0, giving exact zeros through the LSE_FLOOR guard.
//
// What bounds it now: at dh 64 a tile's softmax (66 ex2 a lane on the
// 16-a-clock special-function units) weighs as much as its two products,
// and the two warpgroups reach their softmaxes together.  Slower on the
// H100 and left out: named-barrier ping-pong or a fixed offset of the two
// warpgroups, three consumers of 192 rows or two blocks of one (register
// spills), part of the ex2 on the FMA pipe (register pressure serialises
// the wgmmas).  Not yet used: TMA stores of the output, clusters with
// multicast loads.
//
// f32 inputs (small checks and tests) take the 64-row kernel of
// flash_common.cuh: 4 warps of 16 rows, cp.async tiles, mma.sync with
// 3xTF32 products, the same masks and skip.

#include "flash_common.cuh"
#include "../../csrc/sm90.cuh"

namespace {

using namespace flash;

// -- f32 inputs: 64-row tiles, mma.sync with 3xTF32 products -----------------

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_seg;   // [B, Sq] or null (one segment)
  const int* kv_seg;  // [B, Skv] or null
  void* out;          // [B, Sq, Hq, dh] f32
  float* lse;         // [B, Hq, Sq]
  int Hq, Hkv, Sq, Skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  float scale;
  int causal;
};

template <int DH>
constexpr int smem_bytes() { return 3 * tile_bytes<float, DH>() + kStagingBytes; }

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const Params p) {
  using T = float;
  using OT = float;
  constexpr int LD = row_ld<T, DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + BK * LD);  // P staging
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

template <int DH>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t st) {
  constexpr int bytes = smem_bytes<DH>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B), block(kThreads);
  flash_fwd_f32_kernel<DH><<<grid, block, bytes, st>>>(p);
  return cudaGetLastError();
}

// -- bf16 inputs: 128-row tiles, TMA, wgmma, warp specialisation ---------------

namespace wg {

using namespace sm90;

constexpr int BQ = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int BK = 128;  // kv rows per tile
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;  // the producer warpgroup last
// 128 x 40 + 256 x 232 = 384 x 168, the register file of a 384-thread block
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int DH>
struct Cfg {
  static constexpr int kBox = DH < 64 ? DH : 64;  // columns of one TMA box: at most 128 bytes
  static constexpr int kBoxes = DH / kBox;
  static constexpr int kRowBytes = 2 * kBox;
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : 2;  // wgmma's 128- / 64-byte swizzle
  static constexpr int kStages = DH == 128 ? 2 : 3;  // K and V ring depth
  static constexpr int kQBytes = BQ * DH * 2;
  static constexpr int kTileBytes = BK * DH * 2;
  // two Q buffers, the K ring, the V ring; the barriers (Q full and Q
  // empty per buffer; K full, K empty, V full, V empty per stage); each K
  // stage's metadata (tile index or -1 at an item's end, the tile's
  // segment-id range) and its kv segment ids
  static constexpr int kBarOff = 2 * kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kMetaOff = kBarOff + 8 * (4 + 4 * kStages);
  static constexpr int kIdsOff = kMetaOff + 16 * kStages;
  static constexpr int kBytes = kIdsOff + 4 * BK * kStages + 1024;  // + the 1024-byte alignment
};

struct Params {
  CUtensorMap tq, tk, tv;  // [B, S, H, dh] bf16 views, boxes of BQ / BK rows
  const int* q_seg;        // [B, Sq] or null (one segment)
  const int* kv_seg;       // [B, Skv] or null
  void* out;               // [B, Sq, Hq, dh], bf16 or f32
  float* lse;              // [B, Hq, Sq]
  int B, Hq, Hkv, Sq, Skv;
  float scale;
  int causal;
};

template <int DH>
struct Smem {
  using C = Cfg<DH>;
  unsigned char* base;
  __device__ unsigned char* q(int i) const { return base + i * C::kQBytes; }
  __device__ unsigned char* k(int s) const { return base + 2 * C::kQBytes + s * C::kTileBytes; }
  __device__ unsigned char* v(int s) const {
    return base + 2 * C::kQBytes + (C::kStages + s) * C::kTileBytes;
  }
  __device__ uint64_t* bar() const { return reinterpret_cast<uint64_t*>(base + C::kBarOff); }
  __device__ uint64_t* q_full(int i) const { return bar() + i; }
  __device__ uint64_t* q_empty(int i) const { return bar() + 2 + i; }
  __device__ uint64_t* k_full(int s) const { return bar() + 4 + s; }
  __device__ uint64_t* k_empty(int s) const { return bar() + 4 + C::kStages + s; }
  __device__ uint64_t* v_full(int s) const { return bar() + 4 + 2 * C::kStages + s; }
  __device__ uint64_t* v_empty(int s) const { return bar() + 4 + 3 * C::kStages + s; }
  __device__ int* meta(int s) const { return reinterpret_cast<int*>(base + C::kMetaOff) + 4 * s; }
  __device__ int* ids(int s) const { return reinterpret_cast<int*>(base + C::kIdsOff) + BK * s; }
};

// One work item: a q tile of one head of one batch entry.  Items are
// numbered heaviest first (dealt by item_index): heads and batch fastest, q
// tiles from the last down (under the causal mask the last tiles see the
// most keys).
struct Item {
  int q0, h, hk, b, n_tiles;
  const int* qseg;  // the batch entry's ids, or null
  const int* kseg;
};

__device__ __forceinline__ Item item(const Params& p, int n) {
  const int n_q = (p.Sq + BQ - 1) / BQ, hb = p.Hq * p.B;
  Item it;
  it.q0 = (n_q - 1 - n / hb) * BQ;
  it.h = n % p.Hq;
  it.b = n % hb / p.Hq;
  it.hk = it.h / (p.Hq / p.Hkv);
  it.qseg = p.q_seg ? p.q_seg + static_cast<long long>(it.b) * p.Sq : nullptr;
  it.kseg = p.kv_seg ? p.kv_seg + static_cast<long long>(it.b) * p.Skv : nullptr;
  it.n_tiles = (p.Skv + BK - 1) / BK;
  if (p.causal) it.n_tiles = min(it.n_tiles, (it.q0 + BQ - 1) / BK + 1);
  return it;
}

// The producer warp: the tile schedule and every TMA load.  For each of
// the block's items it loads Q into the free one of two buffers, then
// walks the live kv tiles (the tile skip on the item's 128 q rows) and,
// for each, loads K into the next K stage with the tile's metadata and
// ids, then V into the next V stage; a stage or buffer is reused once all
// 8 consumer warps have released it.  After an item's last tile a K stage
// carries -1 and no data.  The next tile's ids are in flight while this
// tile's stages are claimed, and the next item's loads while the
// consumers finish this one.
template <int DH>
__device__ __forceinline__ void produce(const Params& p, const Smem<DH>& sm, int n_items) {
  static_assert(BQ == 128 && BK == 128, "fetch_ids covers 128 rows");
  using C = Cfg<DH>;
  const int lane = threadIdx.x % 32;
  Ring<2> qb;
  Ring<C::kStages> ks, vs;
  for (int round = 0;; ++round) {
    const int n = item_index(round);
    if (n >= n_items) break;
    const Item it = item(p, n);
    mbar_wait(sm.q_empty(qb.i), qb.phase ^ 1);
    if (lane == 0) {
      mbar_expect_tx(sm.q_full(qb.i), C::kQBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load_4d(sm.q(qb.i) + x * BQ * C::kRowBytes, &p.tq, sm.q_full(qb.i), x * C::kBox,
                    it.q0, it.h, it.b);
    }
    qb.advance();
    int q_lo = 0, q_hi = 0, t_lo = 0, t_hi = 0;
    int ids[4] = {}, next_ids[4] = {};
    // the first live tile at or after j, its ids and range; uniform across the warp
    auto seek = [&](int j) {
      for (; j < it.n_tiles; ++j) {
        fetch_ids(ids, it.kseg, j * BK, p.Skv);
        id_range(ids, t_lo, t_hi);
        if (t_hi >= q_lo && t_lo <= q_hi) break;
      }
      return j;
    };
    int j = 0;
    if (it.qseg) {
      fetch_ids(ids, it.qseg, it.q0, p.Sq);
      id_range(ids, q_lo, q_hi);
      j = seek(0);
    }
    for (;;) {
      const bool live = j < it.n_tiles;
      if (it.kseg && j + 1 < it.n_tiles) fetch_ids(next_ids, it.kseg, (j + 1) * BK, p.Skv);
      mbar_wait(sm.k_empty(ks.i), ks.phase ^ 1);
      if (live && it.kseg) {
#pragma unroll
        for (int m = 0; m < 4; ++m) sm.ids(ks.i)[lane + 32 * m] = ids[m];
      }
      if (lane == 0) {
        int* meta = sm.meta(ks.i);
        meta[0] = live ? j : -1;
        meta[1] = t_lo;
        meta[2] = t_hi;
      }
      __syncwarp();  // the lanes' ids before lane 0's arrival releases them
      if (lane == 0) {
        if (live) {
          mbar_expect_tx(sm.k_full(ks.i), C::kTileBytes);
#pragma unroll
          for (int x = 0; x < C::kBoxes; ++x)
            tma_load_4d(sm.k(ks.i) + x * BK * C::kRowBytes, &p.tk, sm.k_full(ks.i), x * C::kBox,
                        j * BK, it.hk, it.b);
        } else {
          mbar_arrive(sm.k_full(ks.i));
        }
      }
      ks.advance();
      if (!live) break;
      mbar_wait(sm.v_empty(vs.i), vs.phase ^ 1);
      if (lane == 0) {
        mbar_expect_tx(sm.v_full(vs.i), C::kTileBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load_4d(sm.v(vs.i) + x * BK * C::kRowBytes, &p.tv, sm.v_full(vs.i), x * C::kBox,
                      j * BK, it.hk, it.b);
      }
      vs.advance();
      ++j;
      if (it.kseg && j < it.n_tiles) {
#pragma unroll
        for (int m = 0; m < 4; ++m) ids[m] = next_ids[m];
        id_range(ids, t_lo, t_hi);
        if (!(t_hi >= q_lo && t_lo <= q_hi)) j = seek(j + 1);
      }
    }
  }
}

// S = Q K^T for the warpgroup's 64 rows against the stage's BK keys
template <int DH>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_addr, uint32_t k_addr) {
  using C = Cfg<DH>;
  constexpr uint32_t kGroup = 8 * C::kRowBytes;  // 8 rows of a swizzle atom
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int x = kk * 16 / C::kBox, col = (kk * 16) % C::kBox * 2;  // box, byte column
    const uint64_t da = wgmma_desc(q_addr + x * BQ * C::kRowBytes + col, kGroup, kGroup, C::kSwizzle);
    const uint64_t db = wgmma_desc(k_addr + x * BK * C::kRowBytes + col, kGroup, kGroup, C::kSwizzle);
    wgmma_ss_n128(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V for the warpgroup's 64 rows: P from registers, V [BK, DH] of
// the stage read MN-major, one box of at most 64 columns per product
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2], uint32_t (&pf)[BK / 16][4],
                                         uint32_t v_addr) {
  using C = Cfg<DH>;
  constexpr uint32_t kGroup = 8 * C::kRowBytes;
  pin(o);
  pin(pf);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) {
      const uint64_t db = wgmma_desc(v_addr + x * BK * C::kRowBytes + kk * 16 * C::kRowBytes,
                                     kGroup, kGroup, C::kSwizzle);
      if constexpr (C::kBox == 64) wgmma_rs_n64(o + 32 * x, pf[kk], db, 1);
      else wgmma_rs_n32(o, pf[kk], db, 1);
    }
  }
  wgmma_commit();
}

// The rows' running max (raw scores) and sum, two rows a lane
struct RowState {
  float m_a, m_b, l_a, l_b;
};

// The online softmax of one tile on the accumulator registers: updates
// the rows' (m, l) and leaves P = 2^(s * scale2 - m * scale2) in s, f32;
// returns the rescale of the rows' earlier output in corr_a / corr_b.
// Hidden entries come in as NEG_INF and leave as exact zeros, also in a
// row that has seen no key yet (its m stays NEG_INF, and its exponents
// are then NEG_INF * scale2).
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], RowState& r, float& corr_a,
                                             float& corr_b, float scale2) {
  float mx_a = r.m_a, mx_b = r.m_b;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (i % 4 < 2) mx_a = fmaxf(mx_a, s[i]);
    else mx_b = fmaxf(mx_b, s[i]);
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  corr_a = ex2((r.m_a - mx_a) * scale2);
  corr_b = ex2((r.m_b - mx_b) * scale2);
  const float sub_a = mx_a == NEG_INF ? 0.f : mx_a * scale2;
  const float sub_b = mx_b == NEG_INF ? 0.f : mx_b * scale2;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float pe = ex2(fmaf(s[i], scale2, -(i % 4 < 2 ? sub_a : sub_b)));
    s[i] = pe;
    if (i % 4 < 2) sum_a += pe;
    else sum_b += pe;
  }
  r.l_a = r.l_a * corr_a + quad_sum(sum_a);
  r.l_b = r.l_b * corr_b + quad_sum(sum_b);
  r.m_a = mx_a;
  r.m_b = mx_b;
}

// One tile's softmax.  Where some key of the tile is hidden from some row
// of the warp (another segment, the causal cut, the ragged edge) its
// score becomes NEG_INF first, by the stage's kv ids.
__device__ __forceinline__ void softmax(float (&s)[BK / 2], RowState& r, float& corr_a,
                                        float& corr_b, const Params& p, const int* ids,
                                        const int* meta, int r0, int row_a, int seg_a, int seg_b,
                                        int w_lo, int w_hi, bool segmented, float scale2) {
  const int t = threadIdx.x % 4;
  const int k0 = meta[0] * BK, t_lo = meta[1], t_hi = meta[2];
  const int row_b = row_a + 8;
  const bool full = (!segmented || (w_lo == w_hi && t_lo == t_hi && w_lo == t_lo)) &&
                    k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= r0);
  if (!full) {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + 2 * t + (e & 1);
        bool ok = k0 + cl < p.Skv;
        if (p.causal) ok = ok && (e < 2 ? row_a : row_b) >= k0 + cl;
        if (segmented) ok = ok && ids[cl] == (e < 2 ? seg_a : seg_b);
        if (!ok) s[nt * 4 + e] = NEG_INF;
      }
    }
  }
  softmax_tile(s, r, corr_a, corr_b, scale2);
}

// A consumer warpgroup: 64 q rows of each of the block's items, over every
// tile the producer schedules for it.
template <typename OT, int DH>
__device__ __forceinline__ void consume(const Params& p, const Smem<DH>& sm, int n_items) {
  using C = Cfg<DH>;
  const int wgi = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale2 = p.scale * LOG2E;  // exp(x scale) = 2^(x scale2)
  Ring<2> qb;
  Ring<C::kStages> ks, vs;
  for (int round = 0;; ++round) {
    const int n = item_index(round);
    if (n >= n_items) break;
    const Item it = item(p, n);
    const int r0 = it.q0 + wgi * 64 + warp * 16;  // the warp's first row
    const int row_a = r0 + g, row_b = row_a + 8;
    int seg_a = 0, seg_b = 0, w_lo = 0, w_hi = 0;
    if (it.qseg) {
      seg_a = it.qseg[min(row_a, p.Sq - 1)];
      seg_b = it.qseg[min(row_b, p.Sq - 1)];
      warp_range(seg_a, seg_b, w_lo, w_hi);
    }
    const bool segmented = it.kseg != nullptr;
    float o[DH / 2], s[BK / 2];
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    RowState r{NEG_INF, NEG_INF, 0.f, 0.f};
    float corr_a, corr_b;

    mbar_wait(sm.q_full(qb.i), qb.phase);
    const uint32_t q_addr = smem_u32(sm.q(qb.i)) + wgi * 64 * C::kRowBytes;
    mbar_wait(sm.k_full(ks.i), ks.phase);
    if (sm.meta(ks.i)[0] >= 0) {
      issue_s<DH>(s, q_addr, smem_u32(sm.k(ks.i)));
      wgmma_wait<0>();
      pin(s);
      softmax(s, r, corr_a, corr_b, p, sm.ids(ks.i), sm.meta(ks.i), r0, row_a, seg_a, seg_b,
              w_lo, w_hi, segmented, scale2);
      release(sm.k_empty(ks.i));
      to_bf16(pf, s);
      ks.advance();
      // Each turn: Q K(j+1)^T and P(j) V(j) in flight together; the
      // softmax of tile j+1 runs once the first has landed, beside the
      // second.
      for (;;) {
        mbar_wait(sm.k_full(ks.i), ks.phase);
        if (sm.meta(ks.i)[0] < 0) break;
        issue_s<DH>(s, q_addr, smem_u32(sm.k(ks.i)));
        mbar_wait(sm.v_full(vs.i), vs.phase);
        issue_pv<DH>(o, pf, smem_u32(sm.v(vs.i)));
        wgmma_wait<1>();
        pin(s);
        softmax(s, r, corr_a, corr_b, p, sm.ids(ks.i), sm.meta(ks.i), r0, row_a, seg_a, seg_b,
                w_lo, w_hi, segmented, scale2);
        release(sm.k_empty(ks.i));
        wgmma_wait<0>();
        pin(o);
        pin(pf);
        release(sm.v_empty(vs.i));
        vs.advance();
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] *= i % 4 < 2 ? corr_a : corr_b;
        to_bf16(pf, s);
        ks.advance();
      }
      // the last tile's P V
      mbar_wait(sm.v_full(vs.i), vs.phase);
      issue_pv<DH>(o, pf, smem_u32(sm.v(vs.i)));
      wgmma_wait<0>();
      pin(o);
      pin(pf);
      release(sm.v_empty(vs.i));
      vs.advance();
    }
    // the item's end marker, and its Q: every product reading them has landed
    release(sm.k_empty(ks.i));
    ks.advance();
    release(sm.q_empty(qb.i));
    qb.advance();

    // a row that saw no key keeps m = NEG_INF, l = 0
    const float den_a = fmaxf(r.l_a, LSE_FLOOR), den_b = fmaxf(r.l_b, LSE_FLOOR);
    OT* og = static_cast<OT*>(p.out);
    if (row_a < p.Sq) {
      OT* op = og + ((static_cast<long long>(it.b) * p.Sq + row_a) * p.Hq + it.h) * DH + 2 * t;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) store2(op + d * 8, o[4 * d] / den_a, o[4 * d + 1] / den_a);
      if (t == 0)
        p.lse[(static_cast<long long>(it.b) * p.Hq + it.h) * p.Sq + row_a] =
            (r.m_a == NEG_INF ? NEG_INF : r.m_a * p.scale) + logf(den_a);
    }
    if (row_b < p.Sq) {
      OT* op = og + ((static_cast<long long>(it.b) * p.Sq + row_b) * p.Hq + it.h) * DH + 2 * t;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
        store2(op + d * 8, o[4 * d + 2] / den_b, o[4 * d + 3] / den_b);
      if (t == 0)
        p.lse[(static_cast<long long>(it.b) * p.Hq + it.h) * p.Sq + row_b] =
            (r.m_b == NEG_INF ? NEG_INF : r.m_b * p.scale) + logf(den_b);
    }
  }
}

// Persistent: one block per SM (at most), walking its items (item_index).
// OT: the output's type, bf16 or f32 (the training residual).
template <typename OT, int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wg_kernel(__grid_constant__ const Params p) {
  using C = Cfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<DH> sm{smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023)};
  const int n_items = (p.Sq + BQ - 1) / BQ * p.Hq * p.B;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(sm.q_full(i), 1);
      mbar_init(sm.q_empty(i), kConsumers * 4);
    }
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.k_empty(s), kConsumers * 4);
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.v_empty(s), kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x / 128 == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 < 32) produce<DH>(p, sm, n_items);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<OT, DH>(p, sm, n_items);
  }
}

template <typename OT, int DH>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v, const long long* st,
                   cudaStream_t stream) {
  using C = Cfg<DH>;
  cudaError_t err = bf16_map(&p.tq, q, p.B, p.Sq, p.Hq, DH, st[0], st[1], st[2], BQ, C::kBox);
  if (err == cudaSuccess) err = bf16_map(&p.tk, k, p.B, p.Skv, p.Hkv, DH, st[3], st[4], st[5], BK, C::kBox);
  if (err == cudaSuccess) err = bf16_map(&p.tv, v, p.B, p.Skv, p.Hkv, DH, st[6], st[7], st[8], BK, C::kBox);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wg_kernel<OT, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_items = (p.Sq + BQ - 1) / BQ * p.Hq * p.B;
  flash_fwd_wg_kernel<OT, DH><<<min(n_items, sms), kThreads, C::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t launch_dh(Params& p, const void* q, const void* k, const void* v, int dh,
                      const long long* st, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<OT, 32>(p, q, k, v, st, stream);
    case 64: return launch<OT, 64>(p, q, k, v, st, stream);
    case 128: return launch<OT, 128>(p, q, k, v, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// q: [B, Sq, Hq, dh], k, v: [B, Skv, Hkv, dh], each with element strides
// (batch, token, head), a contiguous last axis and 16-byte aligned rows;
// q_seg [B, Sq] and kv_seg [B, Skv] int32, both null for one segment; out:
// contiguous [B, Sq, Hq, dh] in q's dtype, or f32 with out_f32 (the
// training residual of bf16 inputs); lse: [B, Hq, Sq] f32.  Returns
// cudaGetLastError() after the launch (or the tensor maps' error).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* q_seg, const void* kv_seg, void* out, void* lse,
                         int B, int Hq, int Hkv, int Sq, int Skv, int dh,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int causal, int is_bf16, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    wg::Params p{};
    p.q_seg = static_cast<const int*>(q_seg);
    p.kv_seg = static_cast<const int*>(kv_seg);
    p.out = out;
    p.lse = static_cast<float*>(lse);
    p.B = B;
    p.Hq = Hq;
    p.Hkv = Hkv;
    p.Sq = Sq;
    p.Skv = Skv;
    p.scale = scale;
    p.causal = causal;
    const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    const cudaError_t err = out_f32 ? wg::launch_dh<float>(p, q, k, v, dh, strides, st)
                                    : wg::launch_dh<__nv_bfloat16>(p, q, k, v, dh, strides, st);
    return static_cast<int>(err);
  }
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
  cudaError_t err;
  switch (dh) {
    case 32: err = launch_f32<32>(p, B, st); break;
    case 64: err = launch_f32<64>(p, B, st); break;
    case 128: err = launch_f32<128>(p, B, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
