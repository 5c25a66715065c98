// K9, the dk, dv entry point of the segment-aware flash-attention backward
// (flash_bwd.cuh holds the kernel and its design).
//
// Replaces: repro/kernels/flash_attention/flash.py,
// flash_attention_bwd_dkv_pallas.

#include "flash_bwd.cuh"

// Arguments as flash_bwd_dq's (flash_bwd_dq.cu), without out and dq.
// Reads delta (K8's); writes dk, dv (contiguous [B, Skv, Hkv, dh]).
// ranges: as K8's, for the q tiles ([B, ceil(Sq / 64), 2]).  On bf16
// inputs `splits` blocks share each item's q sweep; with splits > 1,
// part is f32 scratch [2, splits, B, Skv, Hkv, dh] for their sums, which a
// second launch adds in a fixed order (f32 inputs: splits 1, part null).
// Returns cudaGetLastError() after its launches.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta,
                             const void* q_seg, const void* kv_seg, void* ranges, void* dk,
                             void* dv, void* part, int splits, int B, int Hq, int Hkv, int Sq, int Skv, int dh,
                             const long long* strides, float scale, int causal, int is_bf16,
                             void* stream) {
  Params p{};
  p.dk = dk;
  p.dv = dv;
  return run<1>(p, q, k, v, dout, nullptr, lse, const_cast<void*>(delta), q_seg, kv_seg, ranges,
                part, splits, B, Hq, Hkv, Sq, Skv, dh, strides, scale, causal, is_bf16, stream);
}
