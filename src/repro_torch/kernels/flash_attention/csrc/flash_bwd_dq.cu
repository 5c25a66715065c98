// K8, the dq entry point of the segment-aware flash-attention backward
// (flash_bwd.cuh holds the kernel and its design).
//
// Replaces: repro/kernels/flash_attention/flash.py,
// flash_attention_bwd_dq_pallas.

#include "flash_bwd.cuh"

// q [B, Sq, Hq, dh], k, v [B, Skv, Hkv, dh] and dout [B, Sq, Hq, dh], each
// with element strides (batch, token, head) in `strides` (12 values, q k v
// dout) and a contiguous last axis; q_seg [B, Sq] / kv_seg [B, Skv] int32,
// both null for one segment; lse, delta [B, Hq, Sq] f32.  out: contiguous
// [B, Sq, Hq, dh] f32 (the forward's output); writes delta and dq
// (contiguous [B, Sq, Hq, dh], q's dtype).  ranges: with segment ids on
// bf16 inputs, int32 scratch [B, ceil(Skv / 64), 2] for the kv tiles' id
// ranges (a pre-pass launch writes them), else null.  Returns
// cudaGetLastError() after its launches.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* out, const void* lse, void* delta,
                            const void* q_seg, const void* kv_seg, void* ranges, void* dq,
                            int B, int Hq, int Hkv, int Sq, int Skv, int dh,
                            const long long* strides, float scale, int causal, int is_bf16,
                            void* stream) {
  Params p{};
  p.dq = dq;
  return run<0>(p, q, k, v, dout, out, lse, delta, q_seg, kv_seg, ranges, nullptr, 1, B, Hq,
                Hkv, Sq, Skv, dh, strides, scale, causal, is_bf16, stream);
}
