"""The error model of the f32 flash kernels' tensor-core products, on the CPU.

K7, K8 and K9 on f32 inputs (the ring's backward hops, K11) form each
product with ``mma.sync`` in TF32 three times (3xTF32,
``csrc/flash_common.cuh``): every operand x splits into ``hi = rna(x)``
and ``lo = rna(x - hi)``, TF32 values of 10 mantissa bits rounded to
nearest with ties away from zero (what ``cvt.rna.tf32.f32`` computes;
the kernels round with the same integer operations on the bits as
``tf32_rna`` here), and a product accumulates ``a_lo b_hi + a_hi b_lo``,
then ``a_hi b_hi``.  Here that rounding runs on int32 views, the three passes
by f32 matmuls of the parts (a product of two TF32 values is exact in
f32), and the backward's five products (``q k^T``, ``do v^T``, ``p^T
do``, ``ds k``, ``ds^T q``) are formed that way at a small shape with
segment ids and padding (-1).  Three passes meet the f32 ring gate
(rel-L2 1e-5 against the exact f32 ``attention_bwd_ref``, the JAX
package's own f32 flash gate); one pass does not, which is why the
kernels pay for three.

Also: the work bound's tile count stays on 64 x 64 pairs, whatever tile
the bf16 forward runs (``flash.BOUND_TILE``, ``flash.FWD_TILE``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.flash import BOUND_TILE, FWD_TILE, live_tile_pairs
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_delta_ref,
    attention_ref,
)

GATE = 1e-5  # rel-L2 of the f32 gradients (tests/test_flash_segment.py:84)
_SIGN = torch.tensor(-(2**31), dtype=torch.int32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as f32: add half of the dropped 13 bits to the magnitude, then
    clear them."""
    bits = x.contiguous().view(torch.int32)
    mag = (bits & ~_SIGN) + 0x1000
    return ((mag & ~0x1FFF) | (bits & _SIGN)).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    """a @ b in three TF32 passes: the cross terms, then hi hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    """a @ b in one TF32 pass."""
    return tf32_rna(a) @ tf32_rna(b)


def attention_bwd_mm(q, k, v, do, lse, delta, q_seg, kv_seg, mm, *, causal):
    """(dq, dk, dv) of segment-aware attention with every product formed by
    ``mm``: the kernels' recompute (``flash_bwd.cuh``) in [B, H, S, dh]."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g, scale = hq // hkv, dh**-0.5
    qf, dof = q.transpose(1, 2), do.transpose(1, 2)
    kf, vf = (t.transpose(1, 2).repeat_interleave(g, dim=1) for t in (k, v))
    mask = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
    if causal:
        mask = mask & (torch.arange(sq)[:, None] >= torch.arange(skv)[None, :])
    p = torch.where(mask, torch.exp(mm(qf, kf.transpose(-1, -2)) * scale - lse[..., None]), 0.0)
    ds = p * (mm(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = mm(ds, kf) * scale
    dk = (mm(ds.transpose(-1, -2), qf) * scale).unflatten(1, (hkv, g)).sum(2)
    dv = mm(p.transpose(-1, -2), dof).unflatten(1, (hkv, g)).sum(2)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("x, want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),  # a tie: away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-12, 1.0),  # below half: down
    (1.0 + 3 * 2.0**-12, 1.0 + 2.0**-10),  # above half: up
    (3.0, 3.0),  # already TF32
    (0.0, 0.0),
])
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


def test_tf32_split_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):  # both parts are TF32 values
        assert torch.equal(part, tf32_rna(part))
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0**-21
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) > 2.0**-13


@pytest.mark.parametrize("causal", [False, True])
def test_three_tf32_passes_meet_the_f32_gate(causal):
    """The ring backward's five products at 2 heads, dh 64, S 256 with
    segment ids and a -1 tail: 3xTF32 within 1e-5 of exact f32, one pass
    not."""
    rng = np.random.default_rng(16)
    s, h, dh = 256, 2, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, s, h, dh)).astype(np.float32))
                   for _ in range(4))
    seg = torch.from_numpy(np.array([[0] * 90 + [1] * 120 + [-1] * 46], np.int32))
    out, lse = attention_ref(q, k, v, seg, seg, causal=causal, out_dtype=torch.float32)
    delta = attention_delta_ref(do, out)
    want = attention_bwd_ref(q, k, v, do, lse, delta, seg, seg, causal=causal)
    three = attention_bwd_mm(q, k, v, do, lse, delta, seg, seg, mm_3xtf32, causal=causal)
    one = attention_bwd_mm(q, k, v, do, lse, delta, seg, seg, mm_tf32, causal=causal)
    for name, a, b, c in zip(("dq", "dk", "dv"), three, one, want):
        assert _rel(a, c) <= GATE, (name, _rel(a, c))
        assert _rel(b, c) > 10 * GATE, (name, _rel(b, c))


def _brute_pairs(q_seg, kv_seg, tile, causal):
    """(q tile, kv tile) pairs whose id ranges meet, the causal triangle
    aside, counted one by one."""
    n = 0
    sq, skv = len(q_seg), len(kv_seg)
    for i in range(0, sq, tile):
        for j in range(0, skv, tile):
            if causal and i + tile - 1 < j:
                continue
            qa, ka = q_seg[i:i + tile], kv_seg[j:j + tile]
            n += int(min(qa) <= max(ka) and min(ka) <= max(qa))
    return n


@pytest.mark.parametrize("causal", [False, True])
def test_live_tile_pairs_count_64_tiles_after_the_split(causal):
    assert BOUND_TILE == 64 and FWD_TILE == 128
    ids = [0] * 70 + [1] * 200 + [2] * 30 + [-1] * 100  # 400: a ragged last tile
    seg = torch.tensor([ids], dtype=torch.int32)
    assert live_tile_pairs(400, 400, seg, seg, causal=causal) == _brute_pairs(ids, ids, 64, causal)
    assert (live_tile_pairs(400, 400, seg, seg, causal=causal, tile=FWD_TILE)
            == _brute_pairs(ids, ids, 128, causal))
    assert live_tile_pairs(2048, 2048, causal=True) == 32 * 33 // 2
