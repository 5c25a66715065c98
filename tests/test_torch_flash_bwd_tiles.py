"""The bf16 flash backward kernels (K8, K9: ``flash_bwd.cuh``, namespace
``wg``) on the CPU, where they cannot run: their tile walk and their
rounding.

- ``bwd_tile_walk`` mirrors each kernel's producer (K8: items of 128 q rows,
  walking kv tiles of 64; K9: items of 128 kv rows, walking for each q head
  of the GQA group the q tiles of 64).  It must visit each live pair of
  ``live_tile_mask`` at those tiles exactly once, for every head, and the
  live pairs must cover every (q, kv) entry the mask lets through.
- ``bf16_bwd_model`` emulates the kernels' arithmetic: bf16 q, k, v and do,
  f32 products and sums, p and ds rounded to bf16 as the A operands of
  their products (and nowhere else), the gradients rounded to bf16 once.
  It must stay within the card's bf16 gate (rel-L2 2e-2, ``chip_smoke.py``
  ``BWD_TOL["flash_bf16"]``) of the JAX package's flash backward in bf16:
  the Pallas kernels in interpret mode at dh 128 (as
  ``tests/test_torch_kernels_bwd.py`` runs them), and autodiff of its plain
  reference at dh 32 and 64, which the Pallas kernels do not take.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.flash import (  # noqa: E402
    flash_attention_bwd_dkv_pallas,
    flash_attention_bwd_dq_pallas,
    flash_attention_fwd_pallas,
)
from repro.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.kernels.flash_attention.flash import (  # noqa: E402
    BWD_TILES,
    DKV_MAX_SPLITS,
    bwd_tile_walk,
    dkv_splits,
    live_tile_mask,
    live_tile_pairs,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_delta_ref,
    attention_ref,
)

FLASH_BF16_GATE = 2e-2  # chip_smoke.py BWD_TOL["flash_bf16"], rel-L2


def _seg(*runs):
    return np.concatenate([np.full(n, i, np.int32) for i, n in runs])


# name: (hq, hkv, sq, skv, q_seg rows per batch, kv_seg rows per batch, causal),
# tests/test_torch_kernels_bwd.py's FLASH_CASES
FLASH_CASES = {
    "pad": (2, 2, 256, 256,
            [_seg((0, 100), (1, 100), (-1, 56)), _seg((0, 200), (-1, 56))], None, False),
    "masked_row": (2, 2, 256, 128,
                   [_seg((0, 120), (7, 8), (1, 128))] * 2,
                   [_seg((0, 64), (1, 64))] * 2, False),
    "causal": (2, 2, 256, 256, None, None, True),
    "causal_seg": (2, 2, 256, 256, [_seg((0, 128), (1, 128))] * 2, None, True),
    "gqa": (4, 2, 256, 256, [_seg((0, 64), (1, 192))] * 2, None, False),
}
# the walk's layouts: FLASH_CASES, and ragged lengths, GQA 4 with the causal
# cut and packed documents with -1 tails, rows that see no key, few rows
WALK_CASES = {
    **FLASH_CASES,
    "ragged_gqa4_causal_packed": (
        8, 2, 300, 300,
        [_seg((0, 70), (1, 130), (-1, 100)), _seg((3, 150), (4, 140), (-1, 10))], None, True),
    "ragged_cross_dead_rows": (
        4, 4, 200, 150,
        [_seg((0, 60), (7, 20), (1, 90), (-1, 30)), _seg((5, 100), (8, 30), (9, 70))],
        [_seg((0, 50), (1, 70), (-1, 30)), _seg((5, 100), (9, 50))], False),
    "short_causal": (4, 1, 40, 40, None, None, True),
    "long_packed_causal": (
        4, 1, 1000, 1000, [_seg((0, 300), (1, 250), (2, 400), (-1, 50))], None, True),
}


def _segs(case):
    _, _, _, _, qs, ks, _ = case
    if qs is None:
        return None, None
    qseg = np.stack(qs)
    return qseg, qseg if ks is None else np.stack(ks)


@pytest.mark.parametrize("which", ["dq", "dkv", "dkv split 3"])
@pytest.mark.parametrize("case", list(WALK_CASES))
def test_bwd_tile_walk_visits_each_live_pair_once(case, which):
    # "dkv split 3": K9 with each item's q sweep shared by 3 blocks
    hq, hkv, sq, skv, _, _, causal = WALK_CASES[case]
    qseg, kseg = _segs(WALK_CASES[case])
    ids = (None, None) if qseg is None else (torch.from_numpy(qseg), torch.from_numpy(kseg))
    batch, splits, which = 2, 3 if which.endswith("3") else 1, which.split()[0]
    walk = bwd_tile_walk(which, sq, skv, hq, hkv, *ids, causal=causal, batch=batch, splits=splits)
    assert len(walk) == len(set(walk)), "a tile pair is visited twice"
    q_tile, kv_tile = BWD_TILES[which]
    live = live_tile_mask(sq, skv, *ids, causal=causal, q_tile=q_tile, kv_tile=kv_tile)
    live = live.expand(batch, -1, -1) if qseg is None else live
    want = {(b, h, i, j) for b, i, j in zip(*map(list, torch.nonzero(live, as_tuple=True)))
            for h in range(hq)}
    assert {(b, h, int(i), int(j)) for b, h, i, j in walk} == {
        (int(b), h, int(i), int(j)) for b, h, i, j in want}
    n = live_tile_pairs(sq, skv, *ids, causal=causal, batch=batch, q_tile=q_tile, kv_tile=kv_tile)
    assert len(walk) == n * hq


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("case", list(WALK_CASES))
def test_bwd_live_pairs_cover_every_visible_entry(case, which):
    # the skip is safe: every (q, kv) entry the mask lets through lies in a
    # live pair of the kernel's tiles
    hq, hkv, sq, skv, _, _, causal = WALK_CASES[case]
    qseg, kseg = _segs(WALK_CASES[case])
    ids = (None, None) if qseg is None else (torch.from_numpy(qseg), torch.from_numpy(kseg))
    q_tile, kv_tile = BWD_TILES[which]
    live = live_tile_mask(sq, skv, *ids, causal=causal, q_tile=q_tile, kv_tile=kv_tile)
    vis = torch.ones((1, sq, skv), dtype=torch.bool)
    if causal:
        vis = vis & torch.ones(sq, skv, dtype=torch.bool).tril()[None]
    if qseg is not None:
        vis = vis & (ids[0][:, :, None] == ids[1][:, None, :])
    rows = torch.arange(sq) // q_tile
    cols = torch.arange(skv) // kv_tile
    covered = live[:, rows][:, :, cols]
    assert not torch.any(vis & ~covered)


def test_dkv_splits_fill_the_card_only_where_items_are_few():
    # the diffusion shapes on 132 SMs: self-attention never splits, the
    # 512 text keys of cross-attention split only at B = 1
    assert dkv_splits(1, 7877, 12, 132) == 1
    assert dkv_splits(1, 512, 12, 132) == 2
    assert dkv_splits(2, 512, 12, 132) == 1
    assert dkv_splits(1, 150, 1, 132) == DKV_MAX_SPLITS


def test_live_tile_pairs_square_tiles_unchanged():
    # tile= keeps its meaning for the callers that pass it
    qseg = torch.from_numpy(np.stack([_seg((0, 70), (1, 130), (-1, 100))] * 2))
    for tile in (64, 128):
        for causal in (False, True):
            assert live_tile_pairs(300, 300, qseg, qseg, causal=causal, tile=tile) == \
                live_tile_pairs(300, 300, qseg, qseg, causal=causal, q_tile=tile, kv_tile=tile)
    assert live_tile_pairs(300, 300, causal=True, batch=3, tile=64) == 3 * 15


def _bf16(x):
    return x.to(torch.bfloat16).float()


def bf16_bwd_model(q, k, v, do, q_seg, kv_seg, *, causal, scale):
    """The bf16 K8/K9 arithmetic on [B, S, H, dh] bf16 inputs: lse and the
    f32 output from the forward in f32 (K7's f32-out residual), delta =
    sum(do * out) in f32, s and dp as f32 sums of bf16 products, p and ds
    in f32, each rounded to bf16 before its product (p^T do; ds k, ds^T q),
    the GQA group summed in f32 on chip; dq, dk, dv rounded to bf16 once."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))  # [B, H, S, dh]
    kr, vr = kf.repeat_interleave(g, dim=1), vf.repeat_interleave(g, dim=1)
    s = qf @ kr.transpose(-1, -2)
    vis = torch.ones((sq, k.shape[1]), dtype=torch.bool)
    if causal:
        vis = vis.tril()
    vis = vis[None, None]
    if q_seg is not None:
        vis = vis & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    out, lse = attention_ref(q, k, v, q_seg, kv_seg, causal=causal, scale=scale,
                             out_dtype=torch.float32)
    delta = attention_delta_ref(do, out)  # [B, Hq, Sq]
    p = torch.where(vis, torch.exp(s * scale - lse[..., None]), torch.zeros(()))
    dp = dof @ vr.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    pb, dsb = _bf16(p), _bf16(ds)
    dq = scale * (dsb @ kr)
    dk = scale * (dsb.transpose(-1, -2) @ qf)
    dv = pb.transpose(-1, -2) @ dof
    dk = dk.reshape(b, hkv, g, -1, dh).sum(2)
    dv = dv.reshape(b, hkv, g, -1, dh).sum(2)
    return tuple(x.transpose(1, 2).to(torch.bfloat16) for x in (dq, dk, dv))


def _rel(a, b):
    a, b = torch.from_numpy(np.array(a, np.float32)), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _jax_bwd(q, k, v, do, qseg, kseg, causal, scale, dh):
    """The JAX package's bf16 flash gradients, heads first: Pallas in
    interpret mode at dh 128, autodiff of the plain reference otherwise."""
    jseg = [None if a is None else jnp.asarray(a) for a in (qseg, kseg)]
    if dh % 128 == 0:
        kw = dict(causal=causal, q_block=128, kv_block=128, interpret=True)
        out32, lse = flash_attention_fwd_pallas(q, k, v, *jseg, out_dtype=jnp.float32, **kw)
        delta = jnp.sum(do.astype(jnp.float32) * out32, axis=-1)
        dq = flash_attention_bwd_dq_pallas(q, k, v, do, lse, delta, *jseg, scale=scale, **kw)
        dk, dv = flash_attention_bwd_dkv_pallas(q, k, v, do, lse, delta, *jseg, scale=scale, **kw)
        return dq, dk, dv
    _, vjp = jax.vjp(lambda a, b_, c: attention_reference(
        a, b_, c, causal=causal, scale=scale, q_segment_ids=jseg[0], kv_segment_ids=jseg[1]),
        q, k, v)
    return vjp(do)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_bf16_rounding_model_within_gate_of_jax(case, dh):
    hq, hkv, sq, skv, _, _, causal = FLASH_CASES[case]
    qseg, kseg = _segs(FLASH_CASES[case])
    rng = np.random.default_rng(len(case) + dh)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((2, sq, hq, dh), (2, skv, hkv, dh), (2, skv, hkv, dh), (2, sq, hq, dh))]
    scale = dh**-0.5
    heads_first = [jnp.asarray(a.swapaxes(1, 2), jnp.bfloat16) for a in arrs]
    want = _jax_bwd(*heads_first, qseg, kseg, causal, scale, dh)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    tseg = [None if a is None else torch.from_numpy(a) for a in (qseg, kseg)]
    got = bf16_bwd_model(q, k, v, do, *tseg, causal=causal, scale=scale)
    # the port's plain backward (the card's yardstick) on the same residuals
    out, lse = attention_ref(q, k, v, *tseg, causal=causal, out_dtype=torch.float32)
    plain = attention_bwd_ref(q, k, v, do, lse, attention_delta_ref(do, out), *tseg,
                              causal=causal)
    for name, j, t, pl in zip(("dq", "dk", "dv"), want, got, plain):
        jt = np.asarray(j.astype(jnp.float32)).swapaxes(1, 2)
        err = _rel(jt, t)
        assert err < FLASH_BF16_GATE, f"{name}: model vs JAX rel-L2 {err}"
        assert _rel(pl.float().numpy(), t) < FLASH_BF16_GATE, name
    if case == "masked_row":
        # rows that see no key: exact zeros in the model as on the card
        assert torch.count_nonzero(got[0][:, 120:128].float()) == 0
