"""The port's plain kernel versions against the JAX package's kernels.

Inputs are drawn once with numpy and handed to both sides.  The JAX side
runs the Pallas kernels in interpret mode (the same entry points
``tests/test_kernels.py`` validates) or, for head dims the flash kernel
does not tile, the ``blocked_attention`` oracle.  Tolerances mirror
``tests/test_kernels.py``: 2e-4 (f32) / 6e-2 (bf16) for the norms, 2e-5 /
3e-2 for attention outputs; the f32 statistics (mu, rstd, lse) are held to
2e-4 in both dtypes, since both sides compute them in f32 from the same
rounded inputs.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.flash import flash_attention_fwd_pallas  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro.kernels.fused_adaln.adaln import adaln_fwd_pallas  # noqa: E402
from repro.kernels.fused_rmsnorm.rmsnorm import rms_fwd_pallas  # noqa: E402
from repro.models.attention import blocked_attention  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention.flash import live_tile_pairs  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused_adaln.ref import adaln_modulate_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.ref import qk_norm_ref  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
NORM_TOL = {"f32": 2e-4, "bf16": 6e-2}
ATTN_TOL = {"f32": 2e-5, "bf16": 3e-2}
STAT_TOL = 2e-4


def _both(a, dt):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a, dtype=jdt), torch.from_numpy(a).to(tdt)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j.astype(jnp.float32)) - t.float().numpy())))


# -- K1: fused AdaLN forward -------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 40, 256), (1, 96, 384)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_adaln_plain_matches_pallas(shape, dt):
    b, s, d = shape
    rng = np.random.default_rng(s + d)
    x_np = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    sc_np = (rng.standard_normal((b, d)) * 0.1).astype(np.float32)
    sh_np = (rng.standard_normal((b, d)) * 0.1).astype(np.float32)
    xj, xt = _both(x_np, dt)
    yj, muj, rj = adaln_fwd_pallas(
        xj, jnp.asarray(sc_np), jnp.asarray(sh_np),
        eps=1e-6, seq_block=s, interpret=True,
    )
    yt, mut, rt = adaln_modulate_ref(xt, torch.from_numpy(sc_np), torch.from_numpy(sh_np))
    assert yt.dtype == xt.dtype and mut.shape == rt.shape == (b, s)
    assert _err(yj, yt) < NORM_TOL[dt]
    assert _err(muj, mut) < STAT_TOL
    assert _err(rj, rt) < STAT_TOL


# -- K4: RMSNorm forward as joint QK-norm --------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_qk_norm_plain_matches_pallas(dt):
    b, s, h, dh = 2, 24, 3, 128
    rng = np.random.default_rng(7)
    qkv = (rng.standard_normal((b, s, 3 * h * dh)) * 1.5).astype(np.float32)
    wq = (1 + 0.1 * rng.standard_normal(dh)).astype(np.float32)
    wk = (1 + 0.1 * rng.standard_normal(dh)).astype(np.float32)
    _, qkv_t = _both(qkv, dt)
    # strided views of the fused projection, as the model hands them over
    q = qkv_t[..., : h * dh].reshape(b, s, h, dh)
    k = qkv_t[..., h * dh : 2 * h * dh].reshape(b, s, h, dh)
    yq, yk, rq, rk = qk_norm_ref(q, k, torch.from_numpy(wq), torch.from_numpy(wk))
    for x_t, w, y_t, r_t in ((q, wq, yq, rq), (k, wk, yk, rk)):
        x2d = jnp.asarray(x_t.float().numpy().reshape(-1, dh), dtype=DTYPES[dt][0])
        yj, rj = rms_fwd_pallas(x2d, jnp.asarray(w), eps=1e-6, row_block=x2d.shape[0],
                                interpret=True)
        assert _err(yj, y_t.reshape(-1, dh)) < NORM_TOL[dt]
        assert _err(rj, r_t.reshape(-1)) < STAT_TOL
    # the dispatch layer takes the plain path for CPU tensors
    dq, dk = kernels.qk_norm(q, k, torch.from_numpy(wq), torch.from_numpy(wk))
    assert torch.equal(dq, yq) and torch.equal(dk, yk)


# -- K7: segment-aware flash attention forward --------------------------------


def _seg(*runs):
    return np.concatenate([np.full(n, i, np.int32) for i, n in runs])


# name: (hq, hkv, sq, skv, q_seg rows per batch, kv_seg rows per batch, causal)
FLASH_CASES = {
    # packed clips with -1 tail padding (padding attends padding)
    "pad": (2, 2, 256, 256,
            [_seg((0, 100), (1, 100), (-1, 56)), _seg((0, 200), (-1, 56))],
            None, False),
    # cross-attention shape; q rows with id 7 see no key: exact zeros
    "masked_row": (2, 2, 256, 128,
                   [_seg((0, 120), (7, 8), (1, 128))] * 2,
                   [_seg((0, 64), (1, 64))] * 2, False),
    "causal": (2, 2, 256, 256, None, None, True),
    "causal_seg": (2, 2, 256, 256, [_seg((0, 128), (1, 128))] * 2, None, True),
    "gqa": (4, 2, 256, 256, [_seg((0, 64), (1, 192))] * 2, None, False),
}


def _attn_inputs(hq, hkv, sq, skv, dh, dt, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, hq, dh)).astype(np.float32)
    k = rng.standard_normal((2, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, skv, hkv, dh)).astype(np.float32)
    return [_both(a, dt) for a in (q, k, v)]


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_plain_matches_flash_pallas(case, dt):
    hq, hkv, sq, skv, qs, ks, causal = FLASH_CASES[case]
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(hq, hkv, sq, skv, 128, dt, len(case))
    qseg = None if qs is None else np.stack(qs)
    kseg = None if qs is None else (qseg if ks is None else np.stack(ks))
    out_j, lse_j = flash_attention_fwd_pallas(
        qj.swapaxes(1, 2), kj.swapaxes(1, 2), vj.swapaxes(1, 2),
        None if qseg is None else jnp.asarray(qseg),
        None if kseg is None else jnp.asarray(kseg),
        causal=causal, q_block=128, kv_block=128, interpret=True,
    )
    tq = None if qseg is None else torch.from_numpy(qseg)
    tk = None if kseg is None else torch.from_numpy(kseg)
    out_t, lse_t = attention_ref(qt, kt, vt, tq, tk, causal=causal)
    assert out_t.shape == (2, sq, hq, 128) and lse_t.shape == (2, hq, sq)
    assert _err(out_j.swapaxes(1, 2), out_t) < ATTN_TOL[dt]
    assert _err(lse_j, lse_t) < STAT_TOL
    if case == "masked_row":
        dead = out_t[:, 120:128].float()
        assert torch.count_nonzero(dead) == 0 and torch.all(lse_t[:, :, 120:128] < -1e38)


# ragged lengths through the JAX wrapper, which pads to its tile grid
RAGGED_CASES = {
    "causal": (200, 200, None, None, True),
    "cross_seg": (200, 72, _seg((0, 120), (1, 80)), _seg((0, 40), (1, 32)), False),
}


@pytest.mark.parametrize("case", list(RAGGED_CASES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_plain_matches_flash_ops_ragged(case, dt):
    sq, skv, qs, ks, causal = RAGGED_CASES[case]
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(2, 2, sq, skv, 128, dt, sq + skv)
    qseg = None if qs is None else np.stack([qs, qs])
    kseg = None if ks is None else np.stack([ks, ks])
    out_j = flash_attention(
        qj.swapaxes(1, 2), kj.swapaxes(1, 2), vj.swapaxes(1, 2),
        None if qseg is None else jnp.asarray(qseg),
        None if kseg is None else jnp.asarray(kseg),
        causal=causal, interpret=True,
    )
    out_t = kernels.attention(
        qt, kt, vt, causal=causal,
        q_segment_ids=None if qseg is None else torch.from_numpy(qseg),
        kv_segment_ids=None if kseg is None else torch.from_numpy(kseg),
    )
    assert _err(out_j.swapaxes(1, 2), out_t) < ATTN_TOL[dt]


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_plain_matches_blocked_attention(dh, causal):
    """Head dims the JAX flash kernel does not tile (smoke config, example)."""
    sq = skv = 50
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(3, 3, sq, skv, dh, "f32", dh)
    seg = np.stack([_seg((0, 20), (1, 24), (-1, 6)), _seg((0, 50))])
    out_j = blocked_attention(
        qj, kj, vj, causal=causal, kv_block=16,
        q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
    )
    out_t, _ = attention_ref(qt, kt, vt, torch.from_numpy(seg), torch.from_numpy(seg),
                             causal=causal, kv_block=16)
    assert _err(out_j, out_t) < ATTN_TOL["f32"]


def test_live_tile_pairs_follow_segments():
    """Packed windows skip cross-segment tiles; causal skips the upper
    triangle; padding tiles attend each other."""
    s = 256  # 4 tiles of 64
    seg = torch.from_numpy(np.stack([_seg((0, 128), (1, 128)), _seg((0, 64), (-1, 192))]))
    # batch 0: two 2x2 diagonal blocks; batch 1: tile 0 alone + a 3x3 pad block
    assert live_tile_pairs(s, s, seg, seg) == 8 + 10
    assert live_tile_pairs(s, s, causal=True, batch=2) == 2 * 10
    assert live_tile_pairs(s, 100, batch=3) == 3 * 4 * 2
