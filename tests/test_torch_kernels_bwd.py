"""The port's plain backward kernels (K2, K3, K5, K6, K8, K9) against the JAX
package's Pallas backward kernels in interpret mode, called directly as
``tests/test_torch_kernels.py`` calls the forward ones, and the port's
autograd wiring (``kernels/*/ops.py``) against autograd through the plain
forward.

Inputs are drawn once with numpy and handed to both sides, together with
the same forward residuals (mu/rstd, lse, delta).  Tolerances are those of
``tests/test_kernels.py`` for the norm gradients (tol x 60, tol = 2e-4 f32
and 6e-2 bf16) and of ``tests/test_flash_segment.py:84`` for the flash
gradients (rel-err 1e-5 f32, 1e-3 bf16, normalised by max(|ref|, 1)).
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
from repro.kernels.fused_adaln.adaln import (  # noqa: E402
    adaln_bwd_dmod_pallas,
    adaln_bwd_dx_pallas,
    adaln_fwd_pallas,
)
from repro.kernels.fused_rmsnorm.rmsnorm import (  # noqa: E402
    rms_bwd_dw_pallas,
    rms_bwd_dx_pallas,
    rms_fwd_pallas,
)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_delta_ref,
    attention_ref,
)
from repro_torch.kernels.fused_adaln.ref import adaln_bwd_dmod_ref, adaln_bwd_dx_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.ref import qk_rms_bwd_ref  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
NORM_GRAD_TOL = {"f32": 2e-4 * 60, "bf16": 6e-2 * 60}
FLASH_GRAD_TOL = {"f32": 1e-5, "bf16": 1e-3}


def _both(a, dt):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a, dtype=jdt), torch.from_numpy(a).to(tdt)


def _t(a):
    """A JAX array as a torch tensor (bf16 through f32, exactly)."""
    a = np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)
    return torch.from_numpy(a.copy())


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j.astype(jnp.float32)) - t.float().numpy())))


def _rel(j, t):
    """tests/test_flash_segment.py's rel-err: L2 of the difference over
    max(L2 of the reference, 1)."""
    a = np.asarray(j.astype(jnp.float32), dtype=np.float64)
    b = t.double().numpy()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1.0))


# -- K2, K3: fused AdaLN backward -------------------------------------------


@pytest.mark.parametrize("shape,seq_block", [((2, 64, 128), 32), ((3, 40, 256), 8)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_adaln_bwd_plain_matches_pallas(shape, seq_block, dt):
    b, s, d = shape
    rng = np.random.default_rng(s + d)
    x_np = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    sc_np = (rng.standard_normal((b, d)) * 0.1).astype(np.float32)
    sh_np = (rng.standard_normal((b, d)) * 0.1).astype(np.float32)
    dy_np = rng.standard_normal(shape).astype(np.float32)
    (xj, xt), (dyj, dyt) = _both(x_np, dt), _both(dy_np, dt)
    scj = jnp.asarray(sc_np)
    _, muj, rj = adaln_fwd_pallas(xj, scj, jnp.asarray(sh_np), eps=1e-6, seq_block=s,
                                  interpret=True)
    mut, rt, sct = _t(muj), _t(rj), torch.from_numpy(sc_np)

    dxj = adaln_bwd_dx_pallas(dyj, xj, muj, rj, scj, seq_block=seq_block, interpret=True)
    dxt = adaln_bwd_dx_ref(dyt, xt, mut, rt, sct)
    assert dxt.dtype == xt.dtype and _err(dxj, dxt) < NORM_GRAD_TOL[dt]

    dscj, dshj = adaln_bwd_dmod_pallas(dyj, xj, muj, rj, d_block=128, seq_block=seq_block,
                                       interpret=True)
    dsct, dsht = adaln_bwd_dmod_ref(dyt, xt, mut, rt)
    assert dsct.dtype == dsht.dtype == torch.float32 and dsct.shape == (b, d)
    assert _err(dscj, dsct) < NORM_GRAD_TOL[dt]
    assert _err(dshj, dsht) < NORM_GRAD_TOL[dt]


# -- K5, K6: joint q/k RMSNorm backward -----------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_qk_rms_bwd_plain_matches_pallas(dt):
    b, s, h, dh = 2, 24, 3, 128
    rng = np.random.default_rng(11)
    qkv = (rng.standard_normal((b, s, 3 * h * dh)) * 1.5).astype(np.float32)
    w = [(1 + 0.1 * rng.standard_normal(dh)).astype(np.float32) for _ in range(2)]
    dys = [rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(2)]
    _, qkv_t = _both(qkv, dt)
    # strided views of the fused projection, as the model hands them over
    xs_t = [qkv_t[..., i * h * dh: (i + 1) * h * dh].reshape(b, s, h, dh) for i in range(2)]
    rows = b * s * h
    got = []
    want_j = []
    for x_t, w_np, dy_np in zip(xs_t, w, dys):
        x2d = jnp.asarray(x_t.float().numpy().reshape(rows, dh), dtype=DTYPES[dt][0])
        dy2d = jnp.asarray(dy_np.reshape(rows, dh), dtype=DTYPES[dt][0])
        _, rj = rms_fwd_pallas(x2d, jnp.asarray(w_np), eps=1e-6, row_block=rows, interpret=True)
        want_j.append((
            rms_bwd_dx_pallas(dy2d, x2d, jnp.asarray(w_np), rj, row_block=48, interpret=True),
            rms_bwd_dw_pallas(dy2d, x2d, rj, d_block=128, row_block=48, interpret=True),
        ))
        got.append(_t(rj).reshape(b, s, h))
    dyq, dyk = (_both(a, dt)[1] for a in dys)
    dq, dk, dwq, dwk = qk_rms_bwd_ref(dyq, dyk, *xs_t, *(torch.from_numpy(a) for a in w), *got)
    for (dxj, dwj), dx_t, dw_t in zip(want_j, (dq, dk), (dwq, dwk)):
        assert dx_t.dtype == DTYPES[dt][1] and dw_t.dtype == torch.float32
        assert _err(dxj, dx_t.reshape(rows, dh)) < NORM_GRAD_TOL[dt]
        assert _err(dwj, dw_t) < NORM_GRAD_TOL[dt]


# -- K8, K9: segment-aware flash attention backward ------------------------------


def _seg(*runs):
    return np.concatenate([np.full(n, i, np.int32) for i, n in runs])


# name: (hq, hkv, sq, skv, q_seg rows per batch, kv_seg rows per batch, causal)
FLASH_CASES = {
    # packed clips with -1 tail padding (padding attends padding)
    "pad": (2, 2, 256, 256,
            [_seg((0, 100), (1, 100), (-1, 56)), _seg((0, 200), (-1, 56))], None, False),
    # cross-attention shape; q rows with id 7 see no key: exact zeros
    "masked_row": (2, 2, 256, 128,
                   [_seg((0, 120), (7, 8), (1, 128))] * 2,
                   [_seg((0, 64), (1, 64))] * 2, False),
    "causal": (2, 2, 256, 256, None, None, True),
    "causal_seg": (2, 2, 256, 256, [_seg((0, 128), (1, 128))] * 2, None, True),
    "gqa": (4, 2, 256, 256, [_seg((0, 64), (1, 192))] * 2, None, False),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_plain_matches_pallas(case, dt):
    hq, hkv, sq, skv, qs, ks, causal = FLASH_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((2, sq, hq, 128), (2, skv, hkv, 128), (2, skv, hkv, 128), (2, sq, hq, 128))]
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (_both(a, dt) for a in arrs)
    qseg = None if qs is None else np.stack(qs)
    kseg = None if qs is None else (qseg if ks is None else np.stack(ks))
    jseg = [None if a is None else jnp.asarray(a) for a in (qseg, kseg)]
    tseg = [None if a is None else torch.from_numpy(a) for a in (qseg, kseg)]
    heads_first = [a.swapaxes(1, 2) for a in (qj, kj, vj, doj)]
    kw = dict(causal=causal, q_block=128, kv_block=128, interpret=True)
    out32, lse = flash_attention_fwd_pallas(*heads_first[:3], *jseg, out_dtype=jnp.float32, **kw)
    delta = jnp.sum(heads_first[3].astype(jnp.float32) * out32, axis=-1)
    scale = 128**-0.5
    dqj = flash_attention_bwd_dq_pallas(*heads_first, lse, delta, *jseg, scale=scale, **kw)
    dkj, dvj = flash_attention_bwd_dkv_pallas(*heads_first, lse, delta, *jseg, scale=scale, **kw)

    delta_t = attention_delta_ref(dot, _t(out32).transpose(1, 2))
    assert _err(delta, delta_t) < 1e-4
    dq, dk, dv = attention_bwd_ref(qt, kt, vt, dot, _t(lse), _t(delta), *tseg,
                                   causal=causal, kv_block=96)
    assert dq.dtype == dk.dtype == dv.dtype == DTYPES[dt][1]
    for name, j, t in (("dq", dqj, dq), ("dk", dkj, dk), ("dv", dvj, dv)):
        err = _rel(j.swapaxes(1, 2), t)
        assert err < FLASH_GRAD_TOL[dt], f"{name} rel err {err}"
    if case == "masked_row":
        # rows that see no key: lse is NEG_INF and every gradient term is 0
        assert torch.all(_t(lse)[:, :, 120:128] < -1e38)
        assert torch.count_nonzero(dq[:, 120:128].float()) == 0


# -- autograd wiring: the Functions against autograd through the plain forward ----


def _grads(fn, inputs, seed=1):
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    sum((o.float() * torch.randn(o.shape, generator=g)).sum() for o in outs).backward()
    return [i.grad for i in ins]


def _close(got, want, tol):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), (a - b).abs().max()


def test_adaln_function_matches_plain_autograd():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((2, 40, 64)) * 2 + 0.3).astype(np.float32))
    mod = torch.from_numpy((rng.standard_normal((2, 6, 64)) * 0.1).astype(np.float32))
    # scale and shift are row slices of the modulation, as in the model
    f = lambda x, m: kernels.adaln_modulate(x, m[:, 1], m[:, 0])  # noqa: E731
    p = lambda x, m: kernels.plain.adaln_modulate(x, m[:, 1], m[:, 0])  # noqa: E731
    _close(_grads(f, [x, mod]), _grads(p, [x, mod]), 1e-5)


def test_qk_norm_function_matches_plain_autograd():
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 10, 3 * 3 * 32)).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal((2, 32))).astype(np.float32))

    def run(op):
        def fn(qkv, w):
            q = qkv[..., :96].reshape(2, 10, 3, 32)
            k = qkv[..., 96:192].reshape(2, 10, 3, 32)
            return op(q, k, w[0], w[1])
        return fn

    _close(_grads(run(kernels.qk_norm), [qkv, w]), _grads(run(kernels.plain.qk_norm), [qkv, w]),
           1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("group", [1, 2])
def test_attention_function_matches_plain_autograd(causal, group):
    rng = np.random.default_rng(2 + group)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((2, 50, 4, 32), (2, 30, 4 // group, 32), (2, 30, 4 // group, 32)))
    # batch 1: the q rows of id 2 see no key
    qs = torch.from_numpy(np.stack([_seg((0, 20), (1, 24), (-1, 6)), _seg((0, 40), (2, 10))]))
    ks = torch.from_numpy(np.stack([_seg((0, 10), (1, 15), (-1, 5)), _seg((0, 30))]))
    kw = dict(causal=causal, q_segment_ids=qs, kv_segment_ids=ks)
    got = _grads(lambda q, k, v: kernels.attention(q, k, v, **kw), [q, k, v])
    _close(got, _grads(lambda q, k, v: kernels.plain.attention(q, k, v, **kw), [q, k, v]), 1e-5)
    assert torch.count_nonzero(got[0][1, 40:]) == 0


def test_attention_function_keeps_f32_residual_and_returns_q_dtype():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 20, 2, 32)).astype(np.float32))
               .bfloat16().requires_grad_() for _ in range(3))
    out = kernels.attention(q, k, v, causal=False)
    assert out.dtype == torch.bfloat16
    want, _ = attention_ref(q.detach(), k.detach(), v.detach())
    assert torch.equal(out.detach(), want)
    out.float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16
