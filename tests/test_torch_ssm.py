"""The port's Mamba-2 slice against the JAX package on the CPU: the plain
versions of K13 (gated RMSNorm forward), K5 and K6 on model rows and K10
(naive-access AdaLN reduction) against the Pallas kernels in interpret
mode, the autograd wiring of the row and gated norms, and the
``mamba2-smoke`` model (``apply_ssm``, the forward's hidden state,
``lm_loss`` and every gradient) through ``convert.from_jax_params``.

Kernel tolerances are those of ``tests/test_kernels.py`` (2e-4 f32, 6e-2
bf16), per unit of the reference's largest magnitude.  The model is held
to rel-L2 <= 1e-5, the oracle gate of the JAX package's README, leaf by
leaf and over the whole gradient tree; the gradients of ``A_log`` and
``dt_bias`` get 1e-4 per leaf: each is a sum over every (batch, position)
of terms that cancel to about 1e-3 of their size, so f32 rounding alone
moves them by about 1e-5.  In f64 the two models give the same gradients,
and in f32 the reference's own ``A_log`` gradient lies 0.8e-5 to 1.5e-5
from its f64 value (``test_f32_gap_of_the_cancelling_leaves_is_rounding``;
``python tests/test_torch_ssm.py`` prints the readings).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import kernels as jax_kernels  # noqa: E402
from repro.configs import mamba2_2_7b as jax_mamba  # noqa: E402
from repro.kernels.fused_adaln.adaln import (  # noqa: E402
    adaln_bwd_dmod_naive_pallas,
    adaln_fwd_pallas,
)
from repro.kernels.fused_rmsnorm import ops as jax_rms_ops  # noqa: E402
from repro.kernels.fused_rmsnorm.rmsnorm import (  # noqa: E402
    gated_rms_fwd_pallas,
    rms_bwd_dw_pallas,
    rms_bwd_dx_pallas,
    rms_fwd_pallas,
)
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import mamba2_2_7b as torch_mamba  # noqa: E402
from repro_torch.convert import from_jax_params, to_numpy  # noqa: E402
from repro_torch.kernels.fused_adaln.adaln import adaln_bwd_dmod_naive  # noqa: E402
from repro_torch.kernels.fused_adaln.ref import adaln_bwd_dmod_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.ref import (  # noqa: E402
    gated_rms_bwd_ref,
    gated_rms_norm_ref,
    rms_bwd_ref,
)
from repro_torch.kernels.fused_rmsnorm.rmsnorm import (  # noqa: E402
    gated_rms_fwd,
    rms_bwd_dw,
    rms_bwd_dx,
)
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig, lm_layers  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
NORM_TOL = {"f32": 2e-4, "bf16": 6e-2}
GATE = 1e-5
SLOW_LEAVES = {"A_log": 1e-4, "dt_bias": 1e-4}  # cancelling sums (module docstring)


def _np(a):
    """A JAX array or a torch tensor as f64 numpy (bf16 exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), dtype=np.float64)


def _close(got, want, dt):
    """max |got - want| within the dtype's tolerance per unit of max |want|."""
    g, w = _np(got), _np(want)
    assert np.abs(g - w).max() <= NORM_TOL[dt] * max(1.0, np.abs(w).max())


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _rows(rng, n, d, dt, scale=1.5, shift=0.2):
    a = (rng.standard_normal((n, d)) * scale + shift).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# -- K13, K5 and K6 on rows, K10: plain versions against the Pallas kernels --------


@pytest.mark.parametrize("shape", [(64, 128), (128, 256), (16, 512)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gated_rms_fwd_plain_matches_pallas(shape, dt):
    rng = np.random.default_rng(shape[1])
    (xj, xt), (gj, gt) = _rows(rng, *shape, dt), _rows(rng, *shape, dt, scale=2.0, shift=0.0)
    w = (1 + 0.1 * rng.standard_normal(shape[1])).astype(np.float32)
    yj, rj = gated_rms_fwd_pallas(xj, jnp.asarray(w), gj, eps=1e-6, row_block=32, interpret=True)
    yt, rt = gated_rms_norm_ref(xt, torch.from_numpy(w), gt)
    assert yt.dtype == xt.dtype and rt.dtype == torch.float32 and rt.shape == shape[:1]
    _close(yt, yj, dt)
    _close(rt, rj, "f32")


@pytest.mark.parametrize("shape", [(64, 128), (32, 384)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_bwd_rows_plain_matches_pallas(shape, dt):
    rng = np.random.default_rng(shape[1] + 1)
    (xj, xt), (dyj, dyt) = _rows(rng, *shape, dt), _rows(rng, *shape, dt, scale=1.0, shift=0.0)
    w = (1 + 0.1 * rng.standard_normal(shape[1])).astype(np.float32)
    _, rstd = rms_fwd_pallas(xj, jnp.asarray(w), eps=1e-6, row_block=32, interpret=True)
    dxj = rms_bwd_dx_pallas(dyj, xj, jnp.asarray(w), rstd, row_block=32, interpret=True)
    dwj = rms_bwd_dw_pallas(dyj, xj, rstd, d_block=128, row_block=32, interpret=True)
    dxt, dwt = rms_bwd_ref(dyt, xt, torch.from_numpy(w), torch.from_numpy(np.array(rstd)))
    assert dxt.dtype == xt.dtype and dwt.dtype == torch.float32
    _close(dxt, dxj, dt)
    _close(dwt, dwj, dt)


@pytest.mark.parametrize("shape", [(2, 128, 256), (3, 40, 128)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_adaln_dmod_naive_plain_matches_pallas(shape, dt):
    """K10's plain version is K3's: the naive Pallas kernel computes the
    same sums."""
    b, s, d = shape
    rng = np.random.default_rng(s)
    jdt, tdt = DTYPES[dt]
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    zero = jnp.zeros((b, d), jnp.float32)
    _, mu, rstd = adaln_fwd_pallas(jnp.asarray(x, jdt), zero, zero, eps=1e-6, seq_block=8,
                                   interpret=True)
    want = adaln_bwd_dmod_naive_pallas(jnp.asarray(dy, jdt), jnp.asarray(x, jdt), mu, rstd,
                                       interpret=True)
    got = adaln_bwd_dmod_ref(torch.from_numpy(dy).to(tdt), torch.from_numpy(x).to(tdt),
                             torch.from_numpy(np.asarray(mu)), torch.from_numpy(np.array(rstd)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (b, d)
        _close(g, w, "f32")


def test_new_wrappers_take_cuda_tensors_only():
    x, w = torch.zeros(4, 64), torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        gated_rms_fwd(x, w, x)
    with pytest.raises(ValueError, match="CUDA"):
        rms_bwd_dx(x, x, w, torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        rms_bwd_dw(x, x, torch.ones(4))
    x3 = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        adaln_bwd_dmod_naive(x3, x3, torch.zeros(2, 8), torch.ones(2, 8))
    assert all(kernels.launch_counts()[k] == 0 for k in
               ("gated_rms_fwd", "rms_bwd_dx", "rms_bwd_dw", "adaln_bwd_dmod_naive"))


# -- the autograd wiring against the JAX package's custom VJPs -----------------------


def _vjp_case(dt, d=256, n=32, gated=True):
    rng = np.random.default_rng(d + gated)
    x = (rng.standard_normal((2, n // 2, d)) * 1.5 + 0.2).astype(np.float32)
    g = (rng.standard_normal((2, n // 2, d)) * 2).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((2, n // 2, d)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    jx = [jnp.asarray(x, jdt), jnp.asarray(w)] + ([jnp.asarray(g, jdt)] if gated else [])
    tx = [torch.from_numpy(x).to(tdt), torch.from_numpy(w)] + (
        [torch.from_numpy(g).to(tdt)] if gated else [])
    return jx, [t.requires_grad_() for t in tx], dy


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("gated", [False, True])
def test_norm_autograd_matches_the_pallas_vjp(dt, gated):
    """``kernels.rms_norm`` / ``gated_rms_norm`` under autograd on the CPU
    (the ``ops.py`` Functions on the plain versions) against the
    reference's custom VJP on its Pallas kernels in interpret mode.  In
    bf16 the Pallas backward rounds ``dy * silu(g)`` to bf16 and the plain
    one does not: one rounding, inside the bf16 tolerance."""
    jx, tx, dy = _vjp_case(dt, gated=gated)
    jdt, tdt = DTYPES[dt]
    op = jax_rms_ops.gated_rms_norm if gated else jax_rms_ops.rms_norm
    y_j, vjp = jax.vjp(lambda *a: op(*a, interpret=True), *jx)
    grads_j = vjp(jnp.asarray(dy, jdt))
    fn = kernels.gated_rms_norm if gated else kernels.rms_norm
    y_t = fn(*tx)
    grads_t = torch.autograd.grad(y_t, tx, torch.from_numpy(dy).to(tdt))
    _close(y_t, y_j, dt)
    for g_t, g_j, t in zip(grads_t, grads_j, tx):
        assert g_t.dtype == t.dtype and g_t.shape == t.shape
        _close(g_t, g_j, dt)


def test_gated_backward_plain_is_the_ref_backends():
    """``gated_rms_bwd_ref`` against the reference's ``ref`` backend VJP
    (``gated_rms_norm_fused_ref``), in f32."""
    jx, tx, dy = _vjp_case("f32", d=64, n=16)
    _, vjp = jax.vjp(lambda *a: jax_kernels.gated_rms_norm(*a), *jx)
    want = vjp(jnp.asarray(dy))
    x, w, g = (t.detach() for t in tx)
    rstd = gated_rms_norm_ref(x, w, g)[1]
    got = gated_rms_bwd_ref(torch.from_numpy(dy), x, w, g, rstd)
    for a, b in zip(got, want):
        assert _rel(a, b) <= GATE


# -- the mamba2-smoke model -----------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    cfg = torch_mamba.smoke_config()
    params = JT.init_params(jax.random.PRNGKey(0), jax_mamba.smoke_config())
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu"), strict=True
    )
    return cfg, params, model


def test_mamba_configs_match_and_widths():
    for fn in ("config", "smoke_config"):
        ours, ref = getattr(torch_mamba, fn)(), getattr(jax_mamba, fn)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert (ours.d_inner, ours.ssm_heads) == (ref.d_inner, ref.ssm_heads)
    assert (torch_mamba.config().d_inner, torch_mamba.config().ssm_heads) == (5120, 80)


@pytest.mark.parametrize("s", [64, 40])
def test_apply_ssm_matches_jax(mamba, s):
    """S 64 is 4 chunks of 16; S 40 is not a multiple of the chunk, so the
    mixer pads to 48 and slices."""
    cfg, params, model = mamba
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    for layer in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[layer], params["blocks"]["s0"]["mixer"])
        want = JS.apply_ssm(p, jnp.asarray(x), jax_mamba.smoke_config().ssm)
        with torch.no_grad():
            got = TS.apply_ssm(model.blocks[layer].mixer, torch.from_numpy(x), cfg.ssm)
        assert got.shape == x.shape and _rel(got, want) <= GATE


def _tokens(s, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 256, (2, s)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def assert_grads_close(got_tree, want_tree):
    """Every leaf within 1e-5 rel-L2 (``SLOW_LEAVES`` 1e-4), and the whole
    tree within 1e-5."""
    got = dict(_leaves(got_tree))
    want = dict(_leaves(jax.tree.map(np.asarray, want_tree)))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= SLOW_LEAVES.get(k.rsplit(".", 1)[-1], GATE), k
    num = sum(float(((_np(got[k]) - _np(want[k])) ** 2).sum()) for k in want)
    den = sum(float((_np(want[k]) ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= GATE


@pytest.mark.parametrize("s", [64, 40])
def test_forward_loss_and_every_gradient_match_jax(mamba, s):
    cfg, params, model = mamba
    tok, lab = _tokens(s)
    jcfg = jax_mamba.smoke_config()
    h_j, _, _ = JT.forward(params, jcfg, jnp.asarray(tok))
    with torch.no_grad():
        h_t, caches = model(torch.from_numpy(tok))
    assert caches is None and _rel(h_t, h_j) <= GATE
    loss_j, grads_j = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jnp.asarray(tok), jnp.asarray(lab)))(params)
    model.zero_grad(set_to_none=True)
    loss_t = T.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= GATE * abs(float(loss_j))
    assert_grads_close(to_numpy({n: p.grad for n, p in model.named_parameters()}, cfg), grads_j)


def test_loss_and_gradients_match_jax_on_pallas_interpret(mamba):
    """The reference on its Pallas backend (interpret mode): its gated norm
    (d_inner 128) runs K13 and the K5/K6 backward itself."""
    cfg, params, model = mamba
    tok, lab = _tokens(32, seed=1)
    prev = jax_kernels.get_backend()
    jax_kernels.set_backend("pallas_interpret")
    try:
        loss_j, grads_j = jax.value_and_grad(lambda p: JT.lm_loss(
            p, jax_mamba.smoke_config(), jnp.asarray(tok), jnp.asarray(lab)))(params)
    finally:
        jax_kernels.set_backend(prev)
    model.zero_grad(set_to_none=True)
    loss_t = T.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= GATE * abs(float(loss_j))
    assert_grads_close(to_numpy({n: p.grad for n, p in model.named_parameters()}, cfg), grads_j)


def _grads_in(params, tok, lab, f64: bool):
    """Every gradient of the smoke ``lm_loss`` from both models on the same
    (f32-initialised) parameters, as f64 numpy by JAX leaf name: ``{"jax":
    ..., "port": ...}``.  With ``f64`` both run in f64 throughout: the
    parameters are cast up, and each model's casts to f32 (``jnp.float32``,
    ``Tensor.float``) become casts to f64."""
    cfg, jcfg = torch_mamba.smoke_config(), jax_mamba.smoke_config()
    p_np = jax.tree.map(lambda a: np.asarray(a, np.float64 if f64 else np.float32), params)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.float32, p_np), cfg, device="cpu"))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(f64):
        if f64:
            mp.setattr(jnp, "float32", jnp.float64)
            mp.setattr(torch.Tensor, "float", torch.Tensor.double)
            model.double()
        grads_j = jax.grad(lambda p: JT.lm_loss(p, jcfg, jnp.asarray(tok), jnp.asarray(lab)))(
            jax.tree.map(jnp.asarray, p_np))
        model.zero_grad(set_to_none=True)
        T.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab)).backward()
        grads_t = to_numpy({n: p.grad.double() for n, p in model.named_parameters()}, cfg)
    return {side: {k: np.asarray(v, np.float64) for k, v in _leaves(tree) if np.size(v)}
            for side, tree in (("jax", jax.tree.map(np.asarray, grads_j)), ("port", grads_t))}


def test_f32_gap_of_the_cancelling_leaves_is_rounding(mamba):
    """Why ``SLOW_LEAVES`` get 1e-4: in f64 the two models agree on every
    gradient to rounding of f64, so they compute the same function; in f32
    the reference's own ``A_log`` / ``dt_bias`` gradient lies about as far
    from its f64 value as the port's does.  ``python
    tests/test_torch_ssm.py`` prints the readings."""
    _, params, _ = mamba
    tok, lab = _tokens(64)
    g32, g64 = _grads_in(params, tok, lab, False), _grads_in(params, tok, lab, True)
    for k, truth in g64["jax"].items():
        assert _rel(g64["port"][k], truth) <= 1e-11, k
        gate = SLOW_LEAVES.get(k.rsplit(".", 1)[-1], GATE)
        assert _rel(g32["jax"][k], truth) <= gate and _rel(g32["port"][k], truth) <= gate, k


def test_remat_changes_no_gradient(mamba):
    cfg, _, model = mamba
    tok, lab = (torch.from_numpy(a) for a in _tokens(48, seed=2))
    grads = []
    for remat in (True, False):
        model.zero_grad(set_to_none=True)
        T.lm_loss(model, tok, lab, remat=remat).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("n_layers,pattern", [(2, ("ssm",)), (3, ("ssm", "ssm"))])
def test_convert_round_trip_of_the_ssm_tree(n_layers, pattern):
    """Every ``mixer.*`` leaf of the stacked superblocks (and of a tail
    layer when the plan has one) lands in one port parameter and comes
    back, in its dtype (``A_log``, ``dt_bias``, ``D``, ``norm_w`` f32)."""
    jcfg = dataclasses.replace(jax_mamba.smoke_config(), n_layers=n_layers, pattern=pattern,
                               dtype="bfloat16")
    cfg = dataclasses.replace(torch_mamba.smoke_config(), n_layers=n_layers, pattern=pattern,
                              dtype="bfloat16")
    params_np = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(3), jcfg))
    state = from_jax_params(params_np, cfg, device="cpu")
    model = T.Transformer(cfg, device="cpu")
    assert sorted(state) == sorted(model.state_dict())
    for name, p in model.state_dict().items():
        assert state[name].dtype == p.dtype and state[name].shape == p.shape, name
    assert model.blocks[0].mixer.A_log.dtype == torch.float32
    assert model.blocks[0].mixer.in_proj.dtype == torch.bfloat16
    model.load_state_dict(state, strict=True)
    back = to_numpy(dict(model.state_dict()), cfg)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), params_np)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, want)))
    if pattern == ("ssm", "ssm"):  # layer 2 is the plan's tail
        assert np.array_equal(state["blocks.2.mixer.A_log"].numpy(),
                              params_np["tail"][0]["mixer"]["A_log"])


@pytest.mark.parametrize("n_layers,pattern", [(2, ("ssm",)), (3, ("ssm", "ssm"))])
def test_decay_mask_is_the_references_ndim_rule(n_layers, pattern):
    """AdamW decays JAX leaves of ndim >= 2: stacked superblock leaves
    (1-D per layer) decay, tail layers and top-level vectors do not."""
    kw = dict(n_layers=n_layers, pattern=pattern)
    jcfg = dataclasses.replace(jax_mamba.smoke_config(), **kw)
    cfg = dataclasses.replace(torch_mamba.smoke_config(), **kw)
    model = T.Transformer(cfg, device="cpu")
    params_np = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    rule = T.decays(cfg)
    want = to_numpy({n: torch.tensor(float(a.ndim >= 2)) for n, a in
                     _port_named_jax_leaves(params_np, cfg)}, cfg)
    got = to_numpy({n: torch.tensor(float(rule(n, p))) for n, p in model.named_parameters()}, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, got, want)))
    flags = {n: rule(n, p) for n, p in model.named_parameters()}
    assert flags["blocks.0.mixer.A_log"] and flags["blocks.0.norm1.w"]
    assert not flags["final_norm.w"] and flags["embed"]
    if n_layers == 3:
        assert not flags["blocks.2.mixer.A_log"] and flags["blocks.2.mixer.in_proj"]


def _port_named_jax_leaves(params_np, cfg):
    """(port name, JAX leaf) for every leaf of the JAX tree: each stacked
    superblock leaf once per layer, with its stacked ndim."""
    state = from_jax_params(params_np, cfg, device="cpu")
    places = dict(enumerate(lm_layers(cfg)))
    for name in state:
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            where, j = places[int(i)]
            node = params_np[where][j] if where in ("lead", "tail") else params_np["blocks"][where]
            for key in rest.split("."):
                node = node[key]
            yield name, node
        else:
            node = params_np
            for key in name.split("."):
                node = node[key]
            yield name, node


def test_paged_serving_refuses_ssm_blocks_and_the_layer_plan_matches():
    cfg = torch_mamba.smoke_config()
    with pytest.raises(ValueError, match="paged serving"):
        T.init_paged_pools(cfg, 8, 16, device="cpu")
    model = T.Transformer(cfg, device="cpu")
    pools = [{"k": torch.zeros(3, 8, 8, 16), "v": torch.zeros(3, 8, 8, 16)}] * cfg.n_layers
    with pytest.raises(ValueError, match="paged serving"):
        T.paged_prefill(model, torch.zeros(1, 16, dtype=torch.int32),
                        torch.tensor([16], dtype=torch.int32), torch.zeros(1, 2, dtype=torch.int32),
                        pools)
    kw = dict(name="t", family="hybrid", n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
              head_dim=16, d_ff=128, vocab=64, pattern=("ssm", "attn"),
              ssm=torch_mamba.smoke_config().ssm)
    jkw = dict(kw, ssm=jax_mamba.smoke_config().ssm)
    assert ModelConfig(**kw).superblocks() == JaxModelConfig(**jkw).superblocks()
    assert T.Transformer(ModelConfig(**kw), device="cpu").kinds == JaxModelConfig(**jkw).layer_kinds()


if __name__ == "__main__":
    # the readings behind SLOW_LEAVES: rel-L2 of each gradient, port against
    # JAX in f32 and in f64, and each model's f32 gradient against the f64 one
    _params = JT.init_params(jax.random.PRNGKey(0), jax_mamba.smoke_config())
    for _s, _seed in ((64, 0), (40, 0), (32, 1)):
        _tok, _lab = _tokens(_s, seed=_seed)
        _g32, _g64 = (_grads_in(_params, _tok, _lab, f64) for f64 in (False, True))
        print(f"S {_s}, token seed {_seed}: leaf, port-jax f32, port-jax f64, "
              f"jax f32-f64, port f32-f64")
        for _k, _truth in _g64["jax"].items():
            print(f"  {_k:<26} {_rel(_g32['port'][_k], _g32['jax'][_k]):.2e} "
                  f"{_rel(_g64['port'][_k], _truth):.2e} {_rel(_g32['jax'][_k], _truth):.2e} "
                  f"{_rel(_g32['port'][_k], _truth):.2e}")
