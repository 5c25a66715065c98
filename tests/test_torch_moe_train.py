"""Training the routed-MoE models (the ``"moe"`` block kind) in the port
against the JAX package, on the CPU in f32 at the smoke sizes of
Llama-4-Scout (``llama4-smoke``: 2 MoE layers, 4 experts, top-1, a shared
expert) and Kimi-K2 (``kimi-smoke``: a dense lead layer and 2 MoE layers,
8 experts, top-2, a shared expert, bf16 AdamW moments):

* the decay mask with Kimi's unstacked lead layer;
* the forward's hidden states and summed router loss, ``lm_loss`` (the
  router loss weighted in) and every gradient of both models;
* 3 ``Trainer`` steps of each against the reference's train step: the
  losses, the parameters and both moments (Kimi's in bf16, with the same
  steps in f64 as the evidence for their gate); the train launcher's
  route.

The configurations, the layer and serving are ``tests/test_torch_moe.py``.
The parameters are drawn by the port and carried to JAX with
``convert.to_numpy``.  Every comparison is rel-L2 <= 1e-5 unless stated.
"""

import concurrent.futures
import copy
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import to_numpy  # noqa: E402
from repro_torch.core import bucketing  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as T_attention  # noqa: E402
from repro_torch.models import layers as T_layers  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.engine import EmulatedEngine  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402

GATE = 1e-5
ARCHS = {"llama4": "llama4-scout-17b-a16e", "kimi": "kimi-k2-1t-a32b"}
# Kimi's AdamW moments are stored in bf16: f32 values a few 1e-7 apart
# round to neighbouring bf16 values (one step, 2^-8 of the value) in a
# share s of the elements, which gives a tree rel-L2 about 2^-8 sqrt(s)
# (read: s under 1%, 3.9e-4 at most); a leaf of 64 values reads up to
# 1.2e-3 with one or two elements a step apart.  So the leaves are held to
# 2^-8 (every element one step apart) and the whole tree to 1e-3 (s up to
# 6.5%), and the same three steps in f64 agree in these moments to
# F64_GATE (test_bf16_moments_agree_in_f64).
BF16_LEAF_GATE, BF16_TREE_GATE = 2.0**-8, 1e-3
F64_GATE = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

def _rel(got, want) -> float:
    got = np.asarray(got.detach().double().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif isinstance(v, list):
            for i, item in enumerate(v):
                yield from _leaves(item, f"{prefix}{k}.{i}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)

def _assert_trees_close(port_tree, jax_tree, gate=GATE):
    want, got = dict(_leaves(jax_tree)), dict(_leaves(port_tree))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= gate, (k, _rel(got[k], want[k]))

@pytest.fixture(scope="module")
def models():
    """Each smoke model drawn from seed 0 by the port, and its parameters as
    the JAX tree."""
    out = {}
    for key, arch in ARCHS.items():
        cfg, jcfg = registry.get_smoke_config(arch), jax_registry.get_smoke_config(arch)
        model = T.Transformer(cfg, seed=0, device="cpu")
        params = jax.tree.map(jnp.asarray, to_numpy(dict(model.state_dict()), cfg))
        out[key] = (jcfg, cfg, params, model)
    return out


def _tokens(cfg, b, s, seed):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def test_decay_mask_keeps_the_lead_layer_unstacked(models):
    """AdamW decays JAX leaves of ndim >= 2: Kimi's lead layer is unstacked,
    so its norms do not decay while the stacked MoE layers' do."""
    jcfg, cfg, params, model = models["kimi"]
    want = jax.tree.map(lambda a: np.float32(a.ndim >= 2), params)
    rule = T.decays(cfg)
    got = to_numpy({n: torch.tensor(float(rule(n, p))) for n, p in model.named_parameters()},
                   cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(np.all(a == b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    flags = {n: rule(n, p) for n, p in model.named_parameters()}
    assert not flags["blocks.0.norm1.w"] and flags["blocks.1.norm1.w"]
    assert flags["blocks.2.moe.router"] and flags["blocks.0.mlp.w1"]


# -- the JAX side, compiled once -----------------------------------------------------------


def _grad_fn(jcfg):
    def grad(p, tok, lab):
        h, aux, _ = JT.forward(p, jcfg, tok, remat=False)
        loss, g = jax.value_and_grad(lambda q: JT.lm_loss(q, jcfg, tok, lab))(p)
        return h, aux, loss, g

    return grad


def _train_opt(key, state_dtype=None):
    """The 3-step tests' AdamW (a constant lr), with the arch's state dtype."""
    base = registry.get_optimizer(ARCHS[key])
    return adamw.OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=3,
                                 state_dtype=state_dtype or base.state_dtype)


@pytest.fixture(scope="module")
def jfns(models):
    """The JAX functions the tests share, jitted once a model and compiled
    together on threads before the first test (a compile costs seconds):
    the forward's hidden states and router loss with ``lm_loss`` and its
    gradient (2 rows of 32 tokens), and AdamW's update."""
    out, calls = {}, []
    for key, (jcfg, cfg, params, _) in models.items():
        jopt = jax_adamw.OptimizerConfig(**dataclasses.asdict(_train_opt(key)))
        f = out[key] = dict(
            grad=jax.jit(_grad_fn(jcfg)),
            update=jax.jit(lambda p, g, o, step, jopt=jopt: jax_adamw.adamw_update(
                p, g, o, step, jopt)))
        tok = np.zeros((2, 32), np.int32)
        calls += [(f["grad"], (params, tok, tok)),
                  (f["update"], (params, params, jax_adamw.init_opt_state(params, jopt),
                                 jnp.int32(0)))]
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        for done in [pool.submit(fn, *args) for fn, args in calls]:
            jax.block_until_ready(done.result())
    return out


# -- training -----------------------------------------------------------------------------


@pytest.mark.parametrize("key", ARCHS)
def test_forward_loss_and_every_gradient_match_jax(models, jfns, key):
    """The hidden states and the summed router loss of the forward, then
    ``lm_loss`` (the router loss weighted in) and every gradient."""
    jcfg, cfg, params, model = models[key]
    tok, lab = _tokens(cfg, 2, 32, 7)
    jh, jaux, jloss, jgrads = jfns[key]["grad"](params, tok, lab)
    with torch.no_grad():
        h, aux, _ = model(torch.from_numpy(tok), return_aux=True)
    assert _rel(h, jh) <= GATE and _rel(aux, jaux) <= GATE
    assert float(aux) > 0.9  # E sum_e f_e P_e is about 1 a layer for near-uniform routing
    model.zero_grad(set_to_none=True)
    loss = T.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= GATE * abs(float(jloss))
    _assert_trees_close(to_numpy({n: p.grad for n, p in model.named_parameters()}, cfg), jgrads)


def _three_steps(models, key, grad, update, opt, dtype=torch.float32):
    """3 ``Trainer`` steps on ``EmulatedEngine`` and 3 of the reference's
    train step (``make_train_step``'s ``value_and_grad`` of ``lm_loss``, then
    ``adamw_update``, here the two jitted ``grad`` and ``update``) from the
    same state.  Returns ``{"jax": ..., "port": ...}``: the losses, and the
    parameters and both moments as f64 numpy by JAX leaf name."""
    jcfg, cfg, params, _ = models[key]
    batches = [dict(zip(("tokens", "labels"), _tokens(cfg, 2, 32, 20 + i))) for i in range(3)]
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    jstate, jlosses = jax_adamw.init_opt_state(jparams, jax_adamw.OptimizerConfig(
        **dataclasses.asdict(opt))), []
    for i, b in enumerate(batches):
        loss, grads = grad(jparams, b["tokens"], b["labels"])[2:]
        jparams, jstate, _ = update(jparams, grads, jstate, jnp.int32(i))
        jlosses.append(float(loss))

    model = copy.deepcopy(models[key][3]).to(dtype)  # drawn before any f64 patch
    state = {"model": model, "step": 0,
             "opt": adamw.init_opt_state(dict(model.named_parameters()), opt)}
    bucket = bucketing.Bucket(bucketing.DataShape(1, 16, 16), 2)
    stream = iter([[(bucket, {k: torch.from_numpy(v) for k, v in b.items()})] for b in batches])
    state, hist = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt)).run(
        state, stream, 3, rng=5, log_every=0)
    assert state["step"] == 3
    assert {t.dtype for t in state["opt"]["m"].values()} == {getattr(torch, opt.state_dtype)}
    flat = lambda tree: {k: np.asarray(v, np.float64) for k, v in _leaves(tree)}  # noqa: E731
    port = [to_numpy({n: t.double() for n, t in tree.items()}, cfg) for tree in (
        dict(model.named_parameters()), state["opt"]["m"], state["opt"]["v"])]
    return {"jax": (jlosses, *map(flat, (jparams, jstate["m"], jstate["v"]))),
            "port": (list(hist.losses), *map(flat, port))}


def _assert_flat_close(got: dict, want: dict, gate: float, tree_gate: float | None = None):
    """Leaf by leaf at ``gate`` and over the whole tree at ``tree_gate``
    (``gate`` if not given)."""
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= gate, (k, _rel(got[k], want[k]))
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= (tree_gate or gate), (num / den) ** 0.5


@pytest.mark.parametrize("key", ARCHS)
def test_trainer_three_steps_match_jax(models, jfns, key):
    """The losses and the parameters at 1e-5, leaf by leaf and over the
    tree; the moments at 1e-5 in f32 (Llama-4), at ``BF16_LEAF_GATE`` and
    ``BF16_TREE_GATE`` in bf16 (Kimi: the stored moments are bf16
    roundings)."""
    run = _three_steps(models, key, jfns[key]["grad"], jfns[key]["update"], _train_opt(key))
    (jlosses, jp, jm, jv), (losses, p, m, v) = run["jax"], run["port"]
    np.testing.assert_allclose(losses, jlosses, rtol=GATE)
    _assert_flat_close(p, jp, GATE)
    gates = ((BF16_LEAF_GATE, BF16_TREE_GATE) if _train_opt(key).state_dtype == "bfloat16"
             else (GATE, GATE))
    _assert_flat_close(m, jm, *gates)
    _assert_flat_close(v, jv, *gates)


class _TorchF64:
    """``torch`` with ``float32`` meaning f64, for the modules of the port
    that name the dtype; ``torch`` itself stays as it is."""

    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def _f64(mp):
    """Both packages in f64: JAX's casts to f32 and the port's (``float()``,
    ``torch.float32`` in the modules on the MoE models' path, the plain
    attention's state and its autograd residual included) become casts to
    f64."""
    mp.setattr(jnp, "float32", jnp.float64)
    mp.setattr(torch.Tensor, "float", torch.Tensor.double)
    for mod in (M, T, T_layers, T_attention, flash_ops, flash_ref):
        mp.setattr(mod, "torch", _TorchF64())


def test_bf16_moments_agree_in_f64(models):
    """Kimi's 3 steps with both packages in f64 and the moments stored in
    bf16: the losses, the parameters and both moments at ``F64_GATE``, so
    the bf16 moments' gap in f32 is the rounding of f32 values that agree
    (a bf16 moment rounded from f64 values that agree to 1e-15 lands on the
    same bf16 value)."""
    jcfg = models["kimi"][0]
    opt = _train_opt("kimi")
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        _f64(mp)
        jopt = jax_adamw.OptimizerConfig(**dataclasses.asdict(opt))
        run = _three_steps(
            models, "kimi", jax.jit(_grad_fn(jcfg)),
            jax.jit(lambda p, g, o, step: jax_adamw.adamw_update(p, g, o, step, jopt)), opt,
            torch.float64)
    (jlosses, jp, jm, jv), (losses, p, m, v) = run["jax"], run["port"]
    np.testing.assert_allclose(losses, jlosses, rtol=F64_GATE)
    for got, want in ((p, jp), (m, jm), (v, jv)):
        _assert_flat_close(got, want, F64_GATE)


@pytest.mark.parametrize("key", ARCHS)
def test_train_launcher_routes_the_moe_smoke_models_on_cpu(key, capsys):
    hist = launch_train.main(["--arch", ARCHS[key], "--smoke", "--device", "cpu", "--batch",
                              "2", "--seq", "32", "--steps", "2"])
    assert hist.tokens == [64, 64] and np.isfinite(hist.losses).all()
    assert "final loss" in capsys.readouterr().out
