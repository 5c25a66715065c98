"""Llama-3.2-Vision-90B (the ``"vlm"`` family: 4 ``"attn"`` blocks and one
``"cross"`` block a superblock) in the port against the JAX package, on
the CPU in f32 at the smoke size (``llama3.2-vision-smoke``: one
superblock, d 64, 4 heads over 2 of 16, 16 image tokens):

* the configurations, the full model's parameter count and decode-cache
  shapes (abstract / on the meta device); ``make_lm_batch``'s ``memory``;
* the decay mask (the cross layer's scalar ``gate`` does not decay) and
  the convert round trip of the gate;
* the forward with ``memory``, ``lm_loss`` and every gradient (``wq``,
  ``wkv``, ``wo`` and ``gate`` included), and 3 ``Trainer`` steps against
  the reference's train step (losses, parameters, both moments; the same
  steps with both packages in f64);
* at the init gate of 0: the cross projections' gradients exactly zero in
  both packages, and the gate's gradient in agreement;
* contiguous ``prefill(memory=)`` (the cross caches included) and 4
  decode steps; the train launcher's route;
* the refusals: paged serving (also through the serve launcher),
  sequence parallelism, a cross layer without memory, f32 memory given to
  a bf16 model.

The zero gate of init hides the cross path (``tanh(0) = 0``: its output
and the gradients of ``wq``, ``wkv`` and ``wo`` are exactly zero), so
every parity test but the zero-gate one sets the gate to 0.5 in the port
before carrying the parameters to JAX, and draws the memory from a seed.
Every comparison is rel-L2 <= 1e-5 but the one stated exception (the
trainer's moments in f32, with both packages agreeing in f64).
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
from repro.core.cost_model import CostModel as JaxCostModel  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import caches_to_numpy, from_jax_params, to_numpy  # noqa: E402
from repro_torch.core import bucketing  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.data.synthetic import make_lm_batch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ring import LocalRing  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as T_attention  # noqa: E402
from repro_torch.models import layers as T_layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.engine import EmulatedEngine  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402

GATE = 1e-5
MOMENT_GATE = 4e-5  # both moments after three AdamW steps in f32 (the trainer test)
F64_GATE = 1e-10  # both packages in f64
ARCH = "llama-3.2-vision-90b"
OPT = dict(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=3)
CROSS = 4  # the smoke model's cross layer (blocks.s4)
B, S = 2, 32  # the training batches


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


def _as_jax(model, cfg):
    return jax.tree.map(jnp.asarray, to_numpy(dict(model.state_dict()), cfg))


@pytest.fixture(scope="module")
def vlm():
    """The smoke model drawn from seed 0 by the port with its cross layer's
    gate set to 0.5, and its parameters as the JAX tree; the model at its
    init gate of 0 and its tree."""
    cfg, jcfg = registry.get_smoke_config(ARCH), jax_registry.get_smoke_config(ARCH)
    model0 = T.Transformer(cfg, seed=0, device="cpu")
    model = copy.deepcopy(model0)
    with torch.no_grad():
        model.blocks[CROSS].attn.gate.fill_(0.5)
    return dict(jcfg=jcfg, cfg=cfg, model=model, params=_as_jax(model, cfg), model0=model0,
                params0=_as_jax(model0, cfg))


def _batch(cfg, b, s, seed):
    """Tokens, labels and memory [b, n_image_tokens, d] (N(0, 1), f32) from
    ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    mem = rng.standard_normal((b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1), "memory": mem}


# -- configuration ----------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["config", "smoke_config"])
def test_configs_match(fn):
    get = registry.get_config if fn == "config" else registry.get_smoke_config
    jget = jax_registry.get_config if fn == "config" else jax_registry.get_smoke_config
    assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    assert get(ARCH).superblocks() == jget(ARCH).superblocks()
    opt, jopt = registry.get_optimizer(ARCH), jax_registry.get_optimizer(ARCH)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
    assert "vlm" in steps.TRAINED and "cross" in T.KINDS
    assert "cross" not in T.PAGED_KINDS and "cross" not in T.SP_KINDS


def test_full_model_sizes():
    """86,616,113,152 parameters by the reference's ``param_count()``; the
    tree holds the final norm's d and the 20 gates besides.  A superblock
    holds 4,278,272,001 values (its gate included) and the embedding
    1,050,673,152.  The decode caches' shapes (meta device) are the
    reference's: a cross layer's k and v hold the 4096 image tokens."""
    jcfg, cfg = jax_registry.get_config(ARCH), registry.get_config(ARCH)
    assert jcfg.param_count() == 86_616_113_152
    tree = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    assert sum(a.size for a in jax.tree.leaves(tree)) == 86_616_113_152 + 8192 + 20
    assert sum(a.size for a in jax.tree.leaves(tree["blocks"])) // 20 == 4_278_272_001
    assert tree["embed"].size == 1_050_673_152
    assert tree["blocks"]["s4"]["attn"]["gate"].shape == (20,)
    caches = T.init_cache(cfg, 2, 8, device="meta")
    want = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 8))
    assert len(caches) == cfg.n_layers == 100
    for c, (where, j) in zip(caches, T.lm_layers(cfg)):
        for name, t in c.items():
            assert want["blocks"][where][name].shape[1:] == tuple(t.shape)
    assert tuple(caches[CROSS]["k"].shape) == (2, 4096, 8, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_lm_batch_draws_the_memory(dtype):
    """``memory`` [B, n_image_tokens, d] in the config's dtype, N(0, 1),
    drawn after the tokens (which equal a text model's draw)."""
    cfg = dataclasses.replace(registry.get_smoke_config(ARCH), dtype=dtype)
    b = make_lm_batch(3, 2, 32, cfg.vocab, cfg, "cpu")
    text = make_lm_batch(3, 2, 32, cfg.vocab, dataclasses.replace(cfg, family="dense"), "cpu")
    assert set(text) == {"tokens", "labels"}
    assert torch.equal(b["tokens"], text["tokens"]) and torch.equal(b["labels"], text["labels"])
    mem = b["memory"]
    assert mem.shape == (2, cfg.n_image_tokens, cfg.d_model) and mem.dtype == getattr(torch, dtype)
    assert abs(float(mem.float().mean())) < 0.1 and abs(float(mem.float().std()) - 1) < 0.1


def test_decay_mask_and_the_gate_round_trip(vlm):
    """AdamW decays JAX leaves of ndim >= 2: the gate, stacked to [n_rep]
    in JAX and 0-d a layer in the port, does not decay in either layout;
    ``convert`` carries it both ways."""
    cfg, model, params = vlm["cfg"], vlm["model"], vlm["params"]
    want = jax.tree.map(lambda a: np.float32(a.ndim >= 2), params)
    rule = T.decays(cfg)
    got = to_numpy({n: torch.tensor(float(rule(n, p))) for n, p in model.named_parameters()},
                   cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(np.all(a == b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    gate = f"blocks.{CROSS}.attn.gate"
    assert not rule(gate, dict(model.named_parameters())[gate])
    assert params["blocks"]["s4"]["attn"]["gate"].shape == (1,)
    assert float(params["blocks"]["s4"]["attn"]["gate"][0]) == 0.5
    assert set(params["blocks"]["s4"]["attn"]) == {"wq", "wkv", "wo", "gate"}
    back = from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    assert back[gate].shape == () and back[gate].dtype == torch.float32
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name


# -- the JAX side, compiled once -----------------------------------------------------------


@pytest.fixture(scope="module")
def jfns(vlm):
    """The JAX functions the tests share, jitted once and compiled together
    on threads before the first test: the forward's hidden states with
    ``lm_loss`` and its gradient (2 rows of 32 tokens over 16 image
    tokens), AdamW's update, the contiguous prefill (caches of 16) and
    decode step."""
    jcfg, params = vlm["jcfg"], vlm["params"]
    jopt = jax_adamw.OptimizerConfig(**OPT)

    def grad(p, tok, lab, mem):
        h, _, _ = JT.forward(p, jcfg, tok, memory=mem, remat=False)
        loss, g = jax.value_and_grad(lambda q: JT.lm_loss(q, jcfg, tok, lab, memory=mem))(p)
        return h, loss, g

    f = dict(grad=jax.jit(grad),
             update=jax.jit(lambda p, g, o, step: jax_adamw.adamw_update(p, g, o, step, jopt)),
             prefill=jax.jit(jax_steps.make_prefill_step(jcfg, cache_cap=16)),
             decode=jax.jit(jax_steps.make_decode_step(jcfg)))
    cfg = vlm["cfg"]
    i32 = lambda *shape: np.zeros(shape, np.int32)  # noqa: E731
    mem = lambda b: np.zeros((b, cfg.n_image_tokens, cfg.d_model), np.float32)  # noqa: E731
    caches = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jax.eval_shape(
        f["prefill"], params, i32(2, 11), mem(2))[1])
    calls = [(f["grad"], (params, i32(B, S), i32(B, S), mem(B))),
             (f["update"], (params, params, jax_adamw.init_opt_state(params, jopt),
                            jnp.int32(0))),
             (f["prefill"], (params, i32(2, 11), mem(2))),
             (f["decode"], (params, caches, i32(2, 1), 11))]
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        for done in [pool.submit(fn, *args) for fn, args in calls]:
            jax.block_until_ready(done.result())
    return f


def _port_grads(model, cfg, batch):
    model.zero_grad(set_to_none=True)
    loss = T.lm_loss(model, *(torch.from_numpy(batch[k]) for k in ("tokens", "labels")),
                     memory=torch.from_numpy(batch["memory"]))
    loss.backward()
    return loss.item(), to_numpy({n: p.grad for n, p in model.named_parameters()}, cfg)


# -- training -----------------------------------------------------------------------------


def test_forward_loss_and_every_gradient_match_jax(vlm, jfns):
    """Gate 0.5, memory from a seed: the hidden states, ``lm_loss`` and
    every gradient, the cross layer's ``wq``, ``wkv``, ``wo`` and ``gate``
    included (all non-zero)."""
    cfg, model, params = vlm["cfg"], vlm["model"], vlm["params"]
    batch = _batch(cfg, B, S, 7)
    jh, jloss, jgrads = jfns["grad"](params, *batch.values())
    with torch.no_grad():
        h, _ = model(torch.from_numpy(batch["tokens"]), memory=torch.from_numpy(batch["memory"]))
    assert _rel(h, jh) <= GATE
    loss, grads = _port_grads(model, cfg, batch)
    assert abs(loss - float(jloss)) <= GATE * abs(float(jloss))
    cross = grads["blocks"]["s4"]["attn"]
    assert all(float(np.abs(cross[k]).max()) > 0 for k in ("wq", "wkv", "wo", "gate"))
    _assert_trees_close(grads, jgrads)


def test_zero_gate_zeroes_the_cross_gradients(vlm, jfns):
    """At the init gate of 0 the cross layer adds nothing: the gradients of
    ``wq``, ``wkv`` and ``wo`` are exactly zero in both packages, and every
    other gradient, the gate's included, agrees."""
    cfg, model, params = vlm["cfg"], vlm["model0"], vlm["params0"]
    batch = _batch(cfg, B, S, 8)
    _, jloss, jgrads = jfns["grad"](params, *batch.values())
    loss, grads = _port_grads(model, cfg, batch)
    assert abs(loss - float(jloss)) <= GATE * abs(float(jloss))
    for tree in (grads, jgrads):
        cross = tree["blocks"]["s4"]["attn"]
        for k in ("wq", "wkv", "wo"):
            assert not np.asarray(cross[k]).any(), k
        assert float(np.abs(np.asarray(cross["gate"])).max()) > 0
    _assert_trees_close(grads, jgrads)


def _three_steps(vlm, f64: bool, jfns=None):
    """3 ``Trainer`` steps on ``EmulatedEngine`` over batches that carry
    their memory, and 3 of the reference's train step (the jitted
    ``value_and_grad`` of ``lm_loss``, then ``adamw_update``) from the same
    state (gate 0.5).  Returns ``{"jax": ..., "port": ...}``, each
    ``(losses, parameters, first moments, second moments)``, the trees as
    f64 numpy by JAX leaf name.  With ``f64`` both run in f64 throughout:
    the parameters, moments and memory are f64, and each package's casts to
    f32 (``jnp.float32``, ``Tensor.float``, ``torch.float32`` in the port's
    modules on the path) become casts to f64."""
    jcfg, cfg = vlm["jcfg"], vlm["cfg"]
    dt = "float64" if f64 else "float32"
    opt = adamw.OptimizerConfig(**OPT, state_dtype=dt)
    jopt = jax_adamw.OptimizerConfig(**OPT, state_dtype=dt)
    batches = [_batch(cfg, B, S, 20 + i) for i in range(3)]
    for b in batches:
        b["memory"] = b["memory"].astype(dt)
    params_np = jax.tree.map(np.asarray, vlm["params"])
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(f64):
        if f64:
            mp.setattr(jnp, "float32", jnp.float64)
            mp.setattr(torch.Tensor, "float", torch.Tensor.double)
            for mod in (T, T_layers, T_attention, flash_ops, flash_ref):
                mp.setattr(mod, "torch", _TorchF64())

            def grad(p, tok, lab, mem):
                return jax.value_and_grad(lambda q: JT.lm_loss(q, jcfg, tok, lab, memory=mem))(p)

            grad = jax.jit(grad)
            update = jax.jit(lambda p, g, o, step: jax_adamw.adamw_update(p, g, o, step, jopt))
        else:
            grad = lambda *a: jfns["grad"](*a)[1:]  # noqa: E731
            update = jfns["update"]
        jparams = jax.tree.map(lambda a: jnp.asarray(a, dt), params_np)
        jstate, jlosses = jax_adamw.init_opt_state(jparams, jopt), []
        for i, b in enumerate(batches):
            loss, grads = grad(jparams, *b.values())
            jparams, jstate, _ = update(jparams, grads, jstate, jnp.int32(i))
            jlosses.append(float(loss))

        model = copy.deepcopy(vlm["model"]).to(getattr(torch, dt))
        state = {"model": model, "step": 0,
                 "opt": adamw.init_opt_state(dict(model.named_parameters()), opt)}
        bucket = bucketing.Bucket(bucketing.DataShape(1, 16, 16), B)
        stream = iter([[(bucket, {k: torch.from_numpy(v) for k, v in b.items()})]
                       for b in batches])
        state, hist = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt)).run(
            state, stream, 3, rng=5, log_every=0)
    assert state["step"] == 3
    assert model.blocks[CROSS].attn.gate.item() != 0.5  # the gate trained (undecayed)
    flat = lambda tree: {k: np.asarray(v, np.float64) for k, v in _leaves(tree)}  # noqa: E731
    port = [to_numpy({n: t.detach().double() for n, t in tree.items()}, cfg) for tree in (
        dict(model.named_parameters()), state["opt"]["m"], state["opt"]["v"])]
    return {"jax": (jlosses, *map(flat, (jparams, jstate["m"], jstate["v"]))),
            "port": (list(hist.losses), *map(flat, port))}


def _assert_flat_close(got: dict, want: dict, gate: float):
    """Leaf by leaf and over the whole tree."""
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= gate, (k, _rel(got[k], want[k]))
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= gate, (num / den) ** 0.5


class _TorchF64:
    """``torch`` with ``float32`` meaning f64, for the modules of the port
    that name the dtype; ``torch`` itself stays as it is."""

    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def test_trainer_three_steps_match_jax(vlm, jfns):
    """The losses and the parameters at 1e-5, leaf by leaf and over the
    tree (readings 6.1e-6 and 1.4e-6); both moments at ``MOMENT_GATE``
    (readings 2.5e-5 a leaf at most, 2.4e-5 and 2.2e-5 over the tree).

    Why the moments get 4e-5, as RecurrentGemma's first moments get 2e-5
    (``tests/test_torch_hybrid.py``): every gradient agrees to 1e-5 (the
    tests above), but AdamW's first update of an element is lr g / (|g| +
    eps), so an element whose gradient cancels to rounding noise moves by
    whatever the noise says, and the next two gradients are taken at the
    moved weights.  The reference's own f32 run lies up to 1.4e-5 a leaf
    from its f64 run in the moments, the port's up to 2.8e-5; in f64 the
    two agree to 2.4e-14 (``test_trainer_three_steps_agree_in_f64``)."""
    run = _three_steps(vlm, f64=False, jfns=jfns)
    (jlosses, jp, jm, jv), (losses, p, m, v) = run["jax"], run["port"]
    np.testing.assert_allclose(losses, jlosses, rtol=GATE)
    _assert_flat_close(p, jp, GATE)
    _assert_flat_close(m, jm, MOMENT_GATE)
    _assert_flat_close(v, jv, MOMENT_GATE)


def test_trainer_three_steps_agree_in_f64(vlm):
    """The same 3 steps with both packages in f64: the losses, the
    parameters and both moments agree to ``F64_GATE``, so the two compute
    the same trajectory and the f32 gaps above are rounding."""
    run = _three_steps(vlm, f64=True)
    (jlosses, jp, jm, jv), (losses, p, m, v) = run["jax"], run["port"]
    np.testing.assert_allclose(losses, jlosses, rtol=F64_GATE)
    for got, want in ((p, jp), (m, jm), (v, jv)):
        _assert_flat_close(got, want, F64_GATE)


def test_train_launcher_routes_the_vlm_on_cpu(capsys):
    hist = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                              "--seq", "32", "--steps", "2"])
    assert hist.tokens == [64, 64] and np.isfinite(hist.losses).all()
    assert "final loss" in capsys.readouterr().out


# -- serving ------------------------------------------------------------------------------


def test_prefill_and_decode_match_jax(vlm, jfns):
    """Contiguous ``prefill(memory=)`` of 2 prompts of 11 tokens into caches
    of 16 (the cross layer's k and v of the 16 image tokens), then 4 greedy
    decode steps: logits and the whole cache tree."""
    cfg, model, params = vlm["cfg"], vlm["model"], vlm["params"]
    batch = _batch(cfg, 2, 11, 3)
    tok, mem = batch["tokens"], batch["memory"]
    jlogits, jcaches = jfns["prefill"](params, tok, mem)
    logits, caches = steps.make_prefill_step(cfg, 16)(model, torch.from_numpy(tok),
                                                       torch.from_numpy(mem))
    assert _rel(logits, jlogits) <= GATE
    assert tuple(caches[CROSS]["k"].shape) == (2, cfg.n_image_tokens, 2, 16)
    _assert_trees_close(caches_to_numpy(caches, cfg), jcaches)
    decode = steps.make_decode_step(cfg)
    for i in range(4):
        nxt = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)[:, None]
        jlogits, jcaches = jfns["decode"](params, jcaches, nxt, 11 + i)
        logits, caches = decode(model, caches, torch.from_numpy(nxt), 11 + i)
        assert _rel(logits, jlogits) <= GATE, i
    _assert_trees_close(caches_to_numpy(caches, cfg), jcaches)


# -- refusals --------------------------------------------------------------------------------


def test_paged_serving_refuses_the_vlm(vlm):
    """Paged serving takes global attention only, in both packages; the
    serve launcher refuses before building the model."""
    jcfg, cfg = vlm["jcfg"], vlm["cfg"]
    msg = "paged serving supports global-attention transformer blocks only"
    with pytest.raises(ValueError, match=msg):
        T.init_paged_pools(cfg, 8, 16, device="cpu")
    with pytest.raises(ValueError, match=msg):
        JT.init_paged_pools(jcfg, 8, 16)
    serve = dict(target_step=0.1, page_size=8, num_pages=8, decode_slots=2, max_seq=32)
    cost = dict(a=0.01, b=1e-6, p=2.0, r2=1.0)
    with pytest.raises(ValueError, match=msg):
        ServeEngine(vlm["model"], cfg, CostModel(**cost), ServeConfig(**serve))
    with pytest.raises(ValueError, match=msg):
        JaxServeEngine(vlm["params"], jcfg, JaxCostModel(**cost), JaxServeConfig(**serve))
    with pytest.raises(ValueError, match=msg):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_sequence_parallelism_refuses_the_vlm(vlm):
    """The SP loss takes the dense family only, and a cross block refuses a
    ring, with the reference's messages."""
    jcfg, cfg = vlm["jcfg"], vlm["cfg"]
    with pytest.raises(ValueError) as port:
        steps.make_sp_loss_fn(cfg, LocalRing(2))
    with pytest.raises(ValueError) as ref:
        jax_steps.make_sp_loss_fn(jcfg)
    assert str(port.value) == str(ref.value) and "dense transformer LM path only" in str(ref.value)
    x = torch.zeros(1, 32, cfg.d_model)
    with pytest.raises(ValueError) as port:
        T.apply_block(vlm["model"].blocks[CROSS], x, cfg, torch.arange(32), T.kernels, "cross",
                      memory=torch.zeros(1, cfg.n_image_tokens, cfg.d_model),
                      seq_group=LocalRing(2))
    with pytest.raises(ValueError) as ref:
        JT.apply_block(jax.tree.map(lambda a: a[0], vlm["params"]["blocks"]["s4"]),
                       jnp.zeros((1, 32, cfg.d_model)), "cross", jcfg, jnp.arange(32),
                       memory=jnp.zeros((1, cfg.n_image_tokens, cfg.d_model)), seq_axis="seq")
    assert str(port.value) == str(ref.value) and "does not support 'cross' blocks" in str(ref.value)


def test_cross_layer_without_memory_raises(vlm):
    tok = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="a cross-attention layer needs the image memory"):
        vlm["model"](tok)
    with pytest.raises(ValueError, match="needs the image memory"):
        steps.make_prefill_step(vlm["cfg"], 16)(vlm["model"], tok)


def test_f32_memory_into_a_bf16_model_raises():
    """The reference would promote ``memory @ wkv`` to f32 and hand K7 mixed
    dtypes; the port asks for the memory in the model's dtype."""
    cfg = dataclasses.replace(registry.get_smoke_config(ARCH), dtype="bfloat16")
    model = T.Transformer(cfg, seed=0, device="cpu")
    tok = torch.zeros(1, 8, dtype=torch.int32)
    mem = torch.zeros(1, cfg.n_image_tokens, cfg.d_model)
    with pytest.raises(ValueError, match="memory must come in the model's dtype"):
        model(tok, memory=mem)
    h, _ = model(tok, memory=mem.bfloat16())
    assert h.dtype == torch.bfloat16 and bool(torch.isfinite(h.float()).all())
