"""RecurrentGemma (the hybrid family: RG-LRU and local-attention blocks) in
the port against the JAX package, on the CPU in f32 at the smoke size
(``recurrentgemma-smoke``: 5 layers, one superblock of (rglru, rglru,
local) and a tail of 2 rglru layers, d 64, 4 heads over 1 kv head of 16,
window 16):

* the configurations, the layer plan and the full model's decode-cache
  bytes; the convert round trip of parameters (``lam`` f32) and caches
  (the local ring's int32 ``pos``), exactly; the decay mask;
* the forward, ``lm_loss`` and every gradient against ``jax.grad``, on
  unpacked rows (S 40: the padded chunked branch) and on packed windows
  of 64 with segment ids; 3 ``Trainer`` steps against the JAX trainer,
  in f32 and with both packages in f64;
* ``make_prefill_step`` of a 23-token prompt (the padded branch) and of a
  10-token one (the ring half empty), each followed by 20
  ``make_decode_step`` steps across the ring's wrap: logits and caches
  against JAX's jitted steps;
* the launcher's hybrid route, and the refusals of paged serving, the
  serve launcher and sequence parallelism (the reference's messages), and
  of the kinds still unported.

Every comparison is rel-L2 <= 1e-5 unless stated (the oracle gate of the
JAX package's README); the JAX side runs under ``jax.jit``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import recurrentgemma_9b as jax_rg  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.core.cost_model import CostModel as JaxCostModel  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.configs import recurrentgemma_9b as torch_rg  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    caches_from_jax,
    caches_to_numpy,
    from_jax_params,
    to_numpy,
)
from repro_torch.core import bucketing  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.data.pipeline import materialize_packed_windows  # noqa: E402
from repro_torch.kernels.flash_attention.ring import LocalRing  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as T_attention  # noqa: E402
from repro_torch.models import layers as T_layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import lm_layers  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.engine import EmulatedEngine  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402

GATE = 1e-5
MOMENT_GATE = 2e-5  # the first moments after three AdamW steps in f32 (the trainer test)
F64_GATE = 1e-10  # both packages in f64
ARCH = "recurrentgemma-9b"
N_DECODE = 20
DOCS = [30, 20, 25, 14, 40, 9]  # FFD into windows of 64: [40, 20] and [30, 25, 9], [14]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif isinstance(v, list):
            for i, item in enumerate(v):
                yield from _leaves(item, f"{prefix}{k}.{i}.")
        else:
            yield f"{prefix}{k}", v


def _assert_trees_close(port_tree, jax_tree, gate=GATE):
    want = dict(_leaves(_np(jax_tree)))
    got = dict(_leaves(port_tree))
    assert set(got) == set(want)
    for k in want:
        if want[k].dtype == np.int32:  # a ring's positions
            assert np.array_equal(got[k], want[k]), k
        else:
            assert _rel(got[k], want[k]) <= gate, (k, _rel(got[k], want[k]))


@pytest.fixture(scope="module")
def hybrid():
    """The smoke model drawn from seed 0 by the port, and its parameters as
    the JAX tree (``to_numpy``; the round trip from a tree the JAX model
    drew is its own test)."""
    jcfg, cfg = jax_rg.smoke_config(), torch_rg.smoke_config()
    model = T.Transformer(cfg, seed=0, device="cpu")
    params = jax.tree.map(jnp.asarray, to_numpy(dict(model.state_dict()), cfg))
    return jcfg, cfg, params, model


def _packed() -> dict:
    mb = materialize_packed_windows(DOCS, window=64, vocab=256, batch_windows=2, seed=3)[0]
    return {k: mb[k] for k in ("tokens", "labels", "segment_ids")}


def _unpacked() -> dict:
    tok = np.random.default_rng(7).integers(0, 256, (2, 40)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


@pytest.fixture(scope="module")
def jax_serving(hybrid):
    """The reference's jitted ``make_prefill_step`` (one per capacity) and
    ``make_decode_step``."""
    jcfg = hybrid[0]
    prefills = {}

    def prefill(cap):
        if cap not in prefills:
            prefills[cap] = jax.jit(jax_steps.make_prefill_step(jcfg, cache_cap=cap))
        return prefills[cap]

    return prefill, jax.jit(jax_steps.make_decode_step(jcfg))


# -- configuration, layer plan, conversion ----------------------------------------------


@pytest.mark.parametrize("fn", ["config", "smoke_config"])
def test_configs_match(fn):
    assert dataclasses.asdict(getattr(torch_rg, fn)()) == dataclasses.asdict(
        getattr(jax_rg, fn)())
    get = registry.get_config if fn == "config" else registry.get_smoke_config
    assert get(ARCH) == getattr(torch_rg, fn)()
    opt, jopt = registry.get_optimizer(ARCH), jax_registry.get_optimizer(ARCH)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
    assert "hybrid" in steps.TRAINED


def test_layer_plan_and_full_cache_bytes():
    """38 layers: 12 superblocks of (rglru, rglru, local) and a tail of 2
    rglru layers; the decode caches of 4 rows take 26 x 163,840 bytes
    (h f32, 3 conv rows bf16) plus 12 rings x 8,396,800 (k and v of 2048
    slots x 256 bf16, pos int32), whatever the capacity.  The parameter
    tree holds 9,396,195,328 values (18,793,234,432 bytes: what a decode
    step streams); the config's ``param_count()`` formula gives
    8,959,557,632, one d x d projection (``in_y``) short a RG-LRU layer."""
    cfg, jcfg = torch_rg.config(), jax_rg.config()
    assert cfg.superblocks() == jcfg.superblocks() == (
        [], ["rglru", "rglru", "local"], 12, ["rglru", "rglru"])
    tree = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    leaves = jax.tree.leaves(tree)
    assert sum(a.size for a in leaves) == 9_396_195_328
    assert sum(a.size * a.dtype.itemsize for a in leaves) == 18_793_234_432
    assert jcfg.param_count() == 8_959_557_632
    caches = T.init_cache(cfg, 4, 5, device="meta")
    nbytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    assert nbytes == 26 * 163_840 + 12 * 8_396_800 == 105_021_440
    want = jax.eval_shape(lambda: JT.init_cache(jcfg, 4, 5))
    got = {(w, k): (tuple(t.shape), str(t.dtype).split(".")[-1])
           for (w, _), c in zip(lm_layers(cfg), caches) for k, t in c.items()}
    for (where, key), (shape, dt) in got.items():
        leaf = (want["tail"][0] if where == "tail" else want["blocks"][where])[key]
        assert leaf.shape[-len(shape):] == shape and leaf.dtype.name == dt, (where, key)


def test_convert_round_trip_of_parameters_and_caches(hybrid, jax_serving):
    """Every leaf of the bf16 JAX tree (``lam`` f32 in stacked and tail
    layers) lands in one port parameter of its dtype and comes back; the
    prefill caches (rings with their int32 ``pos``) go across and back
    bit for bit."""
    jcfg = dataclasses.replace(jax_rg.smoke_config(), dtype="bfloat16")
    cfg = dataclasses.replace(torch_rg.smoke_config(), dtype="bfloat16")
    rng = np.random.default_rng(3)  # the JAX tree's leaves, each drawn in its own dtype
    params_np = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(rng.standard_normal(a.shape), a.dtype)),
        jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(3), jcfg)))
    state = from_jax_params(params_np, cfg, device="cpu")
    model = T.Transformer(cfg, device="cpu")
    assert sorted(state) == sorted(model.state_dict())
    for name, p in model.state_dict().items():
        assert state[name].dtype == p.dtype and state[name].shape == p.shape, name
    assert state["blocks.3.mixer.lam"].dtype == torch.float32  # a tail layer
    assert np.array_equal(state["blocks.3.mixer.lam"].numpy(), params_np["tail"][0]["mixer"]["lam"])
    model.load_state_dict(state, strict=True)
    back = to_numpy(dict(model.state_dict()), cfg, keep_dtype=True)
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    assert all(np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))
               for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)))

    jcfg, cfg, params, _ = hybrid
    tok = np.random.default_rng(0).integers(0, 256, (2, 23)).astype(np.int32)
    _, caches = jax_serving[0](23)(params, jnp.asarray(tok))
    caches = _np(caches)
    assert caches["blocks"]["s2"]["pos"].shape == (1, 16)
    assert caches["blocks"]["s2"]["pos"].dtype == np.int32
    port = caches_from_jax(caches, cfg, device="cpu")
    assert port[2]["pos"].dtype == torch.int32 and sorted(port[3]) == ["conv", "h"]
    again = caches_to_numpy(port, cfg)
    assert jax.tree.structure(again) == jax.tree.structure(caches)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(again),
                                                    jax.tree.leaves(caches)))


def test_decay_mask_is_the_references_ndim_rule(hybrid):
    """AdamW decays JAX leaves of ndim >= 2: the stacked superblock's 1-D
    leaves (``lam``, ``conv_b``, the norms) decay, the tail's do not."""
    jcfg, cfg, params, model = hybrid
    want = _np(jax.tree.map(lambda a: np.float32(a.ndim >= 2), params))
    rule = T.decays(cfg)
    got = to_numpy({n: torch.tensor(float(rule(n, p))) for n, p in model.named_parameters()},
                   cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    # a stacked leaf comes back as one flag a superblock
    assert all(np.all(a == b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    flags = {n: rule(n, p) for n, p in model.named_parameters()}
    assert flags["blocks.0.mixer.lam"] and flags["blocks.2.norm1.w"]
    assert not flags["blocks.3.mixer.lam"] and not flags["blocks.4.mixer.conv_b"]
    assert flags["blocks.4.mixer.in_x"] and not flags["final_norm.w"]


# -- training ------------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked_s40", "packed_64"])
def test_forward_loss_and_every_gradient_match_jax(hybrid, packed):
    jcfg, cfg, params, model = hybrid
    batch = _packed() if packed else _unpacked()
    seg = batch.get("segment_ids")

    @jax.jit
    def jax_side(p):
        # the hidden states of the packed window (the unpacked forward is
        # held by the prefill tests' logits)
        h = JT.forward(p, jcfg, jnp.asarray(batch["tokens"]), remat=False,
                       segment_ids=jnp.asarray(seg))[0] if packed else None
        loss, grads = jax.value_and_grad(lambda q: JT.lm_loss(
            q, jcfg, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]),
            segment_ids=None if seg is None else jnp.asarray(seg)))(p)
        return h, loss, grads

    jh, jloss, jgrads = jax_side(params)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if packed:
        with torch.no_grad():
            h, _ = model(t["tokens"], segment_ids=t["segment_ids"])
        assert _rel(h, jh) <= GATE
    model.zero_grad(set_to_none=True)
    loss = T.lm_loss(model, t["tokens"], t["labels"], segment_ids=t.get("segment_ids"))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= GATE * abs(float(jloss))
    _assert_trees_close(to_numpy({n: p.grad for n, p in model.named_parameters()}, cfg), jgrads)
    if packed:  # the ids reach the local layer: without them the loss differs
        unscoped = T.lm_loss(model, t["tokens"], t["labels"])
        assert abs(unscoped.item() - loss.item()) > 1e-4 * abs(loss.item())


def _three_steps(hybrid, f64: bool):
    """3 ``Trainer`` steps on ``EmulatedEngine``, one packed microbatch of
    two windows each, and 3 calls of the JAX ``make_train_step`` from the
    same state.  Returns ``{"jax": ..., "port": ...}``, each ``(losses,
    parameters, first moments)`` with the trees as f64 numpy by JAX leaf
    name.  With ``f64`` both run in f64 throughout: the parameters and
    moments are f64, and each package's casts to f32 (``jnp.float32``,
    ``Tensor.float``, ``torch.float32`` in the port's ``layers`` and
    ``attention``) become casts to f64."""
    jcfg, cfg, params, _ = hybrid
    state_dtype = "float64" if f64 else "float32"
    opt = adamw.OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=3,
                                state_dtype=state_dtype)
    jopt = jax_adamw.OptimizerConfig(**dataclasses.asdict(opt))
    mbs = materialize_packed_windows(DOCS + [50, 33, 12, 60, 21], window=64, vocab=cfg.vocab,
                                     batch_windows=2, seed=5)[:3]
    batches = [{k: mb[k] for k in ("tokens", "labels", "segment_ids")} for mb in mbs]
    params_np = _np(params)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(f64):
        if f64:
            mp.setattr(jnp, "float32", jnp.float64)
            mp.setattr(torch.Tensor, "float", torch.Tensor.double)
            for mod in (T_layers, T_attention):  # their explicit torch.float32
                mp.setattr(mod, "torch", _TorchF64())
        jparams = jax.tree.map(lambda a: jnp.asarray(a, state_dtype), params_np)
        jstep = jax.jit(jax_steps.make_train_step(jcfg, jopt))
        jstate = {"params": jparams, "opt": jax_adamw.init_opt_state(jparams, jopt),
                  "step": jnp.zeros((), jnp.int32)}
        jlosses = []
        for b in batches:
            jstate, metrics = jstep(jstate, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(5))
            jlosses.append(float(metrics["loss"]))

        model = T.Transformer(cfg, device="cpu")
        model.load_state_dict(from_jax_params(params_np, cfg, device="cpu"))
        if f64:
            model.double()
        state = {"model": model, "step": 0,
                 "opt": adamw.init_opt_state(dict(model.named_parameters()), opt)}
        stream = iter([[(bucketing.Bucket(bucketing.DataShape(1, 16, 16), 2),
                         {k: torch.from_numpy(v) for k, v in b.items()})] for b in batches])
        state, hist = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt)).run(
            state, stream, 3, rng=5, log_every=0)
        port_p = to_numpy({n: p.detach().double() for n, p in model.named_parameters()}, cfg)
        port_m = to_numpy({n: m.double() for n, m in state["opt"]["m"].items()}, cfg)

    assert state["step"] == int(jstate["step"]) == 3 and hist.microbatches == [1, 1, 1]
    flat = lambda tree: {k: np.asarray(v, np.float64) for k, v in _leaves(_np(tree))}  # noqa: E731
    return {"jax": (jlosses, flat(jstate["params"]), flat(jstate["opt"]["m"])),
            "port": (list(hist.losses), flat(port_p), flat(port_m))}


class _TorchF64:
    """``torch`` with ``float32`` meaning f64, for the modules of the port
    that name the dtype (RoPE's frequencies, the loss's sum, the blocked
    attention's state); ``torch`` itself stays as it is."""

    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def _assert_flat_close(got: dict, want: dict, gate: float):
    """Leaf by leaf and over the whole tree."""
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= gate, (k, _rel(got[k], want[k]))
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= gate, (num / den) ** 0.5


def test_trainer_three_steps_match_jax(hybrid):
    """The port's 3 ``Trainer`` steps against the JAX ``make_train_step``
    in f32: the losses and the parameters at 1e-5, leaf by leaf and over
    the whole tree (largest leaf reading 9.0e-6, whole tree 1.1e-6); the
    first moments at ``MOMENT_GATE`` (largest leaf 1.4e-5, whole tree
    9.8e-6).

    Why the moments get 2e-5: every single gradient agrees to about 2e-6 a
    leaf (the test above), and the two packages' f32 gradients lie equally
    far from their f64 values.  But AdamW's first update of an element is
    lr g / (|g| + eps), so an element whose gradient cancels to rounding
    noise moves by whatever the noise says, and the next two gradients
    are taken at the moved weights.  The reference's own f32 run lies up to
    8.1e-6 a leaf (5.0e-6 over the tree) from its f64 run in the moments,
    and the port's run carries rounding of its own; in f64 the two agree
    to 1e-14 (``test_trainer_three_steps_agree_in_f64``)."""
    run = _three_steps(hybrid, f64=False)
    (jlosses, jparams, jm), (losses, port_p, port_m) = run["jax"], run["port"]
    np.testing.assert_allclose(losses, jlosses, rtol=GATE)
    _assert_flat_close(port_p, jparams, GATE)
    _assert_flat_close(port_m, jm, MOMENT_GATE)


def test_trainer_three_steps_agree_in_f64(hybrid):
    """The same 3 steps with both packages in f64: the losses, the
    parameters and the first moments agree to ``F64_GATE`` (readings:
    1.1e-14 a leaf at most), so the two compute the same trajectory and
    the f32 gaps above are rounding."""
    run = _three_steps(hybrid, f64=True)
    (jlosses, jparams, jm), (losses, port_p, port_m) = run["jax"], run["port"]
    np.testing.assert_allclose(losses, jlosses, rtol=F64_GATE)
    _assert_flat_close(port_p, jparams, F64_GATE)
    _assert_flat_close(port_m, jm, F64_GATE)


def test_launcher_trains_the_hybrid_smoke_model_on_cpu(capsys):
    hist = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                              "--seq", "40", "--steps", "2"])
    assert hist.tokens == [80, 80] and np.isfinite(hist.losses).all()
    assert "final loss" in capsys.readouterr().out


# -- contiguous serving --------------------------------------------------------------------


@pytest.mark.parametrize("s", [23, 10], ids=["padded_branch", "ring_half_empty"])
def test_prefill_and_decode_across_the_wrap_match_jax(hybrid, jax_serving, s):
    """Greedy decoding from position s for 20 steps: the ring (16 slots)
    wraps and overwrites its slots; every step's logits and the whole cache
    tree against JAX's.  No global-attention layer: the capacity (s) does
    not bound the positions."""
    jcfg, cfg, params, model = hybrid
    make_jpf, jdc = jax_serving
    tok = np.random.default_rng(s).integers(0, cfg.vocab, (2, s)).astype(np.int32)
    jlogits, jcaches = make_jpf(s)(params, jnp.asarray(tok))
    logits, caches = steps.make_prefill_step(cfg, s)(model, torch.from_numpy(tok))
    assert _rel(logits, jlogits) <= GATE
    _assert_trees_close(caches_to_numpy(caches, cfg), jcaches)
    ring = caches[2]["pos"]
    assert sorted(ring[ring >= 0].tolist()) == list(range(max(0, s - 16), s))
    decode = steps.make_decode_step(cfg)
    for i in range(N_DECODE):
        nxt = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)[:, None]
        jlogits, jcaches = jdc(params, jcaches, jnp.asarray(nxt), s + i)
        logits, caches = decode(model, caches, torch.from_numpy(nxt), s + i)
        assert _rel(logits, jlogits) <= GATE, i
        _assert_trees_close(caches_to_numpy(caches, cfg), jcaches)
    assert sorted(caches[2]["pos"].tolist()) == list(range(s + N_DECODE - 16, s + N_DECODE))


# -- refusals --------------------------------------------------------------------------------


def test_paged_serving_refuses_the_hybrid_model(hybrid):
    """Paged serving takes global attention only, in both packages; the
    serve launcher refuses before building the model."""
    jcfg, cfg, params, model = hybrid
    msg = "paged serving supports global-attention transformer blocks only"
    with pytest.raises(ValueError, match=msg):
        T.init_paged_pools(cfg, 8, 16, device="cpu")
    with pytest.raises(ValueError, match=msg):
        JT.init_paged_pools(jcfg, 8, 16)
    serve = dict(target_step=0.1, page_size=8, num_pages=8, decode_slots=2, max_seq=32)
    with pytest.raises(ValueError, match=msg):
        ServeEngine(model, cfg, CostModel(a=0.01, b=1e-6, p=2.0, r2=1.0), ServeConfig(**serve))
    with pytest.raises(ValueError, match=msg):
        JaxServeEngine(params, jcfg, JaxCostModel(a=0.01, b=1e-6, p=2.0, r2=1.0),
                       JaxServeConfig(**serve))
    with pytest.raises(ValueError, match=msg):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("kind", ["rglru", "local"])
def test_sequence_parallelism_refuses_the_hybrid_kinds(hybrid, kind):
    jcfg, cfg, params, model = hybrid
    i = cfg.layer_kinds().index(kind)
    x = torch.zeros(1, 32, cfg.d_model)
    with pytest.raises(ValueError) as port:
        T.apply_block(model.blocks[i], x, cfg, torch.arange(32), T.kernels, kind,
                      seq_group=LocalRing(2))
    with pytest.raises(ValueError) as ref:
        JT.apply_block(jax.tree.map(lambda a: a[0], params["blocks"][f"s{i}"]),
                       jnp.zeros((1, 32, cfg.d_model)), kind, jcfg, jnp.arange(32),
                       seq_axis="seq")
    assert str(port.value) == str(ref.value)
    assert f"does not support {kind!r} blocks" in str(port.value)
    with pytest.raises(ValueError, match="dense transformer LM path only"):
        steps.make_sp_loss_fn(cfg, LocalRing(2))


@pytest.mark.parametrize("kind", ["bogus"])
def test_unported_kinds_are_still_refused(kind):
    """Every kind of the reference is ported; an unknown one is refused."""
    cfg = dataclasses.replace(torch_rg.smoke_config(), pattern=("rglru", kind))
    with pytest.raises(ValueError, match="Mamba-2 and cross-attention blocks only"):
        T.Transformer(cfg, device="cpu")
