"""The port's training path against the JAX package on the CPU: the
rectified-flow loss and every parameter gradient, AdamW and its schedules,
the bucketed loader's draws, a 3-step ``Trainer`` run, and the launcher.

The JAX draws (``t``, ``eps``) are injected into the port, since
``torch.Generator`` and ``jax.random`` give different numbers from one
seed.  Model and optimizer trajectories are held to rel-L2 <= 1e-5, the
oracle gate of the JAX package's own engine tests.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import kernels as jax_kernels  # noqa: E402
from repro.configs import wan2_1_mmdit as jax_wan  # noqa: E402
from repro.core import bucketing as jax_bucketing  # noqa: E402
from repro.data.pipeline import BucketedLoader as JaxBucketedLoader  # noqa: E402
from repro.data.synthetic import wan_mixed_corpus as jax_corpus  # noqa: E402
from repro.models import mmdit as M  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import schedule as jax_schedule  # noqa: E402
from repro.train.loop import Trainer as JaxTrainer  # noqa: E402
from repro.train.steps import init_state as jax_init_state  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import from_jax_opt_state, from_jax_params, to_numpy  # noqa: E402
from repro_torch.core import bucketing  # noqa: E402
from repro_torch.data.pipeline import BucketedLoader  # noqa: E402
from repro_torch.data.synthetic import make_diffusion_batch, wan_mixed_corpus  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    CheckpointCadence,
    FaultTolerantRunner,
    HeartbeatMonitor,
)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.mmdit import MMDiT, decays, rectified_flow_loss  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402
from repro_torch.train.engine import EmulatedEngine  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.steps import make_pool_grad_step, make_train_step  # noqa: E402

GATE = 1e-5


def _rel_l2(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_trees_close(port_tree, jax_tree, *, leaf_gate=GATE, tree_gate=GATE):
    """Every leaf within ``leaf_gate`` rel-L2, and the whole tree within
    ``tree_gate`` (``repro.distributed.plan_exec.rel_l2``, the JAX package's
    parity metric)."""
    want = dict(_leaves(jax.tree.map(np.asarray, jax_tree)))
    got = dict(_leaves(port_tree))
    assert set(got) == set(want)
    worst = max((_rel_l2(got[k], want[k]), k) for k in want)
    assert worst[0] <= leaf_gate, worst
    num = sum(float(((np.float64(got[k]) - want[k]) ** 2).sum()) for k in want)
    den = sum(float((np.float64(want[k]) ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= tree_gate


def _port_model(cfg, params):
    model = MMDiT(cfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return model


def _seg(*runs):
    return np.concatenate([np.full(n, i, np.int32) for i, n in runs])


def _jax_draws(rng, x0):
    """The draws ``rectified_flow_loss`` makes from ``rng`` for ``x0``."""
    k1, k2 = jax.random.split(rng)
    t = jax.random.uniform(k1, (x0.shape[0],), jnp.float32)
    eps = jax.random.normal(k2, x0.shape, jnp.float32).astype(x0.dtype)
    return (torch.from_numpy(np.array(t)),
            torch.from_numpy(np.array(eps.astype(jnp.float32))))


# -- loss and gradients ---------------------------------------------------------


def _loss_case(cfg, seed=0, b=2, s=48, padded=True):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((b, s, cfg.in_channels * 4)).astype(np.float32)
    text = rng.standard_normal((b, cfg.text_len, 4096)).astype(np.float32)
    # packed windows: two clips (and padding, -1); the second row one clip
    pad = (-1 if padded else 1, s - 40)
    seg = np.stack([_seg((0, 20), (1, 20), pad), _seg((0, s))])
    n = cfg.text_len
    tseg = np.stack([_seg((0, n // 2), (1, n // 2)), _seg((0, n - 4), (-1 if padded else 0, 4))])
    return x0, text, seg, tseg


def _loss_and_grads_parity(cfg, backend=None, padded=True):
    params = M.init_params(jax.random.PRNGKey(3), cfg)
    x0, text, seg, tseg = _loss_case(cfg, padded=padded)
    rng = jax.random.PRNGKey(7)

    def jax_loss(p):
        return M.rectified_flow_loss(p, cfg, jnp.asarray(x0), jnp.asarray(text), rng,
                                     segment_ids=jnp.asarray(seg),
                                     text_segment_ids=jnp.asarray(tseg))

    prev = jax_kernels.get_backend()
    if backend is not None:
        jax_kernels.set_backend(backend)
    try:
        loss_j, grads_j = jax.value_and_grad(jax_loss)(params)
    finally:
        jax_kernels.set_backend(prev)

    model = _port_model(cfg, params)
    t, eps = _jax_draws(rng, jnp.asarray(x0))
    loss_t = rectified_flow_loss(model, torch.from_numpy(x0), torch.from_numpy(text), t=t,
                                 eps=eps, segment_ids=torch.from_numpy(seg),
                                 text_segment_ids=torch.from_numpy(tseg))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= GATE * abs(float(loss_j))
    grads_t = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads_t.values())
    _assert_trees_close(to_numpy(grads_t, cfg), grads_j)


def test_loss_and_every_gradient_match_jax_f32_smoke():
    _loss_and_grads_parity(jax_wan.smoke_config())


def test_loss_and_every_gradient_match_jax_pallas_head_dim_128():
    """dh = 128 with the JAX backend on its Pallas kernels (interpret mode),
    so the reference runs K1-K9 itself.  The ids hold no -1: the reference's
    flash wrapper pads ragged lengths with id -1, so rows the caller marked
    -1 would also see the wrapper's zero keys there and the Pallas backend
    would differ from the reference's own jnp oracle (ROADMAP, Queue 3)."""
    cfg = dataclasses.replace(jax_wan.smoke_config(), d_model=256, n_heads=2, n_kv_heads=2,
                              head_dim=128)
    _loss_and_grads_parity(cfg, backend="pallas_interpret", padded=False)


def test_loss_draws_from_the_generator_without_injection():
    cfg = jax_wan.smoke_config()
    model = MMDiT(cfg, seed=1, device="cpu")
    x0, text, _, _ = _loss_case(cfg)
    x0, text = torch.from_numpy(x0), torch.from_numpy(text)
    a = rectified_flow_loss(model, x0, text, generator=torch.Generator().manual_seed(5))
    b = rectified_flow_loss(model, x0, text, generator=torch.Generator().manual_seed(5))
    c = rectified_flow_loss(model, x0, text, generator=torch.Generator().manual_seed(6))
    assert float(a) == float(b) != float(c)


def test_remat_changes_no_gradient():
    cfg = jax_wan.smoke_config()
    x0, text, seg, tseg = (torch.from_numpy(a) for a in _loss_case(cfg, seed=2))
    t, eps = torch.tensor([0.25, 0.75]), torch.randn(x0.shape, generator=torch.Generator().manual_seed(0))
    grads = []
    for remat in (True, False):
        model = MMDiT(cfg, seed=4, device="cpu")
        rectified_flow_loss(model, x0, text, t=t, eps=eps, segment_ids=seg,
                            text_segment_ids=tseg, remat=remat).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


# -- optimizer --------------------------------------------------------------------


def _opt_tree(dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 6), "stack": (2, 3, 4), "b": (6,)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("dtype,state_dtype", [("float32", "float32"), ("bfloat16", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_adamw_update_matches_jax(dtype, state_dtype):
    cfg = adamw.OptimizerConfig(peak_lr=1e-2, clip_norm=0.5, schedule="cosine", warmup=3,
                                total_steps=20, state_dtype=state_dtype)
    jcfg = jax_adamw.OptimizerConfig(**dataclasses.asdict(cfg))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    sdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[state_dtype]
    p_np, g_np = _opt_tree(dtype, 0), _opt_tree(dtype, 1)
    m_np = {k: 0.1 * v for k, v in _opt_tree(dtype, 2).items()}
    v_np = {k: 0.01 * np.abs(v) for k, v in _opt_tree(dtype, 3).items()}
    pj = {k: jnp.asarray(v, jdt) for k, v in p_np.items()}
    gj = {k: jnp.asarray(v, jdt) for k, v in g_np.items()}
    sj = {"m": {k: jnp.asarray(v, sdt) for k, v in m_np.items()},
          "v": {k: jnp.asarray(v, sdt) for k, v in v_np.items()}}
    step = 5
    pj2, sj2, statsj = jax_adamw.adamw_update(pj, gj, sj, jnp.asarray(step, jnp.int32), jcfg)

    def torch_tree(tree, dt):
        return {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(dt)
                for k, v in tree.items()}

    pt, gt = torch_tree(pj, tdt), torch_tree(gj, tdt)
    sdt_t = getattr(torch, state_dtype)
    st = {"m": torch_tree(sj["m"], sdt_t), "v": torch_tree(sj["v"], sdt_t)}
    pt2, st2, statst = adamw.adamw_update(pt, gt, st, step, cfg)
    assert pt2 is pt  # in place
    assert float(statst["grad_norm"]) == pytest.approx(float(statsj["grad_norm"]), rel=1e-6)
    assert statst["lr"] == pytest.approx(float(statsj["lr"]), rel=1e-6)
    # f32 to a few ulps; bf16 at most one bf16 rounding apart
    tol = 1e-6 if dtype == state_dtype == "float32" else 2**-7
    for got, want in ((pt2, pj2), (st2["m"], sj2["m"]), (st2["v"], sj2["v"])):
        for k in want:
            w = np.asarray(want[k].astype(jnp.float32))
            g = got[k].float().numpy()
            assert g.dtype == np.float32 and got[k].dtype in (tdt, sdt_t)
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max())


def test_init_opt_state_and_global_norm():
    cfg = adamw.OptimizerConfig(state_dtype="bfloat16")
    params = {"a": torch.ones(3, 2), "b": torch.ones(4)}
    st = adamw.init_opt_state(params, cfg)
    assert st["m"]["a"].dtype == torch.bfloat16 and float(st["v"]["b"].abs().sum()) == 0
    assert float(adamw.global_norm(params)) == pytest.approx(10**0.5)


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedules_match_jax(name):
    for warmup in (0, 10):
        ours = schedule.get_schedule(name, 3e-4, warmup, 100)
        ref = jax_schedule.get_schedule(name, 3e-4, warmup, 100)
        for step in (0, 1, 5, 10, 11, 50, 89, 90, 95, 99, 100, 150):
            assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12)


def test_wan_optimizer_config_matches_jax():
    assert dataclasses.asdict(registry.get_optimizer("wan2.1-1.3b")) == dataclasses.asdict(
        jax_wan.optimizer())


def test_decay_rule_is_the_stacked_layouts():
    """AdamW decays ndim >= 2 leaves of the JAX tree, where per-block
    tensors carry the layer axis: every MMDiT parameter decays."""
    cfg = jax_wan.smoke_config()
    model = MMDiT(cfg, device="cpu")
    params = jax.tree.map(np.asarray, M.init_params(jax.random.PRNGKey(0), cfg))
    jax_decays = {k: v.ndim >= 2 for k, v in _leaves(params)}
    for name, p in model.named_parameters():
        key = "blocks." + name.split(".", 2)[2] if name.startswith("blocks.") else name
        assert decays(name, p) == jax_decays[key], name


# -- data --------------------------------------------------------------------------


def test_bucketing_is_the_reference_module():
    policy = bucketing.BucketingPolicy(m_mem=16384, m_comp=6.4e7, p=2.0)
    jpolicy = jax_bucketing.BucketingPolicy(m_mem=16384, m_comp=6.4e7, p=2.0)
    shapes, weights = wan_mixed_corpus()
    jshapes, jweights = jax_corpus()
    assert weights == jweights
    ours = policy.make_buckets(shapes)
    ref = jpolicy.make_buckets(jshapes)
    assert [(b.seq_len, b.batch_size) for b in ours] == [(b.seq_len, b.batch_size) for b in ref]
    # the 480p image / 1 s / 2 s buckets the chip run trains on
    assert [(b.seq_len, b.batch_size) for b in ours[:1] + ours[2:4]] == [
        (1637, 10), (4757, 2), (7877, 1)]


def test_bucketed_loader_draws_match_jax():
    shapes, weights = wan_mixed_corpus()
    jshapes, _ = jax_corpus()
    policy = bucketing.BucketingPolicy(m_mem=16384, m_comp=6.4e7, p=2.0)
    jpolicy = jax_bucketing.BucketingPolicy(m_mem=16384, m_comp=6.4e7, p=2.0)

    def make_batch(rng, bucket):
        return {"seed": int(rng.integers(2**31))}

    def stream(loader, n):
        try:
            return [[(b.seq_len, b.batch_size, batch["seed"]) for b, batch in next(loader)]
                    for _ in range(n)]
        finally:
            loader.close()

    kw = dict(budget=16384.0, budget_of=lambda b: float(b.tokens), seed=3)
    ours = stream(BucketedLoader(policy.make_buckets(shapes), weights, make_batch, **kw), 6)
    ref = stream(JaxBucketedLoader(jpolicy.make_buckets(jshapes), weights, make_batch, **kw), 6)
    assert ours == ref and sum(len(s) for s in ours) > 6


def test_bucketed_loader_rejects_bad_weights_and_closes():
    b = bucketing.Bucket(bucketing.DataShape(1, 64, 64), 2)
    with pytest.raises(ValueError):
        BucketedLoader([b], [0.0], lambda r, x: {}, budget=1.0, budget_of=lambda x: 1.0)
    loader = BucketedLoader([b], None, lambda r, x: {}, budget=1.0, budget_of=lambda x: 1.0)
    assert len(next(loader)) == 1
    loader.close()
    assert not loader._thread.is_alive()


def test_make_diffusion_batch_shapes_and_seed():
    cfg = jax_wan.smoke_config()
    a = make_diffusion_batch(3, 2, 40, cfg, "cpu")
    b = make_diffusion_batch(3, 2, 40, cfg, "cpu")
    assert a["latents"].shape == (2, 40, 64) and a["text"].shape == (2, cfg.text_len, 4096)
    assert a["latents"].dtype == torch.float32 and torch.equal(a["text"], b["text"])


# -- step functions and the trainer -------------------------------------------------


def _batches(cfg, rng, specs):
    """numpy batches: one list of (batch, seq) microbatches per step."""
    out = []
    for step in specs:
        micro = []
        for b, s in step:
            micro.append({
                "latents": rng.standard_normal((b, s, cfg.in_channels * 4)).astype(np.float32),
                "text": rng.standard_normal((b, cfg.text_len, 4096)).astype(np.float32),
            })
        out.append(micro)
    return out


def test_trainer_three_steps_match_jax():
    cfg = jax_wan.smoke_config()
    opt = adamw.OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=3)
    jopt = jax_adamw.OptimizerConfig(**dataclasses.asdict(opt))
    specs = [[(2, 32), (1, 48)], [(1, 48)], [(2, 32), (2, 32)]]
    steps_np = _batches(cfg, np.random.default_rng(0), specs)

    def stream(mod, to_array):
        items = []
        for step, spec in zip(steps_np, specs):
            items.append([(mod.Bucket(mod.DataShape(1, 16, 16), b), {k: to_array(v) for k, v in
                                                                     batch.items()})
                          for (b, _), batch in zip(spec, step)])
        return iter(items)

    # the reference: 3 steps of the JAX Trainer on its EmulatedEngine
    jstate = jax_init_state(jax.random.PRNGKey(0), cfg, jopt)
    params0 = jax.tree.map(np.asarray, jstate["params"])
    jstate, jhist = JaxTrainer(cfg, jopt, donate=False).run(
        jstate, stream(jax_bucketing, jnp.asarray), 3, rng=jax.random.PRNGKey(5), log_every=0)

    # the JAX draws, in the order the engine enumerates the pool
    draws = []
    key = jax.random.PRNGKey(5)
    for step in steps_np:
        key, sub = jax.random.split(key)
        for i, batch in enumerate(step):
            draws.append((i, _jax_draws(jax.random.fold_in(sub, i), jnp.asarray(batch["latents"]))))

    def noise(step_key, pool_index, batch):
        i, tv = draws.pop(0)
        assert i == pool_index
        return tv

    model = MMDiT(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params0, cfg, device="cpu"))
    state = {"model": model,
             "opt": from_jax_opt_state(jax.tree.map(np.asarray, jax_init_state(
                 jax.random.PRNGKey(0), cfg, jopt)["opt"]), cfg, device="cpu"),
             "step": 0}
    trainer = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt, noise=noise))
    state, hist = trainer.run(state, stream(bucketing, torch.from_numpy), 3, rng=5, log_every=0)

    assert not draws and state["step"] == int(jstate["step"]) == 3
    np.testing.assert_allclose(hist.losses, jhist.losses, rtol=GATE)
    # steps 1 and 2 run only signatures step 0 met first
    assert hist.events == jhist.events == ["compile@0"]
    assert hist.microbatches == [2, 1, 2]
    # telemetry: one record per microbatch that did not pay first-call set-up
    assert [(r.step, r.batch_size) for r in hist.records] == [(1, 1), (2, 2), (2, 2)]
    # the trajectory gate is the tree's rel-L2; a leaf that starts at zero
    # (mod_bias) holds only Adam's updates, so leaves get 1e-4
    _assert_trees_close(to_numpy(dict(model.named_parameters()), cfg), jstate["params"],
                        leaf_gate=1e-4)
    # first moments hold the accumulated f32 gradients: 1e-4
    _assert_trees_close(to_numpy(state["opt"]["m"], cfg), jstate["opt"]["m"], leaf_gate=1e-4,
                        tree_gate=1e-4)


def test_pool_grad_step_seeds_by_step_key_and_pool_index():
    cfg = jax_wan.smoke_config()
    model = MMDiT(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, rng, [[(1, 16)]])[0][0].items()}
    step = make_pool_grad_step(cfg)
    a, ga = step(model, batch, 11, 0)
    b, _ = step(model, batch, 11, 0)
    c, _ = step(model, batch, 11, 1)
    d, _ = step(model, batch, 12, 0)
    assert float(a) == float(b) and len({float(a), float(c), float(d)}) == 3
    assert set(ga) == {n for n, _ in model.named_parameters()}


def test_train_step_updates_in_place():
    cfg = jax_wan.smoke_config()
    opt = adamw.OptimizerConfig(peak_lr=1e-3, warmup=0)
    model = MMDiT(cfg, seed=2, device="cpu")
    state = {"model": model, "opt": adamw.init_opt_state(dict(model.named_parameters()), opt),
             "step": 0}
    before = model.x_in.detach().clone()
    batch = {k: torch.from_numpy(v) for k, v in
             _batches(cfg, np.random.default_rng(2), [[(1, 16)]])[0][0].items()}
    state, metrics = make_train_step(cfg, opt)(state, batch, torch.Generator().manual_seed(0))
    assert state["step"] == 1 and np.isfinite(float(metrics["loss"]))
    assert not torch.equal(before, model.x_in.detach())


def test_trainer_takes_ft_and_start_step(tmp_path):
    """``Trainer(ft=)`` saves on the runner's cadence and ``run(start_step=)``
    numbers the steps from there; the closed loop's per-step hook sees
    every step's metrics."""
    cfg = jax_wan.smoke_config()
    opt = adamw.OptimizerConfig()
    ft = FaultTolerantRunner(ckpt_dir=str(tmp_path),
                             cadence=CheckpointCadence(1e-9, 1e-9, min_interval_steps=1),
                             monitor=HeartbeatMonitor(1, timeout_s=1e9))
    trainer = Trainer(cfg, opt, ft=ft)
    model = MMDiT(cfg, seed=2, device="cpu")
    state = {"model": model, "opt": adamw.init_opt_state(dict(model.named_parameters()), opt),
             "step": 3}
    batch = {k: torch.from_numpy(v) for k, v in
             _batches(cfg, np.random.default_rng(3), [[(1, 16)]])[0][0].items()}
    item = [(bucketing.Bucket(bucketing.DataShape(1, 16, 16), 1), batch)]
    seen = []
    state, hist = trainer.run(state, iter([item, item]), 2, start_step=3, log_every=0,
                              on_metrics=lambda i, m: seen.append((i, sorted(m), m["tokens"])))
    assert seen == [(3, ["loss", "time", "tokens"], 1), (4, ["loss", "time", "tokens"], 1)]
    # the restored checkpoint is step 3's save: the cadence counts from there
    assert hist.events == ["compile@3", "ckpt@3", "ckpt@4"] and not hist.preempted
    assert state["step"] == 5 and store.latest_step(tmp_path) == 5
    assert store.load_run_state(tmp_path)["step"] == 5 == trainer.last_run_state["step"]


# -- launcher ------------------------------------------------------------------------


def test_launch_train_smoke_adaptive_on_cpu(capsys):
    hist = launch_train.main(["--arch", "wan2.1-1.3b", "--smoke", "--device", "cpu",
                              "--adaptive", "--steps", "2"])
    assert len(hist.losses) == 2 and np.isfinite(hist.losses).all()
    assert hist.microbatches == [1, 1] and hist.throughput > 0
    assert "final loss" in capsys.readouterr().out


def test_launch_train_refuses_flags_it_does_not_have():
    # --workers > 1 needs --adaptive (the reference launcher's check: the
    # fixed-shape stream has no planner to shard)
    with pytest.raises(SystemExit) as err:
        launch_train.main(["--smoke", "--device", "cpu", "--workers", "2"])
    assert err.value.code == 2


def test_training_modules_load_no_jax_and_no_repro():
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        "import repro_torch.launch.train, repro_torch.train.loop, repro_torch.data.pipeline\n"
        "import repro_torch.kernels.fused_adaln.ops, repro_torch.kernels.fused_rmsnorm.ops\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.convert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
