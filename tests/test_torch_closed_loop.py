"""The port's multi-rank data path and closed loop against the JAX
package's on the CPU: ``ShardedBucketedLoader`` streams and plan digests
(state snapshots and resize included), the scheduler's ``PlanUpdate``s on
one telemetry stream, ``EmulatedEngine`` on a split fan-out, 2 ``Trainer``
steps of the smoke MMDiT on 2 ranks, and the launcher's ``--workers``.

Streams, digests and updates must be equal; the trajectory is held to
rel-L2 <= 1e-5, the oracle gate of the JAX package's engine tests.  Every
loader is closed in ``finally``; the loaders' waits are all bounded.
"""

import dataclasses
import json
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import wan2_1_mmdit as jax_wan  # noqa: E402
from repro.core import bucketing as jbk  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import telemetry as jt  # noqa: E402
from repro.data import packing as jpk  # noqa: E402
from repro.data import pipeline as jpl  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.loop import Trainer as JaxTrainer  # noqa: E402
from repro.train.steps import init_state as jax_init_state  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import from_jax_opt_state, from_jax_params, to_numpy  # noqa: E402
from repro_torch.core import bucketing as tbk  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import dispatch as td  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import telemetry as tt  # noqa: E402
from repro_torch.data import packing as tpk  # noqa: E402
from repro_torch.data import pipeline as tpl  # noqa: E402
from repro_torch.data.synthetic import lm_length_corpus, wan_mixed_corpus  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.mmdit import MMDiT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.engine import EmulatedEngine  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.steps import init_state  # noqa: E402

GATE = 1e-5
PORT = (tbk, td, tpk, tpl)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke shapes run on one intra-op thread: the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
REFERENCE = (jbk, jd, jpk, jpl)


def _shapes(bk):
    return [bk.DataShape(1, 256, 256, 16), bk.DataShape(1, 512, 512, 16),
            bk.DataShape(17, 256, 256, 16), bk.DataShape(49, 512, 512, 16)]


WEIGHTS = [0.5, 0.25, 0.15, 0.10]


def _seed_batch(rng, bucket):
    """A numpy ``make_batch`` without a model: one draw a microbatch, as
    the launchers take for their keys."""
    return {"seed": np.array([rng.integers(2**31)])}


def _loader(pkg, case: str, **extra):
    bk, _, pk, pl = pkg
    if case.endswith("packed"):
        pool = pk.packed_bucket_pool(lm_length_corpus(np.random.default_rng(11), 240),
                                     window=8192, p=2.0)
        mean = float(np.mean([b.load(2.0) for b in pool]))
        return pl.ShardedBucketedLoader(
            pool, None, lambda rng, b: pl.make_packed_batch(rng, b, vocab=97), n_workers=4,
            budget=3 * mean, budget_of=lambda b: b.load(2.0), strategy=case.split("_")[0],
            seed=3, sp_max_ranks=4, **extra)
    strategy, *opts = case.split("_")
    buckets = bk.BucketingPolicy(m_mem=20_000, m_comp=2e8, p=2.0).make_buckets(_shapes(bk))
    return pl.ShardedBucketedLoader(
        buckets, WEIGHTS, _seed_batch, n_workers=4, budget=3 * 2e8,
        budget_of=lambda b: b.load(2.0), strategy=strategy, seed=3,
        overlap="overlap" in opts, deterministic_refine="overlap" in opts, refine_rounds=8,
        **extra)


def _stream(loader, dmod, n):
    """``n`` steps: per rank, each microbatch's key and its arrays."""
    return [[[(dmod.microbatch_key(b), {k: np.asarray(v).tolist() for k, v in batch.items()})
              for b, batch in share] for share in next(loader)] for _ in range(n)]


def _digests(loader, n):
    return [p.digest() for p in loader.plans[:n]]


# -- the sharded loader ----------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "lpt", "knapsack", "knapsack_overlap",
                                  "lpt_sp4_packed"])
def test_sharded_loader_streams_match_reference(case):
    ours, ref = _loader(PORT, case), _loader(REFERENCE, case)
    try:
        got, want = _stream(ours, td, 6), _stream(ref, jd, 6)
        assert got == want and all(len(step) == 4 for step in got)
        assert _digests(ours, 6) == _digests(ref, 6)
        if case.endswith("packed"):
            assert any(isinstance(b, td.SplitShard) for p in ours.plans[:6]
                       for b in p.microbatches), "no split: the case does not cover SP"
    finally:
        ours.close()
        ref.close()


def test_sharded_loader_state_dict_continues_the_stream():
    """A loader rebuilt from a snapshot (the port's own, or the JAX
    loader's through JSON) continues the stream plan for plan."""
    ours, ref = _loader(PORT, "knapsack"), _loader(REFERENCE, "knapsack")
    rebuilt = []
    try:
        _stream(ours, td, 3)
        _stream(ref, jd, 3)
        sd_t = json.loads(json.dumps(ours.state_dict()))
        sd_j = json.loads(json.dumps(ref.state_dict()))
        rebuilt += [_loader(PORT, "knapsack", resume_state=sd_t),
                    _loader(PORT, "knapsack", resume_state=sd_j)]
        want = _stream(ref, jd, 4)
        assert _stream(ours, td, 4) == want
        for loader in rebuilt:
            assert _stream(loader, td, 4) == want
        assert _digests(rebuilt[0], 4) == _digests(rebuilt[1], 4) == _digests(ref, 7)[3:]
    finally:
        for loader in [ours, ref, *rebuilt]:
            loader.close()


def _wait_depth(loader, depth, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with loader._cv:
            if min(len(d) for d in loader._pending) >= depth:
                return
        time.sleep(0.02)
    raise AssertionError(f"the producer never queued {depth} steps")


def test_sharded_loader_resize_matches_reference():
    """4 -> 3 ranks with 4 plans queued: the re-dealt steps and the plans
    recorded for them are the reference's."""
    ours, ref = _loader(PORT, "lpt", prefetch=4), _loader(REFERENCE, "lpt", prefetch=4)
    try:
        for loader in (ours, ref):
            _wait_depth(loader, 4)
            loader.resize(3)
        got, want = _stream(ours, td, 4), _stream(ref, jd, 4)
        assert got == want and all(len(step) == 3 for step in got)
        assert _digests(ours, 8) == _digests(ref, 8)
        assert ours.planner.n_workers == 3 and len(next(ours)) == 3
    finally:
        ours.close()
        ref.close()


# -- the closed loop -------------------------------------------------------------------


def _scheduler(pkg_sch, pkg_bk, pkg_cm):
    cfg = pkg_sch.SchedulerConfig(target_sync=0.02 + 2e-9 * 6.4e7, m_mem=16384,
                                  refit_interval=3, min_samples=12, dispatch="lpt",
                                  capacity_planning=True)
    shapes = [pkg_bk.DataShape(s.n_frames, s.height, s.width, s.text_len)
              for s in wan_mixed_corpus()[0][:6]]
    sched = pkg_sch.AdaptiveLoadScheduler(
        cfg, shapes, initial_model=pkg_cm.CostModel(a=0.02, b=2e-9, p=2.0, r2=0.9), n_workers=4)
    return sched, sched.make_planner(seed=0, accumulation=2.0)


def _update_key(u):
    return (u.step, u.reason, u.m_comp, [(b.shape.n_frames, b.shape.height, b.shape.width,
                                          b.shape.text_len, b.batch_size) for b in u.buckets],
            u.dispatch, u.n_workers, dataclasses.astuple(u.model))


def test_schedulers_give_the_same_plan_updates():
    """One synthetic telemetry stream, times from a known a + b·B·S^p with
    rank 3 at 1.5x, fed to both schedulers: the same refits, derates and
    capacity replans, and the same plans after each."""
    ours, our_planner = _scheduler(tsch, tbk, tcm)
    ref, ref_planner = _scheduler(jsch, jbk, jcm)
    rng = np.random.default_rng(0)
    try:
        for step in range(16):
            got, want = our_planner.plan(), ref_planner.plan()
            assert got.digest() == want.digest(), step
            recs_t, recs_j = [], []
            for w in range(4):
                for b in got.worker_microbatches(w):
                    t = (0.015 + 4e-9 * b.batch_size * float(b.seq_len) ** 1.8) * float(
                        rng.lognormal(0.0, 0.02)) * (1.5 if w == 3 else 1.0)
                    recs_t.append(tt.WorkerStepRecord(step, w, b.batch_size, b.seq_len, t))
                    recs_j.append(jt.WorkerStepRecord(step, w, b.batch_size, b.seq_len, t))
            ours.observe(recs_t)
            ref.observe(recs_j)
            assert [_update_key(u) for u in ours.updates] == [_update_key(u) for u in
                                                               ref.updates], step
        reasons = " | ".join(u.reason for u in ours.updates)
        assert "refit" in reasons and "straggler" in reasons, reasons
        assert ours.state_dict() == ref.state_dict()
    finally:
        ours.close()
        ref.close()


def test_refit_with_a_slope_below_zero_keeps_the_plan():
    """Telemetry whose best fit in the paper's p grid has b < 0 at R2 above
    the floor (per-microbatch time falling as B·S^p rises, as dual-
    constraint buckets at a wide model's 480p shapes give): the reference
    replans on it and its ``observe`` raises; the port refuses the fit, as
    both packages' per-class refits refuse a slope <= 0."""
    ours, _ = _scheduler(tsch, tbk, tcm)
    ref, _ = _scheduler(jsch, jbk, jcm)
    try:
        shapes = [(10, 1637), (2, 4757), (1, 7877)]
        for step in range(3):
            recs = [(step, w, bs, s, 0.14 - 1e-10 * bs * s**2) for w in range(4)
                    for bs, s in shapes]
            ours.observe([tt.WorkerStepRecord(*r) for r in recs])
            if step < 2:
                ref.observe([jt.WorkerStepRecord(*r) for r in recs])
        fit = tcm.fit_cost_model(ours.telemetry.bench_samples())
        assert fit.b < 0 and fit.r2 >= ours.config.r2_floor
        with pytest.raises(ValueError, match="degenerate slope"):
            ref.observe([jt.WorkerStepRecord(*r) for r in recs])
        assert ours.updates == [] and ours.model.b > 0
    finally:
        ours.close()
        ref.close()


# -- the engine on a split fan-out -----------------------------------------------------


def test_engine_split_fan_out_is_the_merged_step():
    """A window split over ranks 0-1 runs as the merged whole window at
    shard 0's pool position: bitwise the same loss and update."""
    cfg = registry.get_smoke_config("llama3.2-1b")
    opt = adamw.OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=2)
    pool = tpk.packed_bucket_pool([120, 90, 30, 200, 40], window=256, p=2.0)
    base, other = pool[0], pool[1]
    rng = np.random.default_rng(1)
    whole = tpl.make_packed_batch(rng, base, vocab=cfg.vocab)
    other_batch = tpl.to_device(tpl.make_packed_batch(rng, other, vocab=cfg.vocab), "cpu")
    shards = [tpl.to_device(s, "cpu") for s in tpk.split_packed_batch(whole, 2)]
    split = [[(td.SplitShard(base=base, n_ranks=2, shard=0, rank_load=1.0), shards[0])],
             [(td.SplitShard(base=base, n_ranks=2, shard=1, rank_load=1.0), shards[1]),
              (other, other_batch)]]
    merged = [[(base, tpl.to_device(whole, "cpu"))], [(other, other_batch)]]
    results = []
    for worker_steps in (split, merged):
        state = init_state(cfg, opt, seed=0, device="cpu")
        engine = EmulatedEngine(cfg, opt)
        losses = []
        for step in range(2):
            state, out = engine.execute_step(state, worker_steps, step_key=7 + step, step=step)
            losses.append(out.loss)
        recs = [(r.step, r.worker, r.batch_size, r.seq_len, r.ring_ranks)
                for r in engine.timing_records()]
        results.append((losses, dict(state["model"].named_parameters()), state["opt"]["m"],
                        recs, engine.heartbeat_ranks()))
    (la, pa, ma, ra, ha), (lb, pb, mb, rb, hb) = results
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert all(torch.equal(pa[n], pb[n]) and torch.equal(ma[n], mb[n]) for n in pa)
    assert ra == rb == [(1, 0, 1, 256, 1), (1, 1, 1, 256, 1)]
    assert ha == hb == [0, 1]


# -- 2 Trainer steps on 2 ranks against the JAX Trainer ---------------------------------


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
    want = dict(_leaves(jax.tree.map(np.asarray, jax_tree)))
    got = dict(_leaves(port_tree))
    assert set(got) == set(want)
    worst = max((_rel_l2(got[k], want[k]), k) for k in want)
    assert worst[0] <= leaf_gate, worst
    num = sum(float(((np.float64(got[k]) - want[k]) ** 2).sum()) for k in want)
    den = sum(float((np.float64(want[k]) ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= tree_gate


def _mmdit_loader(pkg, cfg, to_array):
    """2 ranks over two smoke shapes ((B, S) = (2, 32) and (1, 48)), numpy
    latents and text drawn from the loader's generator."""
    bk, _, _, pl = pkg
    shapes = [bk.DataShape(1, 64, 64, 16), bk.DataShape(9, 64, 64, 16)]
    buckets = bk.BucketingPolicy(m_mem=64, m_comp=1e9, p=2.0).make_buckets(shapes)

    def make_batch(rng, bucket):
        b, s = bucket.batch_size, bucket.seq_len
        return {"latents": to_array(rng.standard_normal((b, s, cfg.in_channels * 4))
                                    .astype(np.float32)),
                "text": to_array(rng.standard_normal((b, cfg.text_len, 4096))
                                 .astype(np.float32))}

    return pl.ShardedBucketedLoader(buckets, [0.6, 0.4], make_batch, n_workers=2, budget=64.0,
                                    budget_of=lambda b: float(b.tokens),
                                    load_of=lambda b: b.load(2.0), strategy="lpt", seed=2)


@pytest.fixture(scope="module")
def jax_two_ranks():
    """The reference: 2 steps of the JAX Trainer on its EmulatedEngine over
    a 2-rank planned stream (compiled once for the module)."""
    cfg = jax_wan.smoke_config()
    jopt = jax_adamw.OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0,
                                     total_steps=2)
    jstate = jax_init_state(jax.random.PRNGKey(0), cfg, jopt)
    params0 = jax.tree.map(np.asarray, jstate["params"])
    opt0 = jax.tree.map(np.asarray, jstate["opt"])
    loader = _mmdit_loader(REFERENCE, cfg, lambda a: a)
    try:
        jstate, jhist = JaxTrainer(cfg, jopt, donate=False).run(
            jstate, iter(loader), 2, rng=jax.random.PRNGKey(5), log_every=0)
        plans = loader.plans[:2]
    finally:
        loader.close()
    return dict(cfg=cfg, opt=jopt, params0=params0, opt0=opt0, state=jstate, hist=jhist,
                plans=plans)


def _jax_draws(rng, x0):
    k1, k2 = jax.random.split(rng)
    t = jax.random.uniform(k1, (x0.shape[0],), jnp.float32)
    eps = jax.random.normal(k2, x0.shape, jnp.float32).astype(x0.dtype)
    return (torch.from_numpy(np.array(t)),
            torch.from_numpy(np.array(eps.astype(jnp.float32))))


def test_two_rank_trainer_matches_jax(jax_two_ranks):
    ref = jax_two_ranks
    cfg = ref["cfg"]
    opt = adamw.OptimizerConfig(**dataclasses.asdict(ref["opt"]))
    subs = []
    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, sub = jax.random.split(key)
        subs.append(sub)
    step_keys: list[int] = []

    def noise(step_key, pool_index, batch):
        # the JAX draws of this pool entry: fold_in(step's subkey, index)
        if step_key not in step_keys:
            step_keys.append(step_key)
        sub = subs[step_keys.index(step_key)]
        return _jax_draws(jax.random.fold_in(sub, pool_index), jnp.asarray(batch["latents"]))

    model = MMDiT(cfg, device="cpu")
    model.load_state_dict(from_jax_params(ref["params0"], cfg, device="cpu"))
    state = {"model": model, "opt": from_jax_opt_state(ref["opt0"], cfg, device="cpu"),
             "step": 0}
    seen = []
    loader = _mmdit_loader(PORT, cfg, torch.from_numpy)
    try:
        trainer = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt, noise=noise))
        state, hist = trainer.run(state, iter(loader), 2, rng=5, log_every=0,
                                  on_metrics=lambda i, m: seen.append((i, m["tokens"])))
        plans = loader.plans[:2]
    finally:
        loader.close()
    assert [p.digest() for p in plans] == [p.digest() for p in ref["plans"]]
    assert len(step_keys) == 2 and state["step"] == int(ref["state"]["step"]) == 2
    np.testing.assert_allclose(hist.losses, ref["hist"].losses, rtol=GATE)
    assert hist.events == ref["hist"].events and hist.tokens == ref["hist"].tokens
    assert seen == [(i, tok) for i, tok in enumerate(hist.tokens)]
    assert hist.microbatches == [len(p.microbatches) for p in plans]
    # a leaf that starts at zero (mod_bias) holds only Adam's updates: 1e-4
    _assert_trees_close(to_numpy(dict(model.named_parameters()), cfg), ref["state"]["params"],
                        leaf_gate=1e-4)
    _assert_trees_close(to_numpy(state["opt"]["m"], cfg), ref["state"]["opt"]["m"],
                        leaf_gate=1e-4, tree_gate=1e-4)


def test_trainer_scales_recorded_times_and_feeds_the_scheduler():
    cfg = jax_wan.smoke_config()
    opt = adamw.OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=3)

    class Sink:
        def __init__(self):
            self.seen = []

        def observe(self, recs):
            self.seen.append(list(recs))

    sink = Sink()
    state = init_state(cfg, opt, seed=0, device="cpu")
    loader = _mmdit_loader(PORT, cfg, torch.from_numpy)
    try:
        trainer = Trainer(cfg, opt, scheduler=sink, worker_time_scale={1: 1e6})
        state, hist = trainer.run(state, iter(loader), 3, rng=1, log_every=0)
    finally:
        loader.close()
    assert len(sink.seen) == 3 and [r for step in sink.seen for r in step] == hist.records
    # rank 1's host-clock times carry the 1e6 scale; rank 0's do not
    slow = [r.compute_time for r in hist.records if r.worker == 1]
    fast = [r.compute_time for r in hist.records if r.worker == 0]
    assert slow and fast and min(slow) > 1e3 > max(fast)
    with pytest.raises(ValueError):
        Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt), worker_time_scale={0: 2.0})
    with pytest.raises(ValueError):
        trainer.engine.set_time_scale(0, 0.0)
    assert trainer.engine.heartbeat_ranks() == [0, 1]


# -- the launcher ----------------------------------------------------------------------


def test_launcher_workers_on_cpu(capsys):
    """``--adaptive --workers 2 --dispatch lpt``: 2 planned steps whose
    plans are the reference planner's on the reference launcher's buckets,
    and whose records name exactly the planned ranks and buckets."""
    hist = launch_train.main(["--smoke", "--device", "cpu", "--adaptive", "--workers", "2",
                              "--dispatch", "lpt", "--steps", "2"])
    assert len(hist.losses) == 2 and np.isfinite(hist.losses).all()
    assert "2 ranks" in capsys.readouterr().out
    shapes = [jbk.DataShape(1, 256, 256, 16), jbk.DataShape(9, 192, 192, 16),
              jbk.DataShape(17, 192, 192, 16)]
    policy = jbk.BucketingPolicy(m_mem=4 * 1024, m_comp=2.0e7, p=2.0)
    ref = jpl.ShardedBucketedLoader(
        policy.make_buckets(shapes), None, _seed_batch, n_workers=2, budget=512.0,
        budget_of=lambda b: float(b.tokens), load_of=lambda b: b.load(2.0), strategy="lpt")
    try:
        _stream(ref, jd, 2)
        assert [p.digest() for p in hist.plans] == _digests(ref, 2)
    finally:
        ref.close()
    seen = set()
    want = []
    for step, plan in enumerate(hist.plans):
        for w in range(plan.n_workers):
            for b in plan.worker_microbatches(w):
                key = (b.batch_size, b.seq_len)
                if key in seen:  # a batch signature met before is timed
                    want.append((step, w, b.batch_size, b.seq_len))
                seen.add(key)
    assert [(r.step, r.worker, r.batch_size, r.seq_len) for r in hist.records] == want
    assert hist.microbatches == [len(p.microbatches) for p in hist.plans]
