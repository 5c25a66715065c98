"""The port's fault tolerance and chaos harness against the JAX package's,
on scripted inputs with explicit clocks: the cadence's intervals,
``recovery_plan``, the heartbeat monitor's dead latch, ``join`` and
``reset``, ``PreemptionNotice`` (notify and flag file), the runner's saves
and events, every case and error of the chaos grammar and ``seeded`` over
20 seeds.  Then both ``Trainer`` loops over one stub engine (no
model is compiled or run): the same planned stream, the same cadence and
the churn schedule ``kill@1:2,3;join@3:2;preempt@4`` must give the same
events, preemption, saved steps and run-state blobs (less the trainer key,
whose form differs: a JAX key against the port's integer).
"""

import json
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import wan2_1_mmdit as jax_wan  # noqa: E402
from repro.core import bucketing as jbk  # noqa: E402
from repro.data import pipeline as jpl  # noqa: E402
from repro.distributed import chaos as jchaos  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train import engine as jeng  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import wan2_1_mmdit as torch_wan  # noqa: E402
from repro_torch.core import bucketing as tbk  # noqa: E402
from repro_torch.data import pipeline as tpl  # noqa: E402
from repro_torch.distributed import chaos as tchaos  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import engine as teng  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

BOTH = [(jft, jchaos), (tft, tchaos)]


def test_cadence_intervals_match():
    grid = [(c, m, k, dt) for c in (1e-9, 0.5, 30.0) for m in (1e-9, 60.0, 3600.0)
            for k in (1, 10, 50) for dt in (1e-4, 0.3, 12.0)]
    for c, m, k, dt in grid:
        got = tft.CheckpointCadence(c, m, min_interval_steps=k).interval_steps(dt)
        want = jft.CheckpointCadence(c, m, min_interval_steps=k).interval_steps(dt)
        assert got == want, (c, m, k, dt)


def test_recovery_plan_matches():
    for n_alive in range(0, 70):
        for mp in (1, 2, 4, 8, 16):
            assert tft.recovery_plan(n_alive, model_parallel=mp) == \
                jft.recovery_plan(n_alive, model_parallel=mp), (n_alive, mp)
    assert tft.recovery_plan(5) == jft.recovery_plan(5)  # the default degree


def _monitor_script(ft):
    """A flapping rank, a forced death, join and reset, on explicit clocks;
    returns every observation."""
    seen = []
    m = ft.HeartbeatMonitor(4, timeout_s=5.0)
    t0 = 1000.0
    for w in range(4):
        m.heartbeat(w, t0)
    m.heartbeat(1, t0 + 4.0)
    m.heartbeat(3, t0 + 4.0)
    seen.append(m.dead_workers(t0 + 8.0))
    m.heartbeat(0, t0 + 8.5)  # latched: the flapping rank stays dead
    m.heartbeat(9, t0 + 8.5)  # unknown ranks are ignored, not registered
    seen += [m.dead_workers(t0 + 9.0), m.alive(t0 + 9.0), sorted(m.workers)]
    m.mark_dead(3)
    seen.append(m.dead_workers(t0 + 9.0))
    m.join(0, t0 + 9.0)
    seen += [m.dead_workers(t0 + 10.0), m.alive(t0 + 10.0)]
    m.reset(2)
    seen += [sorted(m.workers), m.dead_workers(time.time() + 1.0)]
    return seen


def test_monitor_latch_join_and_reset_match():
    got, want = _monitor_script(tft), _monitor_script(jft)
    assert got == want
    assert want[0] == [0, 2] and want[1] == [0, 2]


def test_preemption_notice_matches(tmp_path):
    for i, (ft, _) in enumerate(BOTH):
        p = ft.PreemptionNotice()
        assert not p.pending()
        p.notify(grace_s=7.0)
        p.notify(grace_s=9.0)  # the first notice's grace holds
        assert p.pending() and p.grace_s == 7.0
        p.clear()
        assert not p.pending() and p.grace_s is None
        flag = tmp_path / f"preempt-{i}.flag"
        q = ft.PreemptionNotice(flag_file=str(flag))
        assert not q.pending()
        flag.write_text("")
        assert q.pending() and q.grace_s == 30.0


def _runner_script(ft, st, tmp_path, state):
    """Failure, join and preemption paths of one runner, with a flaky
    rename on the first save; returns its answers, events and saves."""
    import os

    real_replace = os.replace
    fails = {"n": 1}

    def flaky(src, dst):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient")
        return real_replace(src, dst)

    st.os.replace = flaky
    try:
        sizes = []
        r = ft.FaultTolerantRunner(
            ckpt_dir=str(tmp_path), cadence=ft.CheckpointCadence(1e-9, 1e-9, min_interval_steps=3),
            monitor=ft.HeartbeatMonitor(4, timeout_s=1e9), on_resize=sizes.append, keep=10,
            preemption=ft.PreemptionNotice())
        out = [r.maybe_checkpoint(state, 1, 0.1, run_state={"step": 1}),
               r.maybe_checkpoint(state, 3, 0.1, run_state=lambda: {"step": 3}), r.drain_events()]
        r.monitor.mark_dead(2)
        out += [r.handle_failures(state, 4, run_state={"step": 4}), r._force_full_save,
                r.handle_failures(state, 4, run_state={"step": 4}),
                r.maybe_checkpoint(state, 5, 0.1, run_state={"step": 5}),
                r.maybe_checkpoint(state, 6, 0.1, run_state={"step": 6})]
        out += [r.request_join(2), r.handle_joins(state, 7, run_state={"step": 7}),
                r.handle_joins(state, 8, run_state={"step": 8}), sizes]
        out += [r.handle_preemption(state, 9, run_state={"step": 9})]
        r.preemption.notify(4.0)
        out += [r.handle_preemption(state, 9, run_state={"step": 9})]
        r.note_restored(20)
        out += [r.maybe_checkpoint(state, 21, 0.1), r.drain_events()]
    finally:
        st.os.replace = real_replace
    saves = sorted(p.name for p in tmp_path.glob("step-*"))
    blobs = [jstore.load_run_state(tmp_path, step=int(n.split("-")[1])) for n in saves]
    return out, saves, blobs


def test_runner_matches(tmp_path):
    got = _runner_script(tft, store, tmp_path / "port", {"w": torch.ones(3)})
    want = _runner_script(jft, jstore, tmp_path / "jax", {"w": jnp.ones(3)})
    assert got == want
    assert want[0][2] == ["ckpt-retry#1:OSError"] and want[1][0] == "step-000000003"


SPECS = ["kill@4:2,3; join@8:2; preempt@12; slowdown@2:1x2.5", "kill@1:2,3;join@3:2;preempt@4",
         "join@5", "preempt@3:5", "slowdown@6:0,1", "slowdown@1:1x2;kill@1:3;join@1:2;preempt@1:5",
         ";kill@0:1;;"]
BAD = ["kill@x:1", "join8:2", "freeze@3", "kill@3", "", " ; ", "slowdown@2:1x0",
       "kill@-1:2", "preempt@2:abc", "join@2:x", "slowdown@2"]


def _events(cs):
    return [(e.step, e.kind, e.ranks, e.factor, e.grace_s, e.describe()) for e in cs.events]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_matches(spec):
    got, want = tchaos.ChaosSchedule.from_spec(spec), jchaos.ChaosSchedule.from_spec(spec)
    assert _events(got) == _events(want)
    assert got.last_step == want.last_step
    for step in range(0, 14):
        assert [e.describe() for e in got.events_at(step)] == \
            [e.describe() for e in want.events_at(step)]


@pytest.mark.parametrize("spec", BAD)
def test_chaos_spec_errors_match(spec):
    for _, chaos in BOTH:
        with pytest.raises(ValueError):
            chaos.ChaosSchedule.from_spec(spec)


def test_chaos_event_validation_matches():
    for kw in (dict(step=-1, kind="kill", ranks=(1,)), dict(step=1, kind="kill"),
               dict(step=1, kind="slowdown", ranks=(1,), factor=0.0),
               dict(step=1, kind="freeze")):
        for _, chaos in BOTH:
            with pytest.raises(ValueError):
                chaos.ChaosEvent(**kw)


def test_chaos_seeded_matches():
    for seed in range(20):
        for kw in (dict(n_steps=20, n_workers=4), dict(n_steps=5, n_workers=8, n_events=7),
                   dict(n_steps=12, n_workers=3, kinds=("kill", "join"))):
            got = tchaos.ChaosSchedule.seeded(seed, **kw)
            assert _events(got) == _events(jchaos.ChaosSchedule.seeded(seed, **kw))
            for e in got.events:
                assert 1 <= e.step < kw["n_steps"]
                if e.kind == "kill":
                    assert 0 not in e.ranks and len(e.ranks) < kw["n_workers"]
    for _, chaos in BOTH:
        with pytest.raises(ValueError):
            chaos.ChaosSchedule.seeded(0, n_steps=1, n_workers=4)
        with pytest.raises(ValueError):
            chaos.ChaosSchedule.seeded(0, n_steps=4, n_workers=4, kinds=("freeze",))


class _Scales:
    def __init__(self):
        self.scales = {}

    def set_time_scale(self, rank, factor):
        self.scales[rank] = factor


def test_chaos_fire_routes_to_the_same_hooks():
    spec = "kill@1:3;join@1:2;slowdown@1:1x2.0;preempt@1:5;kill@2:1"
    seen = []
    for ft, chaos in BOTH:
        monitor = ft.HeartbeatMonitor(4, timeout_s=1e9)
        runner = ft.FaultTolerantRunner(
            ckpt_dir="unused", cadence=ft.CheckpointCadence(1.0, 1.0, min_interval_steps=100),
            monitor=monitor)
        engine, pre = _Scales(), ft.PreemptionNotice()
        cs = chaos.ChaosSchedule.from_spec(spec)
        msgs = cs.fire(1, chaos.ChaosContext(monitor=monitor, runner=runner, engine=engine,
                                             preemption=pre))
        seen.append((msgs, monitor.dead_workers(time.time()), runner._pending_joins,
                     engine.scales, pre.pending(), pre.grace_s,
                     cs.fire(2, chaos.ChaosContext()), cs.fire(3, chaos.ChaosContext())))
    assert seen[0] == seen[1]
    assert seen[1][6] == ["chaos-skipped:kill:1"]


# -- both Trainer loops over one stub engine -------------------------------------------


class _StubModel(torch.nn.Module):
    """A one-tensor model: the port's train state with no network to run."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.w = torch.nn.Parameter(torch.zeros(4))

    @property
    def device(self):
        return self.w.device


def _stub_engine(base, outcome):
    class Stub(base):
        """Counts steps, records each physical fan-out, runs nothing."""

        def __init__(self):
            self.fanouts = []

        def execute_step(self, state, worker_steps, *, step_key, step):
            self.fanouts.append([[b.seq_len for b, _ in share] for share in worker_steps])
            self._last_ranks = list(range(len(worker_steps)))
            return dict(state, step=state["step"] + 1), outcome(loss=0.5, compiled=step == 0)

    return Stub()


def _seed_batch(rng, bucket):
    return {"seed": np.array([rng.integers(2**31)])}


def _loader(bk, pl):
    shapes = [bk.DataShape(1, 64, 64, 16), bk.DataShape(9, 64, 64, 16),
              bk.DataShape(17, 64, 64, 16)]
    buckets = bk.BucketingPolicy(m_mem=256, m_comp=1e9, p=2.0).make_buckets(shapes)
    return pl.ShardedBucketedLoader(buckets, None, _seed_batch, n_workers=4, budget=128.0,
                                    budget_of=lambda b: float(b.tokens),
                                    load_of=lambda b: b.load(2.0), strategy="lpt", seed=0)


def _drive(side, tmp_path):
    spec = "kill@1:2,3;join@3:2;preempt@4"
    if side == "jax":
        ft, chaos, loop, eng, bk, pl = jft, jchaos, jloop, jeng, jbk, jpl
        cfg = jax_wan.smoke_config()
        opt = jax_adamw.OptimizerConfig()
        state = {"params": {"w": jnp.zeros(4)},
                 "opt": {"m": {"w": jnp.zeros(4)}, "v": {"w": jnp.zeros(4)}},
                 "step": jnp.int32(0)}
        rng = jax.random.PRNGKey(1)
    else:
        ft, chaos, loop, eng, bk, pl = tft, tchaos, tloop, teng, tbk, tpl
        cfg = torch_wan.smoke_config()
        opt = adamw.OptimizerConfig()
        model = _StubModel(cfg)
        state = {"model": model, "opt": {"m": {"w": torch.zeros(4)}, "v": {"w": torch.zeros(4)}},
                 "step": 0}
        rng = 1
    engine = _stub_engine(eng.ExecutionEngine, eng.StepOutcome)
    loader = _loader(bk, pl)
    runner = ft.FaultTolerantRunner(
        ckpt_dir=str(tmp_path), cadence=ft.CheckpointCadence(1e-9, 1e-9, min_interval_steps=2),
        monitor=ft.HeartbeatMonitor(4, timeout_s=1e9), keep=100,
        preemption=ft.PreemptionNotice())
    try:
        trainer = loop.Trainer(cfg, opt, ft=runner, engine=engine,
                               chaos=chaos.ChaosSchedule.from_spec(spec),
                               run_state_of=lambda held: {"loader": loader.state_dict(
                                   rewind=held)})
        runner.on_resize = trainer.set_physical_ranks
        _, hist = trainer.run(state, iter(loader), 6, rng=rng, log_every=0)
        digests = [p.digest().hex() for p in loader.plans[:len(hist.losses)]]
    finally:
        loader.close()
    saves = sorted(p.name for p in tmp_path.glob("step-*"))
    blobs = [json.loads((tmp_path / n / "manifest.json").read_text())["run_state"]
             for n in saves]
    for blob in blobs:
        assert len(blob["trainer"].pop("rng")) == 2  # two uint32 words on both sides
    last = dict(trainer.last_run_state)
    last["trainer"] = {}
    return dict(events=hist.events, preempted=hist.preempted, losses=hist.losses,
                saves=saves, blobs=blobs, fanouts=engine.fanouts, digests=digests, last=last)


def test_trainer_runs_the_runner_as_the_jax_trainer(tmp_path):
    got = _drive("port", tmp_path / "port")
    want = _drive("jax", tmp_path / "jax")
    assert got == want
    assert want["preempted"] and len(want["losses"]) == 5
    assert "chaos:kill:2,3@1" in want["events"] and "join@3:2->4" in want["events"]
    assert want["events"][-1] == "preempt@4"
    # remap: 2 physical ranks between the kill and the join, 4 again after
    assert [len(f) for f in want["fanouts"]] == [4, 4, 2, 2, 4]


def test_rng_key_words_round_trip_and_read_jax_keys():
    for key in (0, 1, 2**32 - 1, 2**32, 2**63 + 12345, 2**64 - 1):
        words = tloop.serialize_rng_key(key)
        assert len(words) == 2 and all(0 <= w < 2**32 for w in words)
        assert tloop.deserialize_rng_key(json.loads(json.dumps(words))) == key
    # a JAX key's two words, as the JAX package serialises them
    jwords = jloop.serialize_rng_key(jax.random.PRNGKey(7))
    assert tloop.deserialize_rng_key(jwords) == 7
    assert jloop.deserialize_rng_key(tloop.serialize_rng_key(7)).tolist() == \
        jax.random.PRNGKey(7).tolist()
    with pytest.raises(ValueError):
        tloop.serialize_rng_key(-1)
    with pytest.raises(ValueError):
        tloop.deserialize_rng_key([2**32, 0])
