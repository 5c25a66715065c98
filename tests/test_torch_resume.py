"""Resumable runs of the port on the CPU: kill-and-resume, churn and the
launcher's checkpoint flags, on the smoke MMDiT over 4 emulated ranks.

* a run killed at step k = 2 of 4 and resumed from its checkpoint equals
  the uninterrupted run bitwise (parameters, moments, plan digests);
* the churn cycle ``kill@1:2,3;join@3:2;preempt@4`` in ``remap`` mode,
  then a resume from the handoff checkpoint, equals the uninterrupted 6-step
  run bitwise; in ``replan`` mode the join defers one boundary
  (``join-deferred@3``) and the loader grows back to 4 ranks;
* a checkpoint the JAX ``Trainer`` left at k = 2 resumes in the port, with
  the JAX draws injected (``EmulatedEngine(noise=)``), to the uninterrupted
  JAX 4-step run at the closed-loop test's gates: each leaf 1e-4, the tree
  1e-5 (the first moment's tree 1e-4);
* the launcher: a chaos leg with ``--ckpt-dir --digest-log``, then
  ``--resume``, gives the uninterrupted launcher's digests and the JAX
  package's loader's for the same arguments; without ``--ckpt-dir`` nothing
  is written, and the SIGTERM handler is put back when ``main`` returns.

Every loader is closed in ``finally``; every wait is bounded.
"""

import json
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import wan2_1_mmdit as jax_wan  # noqa: E402
from repro.core import bucketing as jbk  # noqa: E402
from repro.data import pipeline as jpl  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.loop import Trainer as JaxTrainer  # noqa: E402
from repro.train.steps import init_state as jax_init_state  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.convert import from_jax_opt_state, from_jax_params, to_numpy  # noqa: E402
from repro_torch.core import bucketing as tbk  # noqa: E402
from repro_torch.data import pipeline as tpl  # noqa: E402
from repro_torch.distributed.chaos import ChaosSchedule  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    CheckpointCadence,
    FaultTolerantRunner,
    HeartbeatMonitor,
    PreemptionNotice,
)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.engine import EmulatedEngine  # noqa: E402
from repro_torch.train.loop import Trainer, deserialize_rng_key  # noqa: E402
from repro_torch.train.steps import init_state  # noqa: E402

CFG = jax_wan.smoke_config()
OPT = dict(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=6)
CHURN = "kill@1:2,3;join@3:2;preempt@4"
N_STEPS = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke shapes run on one intra-op thread: the suite's parallel
    workers would otherwise oversubscribe the cores many times over.  It
    also holds the CPU's sums to one order in every run the module compares
    bitwise (module scope: set before the module's run fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _loader(bk, pl, to_array, resume_state=None):
    """4 ranks over three smoke shapes, numpy latents and text drawn from
    the loader's generator."""
    shapes = [bk.DataShape(1, 64, 64, 16), bk.DataShape(9, 64, 64, 16),
              bk.DataShape(17, 64, 64, 16)]
    buckets = bk.BucketingPolicy(m_mem=96, m_comp=1e9, p=2.0).make_buckets(shapes)

    def make_batch(rng, bucket):
        b, s = bucket.batch_size, bucket.seq_len
        return {"latents": to_array(rng.standard_normal((b, s, CFG.in_channels * 4))
                                    .astype(np.float32)),
                "text": to_array(rng.standard_normal((b, CFG.text_len, 4096))
                                 .astype(np.float32))}

    return pl.ShardedBucketedLoader(buckets, None, make_batch, n_workers=4, budget=96.0,
                                    budget_of=lambda b: float(b.tokens),
                                    load_of=lambda b: b.load(2.0), strategy="lpt", seed=0,
                                    resume_state=resume_state)


def _port_loader(resume_state=None):
    return _loader(tbk, tpl, torch.from_numpy, resume_state)


def _opt():
    return adamw.OptimizerConfig(**OPT)


def _trainer(loader, **kw):
    return Trainer(CFG, _opt(), run_state_of=lambda held: {"loader": loader.state_dict(
        rewind=held)}, **kw)


def _snapshot(state) -> dict:
    return {"params": {n: p.detach().clone() for n, p in state["model"].named_parameters()},
            "m": {n: t.clone() for n, t in state["opt"]["m"].items()},
            "v": {n: t.clone() for n, t in state["opt"]["v"].items()},
            "step": state["step"]}


def _assert_bitwise(state, snap):
    got = _snapshot(state)
    assert got["step"] == snap["step"]
    for part in ("params", "m", "v"):
        assert set(got[part]) == set(snap[part])
        for name, t in snap[part].items():
            assert torch.equal(got[part][name], t), (part, name)


def _resume(ckpt_dir, n_steps):
    """Restore the latest checkpoint into a fresh state (another seed) and
    train ``n_steps`` more; returns (state, history, digests)."""
    run_state = json.loads(json.dumps(store.load_run_state(ckpt_dir)))
    state = store.restore(ckpt_dir, init_state(CFG, _opt(), seed=7, device="cpu"))
    assert state["step"] == run_state["step"]
    loader = _port_loader(run_state["loader"])
    try:
        state, hist = _trainer(loader).run(
            state, iter(loader), n_steps, rng=deserialize_rng_key(run_state["trainer"]["rng"]),
            start_step=run_state["step"], log_every=0)
        digests = [p.digest().hex() for p in loader.plans[:n_steps]]
    finally:
        loader.close()
    return state, hist, digests


@pytest.fixture(scope="module")
def uninterrupted():
    """The port's uninterrupted 6-step run, with its state after 4 steps."""
    state = init_state(CFG, _opt(), seed=0, device="cpu")
    loader = _port_loader()
    at4 = {}

    def on_metrics(step, _m):
        if step == 3:
            at4.update(_snapshot(state))

    try:
        state, hist = _trainer(loader).run(state, iter(loader), N_STEPS, rng=1, log_every=0,
                                           on_metrics=on_metrics)
        digests = [p.digest().hex() for p in loader.plans[:N_STEPS]]
    finally:
        loader.close()
    return dict(at4=at4, final=_snapshot(state), digests=digests, losses=hist.losses)


def test_kill_at_two_of_four_resumes_bitwise(uninterrupted, tmp_path):
    k = 2
    loader = _port_loader()
    ft = FaultTolerantRunner(ckpt_dir=str(tmp_path),
                             cadence=CheckpointCadence(1e-9, 1e-9, min_interval_steps=k),
                             monitor=HeartbeatMonitor(4, timeout_s=1e9), keep=2)
    try:
        _, hist_a = _trainer(loader, ft=ft).run(init_state(CFG, _opt(), seed=0, device="cpu"),
                                                iter(loader), k, rng=1, log_every=0)
        digests_a = [p.digest().hex() for p in loader.plans[:k]]
    finally:
        loader.close()
    assert f"ckpt@{k - 1}" in hist_a.events and store.latest_step(tmp_path) == k
    state, hist_b, digests_b = _resume(tmp_path, 4 - k)
    assert digests_a + digests_b == uninterrupted["digests"][:4]
    assert hist_a.losses + hist_b.losses == uninterrupted["losses"][:4]
    _assert_bitwise(state, uninterrupted["at4"])


def test_churn_in_remap_mode_resumes_bitwise(uninterrupted, tmp_path):
    loader = _port_loader()
    ft = FaultTolerantRunner(ckpt_dir=str(tmp_path),
                             cadence=CheckpointCadence(1.0, 1.0, min_interval_steps=100),
                             monitor=HeartbeatMonitor(4, timeout_s=1e9),
                             preemption=PreemptionNotice())
    try:
        tr = _trainer(loader, ft=ft, chaos=ChaosSchedule.from_spec(CHURN))
        ft.on_resize = tr.set_physical_ranks  # remap elasticity
        _, hist = tr.run(init_state(CFG, _opt(), seed=0, device="cpu"), iter(loader), N_STEPS,
                         rng=1, log_every=0)
        digests_a = [p.digest().hex() for p in loader.plans[:len(hist.losses)]]
    finally:
        loader.close()
    assert hist.preempted and len(hist.losses) == 5  # preempted after step 4
    assert "chaos:kill:2,3@1" in hist.events and "join@3:2->4" in hist.events
    assert any(e.startswith("failure@1:") for e in hist.events)
    assert hist.events[-1] == "preempt@4"
    assert store.load_run_state(tmp_path)["step"] == 5
    assert [r.worker for r in hist.records if r.step == 2] and \
        max(r.worker for r in hist.records if r.step == 2) == 1  # 2 physical ranks
    state, hist_b, digests_b = _resume(tmp_path, N_STEPS - 5)
    assert digests_a + digests_b == uninterrupted["digests"]
    assert hist.losses + hist_b.losses == uninterrupted["losses"]
    _assert_bitwise(state, uninterrupted["final"])


def test_churn_in_replan_mode_grows_the_loader_back(tmp_path):
    loader = _port_loader()
    ft = FaultTolerantRunner(ckpt_dir=str(tmp_path),
                             cadence=CheckpointCadence(1.0, 1.0, min_interval_steps=100),
                             monitor=HeartbeatMonitor(4, timeout_s=1e9))
    try:
        tr = _trainer(loader, ft=ft, chaos=ChaosSchedule.from_spec("kill@1:2,3;join@3:2"))
        ft.on_resize = loader.resize
        _, hist = tr.run(init_state(CFG, _opt(), seed=0, device="cpu"), iter(loader), N_STEPS,
                         rng=1, log_every=0)
    finally:
        loader.close()
    assert len(hist.losses) == N_STEPS and np.isfinite(hist.losses).all()
    assert loader.n_workers == 4  # shrank to 2, grew back to 4
    # the post-kill resize re-emits the boundary plan, so the stream cannot
    # snapshot at step 3: the join drains to the NEXT boundary
    assert "join-deferred@3" in hist.events
    assert any(e.startswith("join@") and e.endswith(":2->4") for e in hist.events)


# -- a JAX checkpoint resumed in the port ------------------------------------------------


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


def _assert_trees_close(port_tree, jax_tree, *, leaf_gate, tree_gate):
    want = dict(_leaves(jax.tree.map(np.asarray, jax_tree)))
    got = dict(_leaves(port_tree))
    assert set(got) == set(want)
    worst = max((_rel_l2(got[k], want[k]), k) for k in want)
    assert worst[0] <= leaf_gate, worst
    num = sum(float(((np.float64(got[k]) - want[k]) ** 2).sum()) for k in want)
    den = sum(float((np.float64(want[k]) ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= tree_gate


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's uninterrupted 4 steps on 4 emulated ranks, its
    cadence saving at k = 2 (and 4) on the way."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    jopt = jax_adamw.OptimizerConfig(**OPT)
    state = jax_init_state(jax.random.PRNGKey(0), CFG, jopt)
    loader = _loader(jbk, jpl, lambda a: a)
    ft = jft.FaultTolerantRunner(ckpt_dir=str(ckpt),
                                 cadence=jft.CheckpointCadence(1e-9, 1e-9, min_interval_steps=2),
                                 monitor=jft.HeartbeatMonitor(4, timeout_s=1e9), keep=10)
    try:
        state, hist = JaxTrainer(CFG, jopt, ft=ft, donate=False, run_state_of=lambda held: {
            "loader": loader.state_dict(rewind=held)}).run(
            state, iter(loader), 4, rng=jax.random.PRNGKey(5), log_every=0)
        digests = [p.digest().hex() for p in loader.plans[:4]]
    finally:
        loader.close()
    assert "ckpt@1" in hist.events
    return dict(ckpt=ckpt, state=state, digests=digests, losses=hist.losses)


def _jax_draws(rng, x0):
    k1, k2 = jax.random.split(rng)
    t = jax.random.uniform(k1, (x0.shape[0],), jnp.float32)
    eps = jax.random.normal(k2, x0.shape, jnp.float32).astype(x0.dtype)
    return (torch.from_numpy(np.array(t)),
            torch.from_numpy(np.array(eps.astype(jnp.float32))))


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    ref = jax_run
    run_state = store.load_run_state(ref["ckpt"], step=2)
    assert run_state["step"] == 2
    words = run_state["trainer"]["rng"]
    # the JAX step keys of steps 2 and 3, from the checkpoint's key
    key, subs = jnp.asarray(np.asarray(words, np.uint32)), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        subs.append(sub)
    step_keys: list[int] = []

    def noise(step_key, pool_index, batch):
        # the port's step keys differ from JAX's: map them in order of use
        if step_key not in step_keys:
            step_keys.append(step_key)
        return _jax_draws(jax.random.fold_in(subs[step_keys.index(step_key)], pool_index),
                          jnp.asarray(batch["latents"]))

    opt = _opt()
    state = store.restore(ref["ckpt"], init_state(CFG, opt, seed=7, device="cpu"), step=2)
    assert state["step"] == 2
    loader = _port_loader(run_state["loader"])
    try:
        trainer = Trainer(CFG, opt, engine=EmulatedEngine(CFG, opt, noise=noise))
        state, hist = trainer.run(state, iter(loader), 2, rng=deserialize_rng_key(words),
                                  start_step=2, log_every=0)
        digests = [p.digest().hex() for p in loader.plans[:2]]
    finally:
        loader.close()
    assert digests == ref["digests"][2:] and len(step_keys) == 2
    assert state["step"] == int(ref["state"]["step"]) == 4
    np.testing.assert_allclose(hist.losses, ref["losses"][2:], rtol=1e-5)
    # a leaf that starts at zero (mod_bias) holds only Adam's updates: 1e-4
    _assert_trees_close(to_numpy(dict(state["model"].named_parameters()), CFG),
                        ref["state"]["params"], leaf_gate=1e-4, tree_gate=1e-5)
    _assert_trees_close(to_numpy(state["opt"]["m"], CFG), ref["state"]["opt"]["m"],
                        leaf_gate=1e-4, tree_gate=1e-4)
    # and the checkpoint itself reads into the port exactly as the converter reads it
    at2 = store.restore(ref["ckpt"], init_state(CFG, opt, seed=8, device="cpu"), step=2)
    like = jax.eval_shape(lambda: jax_init_state(jax.random.PRNGKey(0), CFG,
                                                 jax_adamw.OptimizerConfig(**OPT)))
    jat2 = jax.tree.map(np.asarray, jstore.restore(ref["ckpt"], like, step=2))
    for name, t in from_jax_params(jat2["params"], CFG, device="cpu").items():
        assert torch.equal(dict(at2["model"].named_parameters())[name], t), name
    for moment, tensors in from_jax_opt_state(jat2["opt"], CFG, device="cpu").items():
        for name, t in tensors.items():
            assert torch.equal(at2["opt"][moment][name], t), (moment, name)


# -- the launcher ----------------------------------------------------------------------


LAUNCH = ["--arch", "wan2.1-1.3b", "--smoke", "--device", "cpu", "--adaptive", "--workers", "4",
          "--steps", "4", "--batch", "2"]


def _main(argv):
    before = signal.getsignal(signal.SIGTERM)
    hist = launch_train.main(LAUNCH + argv)
    assert signal.getsignal(signal.SIGTERM) is before  # put back on return
    return hist


def _seed_batch(rng, bucket):
    return {"seed": np.array([rng.integers(2**31)])}


def test_launcher_kill_and_resume(tmp_path, monkeypatch, capsys):
    plain = tmp_path / "plain"
    plain.mkdir()
    monkeypatch.chdir(plain)
    full = _main(["--digest-log", "full.log"])
    assert len(full.losses) == 4 and sorted(p.name for p in plain.iterdir()) == ["full.log"]
    ck, log = tmp_path / "ck", tmp_path / "resumed.log"
    leg = _main(["--ckpt-dir", str(ck), "--digest-log", str(log),
                 "--chaos", "kill@1:2,3;join@2:2;preempt@2"])
    assert leg.preempted and len(leg.losses) == 3 and store.latest_step(ck) == 3
    assert "chaos:kill:2,3@1" in leg.events and "join@2:2->4" in leg.events
    rest = _main(["--ckpt-dir", str(ck), "--digest-log", str(log), "--resume"])
    assert len(rest.losses) == 1 and "resumed from step 3" in capsys.readouterr().out
    assert leg.losses + rest.losses == full.losses
    assert log.read_text() == (plain / "full.log").read_text()
    assert store.latest_step(ck) == 4 and store.load_run_state(ck)["step"] == 4
    # nothing left to do: the checkpoint is at --steps
    assert _main(["--ckpt-dir", str(ck), "--resume"]).losses == []
    assert "nothing to do" in capsys.readouterr().out
    # the JAX package's loader on the launcher's buckets plans the same stream
    shapes = [jbk.DataShape(1, 256, 256, 16), jbk.DataShape(9, 192, 192, 16),
              jbk.DataShape(17, 192, 192, 16)]
    policy = jbk.BucketingPolicy(m_mem=2 * 1024, m_comp=2.0e7, p=2.0)
    ref = jpl.ShardedBucketedLoader(
        policy.make_buckets(shapes), None, _seed_batch, n_workers=4, budget=256.0,
        budget_of=lambda b: float(b.tokens), load_of=lambda b: b.load(2.0), strategy="lpt")
    try:
        for _ in range(4):
            next(ref)
        want = "".join(p.digest().hex() + "\n" for p in ref.plans[:4])
    finally:
        ref.close()
    assert log.read_text() == want


def test_launcher_preempt_flag_and_flag_checks(tmp_path):
    flag = tmp_path / "preempt.flag"
    flag.write_text("")
    hist = _main(["--ckpt-dir", str(tmp_path / "ck"), "--preempt-flag", str(flag),
                  "--elastic", "replan"])
    assert hist.preempted and hist.events[-1] == "preempt@0"
    assert store.latest_step(tmp_path / "ck") == 1
    # resume, chaos and the flag file need --ckpt-dir: without it nothing is saved
    for argv in (["--resume"], ["--chaos", "kill@1:2"], ["--preempt-flag", str(flag)]):
        with pytest.raises(SystemExit):
            launch_train.main(LAUNCH + argv)
    with pytest.raises(SystemExit):  # rank faults need the planned stream
        launch_train.main(LAUNCH[:6] + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                                        "--chaos", "kill@1:2"])
    with pytest.raises(SystemExit):
        launch_train.main(LAUNCH + ["--ckpt-dir", str(tmp_path), "--resume", "--dispatch",
                                    "knapsack", "--overlap"])

