"""Mesh training in the port: ``Trainer(mesh=)`` (one gloo process a rank
on the CPU, through ``MeshEngine`` and ``PlanExecutor``) against
``Trainer`` on ``EmulatedEngine`` over the same planned stream; the closed
loop on a mesh (a scheduler whose planner draws the loader's plan stream:
the same ``PlanUpdate``s and plan digests on every rank, the replan landing
at the plan index the dispatch mode fixes); the refusal of a loader that
draws ahead; and the launcher's ``--mesh`` route: against the emulated
``--workers 2`` route, and resumed from a checkpoint (rank 0 alone
writing) against an uninterrupted run.

One spawn of 2 ranks runs every scenario (each with its own rendezvous
file); the ranks are this file run as a script, with no JAX:

    PYTHONPATH=src python tests/test_torch_mesh_train.py --rank R --world 2 \\
        --store PATH --out PATH

Trajectories are held to rel-L2 <= 1e-5 (the oracle gate); plan digests,
updates and resumed parameters must be equal.  Every wait is bounded.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store as ckpt_store
from repro_torch.configs import registry
from repro_torch.core.bucketing import BucketingPolicy, DataShape
from repro_torch.core.cost_model import CostModel
from repro_torch.core.scheduler import AdaptiveLoadScheduler, SchedulerConfig
from repro_torch.data.pipeline import ShardedBucketedLoader
from repro_torch.distributed.plan_exec import rel_l2
from repro_torch.launch import train as launch_train
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import init_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
GATE = 1e-5
WORLD = 2
CFG = registry.get_smoke_config("wan2.1-1.3b")
OPT = OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=4)
SHAPES = [DataShape(1, 64, 64, 16), DataShape(9, 64, 64, 16)]
STEPS = 3
SCHED_STEPS = 5
LAUNCH = ["--arch", "wan2.1-1.3b", "--smoke", "--device", "cpu", "--adaptive"]


def make_batch(rng, bucket):
    b, s = bucket.batch_size, bucket.seq_len
    return {"latents": torch.from_numpy(rng.standard_normal((b, s, CFG.in_channels * 4))
                                        .astype(np.float32)),
            "text": torch.from_numpy(rng.standard_normal((b, CFG.text_len, 4096))
                                     .astype(np.float32))}


def planned_loader(prefetch: int = 0):
    """2 ranks over the smoke shapes ((B, S) = (2, 32) and (1, 48)), LPT,
    64 tokens a rank; no lead by default, as a mesh needs."""
    buckets = BucketingPolicy(m_mem=64, m_comp=1e9, p=2.0).make_buckets(SHAPES)
    return ShardedBucketedLoader(buckets, [0.6, 0.4], make_batch, n_workers=WORLD, budget=64.0,
                                 budget_of=lambda b: float(b.tokens),
                                 load_of=lambda b: b.load(2.0), strategy="lpt", seed=2,
                                 prefetch=prefetch)


def scheduler():
    cfg = SchedulerConfig(target_sync=0.01, m_mem=64, refit_interval=2, min_samples=4,
                          dispatch="lpt")
    return AdaptiveLoadScheduler(cfg, SHAPES, initial_model=CostModel(a=1e-3, b=1e-6, p=2.0,
                                                                      r2=0.9),
                                 n_workers=WORLD)


def scheduled_loader(sched):
    """The loader whose plan stream ``sched``'s planner draws (every replan
    reaches dispatch), with no lead."""
    return ShardedBucketedLoader(sched.buckets, None, make_batch, n_workers=WORLD,
                                 planner=sched.make_planner(seed=2), prefetch=0)


def _update_key(u) -> list:
    return [u.step, u.reason, u.m_comp, [(b.seq_len, b.batch_size) for b in u.buckets],
            u.dispatch, u.n_workers]


def _params(state) -> dict:
    return {n: p.detach().numpy().copy() for n, p in state["model"].named_parameters()}


# -- the ranks ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, store: str, out: str) -> None:
    from repro_torch.launch.mesh import make_data_group

    torch.set_num_threads(1)  # the ranks share the machine's cores
    res = {}
    # (1) Trainer(mesh=) over the planned stream
    grp = make_data_group(rank=rank, world_size=world, store=store + ".trainer",
                          backend="gloo", device="cpu", timeout_s=60)
    try:
        loader = planned_loader()
        try:
            state, hist = Trainer(CFG, OPT, mesh=grp).run(
                init_state(CFG, OPT, seed=0, device="cpu"), iter(loader), STEPS, rng=5,
                log_every=0)
            res["trainer/digests"] = np.array([p.digest().hex() for p in loader.plans[:STEPS]])
        finally:
            loader.close()
        res["trainer/losses"] = np.array(hist.losses)
        for n, a in _params(state).items():
            res[f"trainer/params/{n}"] = a

        # (2) the closed loop: the scheduler's planner draws the loader's
        # plan stream; rank 1's recorded times scaled 3x (a straggler)
        sched = scheduler()
        loader = scheduled_loader(sched)
        try:
            _, hist = Trainer(CFG, OPT, mesh=grp, scheduler=sched,
                              worker_time_scale={1: 3.0}).run(
                init_state(CFG, OPT, seed=0, device="cpu"), iter(loader), SCHED_STEPS, rng=6,
                log_every=0)
            res["sched/digests"] = np.array([p.digest().hex()
                                             for p in loader.plans[:SCHED_STEPS]])
        finally:
            loader.close()
            sched.close()
        res["sched/updates"] = np.array(json.dumps([_update_key(u) for u in sched.updates]))
        res["sched/records"] = np.array([(r.step, r.worker, r.batch_size, r.seq_len,
                                          r.compute_time) for r in hist.records])

        # (3) a loader that draws ahead is refused on every rank, before
        # any collective
        loader = planned_loader(prefetch=2)
        try:
            Trainer(CFG, OPT, mesh=grp).run(init_state(CFG, OPT, seed=0, device="cpu"),
                                            iter(loader), 1, log_every=0)
            res["lead/refused"] = np.array("")
        except ValueError as e:
            res["lead/refused"] = np.array(str(e))
        finally:
            loader.close()
    finally:
        grp.close()

    # (4) the launcher's --mesh route
    mesh = ["--mesh", "--workers", str(world), "--rank", str(rank), "--backend", "gloo"]
    hist = launch_train.main(LAUNCH + mesh + ["--dist-store", store + ".launch",
                                              "--steps", str(STEPS)])
    res["launch/losses"] = np.array(hist.losses)

    # (5) resume: 4 steps in one run, and 2 + 2 through the checkpoint;
    # count every store.save each rank makes
    saves = []
    real_save = ckpt_store.save

    def counting_save(*a, **kw):
        saves.append(kw.get("run_state") is not None)
        return real_save(*a, **kw)

    ckpt_store.save = counting_save
    try:
        tmp = pathlib.Path(out).parent
        for leg, extra in (("full", ["--steps", "4"]), ("first", ["--steps", "2"]),
                           ("second", ["--steps", "4", "--resume"])):
            d = tmp / ("full" if leg == "full" else "split")
            d.mkdir(exist_ok=True)
            launch_train.main(LAUNCH + mesh + [
                "--dist-store", f"{store}.{leg}", "--ckpt-dir", str(d / "ckpt"),
                "--ckpt-every", "1", "--digest-log", str(d / "digests")] + extra)
    finally:
        ckpt_store.save = real_save
    res["resume/saves"] = np.array(len(saves))
    np.savez(out, **res)


def spawn_ranks(world: int, tmp_path: pathlib.Path) -> list:
    """Run this file as ``world`` gloo ranks over FileStores in
    ``tmp_path``; each writes ``rank<r>.npz``.  A rank that hangs fails the
    test at the timeout instead of hanging the suite."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__)), "--rank", str(r), "--world", str(world),
         "--store", str(tmp_path / "store"), "--out", str(tmp_path / f"rank{r}.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


# -- the parent --------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    return tmp, spawn_ranks(WORLD, tmp)


def test_mesh_trainer_matches_the_emulated_engine(spawned):
    _, res = spawned
    loader = planned_loader()
    try:
        state, hist = Trainer(CFG, OPT).run(init_state(CFG, OPT, seed=0, device="cpu"),
                                            iter(loader), STEPS, rng=5, log_every=0)
        digests = [p.digest().hex() for p in loader.plans[:STEPS]]
    finally:
        loader.close()
    want = _params(state)
    for r in res:
        assert r["trainer/digests"].tolist() == digests
        np.testing.assert_allclose(r["trainer/losses"], hist.losses, rtol=GATE)
        got = {n: r[f"trainer/params/{n}"] for n in want}
        assert rel_l2(got, want) <= GATE
        for n in want:  # every rank holds the same parameters
            assert np.array_equal(got[n], res[0][f"trainer/params/{n}"]), n


def test_every_rank_makes_the_same_plan_updates(spawned):
    _, res = spawned
    updates = json.loads(str(res[0]["sched/updates"]))
    assert any("straggler" in u[1] for u in updates), updates
    for r in res:
        assert json.loads(str(r["sched/updates"])) == updates
        assert r["sched/digests"].tolist() == res[0]["sched/digests"].tolist()
        # the gathered records are every rank's, identical on every process
        assert np.array_equal(r["sched/records"], res[0]["sched/records"])
    assert set(res[0]["sched/records"][:, 1].tolist()) == {0.0, 1.0}


def test_a_replan_lands_at_the_same_plan_on_every_rank(spawned):
    """The first replan, made after ``u`` observed steps, reaches the plan
    stream at plan ``u + 1``: with async dispatch (the mesh's default when
    it measures) step ``u`` was fetched before step ``u - 1``'s records
    were observed.  The plans before it are the stream's without a
    scheduler."""
    _, res = spawned
    u = json.loads(str(res[0]["sched/updates"]))[0][0]
    assert u + 1 < SCHED_STEPS
    sched = scheduler()
    loader = scheduled_loader(sched)
    try:
        for _ in range(SCHED_STEPS):
            next(loader)
        plain = [p.digest().hex() for p in loader.plans[:SCHED_STEPS]]
    finally:
        loader.close()
        sched.close()
    got = res[0]["sched/digests"].tolist()
    assert got[:u + 1] == plain[:u + 1]
    assert got[u + 1] != plain[u + 1]


def test_a_loader_that_draws_ahead_is_refused_on_a_mesh(spawned):
    _, res = spawned
    for r in res:
        assert "prefetch=0" in str(r["lead/refused"])


def test_a_loader_with_no_lead_draws_only_when_asked():
    """``prefetch=0``: nothing is drawn until a consumer asks, a planner
    update between two ``next`` calls reaches exactly the next plan, and
    ``state_dict`` draws the plan it needs."""
    loader = planned_loader()
    try:
        time.sleep(0.2)
        assert loader.plans == [] and loader.prefetch == 0
        next(loader)
        time.sleep(0.2)
        assert len(loader.plans) == 1
        loader.planner.update(budget=512.0)
        next(loader)
        time.sleep(0.2)
        sizes = [len(p.microbatches) for p in loader.plans]
        assert len(sizes) == 2 and sizes[1] > sizes[0]
        sd = loader.state_dict()
        assert sd["seq"] == 2 and len(loader.plans) == 3
        next(loader)  # the plan state_dict drew
        time.sleep(0.2)
        assert len(loader.plans) == 3
    finally:
        loader.close()


def test_launcher_mesh_route_matches_the_emulated_route(spawned):
    _, res = spawned
    hist = launch_train.main(LAUNCH + ["--workers", str(WORLD), "--steps", str(STEPS)])
    for r in res:
        np.testing.assert_allclose(r["launch/losses"], hist.losses, rtol=GATE)
        assert np.array_equal(r["launch/losses"], res[0]["launch/losses"])


def test_resumed_mesh_run_equals_the_uninterrupted_one(spawned):
    tmp, res = spawned
    full = (tmp / "full" / "digests").read_text().split()
    split = (tmp / "split" / "digests").read_text().split()
    assert len(full) == 4 and split == full
    assert int(res[1]["resume/saves"]) == 0 and int(res[0]["resume/saves"]) > 0
    states = [ckpt_store.restore(str(tmp / leg / "ckpt"), init_state(CFG, OPT, seed=1,
                                                                     device="cpu"))
              for leg in ("full", "split")]
    assert states[0]["step"] == states[1]["step"] == 4
    a, b = (dict(s["model"].named_parameters()) for s in states)
    assert all(torch.equal(a[n], b[n]) for n in a)
    for k in ("m", "v"):
        assert all(torch.equal(states[0]["opt"][k][n], states[1]["opt"][k][n]) for n in a)


def test_launcher_mesh_flags_are_checked(capsys):
    smoke = ["--arch", "wan2.1-1.3b", "--smoke", "--device", "cpu"]
    for argv, msg in ((["--mesh"], "--mesh requires --adaptive"),
                      (["--adaptive", "--mesh", "--workers", "2"], "--dist-store and --backend"),
                      (["--adaptive", "--rank", "1"], "configure --mesh"),
                      (["--adaptive", "--mesh", "--workers", "2", "--backend", "gloo",
                        "--dist-store", "x", "--dispatch", "knapsack", "--overlap"],
                       "--deterministic-refine"),
                      (["--adaptive", "--sp-max-ranks", "2"], "--sp-max-ranks > 1")):
        with pytest.raises(SystemExit):
            launch_train.main(smoke + argv)
        assert msg in capsys.readouterr().err, msg


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one gloo rank of the mesh training test")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _rank_main(a.rank, a.world, a.store, a.out)
