"""Step plans executed across processes: the port's ``PlanExecutor`` on
gloo ranks (one process a rank, the CPU) against ``oracle_step`` and the
JAX package's ``PlanExecutor`` on its 4 virtual devices, and the port's
``oracle_step`` against the JAX one.

One spawn a world size (2 and 4) runs every scenario in its ranks:

* (a) the smoke Wan (f32) over a mixed-shape fan-out, 2 steps: against
  ``oracle_step``, every rank bitwise equal to rank 0;
* (b) rank 1 perturbs its plan digest: ``PlanAgreementError`` on every
  rank, before any collective of the step;
* (c) a fan-out of half the world (elastic shrink) against that fan-out's
  oracle; (d) a wider fan-out and an empty share raise on every rank;
* (e) ``measure="serial"`` and ``"async"``: equal states, and every rank
  holds the same rank-major records (first signatures left out);
* (f) packed LM buckets (the smoke Llama), 2 steps: against
  ``oracle_step`` and the JAX ``PlanExecutor``;
* (g) a split group of k 2 (one 512-token window over ranks 0-1 through
  ``ProcessRing``) against ``oracle_step``;
* (h) ``warmup`` and ``time_batch``.

Every comparison is rel-L2 <= 1e-5 (the JAX package's oracle gate).  The
ranks are this file run as a script (no JAX there); every wait is bounded:

    PYTHONPATH=src python tests/test_torch_plan_exec.py --rank R --world K \\
        --store PATH --out PATH
"""

import argparse
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.bucketing import Bucket, BucketingPolicy, DataShape
from repro_torch.core.dispatch import SplitShard
from repro_torch.data.packing import packed_bucket_pool, split_packed_batch
from repro_torch.data.pipeline import make_packed_batch
from repro_torch.distributed.plan_exec import (
    PlanAgreementError,
    PlanExecutor,
    digest_to_row,
    oracle_step,
    rel_l2,
    worker_steps_digest,
)
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.steps import init_state

if __name__ != "__main__":  # the gloo rank processes need no JAX
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import llama3_2_1b as jax_llama
    from repro.core import bucketing as jbk
    from repro.configs import wan2_1_mmdit as jax_wan
    from repro.distributed import plan_exec as jpe
    from repro.launch.mesh import make_data_mesh
    from repro.optim import adamw as jax_adamw
    from repro.train import steps as JS
    from repro_torch.convert import from_jax_opt_state, from_jax_params, to_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent
GATE = 1e-5
WAN = registry.get_smoke_config("wan2.1-1.3b")
LM = registry.get_smoke_config("llama3.2-1b")
OPT = OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=4)
WAN_STEPS = ((1, 7), (2, 8))  # (fan-out seed, step key) of scenario (a)


# -- fan-outs (shared by the ranks and the parent) -------------------------------------


def wan_buckets():
    shapes = [DataShape(1, 64, 64, 16), DataShape(9, 64, 64, 16)]
    return BucketingPolicy(m_mem=64, m_comp=1e9, p=2.0).make_buckets(shapes)  # (2, 32), (1, 48)


def wan_fanout(n: int, seed: int) -> list:
    """``n`` shares of one or two smoke-Wan microbatches of mixed shapes,
    numpy latents and text from ``seed``."""
    buckets = wan_buckets()
    rng = np.random.default_rng(seed)
    shares = []
    for r in range(n):
        share = []
        for j in range(1 + (r + seed) % 2):
            b = buckets[(r + j + seed) % 2]
            share.append((b, {
                "latents": rng.standard_normal((b.batch_size, b.seq_len, WAN.in_channels * 4))
                .astype(np.float32),
                "text": rng.standard_normal((b.batch_size, WAN.text_len, 4096))
                .astype(np.float32)}))
        shares.append(share)
    return shares


LM_DOCS = [200, 150, 100, 250, 120, 60, 90, 230, 40, 180, 70, 210]


def lm_fanout(n: int, seed: int) -> list:
    """``n`` shares of packed 256-token LM buckets (one or two each)."""
    pool = packed_bucket_pool(LM_DOCS, window=256, p=2.0)
    rng = np.random.default_rng(seed)
    shares, i = [], 0
    for r in range(n):
        share = []
        for _ in range(1 + r % 2):
            b = pool[i % len(pool)]
            i += 1
            share.append((b, make_packed_batch(rng, b, vocab=LM.vocab)))
        shares.append(share)
    return shares


def split_fanout(n: int) -> list:
    """One 512-token packed window split over ranks 0-1 (k 2), shard 0's
    rank also running a 256-token bucket; ranks 2.. get one bucket each."""
    base = packed_bucket_pool([300, 150, 62], window=512, p=2.0)[0]
    rng = np.random.default_rng(11)
    shards = split_packed_batch(make_packed_batch(rng, base, vocab=LM.vocab), 2)
    singles = lm_fanout(n, 12)
    out = [[(SplitShard(base, 2, 0, 10.0), shards[0]), singles[0][0]],
           [(SplitShard(base, 2, 1, 10.0), shards[1])]]
    return out + [[s[0]] for s in singles[2:n]]


# -- the ranks ---------------------------------------------------------------------------


def _save_state(res: dict, prefix: str, state) -> None:
    for name, p in state["model"].named_parameters():
        res[f"{prefix}/params/{name}"] = p.detach().numpy().copy()
        for k in ("m", "v"):
            res[f"{prefix}/{k}/{name}"] = state["opt"][k][name].numpy().copy()


def _records(recs) -> np.ndarray:
    return np.array([(r.step, r.worker, r.batch_size, r.seq_len, r.compute_time)
                     for r in recs], dtype=np.float64).reshape(-1, 5)


def _steps(ex, state, fanouts, *, measure=False):
    losses, records, compiled = [], [], []
    for step, (ws, key) in enumerate(fanouts):
        state, out = ex.execute(state, ws, step_key=key, step=step, measure=measure,
                                digest=worker_steps_digest(ws))
        losses.append(float(out["loss"]))
        compiled.append(bool(out["compiled"]))
        if measure == "async":
            records.append(out["timers"].join())
        elif measure == "serial":
            records.append((out["records"], out["rank_times"]))
    return state, losses, records, compiled


def _rank_main(rank: int, world: int, store: str, out: str) -> None:
    from repro_torch.launch.mesh import make_data_group

    torch.set_num_threads(1)  # the ranks share the machine's cores
    grp = make_data_group(rank=rank, world_size=world, store=store, backend="gloo",
                          device="cpu", timeout_s=60)
    res = {}
    try:
        def fresh(cfg):
            ex = PlanExecutor(None, cfg, OPT, device="cpu")
            return ex, ex.place_state(init_state(cfg, OPT, seed=0, device="cpu"))

        # (a) mixed shapes, 2 steps
        ex, state = fresh(WAN)
        state, losses, _, compiled = _steps(
            ex, state, [(wan_fanout(world, s), k) for s, k in WAN_STEPS])
        _save_state(res, "a", state)
        res["a/loss"], res["a/compiled"] = np.array(losses), np.array(compiled)
        res["a/placed"] = np.array(ex.is_placed(state))

        # (b) rank 1 perturbs its digest
        ex, state = fresh(WAN)
        ws = wan_fanout(world, 1)
        ex.verify_agreement(worker_steps_digest(ws))  # unanimous: no raise
        digest = bytes(32) if rank == 1 else worker_steps_digest(ws)
        try:
            ex.execute(state, ws, step_key=7, digest=digest)
            res["b/raised"] = np.array(0)
        except PlanAgreementError as e:
            res["b/raised"] = np.array(1)
            res["b/names_rank1"] = np.array("[1]" in str(e))
        res["b/step"] = np.array(state["step"])

        # (c) elastic shrink: half the world's fan-out
        ex, state = fresh(WAN)
        state, losses, _, _ = _steps(ex, state, [(wan_fanout(world // 2, 3), 9)])
        _save_state(res, "c", state)

        # (d) a wider fan-out, an empty share
        for name, ws in (("wide", wan_fanout(world + 1, 4)),
                         ("empty", wan_fanout(world, 4)[:-1] + [[]])):
            try:
                ex.execute(state, ws, step_key=1, digest=worker_steps_digest(ws))
                res[f"d/{name}"] = np.array("")
            except ValueError as e:
                res[f"d/{name}"] = np.array(str(e))

        # (e) the measure modes on the same two steps
        for mode in ("serial", "async"):
            ex, state = fresh(WAN)
            state, losses, recs, compiled = _steps(
                ex, state, [(wan_fanout(world, 5), 7), (wan_fanout(world, 5), 8)],
                measure=mode)
            _save_state(res, f"e_{mode}", state)
            res[f"e_{mode}/records"] = np.concatenate([_records(r) for r, _ in recs])
            res[f"e_{mode}/rank_times"] = np.array([t for _, t in recs])
            res[f"e_{mode}/compiled"] = np.array(compiled)

        # (f) packed LM buckets, 2 steps
        ex, state = fresh(LM)
        state, losses, _, _ = _steps(ex, state, [(lm_fanout(world, 1), 7),
                                                 (lm_fanout(world, 2), 8)])
        _save_state(res, "f", state)
        res["f/loss"] = np.array(losses)

        # (g) a split group over ranks 0-1
        ex, state = fresh(LM)
        state, losses, _, _ = _steps(ex, state, [(split_fanout(world), 7)])
        _save_state(res, "g", state)
        res["g/loss"] = np.array(losses)

        # (h) the helpers: warmup meets a signature, time_batch times it
        ex, state = fresh(WAN)
        bucket, batch = wan_fanout(1, 6)[0][0]
        ex.warmup(state, [batch])
        res["h/times"] = np.array(ex.time_batch(state, batch, reps=2))
        _, _, _, compiled = _steps(ex, state, [([[(bucket, batch)]] * world, 7)])
        res["h/compiled"] = np.array(compiled)
        np.savez(out, **res)
    finally:
        grp.close()


def spawn_ranks(script: pathlib.Path, world: int, tmp_path: pathlib.Path, *extra) -> list:
    """Run ``script`` as ``world`` gloo ranks over a FileStore in
    ``tmp_path``; each writes ``rank<r>.npz``.  A rank that hangs fails the
    test at the timeout instead of hanging the suite."""
    store = tmp_path / "store"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(
        [sys.executable, str(script), "--rank", str(r), "--world", str(world), "--store",
         str(store), "--out", str(tmp_path / f"rank{r}.npz"), *extra],
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


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    return world, spawn_ranks(pathlib.Path(__file__), world, tmp_path_factory.mktemp(f"w{world}"))


def _state(res: dict, prefix: str) -> dict:
    out = {}
    for key, v in res.items():
        head, _, rest = key.partition("/")
        if head == prefix and "/" in rest:
            kind, name = rest.split("/", 1)
            out.setdefault(kind, {})[name] = v
    return out


def _oracle(cfg, fanouts, noise=None) -> dict:
    state = init_state(cfg, OPT, seed=0, device="cpu")
    losses = []
    for ws, key in fanouts:
        state, out = oracle_step(cfg, OPT, state, ws, step_key=key, noise=noise)
        losses.append(float(out["loss"]))
    model = state["model"]
    return {"params": {n: p.detach().numpy() for n, p in model.named_parameters()},
            "m": {n: t.numpy() for n, t in state["opt"]["m"].items()},
            "v": {n: t.numpy() for n, t in state["opt"]["v"].items()}, "loss": losses}


def _first_signatures(fanouts) -> list[bool]:
    """Per step: did any rank meet a (B, S) it had not run before?"""
    seen: dict[int, set] = {}
    out = []
    for ws in fanouts:
        new = False
        for r, share in enumerate(ws):
            for b, _ in share:
                new |= (b.batch_size, b.seq_len) not in seen.setdefault(r, set())
                seen[r].add((b.batch_size, b.seq_len))
        out.append(new)
    return out


def _assert_bitwise_ranks(res: list, prefix: str) -> None:
    want = _state(res[0], prefix)
    for r in range(1, len(res)):
        got = _state(res[r], prefix)
        for kind in want:
            for name in want[kind]:
                assert np.array_equal(got[kind][name], want[kind][name]), (r, kind, name)


def _assert_oracle(got: dict, want: dict) -> None:
    for kind in ("params", "m", "v"):
        assert rel_l2(got[kind], want[kind]) <= GATE, (kind, rel_l2(got[kind], want[kind]))


def test_mixed_shapes_match_the_oracle_and_every_rank_is_bitwise_rank0(ranks):
    world, res = ranks
    want = _oracle(WAN, [(wan_fanout(world, s), k) for s, k in WAN_STEPS])
    _assert_oracle(_state(res[0], "a"), want)
    np.testing.assert_allclose(res[0]["a/loss"], want["loss"], rtol=GATE)
    _assert_bitwise_ranks(res, "a")
    for r in res:
        assert np.array_equal(r["a/loss"], res[0]["a/loss"])
        assert r["a/compiled"].tolist() == _first_signatures(
            [wan_fanout(world, s) for s, _ in WAN_STEPS]) and bool(r["a/placed"])
    # the shares really differ in shape sequence
    assert len({tuple(b.seq_len for b, _ in s) for s in wan_fanout(world, 1)}) > 1


def test_a_perturbed_digest_raises_on_every_rank(ranks):
    world, res = ranks
    for r in res:
        assert int(r["b/raised"]) == 1 and bool(r["b/names_rank1"]) and int(r["b/step"]) == 0


def test_shrunken_fanout_idles_the_surplus_ranks(ranks):
    world, res = ranks
    _assert_oracle(_state(res[0], "c"), _oracle(WAN, [(wan_fanout(world // 2, 3), 9)]))
    _assert_bitwise_ranks(res, "c")


def test_a_wider_fanout_or_an_empty_share_raises_on_every_rank(ranks):
    world, res = ranks
    for r in res:
        assert "fans out to" in str(r["d/wide"])
        assert f"rank {world - 1} received an empty" in str(r["d/empty"])


def test_serial_and_async_give_equal_states_and_records(ranks):
    world, res = ranks
    for r in res:
        for kind, tree in _state(r, "e_serial").items():
            other = _state(r, "e_async")[kind]
            assert all(np.array_equal(tree[n], other[n]) for n in tree), kind
        s, a = r["e_serial/records"], r["e_async/records"]
        # the first step met every signature: only the second step records
        assert s.shape[0] == a.shape[0] == sum(len(sh) for sh in wan_fanout(world, 5))
        assert np.array_equal(s[:, :4], a[:, :4]) and (s[:, 4] > 0).all()
        assert s[:, 1].tolist() == sorted(s[:, 1].tolist())  # rank-major
        for mode in ("serial", "async"):
            assert np.array_equal(r[f"e_{mode}/records"], res[0][f"e_{mode}/records"])
            assert np.array_equal(r[f"e_{mode}/rank_times"], res[0][f"e_{mode}/rank_times"])
            assert r[f"e_{mode}/compiled"].tolist() == [True, False]


def test_packed_lm_matches_the_oracle_and_the_jax_executor(ranks):
    world, res = ranks
    fanouts = [(lm_fanout(world, 1), 7), (lm_fanout(world, 2), 8)]
    got = _state(res[0], "f")
    want = _oracle(LM, fanouts)
    _assert_oracle(got, want)
    np.testing.assert_allclose(res[0]["f/loss"], want["loss"], rtol=GATE)
    _assert_bitwise_ranks(res, "f")
    # the JAX package's executor on `world` of its virtual devices, from
    # the port's initial weights
    jcfg = jax_llama.smoke_config()
    jopt = jax_adamw.OptimizerConfig(**dataclasses.asdict(OPT))
    params0 = dict(init_state(LM, OPT, seed=0, device="cpu")["model"].named_parameters())
    jstate = JS.init_state(jax.random.PRNGKey(0), jcfg, jopt)
    jstate["params"] = jax.tree.map(lambda _, x: jnp.asarray(x), jstate["params"],
                                    to_numpy(params0, LM))
    ex = jpe.PlanExecutor(make_data_mesh(world), jcfg, jopt, donate=False)
    jstate = ex.place_state(jstate)
    for ws, key in fanouts:
        jstate, _ = ex.execute(jstate, ws, step_key=jax.random.PRNGKey(key))
    ours = {kind: to_numpy({n: torch.from_numpy(a) for n, a in got[kind].items()}, LM)
            for kind in ("params", "m", "v")}
    for kind, tree in (("params", jstate["params"]), ("m", jstate["opt"]["m"]),
                       ("v", jstate["opt"]["v"])):
        theirs = jax.tree.map(np.asarray, jax.device_get(tree))
        assert jpe.rel_l2(ours[kind], theirs) <= GATE, kind


def test_split_group_matches_the_oracle(ranks):
    world, res = ranks
    want = _oracle(LM, [(split_fanout(world), 7)])
    _assert_oracle(_state(res[0], "g"), want)
    np.testing.assert_allclose(res[0]["g/loss"], want["loss"], rtol=GATE)
    _assert_bitwise_ranks(res, "g")


def test_warmup_and_time_batch(ranks):
    _, res = ranks
    for r in res:
        assert r["h/times"].shape == (2,) and (r["h/times"] > 0).all()
        assert r["h/compiled"].tolist() == [False]  # every rank warmed the signature


# -- in one process ------------------------------------------------------------------------


@pytest.mark.parametrize("make", [lambda: wan_fanout(3, 1), lambda: lm_fanout(4, 2),
                                  lambda: split_fanout(3), lambda: [[], wan_fanout(1, 2)[0]]],
                         ids=["wan", "packed", "split", "empty-share"])
def test_digests_are_the_references_bytes(make):
    ws = make()

    def jax_bucket(b):  # the reference keys its own Bucket class by shape
        if isinstance(b, Bucket):
            return jbk.Bucket(jbk.DataShape(*dataclasses.astuple(b.shape)), b.batch_size)
        return b

    ours = worker_steps_digest(ws)
    theirs = jpe.worker_steps_digest([[(jax_bucket(b), x) for b, x in s] for s in ws])
    assert ours == theirs and len(ours) == 32
    assert np.array_equal(digest_to_row(ours), jpe.digest_to_row(theirs))
    assert digest_to_row(ours).dtype == np.uint32
    with pytest.raises(ValueError, match="32-byte"):
        digest_to_row(ours[:31])


def _jax_draws(rng, x0):
    k1, k2 = jax.random.split(rng)
    t = jax.random.uniform(k1, (x0.shape[0],), jnp.float32)
    eps = jax.random.normal(k2, x0.shape, jnp.float32).astype(x0.dtype)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps, dtype=np.float32))


def test_oracle_matches_the_jax_oracle_on_the_smoke_wan():
    """A mixed-shape fan-out of 3 ranks, one step, the JAX draws injected."""
    jcfg = jax_wan.smoke_config()
    jopt = jax_adamw.OptimizerConfig(**dataclasses.asdict(OPT))
    jstate = JS.init_state(jax.random.PRNGKey(0), jcfg, jopt)
    params0 = jax.tree.map(np.asarray, jstate["params"])
    opt0 = jax.tree.map(np.asarray, jstate["opt"])
    fanouts = [(wan_fanout(3, 1), 7)]

    def noise(step_key, pool_index, batch):
        return _jax_draws(jax.random.fold_in(jax.random.PRNGKey(step_key), pool_index),
                          jnp.asarray(batch["latents"].numpy()))

    state = init_state(WAN, OPT, seed=0, device="cpu")
    state["model"].load_state_dict(from_jax_params(params0, WAN, device="cpu"))
    state["opt"] = from_jax_opt_state(opt0, WAN, device="cpu")
    losses = []
    for ws, key in fanouts:
        state, out = oracle_step(WAN, OPT, state, ws, step_key=key, noise=noise)
        jstate, jout = jpe.oracle_step(jcfg, jopt, jstate, ws, step_key=jax.random.PRNGKey(key))
        losses.append((float(out["loss"]), float(jout["loss"])))
    assert state["step"] == 1 and int(jstate["step"]) == 1
    for a, b in losses:
        assert abs(a - b) <= GATE * abs(b)
    params = dict(state["model"].named_parameters())
    for ours, theirs in ((params, jstate["params"]), (state["opt"]["m"], jstate["opt"]["m"]),
                         (state["opt"]["v"], jstate["opt"]["v"])):
        got = to_numpy({n: t.detach() for n, t in ours.items()}, WAN)
        assert jpe.rel_l2(got, jax.tree.map(np.asarray, theirs)) <= GATE


def test_rel_l2_is_the_references():
    a = {"x": np.arange(6.0).reshape(2, 3), "y": np.ones(4)}
    b = {"y": np.ones(4) * 1.5, "x": np.arange(6.0).reshape(2, 3) + 0.25}
    want = jpe.rel_l2([b["x"], b["y"]], [a["x"], a["y"]])
    assert rel_l2({"x": torch.from_numpy(b["x"]), "y": b["y"]}, a) == pytest.approx(want,
                                                                                  rel=1e-15)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one gloo rank of the PlanExecutor test")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _rank_main(a.rank, a.world, a.store, a.out)
