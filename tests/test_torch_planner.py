"""The port's planning core against the JAX package's, numpy on both sides:
the balancer's metrics and assignments, the cost-model fits, telemetry's
straggler and speed estimates, ``StepPlanner`` plan digests for every
strategy (deterministic refinement, capacities and sequence-parallel
splits included), the fan-out regrouping and split merge, the simulators
and the packing functions.

The port keeps its own copy of these framework-free modules, so every
check here is exact: equal digests, equal assignments, equal floats (the
fits to 1e-12 relative).
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import balancer as jb  # noqa: E402
from repro.core import bucketing as jbk  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import telemetry as jt  # noqa: E402
from repro.data import packing as jpk  # noqa: E402
from repro_torch.core import balancer as tb  # noqa: E402
from repro_torch.core import bucketing as tbk  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import dispatch as td  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import telemetry as tt  # noqa: E402
from repro_torch.data import packing as tpk  # noqa: E402
from repro_torch.data.synthetic import lm_length_corpus, wan_mixed_corpus  # noqa: E402

FIT_GATE = 1e-12


def _shapes(mod):
    """A skewed mixed corpus: light images, heavy videos (the reference's
    ``tests/test_dispatch.py`` table)."""
    return [mod.DataShape(1, 256, 256, 16), mod.DataShape(1, 512, 512, 16),
            mod.DataShape(17, 256, 256, 16), mod.DataShape(49, 512, 512, 16)]


WEIGHTS = [0.5, 0.25, 0.15, 0.10]


def _buckets(mod):
    return mod.BucketingPolicy(m_mem=20_000, m_comp=2e8, p=2.0).make_buckets(_shapes(mod))


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


# -- balancer ------------------------------------------------------------------------


def _balancer_case(name, mod):
    rng = np.random.default_rng(3)
    loads = list(rng.lognormal(0.0, 1.0, 23))
    caps = [1.0, 0.5, 1.5, 0.8]
    if name == "step_metrics":
        return mod.step_metrics(loads[:4], loads[4:8], 1234)
    if name == "assign_random":
        return mod.assign_random(23, 4, np.random.default_rng(9))
    if name == "assign_lpt":
        return mod.assign_lpt(loads, 4)
    if name == "assign_lpt_capacities":
        return mod.assign_lpt(loads, 4, caps)
    if name == "makespan":
        groups = mod.assign_lpt(loads, 4, caps)
        return mod.makespan(loads, groups), mod.makespan(loads, groups, caps)
    stats = mod.RunningStats()
    for v in loads:
        stats.add(v)
    return stats.mean, stats.percentile(50), stats.percentile(99), stats.tail_ratio()


@pytest.mark.parametrize("name", ["step_metrics", "assign_random", "assign_lpt",
                                  "assign_lpt_capacities", "makespan", "running_stats"])
def test_balancer_matches_reference(name):
    got, want = _balancer_case(name, tb), _balancer_case(name, jb)
    if name == "step_metrics":
        got, want = got.__dict__, want.__dict__
    assert got == want


# -- cost model ----------------------------------------------------------------------


def _samples(mod, seed=0, a=0.02, b=3e-9, p=1.9, jitter=0.05):
    rng = np.random.default_rng(seed)
    out = []
    for bs, s in [(10, 1637), (2, 4757), (1, 7877), (4, 3197), (1, 12557), (16, 1024)] * 3:
        t = (a + b * bs * s**p) * float(rng.lognormal(0.0, jitter))
        out.append(mod.BenchSample(bs, s, t))
    return out


def test_fits_match_reference():
    got, want = tcm.fit_cost_model(_samples(tcm)), jcm.fit_cost_model(_samples(jcm))
    for f in ("a", "b", "p", "r2"):
        assert _rel(getattr(got, f), getattr(want, f)) <= FIT_GATE, f
    assert got.n_samples == want.n_samples == 18 and 1.8 <= got.p <= 2.0
    by_class = {"fast": _samples(tcm, seed=1), "slow": _samples(tcm, seed=2, b=6e-9)}
    jby_class = {"fast": _samples(jcm, seed=1), "slow": _samples(jcm, seed=2, b=6e-9)}
    got_c = tcm.fit_cost_model_per_class(by_class)
    want_c = jcm.fit_cost_model_per_class(jby_class)
    assert sorted(got_c) == sorted(want_c) == ["fast", "slow"]
    for cls in got_c:
        for f in ("a", "b", "p", "r2"):
            assert _rel(getattr(got_c[cls], f), getattr(want_c[cls], f)) <= FIT_GATE, (cls, f)
    assert tcm.correlation_report(_samples(tcm), 2.0) == jcm.correlation_report(
        _samples(jcm), 2.0)
    # a fit serialised by either package loads in the other
    assert jcm.CostModel.from_json(got.to_json()) == want
    assert tcm.CostModel.from_json(want.to_json()) == got


def test_cost_model_predictions_match_reference():
    kw = dict(a=0.01, b=2e-9, p=1.9, r2=0.97, n_samples=9, comm_scale=0.0)
    tm, jm = tcm.CostModel(**kw), jcm.CostModel(**kw)
    lengths = [700, 1500, 30, 4000]
    assert tm.predict(3, 2048) == jm.predict(3, 2048)
    assert tm.predict_packed(2, lengths) == jm.predict_packed(2, lengths)
    assert tm.m_comp_for_target(0.5) == jm.m_comp_for_target(0.5)
    assert tcm.packed_load(lengths, 2.0) == jcm.packed_load(lengths, 2.0)
    for k in (1, 2, 4):
        assert tcm.split_load(lengths, 1.9, k, comm_scale=3.0) == jcm.split_load(
            lengths, 1.9, k, comm_scale=3.0)
    # the ring's comm weight from split-shard records
    recs_t = [tt.WorkerStepRecord(0, w, 1, 2048, 0.05 + 1e-3 * w, ring_ranks=4) for w in range(4)]
    recs_j = [jt.WorkerStepRecord(0, w, 1, 2048, 0.05 + 1e-3 * w, ring_ranks=4) for w in range(4)]
    got, want = tm.fit_comm_scale(recs_t), jm.fit_comm_scale(recs_j)
    assert got.comm_scale == want.comm_scale > 0
    assert got.predict_split(2, lengths, 4) == want.predict_split(2, lengths, 4)
    pb_t = tpk.packed_bucket_pool(lengths, window=8192, p=1.9)[0]
    pb_j = jpk.packed_bucket_pool(lengths, window=8192, p=1.9)[0]
    assert tm.load_of(pb_t) == jm.load_of(pb_j)
    assert tm.load_of(_buckets(tbk)[2]) == jm.load_of(_buckets(jbk)[2])


# -- telemetry -----------------------------------------------------------------------


def _telemetry(mod):
    """Four workers over three shapes for 12 steps, worker 2 at 1.5x, plus
    data waits and a few split-shard records."""
    rng = np.random.default_rng(5)
    buf = mod.TelemetryBuffer()
    shapes = [(10, 1637), (2, 4757), (1, 7877)]
    for step in range(12):
        for w in range(4):
            for bs, s in shapes:
                t = (0.01 + 2e-9 * bs * s**2) * float(rng.lognormal(0.0, 0.03))
                buf.add(mod.WorkerStepRecord(step, w, bs, s, t * (1.5 if w == 2 else 1.0),
                                             data_wait=0.001 * w, comm_time=0.0005))
        buf.add(mod.WorkerStepRecord(step, step % 4, 1, 2048, 0.03, ring_ranks=4))
    return buf


def test_telemetry_matches_reference():
    got, want = _telemetry(tt), _telemetry(jt)
    assert len(got) == len(want)
    assert got.straggler_workers() == want.straggler_workers() == [2]
    speeds = got.worker_speeds()
    assert speeds == want.worker_speeds() and speeds[2] < 0.75 < min(speeds[0], speeds[1])
    assert got.bottleneck().__dict__ == want.bottleneck().__dict__
    assert [s.__dict__ for s in got.bench_samples()] == [s.__dict__ for s in want.bench_samples()]
    assert [r.__dict__ for r in got.split_records()] == [r.__dict__ for r in
                                                          want.split_records()]
    assert got.wait_sync(3) == want.wait_sync(3)
    by_t, by_j = got.bench_samples_by_worker(), want.bench_samples_by_worker()
    assert {w: [s.__dict__ for s in v] for w, v in by_t.items()} == \
        {w: [s.__dict__ for s in v] for w, v in by_j.items()}


# -- the planner ---------------------------------------------------------------------


def _packed_pool(mod):
    lengths = lm_length_corpus(np.random.default_rng(11), 240)
    return mod.packed_bucket_pool(lengths, window=8192, p=2.0)


def _planner(dispatch, pkg, config):
    """The planner of one case, built in the package ``pkg`` (``dispatch``,
    ``bucketing`` and ``packing`` modules)."""
    dmod, bmod, pmod = pkg
    kw = dict(n_workers=4, strategy=config.get("strategy", "lpt"), seed=7)
    if config.get("packed"):
        pool = _packed_pool(pmod)
        mean = float(np.mean([b.load(2.0) for b in pool]))
        return dmod.StepPlanner(
            pool, None, budget=3 * mean, budget_of=lambda b: b.load(2.0),
            sp_max_ranks=4, **kw,
            split_load_of=lambda b, k: pmod.packed_load(b.lengths, 2.0) / k + 64.0 * b.tokens,
        )
    return dmod.StepPlanner(
        _buckets(bmod), WEIGHTS, budget=3 * 2e8, budget_of=lambda b: b.load(2.0),
        capacities=config.get("capacities"), overlap=config.get("overlap", False),
        deterministic_refine=config.get("deterministic", False),
        refine_rounds=config.get("rounds", 16), **kw,
    )


PLANNER_CASES = {
    "random": {"strategy": "random"},
    "lpt": {"strategy": "lpt"},
    "knapsack": {"strategy": "knapsack"},
    "lpt_capacities": {"strategy": "lpt", "capacities": [1.0, 0.5, 1.5, 1.0]},
    "knapsack_capacities": {"strategy": "knapsack", "capacities": [0.7, 1.3, 1.0, 1.0]},
    "knapsack_deterministic_refine": {"strategy": "knapsack", "overlap": True,
                                      "deterministic": True, "rounds": 8},
    "lpt_sp4_packed": {"strategy": "lpt", "packed": True},
    "knapsack_sp4_packed": {"strategy": "knapsack", "packed": True},
    "random_sp4_packed": {"strategy": "random", "packed": True},
}
PORT = (td, tbk, tpk)
REFERENCE = (jd, jbk, jpk)


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_planner_digests_match_reference(case):
    config = PLANNER_CASES[case]
    ours, ref = _planner(case, PORT, config), _planner(case, REFERENCE, config)
    splits = 0
    try:
        for _ in range(20):
            if config.get("overlap"):
                (seed_t, ticket_t), (seed_j, ticket_j) = ours.plan_async(), ref.plan_async()
                assert seed_t.digest() == seed_j.digest()
                got, want = ticket_t.best(), ticket_j.best()
            else:
                got, want = ours.plan(), ref.plan()
            assert got.digest() == want.digest()
            assert got.assignments == want.assignments and got.loads == want.loads
            assert got.compute_cv() == want.compute_cv()
            splits += any(isinstance(b, td.SplitShard) for b in got.microbatches)
        assert ours.plan_count == ref.plan_count == 20
    finally:
        ours.close()
        ref.close()
    if config.get("packed") and config["strategy"] != "random":
        assert splits > 0, "no plan split a window: the case does not cover SP"


def test_planner_state_round_trips_between_packages():
    ours = _planner("knapsack", PORT, {"strategy": "knapsack"})
    ref = _planner("knapsack", REFERENCE, {"strategy": "knapsack"})
    for _ in range(3):
        ours.plan()
    # the port's state, through JSON, continues the reference's planner and back
    ref.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    assert [ours.plan().digest() for _ in range(4)] == [ref.plan().digest() for _ in range(4)]
    ours.load_state_dict(json.loads(json.dumps(ref.state_dict())))
    assert ours.plan().digest() == ref.plan().digest()
    ours.update(n_workers=3, strategy="lpt")
    ref.update(n_workers=3, strategy="lpt")
    assert ours.plan().digest() == ref.plan().digest()


@pytest.mark.parametrize("fn", ["assign_pool", "refine_swaps", "refine_fixed_rounds",
                                "partition_contiguous"])
def test_dispatch_primitives_match_reference(fn):
    rng = np.random.default_rng(4)
    loads = list(rng.lognormal(0.0, 1.2, 31))
    caps = [1.0, 0.6, 1.4, 1.0, 0.9]
    results = []
    for mod in (td, jd):
        if fn == "assign_pool":
            results.append([mod.assign_pool(loads, 5, s, np.random.default_rng(1), c)
                            for s in ("random", "lpt", "knapsack") for c in (None, caps)])
        elif fn == "refine_swaps":
            seed = mod.assign_lpt(loads, 5)
            results.append([mod.refine_swaps(loads, seed, capacities=caps),
                            mod.refine_swaps(loads, seed, locked=frozenset({0, 3}))])
        elif fn == "refine_fixed_rounds":
            seed = mod.assign_lpt(loads, 5)
            results.append(mod.refine_fixed_rounds(loads, seed, rounds=12,
                                                   seed_bytes=b"\x07" * 32,
                                                   capacities=caps))
        else:
            results.append([mod.partition_contiguous(loads[:9], 3),
                            mod.partition_contiguous(loads[:9], 4, caps[:4])])
    assert results[0] == results[1]


def test_group_and_merge_worker_steps_match_reference():
    rng = np.random.default_rng(2)
    shares = [[(tbk.Bucket(tbk.DataShape(1, 64, 64), int(b)), {"i": i}) for i, b in
               enumerate(rng.integers(1, 9, n))] for n in (3, 1, 4, 2, 2)]
    jshares = [[(jbk.Bucket(jbk.DataShape(1, 64, 64), b.batch_size), x) for b, x in share]
               for share in shares]

    def keys(ws, mod):
        return [[(mod.microbatch_key(b), x["i"]) for b, x in share] for share in ws]

    for n, caps in [(2, None), (3, [1.0, 0.5, 1.5]), (5, None)]:
        assert keys(td.group_worker_steps(shares, n, caps), td) == keys(
            jd.group_worker_steps(jshares, n, caps), jd)
    # a window split over ranks 1-2 merges back at shard 0's position
    lengths = [900, 700, 300, 100]
    base_t = tpk.packed_bucket_pool(lengths, window=2048, batch_windows=1)[0]
    base_j = jpk.packed_bucket_pool(lengths, window=2048, batch_windows=1)[0]
    whole = {"tokens": rng.integers(0, 99, (1, 2048)).astype(np.int32),
             "segment_ids": tpk.segment_id_batch(base_t.windows, 2048)}
    shards = tpk.split_packed_batch(whole, 2)
    other = tbk.Bucket(tbk.DataShape(1, 64, 64), 3)

    def fan_out(dmod, base, bucket):
        sh = [dmod.SplitShard(base=base, n_ranks=2, shard=s, rank_load=1.0) for s in (0, 1)]
        return [[(bucket, {"tokens": np.zeros((3, 8), np.int32)})], [(sh[0], shards[0])],
                [(sh[1], shards[1]), (bucket, {"tokens": np.ones((3, 8), np.int32)})]]

    got = td.merge_split_worker_steps(fan_out(td, base_t, other))
    want = jd.merge_split_worker_steps(fan_out(jd, base_j, jbk.Bucket(jbk.DataShape(1, 64, 64),
                                                                      3)))
    assert [[td.microbatch_key(b) for b, _ in s] for s in got] == \
        [[jd.microbatch_key(b) for b, _ in s] for s in want]
    for gs, ws in zip(got, want):
        for (_, gb), (_, wb) in zip(gs, ws):
            assert set(gb) == set(wb) and all(np.array_equal(gb[k], wb[k]) for k in wb)
    merged = got[1][0][1]
    assert np.array_equal(merged["tokens"], whole["tokens"]) and "positions" not in merged


# -- simulators ----------------------------------------------------------------------


def _simulate(kind, sim, bk, cm):
    buckets = _buckets(bk)
    sampler = sim.CorpusSampler(buckets, WEIGHTS)
    model = cm.CostModel(a=0.01, b=2e-9, p=2.0, r2=1.0)
    kw = dict(seed=3, straggler_worker=1, straggler_slowdown=1.3)
    if kind == "simulate":
        res = sim.simulate(sampler, 8, 30, model.predict, **kw)
    elif kind == "packed":
        res = sim.simulate_packed(sampler, 8, 20, model.predict, budget=3 * 2e8,
                                  budget_of=lambda b: b.load(2.0), **kw)
    else:
        res = sim.simulate_planned(sampler, 8, 20, model.predict, budget=3 * 2e8,
                                   budget_of=lambda b: b.load(2.0), strategy=kind, **kw)
    return res.summary(), [m.__dict__ for m in res.metrics]


@pytest.mark.parametrize("kind", ["simulate", "packed", "random", "lpt", "knapsack"])
def test_simulators_match_reference(kind):
    got = _simulate(kind, tsim, tbk, tcm)
    want = _simulate(kind, jsim, jbk, jcm)
    assert got == want


# -- packing ---------------------------------------------------------------------------


@pytest.mark.parametrize("budgeted", [False, True])
def test_packing_matches_reference(budgeted):
    lengths = lm_length_corpus(np.random.default_rng(8), 300)
    kw = dict(window=8192, p=2.0, load_budget=2.5e7 if budgeted else None)
    got, want = tpk.pack_documents(lengths, **kw), jpk.pack_documents(lengths, **kw)
    assert [w.__dict__ for w in got] == [w.__dict__ for w in want]
    assert tpk.packing_efficiency(got, 8192) == jpk.packing_efficiency(want, 8192)
    assert tpk.load_cv(got) == jpk.load_cv(want)
    pool_t = tpk.packed_bucket_pool(lengths, batch_windows=2, **kw)
    pool_j = jpk.packed_bucket_pool(lengths, batch_windows=2, **kw)
    assert [b.digest_key() for b in pool_t] == [b.digest_key() for b in pool_j]
    assert [b.load(1.9) for b in pool_t] == [b.load(1.9) for b in pool_j]
    assert [(b.tokens, b.batch_size, b.seq_len) for b in pool_t] == \
        [(b.tokens, b.batch_size, b.seq_len) for b in pool_j]


def test_device_classes_are_the_reference_table():
    """The unitless class ratios stay the reference's, so capacity vectors
    and scheduler state are interchangeable between the packages."""
    assert tsch.DEVICE_CLASSES == jsch.DEVICE_CLASSES
    classes = ["v5p", "v5e", "v6e", "v5p"]
    assert tsch.capacities_from_classes(classes) == jsch.capacities_from_classes(classes)
    shapes, weights = wan_mixed_corpus()
    assert len(shapes) == len(weights)
