"""K11, ring segment-aware attention over k sequence shards, on the CPU: the
port's plain ring (``repro_torch.kernels.flash_attention.ring``) against
the JAX package's ring under ``shard_map`` on forced host devices (the
conftest sets four): ``ring_attention_ref`` at dh 64 and 16, and the Pallas
``ring_flash_attention`` in interpret mode at dh 128 (which it needs);
the plain merge against the reference's ``_merge``; the ring against the
port's unsplit attention on the gathered window; the live table against
the reference's skip predicate; and ``ProcessRing`` (one rank per gloo
process) against ``LocalRing`` (all ranks in one process), bitwise.

Gates: rel-L2 <= 1e-5 in f32 (the reference's own ring gate,
tests/test_ring_attention.py) and 1e-3 in bf16 (its bf16 gate).

The gloo ranks are this file run as a script:

    PYTHONPATH=src python tests/test_torch_ring.py --rank R --world K \\
        --store PATH --out PATH
"""

import argparse
import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ring as R
from repro_torch.kernels.flash_attention.ops import attention as window_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF

if __name__ != "__main__":  # the gloo rank processes need no JAX
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.kernels.flash_attention import ring as JR

ROOT = pathlib.Path(__file__).resolve().parent.parent
GATE = {"f32": 1e-5, "bf16": 1e-3}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _segments(s: int, lengths) -> np.ndarray:
    """[1, s] int32: document i over lengths[i] slots, then a -1 tail."""
    ids = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lengths)])
    return np.concatenate([ids, np.full(s - len(ids), -1, np.int32)])[None]


def _inputs(s, dh, hq=2, hkv=1, b=1, seed=0):
    """q, k, v, dy in the port's [B, S, H, dh] layout, f32 numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    dy = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    return q, k, v, dy


def _stack(x, k: int):
    """[B, S, ...] -> the k contiguous shards stacked rank-major: [k B, S/k, ...]."""
    return torch.cat(x.chunk(k, dim=1), dim=0)


def _unstack(x, k: int):
    return torch.cat(x.chunk(k, dim=0), dim=1)


def _port_ring(q, k, v, seg, dy, kranks, causal, dtype=torch.float32):
    """The port's ring on a LocalRing over the gathered window: (out, dq,
    dk, dv) as numpy in the [B, S, H, dh] layout."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    ids = _stack(torch.from_numpy(seg), kranks)
    out = R.ring_attention(*(_stack(t, kranks) for t in leaves), ids, ids,
                           group=R.LocalRing(kranks), causal=causal)
    out = _unstack(out, kranks)
    grads = torch.autograd.grad((out.float() * torch.from_numpy(dy)).sum(), leaves)
    return [_np(out)] + [_np(g) for g in grads]


def _jax_ring(q, k, v, seg, dy, kranks, causal, dtype, *, pallas: bool):
    """The reference's ring under shard_map: (out, dq, dk, dv), port layout."""
    mesh = Mesh(np.array(jax.devices()[:kranks]), ("seq",))
    if pallas:
        def ring_fn(q_, k_, v_, qs, kvs):
            return JR.ring_flash_attention(q_, k_, v_, qs, kvs, axis_name="seq",
                                           causal=causal, interpret=True)
    else:
        def ring_fn(q_, k_, v_, qs, kvs):
            return JR.ring_attention_ref(q_, k_, v_, qs, kvs, axis_name="seq", causal=causal)
    sharded = shard_map(
        ring_fn, mesh=mesh,
        in_specs=(P(None, None, "seq", None),) * 3 + (P(None, "seq"),) * 2,
        out_specs=P(None, None, "seq", None), check_rep=False,
    )
    seg_j = jnp.asarray(seg)
    dy_j = jnp.asarray(dy.transpose(0, 2, 1, 3))

    def loss(q_, k_, v_):
        out = sharded(q_, k_, v_, seg_j, seg_j)
        return jnp.sum(out.astype(jnp.float32) * dy_j), out

    args = [jnp.asarray(a.transpose(0, 2, 1, 3), dtype) for a in (q, k, v)]
    grads, out = jax.jit(jax.grad(loss, (0, 1, 2), has_aux=True))(*args)
    return [np.asarray(t.astype(jnp.float32)).transpose(0, 2, 1, 3) for t in (out, *grads)]


# (k, S, document lengths, causal): the reference's ring cases
# (tests/test_ring_attention.py:95-100), each with a ragged -1 tail
CASES = [
    (2, 512, [300, 150, 62], True),
    (2, 512, [300, 150, 50], False),
    (4, 1024, [700, 200, 100], True),
    (4, 1024, [500, 24], True),
]


@pytest.mark.parametrize("kranks,s,lengths,causal", CASES)
def test_plain_ring_matches_jax_ref_ring_dh64(kranks, s, lengths, causal):
    q, k, v, dy = _inputs(s, 64)
    seg = _segments(s, lengths)
    got = _port_ring(q, k, v, seg, dy, kranks, causal)
    want = _jax_ring(q, k, v, seg, dy, kranks, causal, jnp.float32, pallas=False)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= GATE["f32"], (name, _rel(a, b))


def test_plain_ring_matches_jax_ref_ring_dh16_gqa():
    """The smoke LM's head width (16) and a GQA group of 4."""
    q, k, v, dy = _inputs(512, 16, hq=4, hkv=1, seed=1)
    seg = _segments(512, [200, 200, 90])
    got = _port_ring(q, k, v, seg, dy, 4, True)
    want = _jax_ring(q, k, v, seg, dy, 4, True, jnp.float32, pallas=False)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= GATE["f32"], (name, _rel(a, b))


def test_plain_ring_matches_pallas_ring_dh128():
    """The Pallas ring (K7-K9 per hop, interpret mode), at the dh it takes."""
    kranks, s, lengths, causal = CASES[0]
    q, k, v, dy = _inputs(s, 128, seed=2)
    seg = _segments(s, lengths)
    got = _port_ring(q, k, v, seg, dy, kranks, causal)
    want = _jax_ring(q, k, v, seg, dy, kranks, causal, jnp.float32, pallas=True)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= GATE["f32"], (name, _rel(a, b))


def test_plain_ring_matches_jax_ref_ring_bf16():
    kranks, s, lengths, causal = CASES[0]
    q, k, v, dy = _inputs(s, 64, seed=3)
    seg = _segments(s, lengths)
    got = _port_ring(q, k, v, seg, dy, kranks, causal, torch.bfloat16)
    want = _jax_ring(q, k, v, seg, dy, kranks, causal, jnp.bfloat16, pallas=False)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= GATE["bf16"], (name, _rel(a, b))


# -- the merge ---------------------------------------------------------------------


def _states(seed=0, b=2, hq=3, sq=40, dh=32):
    """A running state, one hop's (o, lse) with some rows masked in the hop
    (o = 0, lse = -2e38) and some rows masked in every hop so far (m =
    -2e38, s = number of masked merges, num = 0), in the port's layouts."""
    rng = np.random.default_rng(seed)
    m = rng.normal(0, 3, (b, hq, sq)).astype(np.float32)
    s = rng.uniform(0.5, 4, (b, hq, sq)).astype(np.float32)
    num = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    o = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    lse = rng.normal(0, 3, (b, hq, sq)).astype(np.float32)
    dead_hop = rng.random((b, hq, sq)) < 0.25
    lse[dead_hop] = NEG_INF
    o.transpose(0, 2, 1, 3)[dead_hop] = 0.0
    dead_rows = rng.random((b, hq, sq)) < 0.25
    m[dead_rows] = NEG_INF
    s[dead_rows] = rng.integers(1, 4, int(dead_rows.sum()))
    num.transpose(0, 2, 1, 3)[dead_rows] = 0.0
    return m, s, num, o, lse


def test_plain_merge_matches_jax_merge():
    """Bitwise, or within 1e-7 of the largest value: torch's and XLA's exp
    on the CPU may differ in the last bit."""
    m, s, num, o, lse = _states()
    got = R.merge_ref(*(torch.from_numpy(a) for a in (m, s, num, o, lse)))
    # the reference's layout: statistics [B, H, S], rows [B, H, S, dh]
    want = JR._merge((jnp.asarray(m), jnp.asarray(s), jnp.asarray(num.transpose(0, 2, 1, 3))),
                     jnp.asarray(o.transpose(0, 2, 1, 3)), jnp.asarray(lse))
    want = [np.asarray(want[0]), np.asarray(want[1]), np.asarray(want[2]).transpose(0, 2, 1, 3)]
    for name, a, b in zip(("m", "s", "num"), got, want):
        a = a.numpy()
        assert np.isfinite(a).all(), name
        assert np.abs(a - b).max() <= 1e-7 * np.abs(b).max(), (name, np.abs(a - b).max())


def test_skipping_a_dead_hop_changes_nothing():
    """Merging the reference's skipped block (o = 0, lse = -2e38) and then
    finalising gives bitwise the output and lse of finalising without it:
    rows with a real block keep (m, s, num) exactly; rows masked so far only
    change s, which their output (0) and lse (-2e38 in f32) absorb."""
    m, s, num, _, _ = _states(seed=1)
    state = [torch.from_numpy(a) for a in (m, s, num)]
    zero_o = torch.zeros_like(state[2])
    dead_lse = torch.full_like(state[0], NEG_INF)
    merged = R.merge_ref(*state, zero_o, dead_lse)
    for a, b in zip(R.finalize_ref(*merged), R.finalize_ref(*state)):
        assert torch.equal(a, b)
    lse = R.finalize_ref(*state)[1]
    assert (lse[torch.from_numpy(m) == NEG_INF] == NEG_INF).all()


# -- the schedule ----------------------------------------------------------------------


@pytest.mark.parametrize("kranks,s,lengths,causal", [CASES[1], CASES[3]])
def test_ring_matches_the_unsplit_window(kranks, s, lengths, causal):
    """The identity the reference's docstring claims (ring.py:24-27): the
    ring over k shards equals the single-device attention on the gathered
    window, forward and backward (here the port's own, plain)."""
    q, k, v, dy = _inputs(s, 64, hq=4, hkv=2, b=2, seed=4)
    seg = np.concatenate([_segments(s, lengths), _segments(s, lengths[::-1])])
    got = _port_ring(q, k, v, seg, dy, kranks, causal)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ids = torch.from_numpy(seg)
    out = window_attention(*leaves, causal=causal, q_segment_ids=ids, kv_segment_ids=ids)
    grads = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), leaves)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, [out, *grads]):
        assert _rel(a, _np(b)) <= GATE["f32"], (name, _rel(a, _np(b)))


@pytest.mark.parametrize("causal", [True, False])
def test_live_table_is_the_reference_predicate(causal):
    """Each entry is the reference's skip decision at (hop t, rank r):
    ``_block_overlap(q shard r, kv shard (r - t) mod k)``, and ``my >= t``
    under causal; the diagonal always runs."""
    k, s = 4, 1024
    seg = np.concatenate([_segments(s, [700, 200, 100]), _segments(s, [100, 120, 300])])
    shards = np.split(seg, k, axis=1)
    group = R.LocalRing(k)
    ids = _stack(torch.from_numpy(seg), k)
    table = group.table(ids, ids, causal)
    assert group.table(ids, ids, causal) is table  # once per pair of id tensors
    for t in range(k):
        for r in range(k):
            src = (r - t) % k
            want = t == 0 or (bool(JR._block_overlap(jnp.asarray(shards[r]), jnp.asarray(shards[src])))
                              and (not causal or r >= t))
            assert table[t, r] == want, (t, r)


def test_shard_width_must_be_a_multiple_of_128():
    q = torch.zeros(2, 192, 2, 64)
    k = torch.zeros(2, 192, 1, 64)
    with pytest.raises(ValueError, match="multiple of 128"):
        R.ring_attention(q, k, k, group=R.LocalRing(2))
    with pytest.raises(ValueError, match="stacked along the batch"):
        R.ring_attention(torch.zeros(3, 128, 2, 64), torch.zeros(3, 128, 1, 64),
                         torch.zeros(3, 128, 1, 64), group=R.LocalRing(2))


# -- ProcessRing against LocalRing ----------------------------------------------------------

# each rank's inputs: dh 64, GQA 2, B 2, a ragged tail; both causal modes
PR_S, PR_CASES = 1024, ((True, 0), (False, 1))


def _pr_case(causal: bool, seed: int):
    q, k, v, dy = _inputs(PR_S, 64, hq=4, hkv=2, b=2, seed=10 + seed)
    seg = np.concatenate([_segments(PR_S, [300, 500, 100]), _segments(PR_S, [600, 124, 250])])
    return q, k, v, dy, seg


def _rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One gloo rank: the ring on this rank's shard for every case; saves
    out and the gradients of q, k and v (this rank's shard)."""
    import torch.distributed as dist

    torch.set_num_threads(1)  # k ranks share the machine's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        group = R.ProcessRing(world)
        res = {}
        for causal, seed in PR_CASES:
            q, k, v, dy, seg = _pr_case(causal, seed)
            mine = [torch.from_numpy(a).chunk(world, dim=1)[rank].contiguous()
                    for a in (q, k, v, dy, seg)]
            leaves = [t.requires_grad_() for t in mine[:3]]
            o = R.ring_attention(*leaves, mine[4], mine[4], group=group, causal=causal)
            grads = torch.autograd.grad((o * mine[3]).sum(), leaves)
            for name, t in zip(("out", "dq", "dk", "dv"), (o, *grads)):
                res[f"{name}_{int(causal)}"] = t.detach().numpy()
        with pytest.raises(ValueError, match="disagree on k"):
            R.ProcessRing(world + rank)  # rank 1 claims another ring size
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


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
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_process_ring_is_bitwise_the_local_ring(world, tmp_path):
    ranks = spawn_ranks(pathlib.Path(__file__), world, tmp_path)
    for causal, seed in PR_CASES:
        q, k, v, dy, seg = _pr_case(causal, seed)
        leaves = [_stack(torch.from_numpy(a), world).requires_grad_() for a in (q, k, v)]
        ids = _stack(torch.from_numpy(seg), world)
        o = R.ring_attention(*leaves, ids, ids, group=R.LocalRing(world), causal=causal)
        grads = torch.autograd.grad((o * _stack(torch.from_numpy(dy), world)).sum(), leaves)
        for name, t in zip(("out", "dq", "dk", "dv"), (o, *grads)):
            local = t.detach().chunk(world, dim=0)
            for r in range(world):
                got = ranks[r][f"{name}_{int(causal)}"]
                assert np.array_equal(got, local[r].numpy()), (name, causal, r)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one gloo rank of the ProcessRing test")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _rank_main(a.rank, a.world, a.store, a.out)
