"""Packed dense-LM training and its sequence-parallel (SP) split step in the
port, against the JAX package on the CPU, at the smoke size of
llama3.2-1b (2 layers, d 64, 4 heads of 16 over 1 kv head, f32):

* the packing data path (``split_packed_batch``, the document-relative
  positions, ``materialize_packed_windows``, ``make_packed_batch``,
  ``lm_length_corpus``), exactly;
* ``lm_loss`` of packed windows with segment ids (padding -1 included)
  and every gradient, and 3 ``Trainer`` steps on packed windows;
* the launcher's dense route and its default architecture (tinyllama);
* ``make_sp_pool_grad_step`` on a ``LocalRing`` (k 4) and on a
  ``ProcessRing`` (2 gloo processes) against the JAX
  ``make_sp_pool_grad_step`` under ``shard_map``, built as
  ``PlanExecutor._sp_step`` builds it (plan_exec.py:477-497), and against
  the port's unsplit step on the merged window;
* the refusals: SP on a Mamba-2 model, SP without global positions.

Every comparison is rel-L2 <= 1e-5 (the oracle gate of the JAX package's
engine tests).  The gloo ranks are this file run as a script:

    PYTHONPATH=src python tests/test_torch_dense_train.py --rank R --world K \\
        --store PATH --out PATH
"""

import argparse
import dataclasses
import datetime
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import llama3_2_1b as torch_llama
from repro_torch.configs import mamba2_2_7b as torch_mamba
from repro_torch.configs import registry
from repro_torch.convert import from_jax_opt_state, from_jax_params, to_numpy
from repro_torch.core import bucketing
from repro_torch.data import packing
from repro_torch.data.pipeline import make_packed_batch, materialize_packed_windows, to_device
from repro_torch.data.synthetic import lm_length_corpus
from repro_torch.kernels.flash_attention.ring import LocalRing, ProcessRing
from repro_torch.models import transformer as T
from repro_torch.models.layers import segment_relative_positions
from repro_torch.train.steps import (
    make_pool_grad_step,
    make_sp_loss_fn,
    make_sp_pool_grad_step,
    sp_batch,
)

if __name__ != "__main__":  # the gloo rank processes need no JAX
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.configs import llama3_2_1b as jax_llama
    from repro.configs import tinyllama_1_1b as jax_tinyllama
    from repro.core import bucketing as jax_bucketing
    from repro.data import packing as jax_packing
    from repro.data import pipeline as jax_pipeline
    from repro.data.synthetic import lm_length_corpus as jax_lm_length_corpus
    from repro.models import transformer as JT
    from repro.models.attention import segment_relative_positions as jax_positions
    from repro.optim import adamw as jax_adamw
    from repro.train import steps as JS
    from repro.train.loop import Trainer as JaxTrainer
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.train.engine import EmulatedEngine
    from repro_torch.train.loop import Trainer

GATE = 1e-5
DOCS = [200, 150, 100, 300, 120, 60]  # FFD into 512: [300, 200] and [150, 120, 100, 60]
WINDOW = 512


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


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
    want = dict(_leaves(jax.tree.map(np.asarray, jax_tree)))
    got = dict(_leaves(port_tree))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= gate, (k, _rel(got[k], want[k]))


def _window_batch() -> dict:
    """Two packed windows of 512 with -1 tails (numpy arrays)."""
    mb = materialize_packed_windows(DOCS, window=WINDOW, vocab=256, batch_windows=2, seed=3)[0]
    return {k: mb[k] for k in ("tokens", "labels", "segment_ids")}


# -- data ------------------------------------------------------------------------------


def test_packing_and_corpus_match_jax_exactly():
    a = lm_length_corpus(np.random.default_rng(7), 500)
    b = jax_lm_length_corpus(np.random.default_rng(7), 500)
    assert np.array_equal(a, b) and a.min() >= 64 and a.max() <= 8192
    kw = dict(window=8192, vocab=300, batch_windows=2, seed=4)
    got = materialize_packed_windows(a[:60], **kw)
    want = jax_pipeline.materialize_packed_windows(a[:60], **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("tokens", "labels", "segment_ids"):
            assert np.array_equal(g[key], w[key]), key
        assert [(x.doc_ids, x.tokens, x.lengths) for x in g["windows"]] == \
            [(x.doc_ids, x.tokens, x.lengths) for x in w["windows"]]
    windows = packing.pack_documents(DOCS, window=WINDOW)
    bucket = packing.PackedBucket(tuple(windows), WINDOW)
    jbucket = jax_packing.PackedBucket(tuple(jax_packing.pack_documents(DOCS, window=WINDOW)),
                                       WINDOW)
    assert (bucket.tokens, bucket.lengths) == (jbucket.tokens, jbucket.lengths)
    got = make_packed_batch(np.random.default_rng(1), bucket, vocab=99)
    want = jax_pipeline.make_packed_batch(np.random.default_rng(1), jbucket, vocab=99)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_labels_are_neutralised_at_padding_and_document_ends():
    batch = _window_batch()
    seg, lab, tok = batch["segment_ids"], batch["labels"], batch["tokens"]
    assert (lab[seg < 0] == 0).all() and (tok[seg < 0] == 0).all() and (lab[:, -1] == 0).all()
    ends = np.zeros_like(seg, dtype=bool)
    ends[:, :-1] = seg[:, :-1] != seg[:, 1:]
    assert (lab[ends] == 0).all()
    inner = ~ends & (seg >= 0)
    inner[:, -1] = False
    assert np.array_equal(lab[:, :-1][inner[:, :-1]], tok[:, 1:][inner[:, :-1]])


def test_split_and_positions_match_jax_exactly():
    batch = _window_batch()
    for k in (2, 4):
        got = packing.split_packed_batch(batch, k)
        want = jax_packing.split_packed_batch(batch, k)
        assert len(got) == len(want) == k
        for g, w in zip(got, want):
            assert set(g) == set(w) and all(np.array_equal(g[n], w[n]) for n in w)
    with pytest.raises(ValueError, match="not divisible"):
        packing.split_packed_batch(batch, 3)
    seg = np.array([[0, 0, 0, 1, 1, 2, -1, -1], [5, 5, 5, 5, 5, 5, 5, 5]], np.int32)
    want = np.asarray(jax_positions(jnp.asarray(seg)))
    assert np.array_equal(segment_relative_positions(torch.from_numpy(seg)).numpy(), want)
    assert np.array_equal(packing.segment_relative_positions_np(seg), want)


# -- configuration and launcher --------------------------------------------------------


def test_tinyllama_registry_matches_jax_and_is_the_launcher_default():
    assert dataclasses.asdict(registry.get_config("tinyllama-1.1b")) == \
        dataclasses.asdict(jax_tinyllama.config())
    assert dataclasses.asdict(registry.get_smoke_config("tinyllama-1.1b")) == \
        dataclasses.asdict(jax_tinyllama.smoke_config())
    assert dataclasses.asdict(registry.get_optimizer("tinyllama-1.1b")) == \
        dataclasses.asdict(jax_tinyllama.optimizer())
    hist = launch_train.main(["--smoke", "--device", "cpu", "--adaptive", "--steps", "2"])
    assert len(hist.losses) == 2 and np.isfinite(hist.losses).all()


def test_launch_train_dense_route_on_cpu(capsys):
    hist = launch_train.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                              "--steps", "2"])
    assert hist.tokens == [512, 512] and np.isfinite(hist.losses).all()
    assert "final loss" in capsys.readouterr().out
    # the reference launcher's checks: --sp-max-ranks > 1 needs --workers > 1,
    # and --workers > 1 needs --adaptive; --mesh is not a flag of the port yet
    for flag in (["--sp-max-ranks", "2"], ["--workers", "2"], ["--mesh", "2x2"]):
        with pytest.raises(SystemExit):
            launch_train.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", *flag])


# -- the dense LM against JAX ------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    """The smoke llama's JAX parameters and the port's model carrying them."""
    cfg, jcfg = torch_llama.smoke_config(), jax_llama.smoke_config()
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return cfg, jcfg, params, model


def test_packed_lm_loss_and_every_gradient_match_jax(lm):
    cfg, jcfg, params, model = lm
    batch = _window_batch()
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, *(jnp.asarray(batch[k]) for k in ("tokens", "labels")),
                             segment_ids=jnp.asarray(batch["segment_ids"])))(params)
    t = to_device(batch, "cpu")
    model.zero_grad(set_to_none=True)
    loss = T.lm_loss(model, t["tokens"], t["labels"], segment_ids=t["segment_ids"])
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= GATE * abs(float(jloss))
    grads = {n: p.grad for n, p in model.named_parameters()}
    _assert_trees_close(to_numpy(grads, cfg), jgrads)
    # the ids matter: without them the loss differs
    unscoped = T.lm_loss(model, t["tokens"], t["labels"])
    assert abs(unscoped.item() - loss.item()) > 1e-3 * abs(loss.item())


def test_trainer_three_packed_steps_match_jax(lm):
    cfg, jcfg, params, _ = lm
    opt = adamw.OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=3)
    jopt = jax_adamw.OptimizerConfig(**dataclasses.asdict(opt))
    lengths = lm_length_corpus(np.random.default_rng(2), 12, lo=16, hi=200)
    mbs = materialize_packed_windows(lengths, window=256, vocab=cfg.vocab, seed=5)
    steps_np = [[mbs[0], mbs[1]], [mbs[2]], [mbs[3], mbs[0]]]

    def stream(mod, to_array):
        return iter([[(mod.Bucket(mod.DataShape(1, 16, 16), 1),
                       {k: to_array(mb[k]) for k in ("tokens", "labels", "segment_ids")})
                      for mb in step] for step in steps_np])

    jstate = JS.init_state(jax.random.PRNGKey(0), jcfg, jopt)
    params0 = jax.tree.map(np.asarray, jstate["params"])
    opt0 = jax.tree.map(np.asarray, jstate["opt"])
    jstate, jhist = JaxTrainer(jcfg, jopt, donate=False).run(
        jstate, stream(jax_bucketing, jnp.asarray), 3, rng=jax.random.PRNGKey(5), log_every=0)

    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params0, cfg, device="cpu"))
    state = {"model": model, "opt": from_jax_opt_state(opt0, cfg, device="cpu"), "step": 0}
    state, hist = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt)).run(
        state, stream(bucketing, torch.from_numpy), 3, rng=5, log_every=0)

    assert state["step"] == int(jstate["step"]) == 3 and hist.microbatches == [2, 1, 2]
    np.testing.assert_allclose(hist.losses, jhist.losses, rtol=GATE)
    _assert_trees_close(to_numpy(dict(model.named_parameters()), cfg), jstate["params"])
    _assert_trees_close(to_numpy(state["opt"]["m"], cfg), jstate["opt"]["m"])


# -- the sequence-parallel step ----------------------------------------------------------


def _jax_sp_step(jcfg, params, shards_batch: dict, k: int, step_key: int, pool_index: int):
    """The reference's SP step as ``PlanExecutor._sp_step`` builds it: a
    ("data", "seq") sub-mesh of k devices, the batch sharded on "seq"."""
    mesh = Mesh(np.array(jax.devices()[:k]).reshape(1, k), ("data", "seq"))
    sp = JS.make_sp_pool_grad_step(jcfg)

    def body(params, tokens, labels, seg, pos, key, idx):
        batch = {"tokens": tokens, "labels": labels, "segment_ids": seg, "positions": pos}
        return sp(params, batch, key, idx)

    fn = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=(P(),) + (P(None, "seq"),) * 4 + (P(), P()),
                           out_specs=(P(), P()), check_rep=False))
    full = {n: np.concatenate([sh[n] for sh in shards_batch], axis=1) for n in shards_batch[0]}
    return fn(params, *(jnp.asarray(full[n]) for n in ("tokens", "labels", "segment_ids",
                                                      "positions")),
              jax.random.PRNGKey(step_key), jnp.int32(pool_index))


def test_sp_step_on_a_local_ring_matches_jax_and_the_unsplit_step(lm):
    cfg, jcfg, params, model = lm
    batch = _window_batch()
    shards = packing.split_packed_batch(batch, 4)
    group = LocalRing(4)
    loss, grads = make_sp_pool_grad_step(cfg, group)(model, sp_batch(shards, group, "cpu"), 3, 1)
    jloss, jgrads = _jax_sp_step(jcfg, params, shards, 4, 3, 1)
    assert abs(loss.item() - float(jloss)) <= GATE * abs(float(jloss))
    _assert_trees_close(to_numpy(grads, cfg), jgrads)
    uloss, ugrads = make_pool_grad_step(cfg)(model, to_device(batch, "cpu"), 3, 1)
    assert abs(loss.item() - uloss.item()) <= GATE * abs(uloss.item())
    for n, g in ugrads.items():
        assert _rel(grads[n], g) <= GATE, n
    # a live table per microbatch: the causal ring skips the upper blocks
    ids = sp_batch(shards, group, "cpu")["segment_ids"]
    assert not group.table(ids, ids, True)[1:, 0].any()


SP_WORLD, SP_SEED = 2, 0


def _sp_rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One gloo rank of the SP step: the seed-``SP_SEED`` model, this rank's
    shard; saves the (ring-mean) loss and gradients."""
    import torch.distributed as dist

    torch.set_num_threads(1)  # k ranks share the machine's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        cfg = torch_llama.smoke_config()
        model = T.Transformer(cfg, seed=SP_SEED, device="cpu")
        group = ProcessRing(world)
        shards = packing.split_packed_batch(_window_batch(), world)
        loss, grads = make_sp_pool_grad_step(cfg, group)(
            model, sp_batch(shards, group, "cpu"), 3, 1)
        np.savez(out, loss=loss.numpy(), **{n: g.numpy() for n, g in grads.items()})
    finally:
        dist.destroy_process_group()


def test_sp_step_on_a_process_ring_matches_jax(tmp_path):
    from test_torch_ring import spawn_ranks

    ranks = spawn_ranks(pathlib.Path(__file__), SP_WORLD, tmp_path)
    cfg, jcfg = torch_llama.smoke_config(), jax_llama.smoke_config()
    model = T.Transformer(cfg, seed=SP_SEED, device="cpu")
    params = jax.tree.map(jnp.asarray, to_numpy(dict(model.named_parameters()), cfg))
    shards = packing.split_packed_batch(_window_batch(), SP_WORLD)
    jloss, jgrads = _jax_sp_step(jcfg, params, shards, SP_WORLD, 3, 1)
    for r in ranks:  # every rank holds the ring's mean
        assert abs(float(r["loss"]) - float(jloss)) <= GATE * abs(float(jloss))
        grads = {n: torch.from_numpy(r[n]) for n in r.files if n != "loss"}
        _assert_trees_close(to_numpy(grads, cfg), jgrads)
    assert all(np.array_equal(ranks[0][n], ranks[1][n]) for n in ranks[0].files)


def test_sp_refusals(lm):
    cfg, _, _, model = lm
    with pytest.raises(ValueError, match="dense transformer LM path only"):
        make_sp_loss_fn(torch_mamba.smoke_config(), LocalRing(2))
    shards = packing.split_packed_batch(_window_batch(), 2)
    b = sp_batch(shards, LocalRing(2), "cpu")
    with pytest.raises(ValueError, match="globally computed positions"):
        T.lm_loss(model, b["tokens"], b["labels"], segment_ids=b["segment_ids"],
                  seq_group=LocalRing(2))
    mamba = T.Transformer(torch_mamba.smoke_config(), device="cpu")
    with pytest.raises(ValueError, match="does not support 'ssm' blocks"):
        T.lm_loss(mamba, b["tokens"], b["labels"], segment_ids=b["segment_ids"],
                  positions=b["positions"], seq_group=LocalRing(2))
    with pytest.raises(ValueError, match="shards for a ring of 4"):
        sp_batch(shards, LocalRing(4), "cpu")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one gloo rank of the SP step test")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _sp_rank_main(a.rank, a.world, a.store, a.out)
