"""The port's LM training route against the JAX package on the CPU, at the
smoke size of mamba2-2.7b (2 layers, d 64, d_inner 128, 8 SSD heads of
16, f32): the chunked softmax cross-entropy, the synthetic token stream, 3
``Trainer`` steps with AdamW against the JAX ``Trainer``, the step
functions, and the launcher's LM route.

Trajectories are held to rel-L2 <= 1e-5 over the whole tree (the oracle
gate of the JAX package's engine tests), and leaf by leaf, parameters and
first moments, within 1e-5, and 1e-4 for the SSM's ``A_log`` and
``dt_bias`` (sums that cancel, whose f32 rounding alone is about 1e-5:
``test_f32_gap_of_the_cancelling_leaves_is_rounding`` in
``tests/test_torch_ssm.py``).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import mamba2_2_7b as jax_mamba  # noqa: E402
from repro.core import bucketing as jax_bucketing  # noqa: E402
from repro.data.synthetic import make_lm_batch as jax_make_lm_batch  # noqa: E402
from repro.models.layers import chunked_softmax_xent as jax_xent  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.loop import Trainer as JaxTrainer  # noqa: E402
from repro.train.steps import init_state as jax_init_state  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs import mamba2_2_7b as torch_mamba  # noqa: E402
from repro_torch.convert import from_jax_opt_state, from_jax_params, to_numpy  # noqa: E402
from repro_torch.core import bucketing  # noqa: E402
from repro_torch.data.synthetic import make_lm_batch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import chunked_softmax_xent  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.engine import EmulatedEngine  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.steps import init_state, make_pool_grad_step, make_train_step  # noqa: E402

GATE = 1e-5
SLOW_LEAVES = ("A_log", "dt_bias")


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_trees_close(port_tree, jax_tree):
    want = dict(_leaves(jax.tree.map(np.asarray, jax_tree)))
    got = dict(_leaves(port_tree))
    assert set(got) == set(want)
    for k in want:
        gate = 1e-4 if k.rsplit(".", 1)[-1] in SLOW_LEAVES else GATE
        assert _rel(got[k], want[k]) <= gate, (k, _rel(got[k], want[k]))
    num = sum(float(((np.float64(got[k]) - want[k]) ** 2).sum()) for k in want)
    den = sum(float((np.float64(want[k]) ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= GATE


# -- configuration ------------------------------------------------------------------


def test_mamba_registry_and_optimizer_match_jax():
    assert registry.get_config("mamba2-2.7b") == torch_mamba.config()
    assert registry.get_smoke_config("mamba2-2.7b") == torch_mamba.smoke_config()
    assert dataclasses.asdict(registry.get_optimizer("mamba2-2.7b")) == dataclasses.asdict(
        jax_mamba.optimizer())


# -- loss ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 40)])
def test_chunked_softmax_xent_matches_jax(s, chunk):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    emb = (rng.standard_normal((100, 32)) * 0.5).astype(np.float32)
    lab = rng.integers(0, 100, (2, s)).astype(np.int32)
    loss_j, (gx_j, ge_j) = jax.value_and_grad(
        lambda a, e: jax_xent(a, e, jnp.asarray(lab), chunk=chunk), (0, 1))(
        jnp.asarray(x), jnp.asarray(emb))
    xt, et = torch.from_numpy(x).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    loss_t = chunked_softmax_xent(xt, et, torch.from_numpy(lab), chunk=chunk)
    loss_t.backward()
    assert loss_t.dtype == torch.float32
    assert abs(loss_t.item() - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    assert _rel(xt.grad, gx_j) <= GATE and _rel(et.grad, ge_j) <= GATE


def test_chunked_softmax_xent_takes_f32_logits_of_bf16_operands():
    """bf16 operands, f32 logits (the reference's preferred_element_type):
    no rounding to bf16 before the logsumexp."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 32, 64)).astype(np.float32)
    emb = rng.standard_normal((50, 64)).astype(np.float32)
    lab = rng.integers(0, 50, (1, 32)).astype(np.int32)
    want = jax_xent(jnp.asarray(x, jnp.bfloat16), jnp.asarray(emb, jnp.bfloat16),
                    jnp.asarray(lab), chunk=16)
    got = chunked_softmax_xent(torch.from_numpy(x).bfloat16(), torch.from_numpy(emb).bfloat16(),
                               torch.from_numpy(lab), chunk=16)
    assert got.dtype == torch.float32 and abs(got.item() - float(want)) <= 1e-5 * float(want)
    with pytest.raises(ValueError, match="not divisible"):
        chunked_softmax_xent(torch.zeros(1, 30, 4), torch.zeros(5, 4),
                             torch.zeros(1, 30, dtype=torch.int32), chunk=16)


# -- data -----------------------------------------------------------------------------


def test_make_lm_batch_follows_the_reference_construction():
    cfg = torch_mamba.smoke_config()
    a = make_lm_batch(3, 4, 512, 50_280, cfg, "cpu")
    b = make_lm_batch(3, 4, 512, 50_280, cfg, "cpu")
    c = make_lm_batch(4, 4, 512, 50_280, cfg, "cpu")
    tok = a["tokens"]
    assert tok.dtype == torch.int32 and tok.shape == (4, 512)
    assert torch.equal(a["labels"], torch.roll(tok, -1, dims=1))
    assert torch.equal(tok, b["tokens"]) and not torch.equal(tok, c["tokens"])
    assert int(tok.min()) >= 0 and int(tok.max()) < 50_280
    # a token repeats its predecessor when it took base[t-1] and the
    # predecessor did not: 1/4 of the time, as in the reference's stream
    jt = np.asarray(jax_make_lm_batch(jax.random.PRNGKey(0), 4, 512, 50_280)["tokens"])
    for t in (tok.numpy(), jt):
        rep = float((t[:, 1:] == t[:, :-1]).mean())
        assert 0.2 < rep < 0.3, rep


# -- steps and the trainer ----------------------------------------------------------


def _lm_steps(rng, specs, vocab):
    out = []
    for step in specs:
        micro = []
        for b, s in step:
            tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
            micro.append({"tokens": tok, "labels": np.roll(tok, -1, axis=1)})
        out.append(micro)
    return out


def test_trainer_three_steps_match_jax():
    cfg, jcfg = torch_mamba.smoke_config(), jax_mamba.smoke_config()
    opt = adamw.OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=3)
    jopt = jax_adamw.OptimizerConfig(**dataclasses.asdict(opt))
    # S 40 is not a multiple of the SSD chunk (16): the mixer pads
    specs = [[(2, 32), (1, 48)], [(1, 48)], [(2, 40), (2, 32)]]
    steps_np = _lm_steps(np.random.default_rng(0), specs, cfg.vocab)

    def stream(mod, to_array):
        return iter([[(mod.Bucket(mod.DataShape(1, 16, 16), b), {k: to_array(v) for k, v in
                                                                 batch.items()})
                      for (b, _), batch in zip(spec, step)]
                     for step, spec in zip(steps_np, specs)])

    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg, jopt)
    params0 = jax.tree.map(np.asarray, jstate["params"])
    opt0 = jax.tree.map(np.asarray, jstate["opt"])
    jstate, jhist = JaxTrainer(jcfg, jopt, donate=False).run(
        jstate, stream(jax_bucketing, jnp.asarray), 3, rng=jax.random.PRNGKey(5), log_every=0)

    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params0, cfg, device="cpu"))
    state = {"model": model, "opt": from_jax_opt_state(opt0, cfg, device="cpu"), "step": 0}
    trainer = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt))
    state, hist = trainer.run(state, stream(bucketing, torch.from_numpy), 3, rng=5, log_every=0)

    assert state["step"] == int(jstate["step"]) == 3
    np.testing.assert_allclose(hist.losses, jhist.losses, rtol=GATE)
    assert hist.microbatches == [2, 1, 2]
    _assert_trees_close(to_numpy(dict(model.named_parameters()), cfg), jstate["params"])
    _assert_trees_close(to_numpy(state["opt"]["m"], cfg), jstate["opt"]["m"])


def test_step_functions_of_the_lm():
    cfg = torch_mamba.smoke_config()
    opt = adamw.OptimizerConfig(peak_lr=1e-3, warmup=0)
    state = init_state(cfg, opt, seed=2, device="cpu")
    model = state["model"]
    assert isinstance(model, T.Transformer) and model.kinds == ["ssm", "ssm"]
    batch = make_lm_batch(1, 2, 32, cfg.vocab, cfg, "cpu")
    step = make_pool_grad_step(cfg)
    a, ga = step(model, batch, 11, 0)
    b, _ = step(model, batch, 12, 3)
    assert float(a) == float(b)  # the LM loss draws nothing
    assert set(ga) == {n for n, _ in model.named_parameters()}
    with pytest.raises(ValueError, match="mmdit"):
        make_pool_grad_step(cfg, noise=lambda *a: None)
    before = model.blocks[0].mixer.A_log.detach().clone()
    state, metrics = make_train_step(cfg, opt)(state, batch, None)
    assert state["step"] == 1 and np.isfinite(float(metrics["loss"]))
    assert not torch.equal(before, model.blocks[0].mixer.A_log.detach())


# -- launcher -------------------------------------------------------------------------


def test_launch_train_mamba_smoke_adaptive_on_cpu(capsys):
    hist = launch_train.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                              "--adaptive", "--steps", "2"])
    assert len(hist.losses) == 2 and np.isfinite(hist.losses).all()
    assert hist.microbatches == [1, 1] and hist.throughput > 0
    assert "final loss" in capsys.readouterr().out


def test_launch_train_fixed_shape_lm_on_cpu():
    hist = launch_train.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                              "--batch", "2", "--seq", "40", "--steps", "2"])
    assert hist.tokens == [80, 80] and np.isfinite(hist.losses).all()


def test_launch_train_refuses_dense_lm_training():
    """The dense LMs train (tests/test_torch_dense_train.py); what the
    launcher still refuses is their sequence-parallel split, whose planner
    flag waits for the planner (an argparse error)."""
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "1",
                           "--sp-max-ranks", "2"])
