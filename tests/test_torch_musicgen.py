"""MusicGen-large (the ``"audio"`` family: ``"attn"`` blocks with LayerNorm,
full MHA) in the port against the JAX package, on the CPU in f32 at the
smoke size (``musicgen-smoke``: 2 layers, d 64, 4 heads of 16, vocab 128):

* the configurations, the registry, the full model's parameter count and
  decode-cache shapes (abstract / on the meta device);
* the decay mask: the stacked LayerNorm biases decay, ``final_norm.b``
  does not (the reference's ``ndim >= 2`` rule);
* the convert round trip of the LayerNorm biases;
* the forward's hidden states, ``lm_loss`` and every gradient (the norms'
  ``w`` and ``b`` included), and 3 ``Trainer`` steps against the
  reference's train step (losses, parameters, both moments);
* contiguous prefill and 4 decode steps (logits and caches), a paged
  prefill and 4 decode waves (logits and pools), ``ServeEngine`` against
  the JAX engine (identical tokens and iteration records); both launchers'
  routes.

The parameters are drawn by the port and carried to JAX with
``convert.to_numpy``; every norm's ``w`` and ``b`` are first moved off
their init values (ones and zeros) so that the bias path is exercised.
Every comparison is rel-L2 <= 1e-5.
"""

import concurrent.futures
import copy
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.core.cost_model import CostModel as JaxCostModel  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import caches_to_numpy, from_jax_params, to_numpy  # noqa: E402
from repro_torch.core import bucketing  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.engine import EmulatedEngine  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402

GATE = 1e-5
ARCH = "musicgen-large"
COST = dict(a=0.01, b=1e-6, p=2.0, r2=1.0)
SERVE = dict(target_step=0.1, page_size=8, num_pages=32, decode_slots=3, max_seq=32)
OPT = dict(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got.detach().double().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif isinstance(v, list):
            for i, item in enumerate(v):
                yield from _leaves(item, f"{prefix}{k}.{i}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_trees_close(port_tree, jax_tree, gate=GATE):
    want, got = dict(_leaves(jax_tree)), dict(_leaves(port_tree))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= gate, (k, _rel(got[k], want[k]))


@pytest.fixture(scope="module")
def musicgen():
    """The smoke model drawn from seed 0 by the port, every norm's ``w`` and
    ``b`` perturbed (1 + 0.1 N and 0.1 N), and its parameters as the JAX
    tree."""
    cfg, jcfg = registry.get_smoke_config(ARCH), jax_registry.get_smoke_config(ARCH)
    model = T.Transformer(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(26)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name and name.endswith((".w", ".b")):
                base = 1.0 if name.endswith(".w") else 0.0
                p.copy_(torch.from_numpy(base + 0.1 * rng.standard_normal(p.shape)).float())
    params = jax.tree.map(jnp.asarray, to_numpy(dict(model.state_dict()), cfg))
    return jcfg, cfg, params, model


def _tokens(cfg, b, s, seed):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


# -- configuration ----------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["config", "smoke_config"])
def test_configs_match(fn):
    get = registry.get_config if fn == "config" else registry.get_smoke_config
    jget = jax_registry.get_config if fn == "config" else jax_registry.get_smoke_config
    assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    assert get(ARCH).superblocks() == jget(ARCH).superblocks()
    opt, jopt = registry.get_optimizer(ARCH), jax_registry.get_optimizer(ARCH)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
    assert "audio" in steps.TRAINED and get(ARCH).norm == "layernorm"
    assert T.paged_kinds(get(ARCH)) == ["attn"] * get(ARCH).n_layers


def test_full_model_sizes():
    """3,225,616,384 parameters by the reference's ``param_count()``, which
    counts d a norm and not the final norm; the tree holds 98 d more (the
    final norm's ``w``, and the 97 LayerNorms' biases).  The decode caches'
    shapes (meta device) are the reference's."""
    jcfg, cfg = jax_registry.get_config(ARCH), registry.get_config(ARCH)
    assert jcfg.param_count() == 3_225_616_384
    tree = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    assert sum(a.size for a in jax.tree.leaves(tree)) == 3_225_616_384 + 98 * 2048
    caches = T.init_cache(cfg, 2, 8, device="meta")
    want = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 8))
    assert len(caches) == cfg.n_layers == 48
    for c, (where, j) in zip(caches, T.lm_layers(cfg)):
        for name, t in c.items():
            assert want["blocks"][where][name].shape[1:] == tuple(t.shape)


def test_decay_mask_matches_the_reference(musicgen):
    """AdamW decays JAX leaves of ndim >= 2: the stacked ``norm1.b`` and
    ``norm2.b`` do, the top-level ``final_norm.w`` and ``.b`` do not."""
    jcfg, cfg, params, model = musicgen
    want = jax.tree.map(lambda a: np.float32(a.ndim >= 2), params)
    rule = T.decays(cfg)
    got = to_numpy({n: torch.tensor(float(rule(n, p))) for n, p in model.named_parameters()},
                   cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(np.all(a == b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    flags = {n: rule(n, p) for n, p in model.named_parameters()}
    assert flags["blocks.1.norm1.b"] and flags["blocks.0.norm2.b"]
    assert not flags["final_norm.b"] and not flags["final_norm.w"]


def test_convert_round_trip_carries_the_biases(musicgen):
    jcfg, cfg, params, model = musicgen
    tree = to_numpy(dict(model.state_dict()), cfg)
    assert tree["blocks"]["s0"]["norm1"]["b"].shape == (cfg.n_layers, cfg.d_model)
    assert tree["final_norm"]["b"].shape == (cfg.d_model,)
    back = from_jax_params(tree, cfg, device="cpu")
    assert set(back) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name


# -- the JAX side, compiled once -----------------------------------------------------------


@pytest.fixture(scope="module")
def jfns(musicgen):
    """The JAX functions the tests share, jitted once and compiled together
    on threads before the first test: the forward's hidden states with
    ``lm_loss`` and its gradient (2 rows of 32 tokens), AdamW's update, the
    contiguous prefill (caches of 16) and decode step, the paged prefill
    (one prompt of a 16-token width) and decode wave (3 slots)."""
    jcfg, cfg, params, _ = musicgen
    jopt = jax_adamw.OptimizerConfig(**OPT)

    def grad(p, tok, lab):
        h, _, _ = JT.forward(p, jcfg, tok, remat=False)
        loss, g = jax.value_and_grad(lambda q: JT.lm_loss(q, jcfg, tok, lab))(p)
        return h, loss, g

    f = dict(grad=jax.jit(grad),
             update=jax.jit(lambda p, g, o, step: jax_adamw.adamw_update(p, g, o, step, jopt)),
             prefill=jax.jit(jax_steps.make_prefill_step(jcfg, cache_cap=16)),
             decode=jax.jit(jax_steps.make_decode_step(jcfg)),
             paged_prefill=jax.jit(jax_steps.make_paged_prefill_step(jcfg)),
             paged_decode=jax.jit(jax_steps.make_paged_decode_step(jcfg)))
    i32 = lambda *shape: np.zeros(shape, np.int32)  # noqa: E731
    caches = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jax.eval_shape(
        f["prefill"], params, i32(2, 11))[1])
    pools = JT.init_paged_pools(jcfg, SERVE["num_pages"], SERVE["page_size"])
    calls = [(f["grad"], (params, i32(2, 32), i32(2, 32))),
             (f["update"], (params, params, jax_adamw.init_opt_state(params, jopt),
                            jnp.int32(0))),
             (f["prefill"], (params, i32(2, 11))),
             (f["decode"], (params, caches, i32(2, 1), 11)),
             (f["paged_prefill"], (params, i32(1, 16), i32(1), i32(1, 2), pools)),
             (f["paged_decode"], (params, pools, i32(3, 4), i32(3), i32(3, 1)))]
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        for done in [pool.submit(fn, *args) for fn, args in calls]:
            jax.block_until_ready(done.result())
    return f


# -- training -----------------------------------------------------------------------------


def test_forward_loss_and_every_gradient_match_jax(musicgen, jfns):
    """The hidden states after the final LayerNorm, ``lm_loss`` and every
    gradient, the norms' ``w`` and ``b`` included."""
    jcfg, cfg, params, model = musicgen
    tok, lab = _tokens(cfg, 2, 32, 7)
    jh, jloss, jgrads = jfns["grad"](params, tok, lab)
    with torch.no_grad():
        h, _ = model(torch.from_numpy(tok))
    assert _rel(h, jh) <= GATE
    model.zero_grad(set_to_none=True)
    loss = T.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= GATE * abs(float(jloss))
    grads = to_numpy({n: p.grad for n, p in model.named_parameters()}, cfg)
    assert float(np.abs(grads["blocks"]["s0"]["norm1"]["b"]).max()) > 0
    _assert_trees_close(grads, jgrads)


def test_trainer_three_steps_match_jax(musicgen, jfns):
    """3 ``Trainer`` steps on ``EmulatedEngine`` and 3 of the reference's
    train step (the jitted ``value_and_grad`` of ``lm_loss``, then
    ``adamw_update``) from the same state: the losses, the parameters and
    both moments, leaf by leaf."""
    jcfg, cfg, params, model0 = musicgen
    batches = [dict(zip(("tokens", "labels"), _tokens(cfg, 2, 32, 20 + i))) for i in range(3)]
    opt = adamw.OptimizerConfig(**OPT)
    jparams, jstate, jlosses = params, jax_adamw.init_opt_state(
        params, jax_adamw.OptimizerConfig(**OPT)), []
    for i, b in enumerate(batches):
        loss, grads = jfns["grad"](jparams, b["tokens"], b["labels"])[1:]
        jparams, jstate, _ = jfns["update"](jparams, grads, jstate, jnp.int32(i))
        jlosses.append(float(loss))

    model = copy.deepcopy(model0)
    state = {"model": model, "step": 0,
             "opt": adamw.init_opt_state(dict(model.named_parameters()), opt)}
    bucket = bucketing.Bucket(bucketing.DataShape(1, 16, 16), 2)
    stream = iter([[(bucket, {k: torch.from_numpy(v) for k, v in b.items()})] for b in batches])
    state, hist = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt)).run(
        state, stream, 3, rng=5, log_every=0)
    assert state["step"] == 3
    np.testing.assert_allclose(hist.losses, jlosses, rtol=GATE)
    _assert_trees_close(to_numpy(dict(model.named_parameters()), cfg), jparams)
    for moment in ("m", "v"):
        _assert_trees_close(to_numpy(state["opt"][moment], cfg), jstate[moment])


def test_train_launcher_routes_musicgen_on_cpu(capsys):
    hist = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                              "--seq", "32", "--steps", "2"])
    assert hist.tokens == [64, 64] and np.isfinite(hist.losses).all()
    assert "final loss" in capsys.readouterr().out


# -- serving ------------------------------------------------------------------------------


def test_prefill_and_decode_match_jax(musicgen, jfns):
    """Contiguous prefill of 2 prompts of 11 tokens into caches of 16, then
    4 greedy decode steps: logits and the whole cache tree."""
    jcfg, cfg, params, model = musicgen
    tok = _tokens(cfg, 2, 11, 3)[0]
    jlogits, jcaches = jfns["prefill"](params, tok)
    logits, caches = steps.make_prefill_step(cfg, 16)(model, torch.from_numpy(tok))
    assert _rel(logits, jlogits) <= GATE
    _assert_trees_close(caches_to_numpy(caches, cfg), jcaches)
    decode = steps.make_decode_step(cfg)
    for i in range(4):
        nxt = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)[:, None]
        jlogits, jcaches = jfns["decode"](params, jcaches, nxt, 11 + i)
        logits, caches = decode(model, caches, torch.from_numpy(nxt), 11 + i)
        assert _rel(logits, jlogits) <= GATE, i
    _assert_trees_close(caches_to_numpy(caches, cfg), jcaches)


def test_paged_prefill_and_decode_waves_match_jax(musicgen, jfns):
    """Two paged prefills (prompts of 13 and 6 tokens, each padded to 16)
    into a fragmented pool, then 4 decode waves over 3 slots (the third
    inactive, on the scratch page): logits and pools."""
    jcfg, cfg, params, model = musicgen
    ps, num_pages = SERVE["page_size"], SERVE["num_pages"]
    pages_max = SERVE["max_seq"] // ps
    rng = np.random.default_rng(4)
    table = np.full((3, pages_max), num_pages, np.int32)  # num_pages: the scratch page
    table[0, :3] = [7, 2, 9]  # 13 + 4 new tokens: 3 pages
    table[1, :2] = [4, 0]  # 6 + 4: 2 pages
    pools_j = JT.init_paged_pools(jcfg, num_pages, ps)
    pools_t = T.init_paged_pools(cfg, num_pages, ps, device="cpu")
    prefill, decode = steps.make_paged_prefill_step(cfg), steps.make_paged_decode_step(cfg)
    last = np.zeros(3, np.int32)
    for slot, n in enumerate((13, 6)):
        tokens = np.zeros((1, 16), np.int32)
        tokens[0, :n] = rng.integers(0, cfg.vocab, n)
        args = (tokens, np.array([n], np.int32), table[slot : slot + 1, :2].copy())
        lg_j, pools_j = jfns["paged_prefill"](params, *args, pools_j)
        lg_t, pools_t = prefill(model, *map(torch.from_numpy, args), pools_t)
        assert _rel(lg_t, lg_j) <= GATE
        last[slot] = int(np.argmax(lg_j[0]))

    def pools_match():
        got = caches_to_numpy([{k: t[:num_pages] for k, t in p.items()} for p in pools_t], cfg)
        want = jax.tree.map(lambda a: np.asarray(a)[..., :num_pages, :, :, :], pools_j)
        _assert_trees_close(got, want)

    pools_match()
    kv_lens = np.array([13, 6, 0], np.int32)
    for _ in range(4):
        args = (table, kv_lens, last[:, None].copy())
        lg_j, pools_j = jfns["paged_decode"](params, pools_j, *args)
        lg_t, pools_t = decode(model, pools_t, *map(torch.from_numpy, args))
        assert _rel(lg_t[:2], np.asarray(lg_j)[:2]) <= GATE
        last[:2] = np.argmax(np.asarray(lg_j)[:2], axis=-1)
        kv_lens[:2] += 1
    pools_match()


def _records(eng):
    return [(it["prefills"], it["decodes"], it["decode_load"], it["prefill_load"],
             it["price"], it["clock"], it["oversize"]) for it in eng.iterations]


def test_engine_matches_jax_engine(musicgen, jfns):
    """5 requests through both engines (the JAX engine running the shared
    jitted steps): the same admissions, waves, loads and clock, and the
    same generated ids."""
    jcfg, cfg, params, model = musicgen
    eng_j = JaxServeEngine(params, jcfg, JaxCostModel(**COST), JaxServeConfig(**SERVE))
    eng_j._prefill, eng_j._decode = jfns["paged_prefill"], jfns["paged_decode"]
    eng_t = ServeEngine(model, cfg, CostModel(**COST), ServeConfig(**SERVE))
    rng = np.random.default_rng(0)
    clock = 0.0
    for i in range(5):
        clock += float(rng.exponential(0.01))
        # prompts of up to 16 tokens: one prefill width, compiled once
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(3, 17))).astype(np.int32)
        for eng in (eng_j, eng_t):
            eng.submit(prompt, 3 + (i % 3), arrival=clock)
    done_j, done_t = eng_j.run(), eng_t.run()
    assert _records(eng_t) == _records(eng_j)
    assert any(len(it["decodes"]) >= 2 for it in eng_t.iterations)
    assert [r.rid for r in done_t] == [r.rid for r in done_j]
    for rj, rt in zip(done_j, done_t):
        assert rt.out == rj.out
        assert (rt.t_first, rt.t_done, rt.ctx) == (rj.t_first, rj.t_done, rj.ctx)


def test_serve_launcher_routes_musicgen_on_cpu(capsys):
    eng = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                             "--gen", "4"])
    assert isinstance(eng, ServeEngine) and len(eng.done) == 3
    assert "served 3 LM requests" in capsys.readouterr().out
