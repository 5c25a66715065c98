"""The port's LM serving slice against the JAX package, at the smoke size of
llama3.2-1b (2 layers, d 64, 4 q heads and 1 kv head of 16, f32).

Parameters are drawn once by the JAX model and converted; prompts and
request streams come from numpy.  The forward's hidden states and caches,
``paged_prefill``'s logits and pools and four ``paged_decode_step`` waves
are held to rel-L2 <= 1e-5 (the oracle gate of the JAX package's README);
the two ``ServeEngine``s must give identical tokens and identical
iteration records, as ``tests/test_serve.py`` holds the JAX engine to
single-stream decoding.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import llama3_2_1b as jax_llama  # noqa: E402
from repro.core.cost_model import CostModel as JaxCostModel  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.serve import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve import PagePool as JaxPagePool  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import llama3_2_1b as torch_llama  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import from_jax_params, to_numpy  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingScheduler,
    OutOfPages,
    PagePool,
    Request,
    ServeConfig,
    ServeEngine,
)

MODEL = dict(a=0.01, b=1e-6, p=2.0, r2=1.0)
GATE = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def lm():
    cfg = torch_llama.smoke_config()
    params = JT.init_params(jax.random.PRNGKey(0), jax_llama.smoke_config())
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu"), strict=True
    )
    return cfg, params, model


# -- configuration and parameters ----------------------------------------------


@pytest.mark.parametrize("fn", ["config", "smoke_config"])
def test_llama_configs_match(fn):
    assert dataclasses.asdict(getattr(torch_llama, fn)()) == dataclasses.asdict(
        getattr(jax_llama, fn)()
    )
    if fn == "config":
        assert registry.get_config("llama3.2-1b") == torch_llama.config()


@pytest.mark.parametrize("pattern,n_layers", [
    (("attn",), 16), (("attn", "local"), 7), (("rglru", "rglru", "attn"), 8),
    (("attn", "attn"), 3),
])
def test_layer_plan_matches(pattern, n_layers):
    kw = dict(name="t", family="dense", n_layers=n_layers, d_model=64, n_heads=4,
              n_kv_heads=1, head_dim=16, d_ff=128, vocab=64, pattern=pattern)
    jc, tc = JaxModelConfig(**kw), ModelConfig(**kw)
    assert tc.layer_kinds() == jc.layer_kinds()
    assert tc.superblocks() == jc.superblocks()


def test_transformer_refuses_unported_kinds():
    """Every kind of the reference is ported; an unknown one is refused."""
    cfg = dataclasses.replace(torch_llama.smoke_config(), pattern=("attn", "bogus"))
    with pytest.raises(ValueError, match="Mamba-2 and cross-attention blocks only"):
        T.Transformer(cfg, device="cpu")


@pytest.mark.parametrize("n_layers,pattern", [(2, ("attn",)), (3, ("attn", "attn"))])
def test_convert_round_trip_of_the_lm_tree(n_layers, pattern):
    """Every leaf of the JAX tree (stacked superblocks, and a tail layer
    when the plan has one) lands in one port parameter and comes back."""
    jcfg = dataclasses.replace(jax_llama.smoke_config(), n_layers=n_layers, pattern=pattern)
    cfg = dataclasses.replace(torch_llama.smoke_config(), n_layers=n_layers, pattern=pattern)
    params_np = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(3), jcfg))
    state = from_jax_params(params_np, cfg, device="cpu")
    model = T.Transformer(cfg, device="cpu")
    assert sorted(state) == sorted(model.state_dict())
    model.load_state_dict(state, strict=True)
    back = to_numpy(dict(model.state_dict()), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, params_np)))
    if pattern == ("attn", "attn"):  # layer 2 is the plan's tail
        assert np.array_equal(state["blocks.2.attn.wqkv"].numpy(), params_np["tail"][0]["attn"]["wqkv"])
        assert np.array_equal(state["blocks.1.mlp.w1"].numpy(), params_np["blocks"]["s1"]["mlp"]["w1"][0])


# -- the model's serving functions -------------------------------------------------


def test_forward_hidden_and_caches_match(lm):
    cfg, params, model = lm
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    h_j, _, c_j = JT.forward(params, jax_llama.smoke_config(), jnp.asarray(tok),
                             remat=False, collect_cache=True)
    h_t, c_t = model(torch.from_numpy(tok), collect_cache=True)
    assert _rel(h_t, h_j) <= GATE
    assert len(c_t) == cfg.n_layers
    for i, c in enumerate(c_t):
        for name in ("k", "v"):
            assert _rel(c[name], c_j["blocks"]["s0"][name][i]) <= GATE
    h_p, c_p = model(torch.from_numpy(tok), ops="plain")
    assert torch.equal(h_p, h_t) and c_p is None


def test_paged_prefill_and_decode_waves_match(lm):
    """One B=2 prefill into a fragmented pool, then 4 decode waves over 3
    slots (the third inactive, on the scratch page) at different depths."""
    cfg, params, model = lm
    jcfg = jax_llama.smoke_config()
    ps, num_pages, pages_max = 8, 12, 4
    scratch = num_pages
    rng = np.random.default_rng(4)
    true_len = np.array([13, 6], np.int32)
    tokens = np.zeros((2, 16), np.int32)
    for bi, n in enumerate(true_len):
        tokens[bi, :n] = rng.integers(0, cfg.vocab, n)
    table = np.full((3, pages_max), scratch, np.int32)
    table[0, :3] = [7, 2, 9]  # 13 + 4 new tokens: 3 pages
    table[1, :2] = [4, 0]  # 6 + 4: 2 pages

    pools_j = JT.init_paged_pools(jcfg, num_pages, ps)
    pools_t = T.init_paged_pools(cfg, num_pages, ps, device="cpu")
    lg_j, pools_j = JT.paged_prefill(params, jcfg, jnp.asarray(tokens), jnp.asarray(true_len),
                                     jnp.asarray(table[:2, :2]), pools_j)
    with torch.inference_mode():
        lg_t, pools_t = T.paged_prefill(model, torch.from_numpy(tokens),
                                        torch.from_numpy(true_len),
                                        torch.from_numpy(table[:2, :2].copy()), pools_t)
    assert lg_t.dtype == torch.float32 and _rel(lg_t, lg_j) <= GATE

    def pools_match():
        for i in range(cfg.n_layers):
            for name in ("k", "v"):
                got = pools_t[i][name][:scratch]  # scratch content is never read
                want = np.asarray(pools_j["blocks"]["s0"][name][i])[:scratch]
                assert _rel(got, want) <= GATE

    pools_match()
    kv_lens = np.array([13, 6, 0], np.int32)
    last = np.array([int(np.argmax(lg_j[0])), int(np.argmax(lg_j[1])), 0], np.int32)
    for _ in range(4):
        lg_j, pools_j = JT.paged_decode_step(params, jcfg, pools_j, jnp.asarray(table),
                                             jnp.asarray(kv_lens), jnp.asarray(last[:, None]))
        with torch.inference_mode():
            lg_t, pools_t = T.paged_decode_step(
                model, pools_t, torch.from_numpy(table), torch.from_numpy(kv_lens),
                torch.from_numpy(last[:, None].copy()))
        assert _rel(lg_t[:2], np.asarray(lg_j)[:2]) <= GATE
        pools_match()
        last[:2] = np.argmax(np.asarray(lg_j)[:2], axis=-1)
        kv_lens[:2] += 1


# -- page pool, requests, engine ----------------------------------------------------


def test_page_pool_lifo_owner_and_leak_checks():
    ops = [("alloc", 3, 0), ("alloc", 2, 1), ("free", 0), ("alloc", 4, 2), ("free", 1),
           ("alloc", 1, 3), ("free", 2), ("free", 3)]
    logs = []
    for pool in (JaxPagePool(10, 16), PagePool(10, 16)):
        held, log = {}, []
        for op in ops:
            if op[0] == "alloc":
                held[op[2]] = pool.alloc(op[1], op[2])
                log.append(list(held[op[2]]))
            else:
                pool.free(held.pop(op[1]), op[1])
            log.append((pool.num_free, pool.free_tokens))
        logs.append(log)
    assert logs[0] == logs[1]
    pool = PagePool(4, 8)
    assert pool.alloc(2, 0) == [0, 1] and pool.pages_for(17) == 3 and pool.pages_for(0) == 0
    with pytest.raises(ValueError, match="not owned"):
        pool.free([0], 1)
    with pytest.raises(OutOfPages):
        pool.alloc(3, 1)
    with pytest.raises(AssertionError, match="leaked"):
        pool.assert_empty()
    pool.free([0, 1], 0)
    pool.assert_empty()
    assert pool.alloc(2, 5) == [0, 1]  # freed in reverse: the same pages again


@pytest.mark.parametrize("target_step", [0.0102, 0.05, 1.0])
def test_scheduler_prices_lm_requests_as_jax(target_step):
    rng = np.random.default_rng(int(target_step * 1e4))
    lens = [int(n) for n in rng.integers(4, 120, size=10)]
    ctxs = [int(n) for n in rng.integers(0, 200, size=3)]
    cfg = dict(target_step=target_step, page_size=16, num_pages=64, decode_slots=4, max_seq=256)
    plans = []
    for Req, Sched, Cost, Serve in ((JaxRequest, JaxScheduler, JaxCostModel, JaxServeConfig),
                                    (Request, ContinuousBatchingScheduler, CostModel,
                                     ServeConfig)):
        sched = Sched(Cost(**MODEL), Serve(**cfg))
        waiting = [Req(i, np.zeros(n, np.int32), 5) for i, n in enumerate(lens)]
        running = [Req(100 + i, np.zeros(4, np.int32), 5) for i in range(len(ctxs))]
        for r, c in zip(running, ctxs):
            r.ctx = c
        plan = sched.plan(waiting, running, free_tokens=512, free_slots=2)
        plans.append(([r.rid for r in plan.prefills], plan.decode_load, plan.prefill_load,
                      plan.oversize, sched.price(plan)))
    assert plans[0] == plans[1]


def _records(eng):
    return [(it["prefills"], it["decodes"], it["decode_load"], it["prefill_load"],
             it["price"], it["clock"], it["oversize"]) for it in eng.iterations]


def test_engine_matches_jax_engine(lm):
    """The stream of ``tests/test_serve.py``'s engine test through both
    engines: the same admissions, waves, loads and clock, and the same
    generated ids."""
    cfg, params, model = lm
    serve = dict(target_step=0.1, page_size=8, num_pages=32, decode_slots=3, max_seq=32)
    eng_j = JaxEngine(params, jax_llama.smoke_config(), JaxCostModel(**MODEL),
                      JaxServeConfig(**serve))
    eng_t = ServeEngine(model, cfg, CostModel(**MODEL), ServeConfig(**serve))
    rng = np.random.default_rng(0)
    clock = 0.0
    for i in range(5):
        clock += float(rng.exponential(0.01))
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(3, 20))).astype(np.int32)
        for eng in (eng_j, eng_t):
            eng.submit(prompt, 3 + (i % 3), arrival=clock)
    done_j, done_t = eng_j.run(), eng_t.run()  # run() asserts each pool drained
    assert _records(eng_t) == _records(eng_j)
    assert [r.rid for r in done_t] == [r.rid for r in done_j]
    # at least one wave ran slots at different depths
    assert any(len(it["decodes"]) >= 2 for it in eng_t.iterations)
    for rj, rt in zip(done_j, done_t):
        assert rt.out == rj.out
        assert (rt.t_first, rt.t_done, rt.ctx) == (rj.t_first, rj.t_done, rj.ctx)
    assert (eng_t.kv_lens == 0).all() and (eng_t.page_table == eng_t.scratch).all()


def test_launcher_serves_llama_on_cpu_and_needs_a_device(monkeypatch, capsys):
    eng = launch_serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                             "--requests", "3", "--gen", "4"])
    assert isinstance(eng, ServeEngine) and len(eng.done) == 3
    assert all(1 <= len(r.out) <= 5 for r in eng.done)
    assert "served 3 LM requests" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--smoke"])  # llama3.2-1b is the default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Transformer(torch_llama.smoke_config())
