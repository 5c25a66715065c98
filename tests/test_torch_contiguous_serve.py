"""The port's contiguous LM serving against the JAX package, at the smoke
sizes of llama3.2-1b, qwen2.5-14b (GQA 2, QKV bias), minicpm-2b (MHA, head
dim 12, vocabulary 251) and mamba2-2.7b (SSD chunk 16), all f32.

Parameters are drawn once by the JAX model and converted; prompts come from
numpy.  ``prefill``'s logits and caches (through ``convert``), four
``decode_step``s fed the same caches and tokens, and ``apply_ssm``'s cache
and ``apply_ssm_decode`` are held to rel-L2 <= 1e-5 (the oracle gate of the
JAX package's README); greedy generations must be identical to JAX's, and
the port's paged ``ServeEngine`` must give the tokens of its own contiguous
path (the reference's ``token_mismatches`` 0).  The decode must also agree
with the forward over the extended sequence within the reference's own
5e-2 (``tests/test_smoke_archs.py``).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import caches_from_jax, caches_to_numpy, from_jax_params  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import lm_layers  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCHS = ["llama3.2-1b", "qwen2.5-14b", "minicpm-2b", "mamba2-2.7b"]
NEW_CONFIGS = {"minicpm-2b": "minicpm_2b", "qwen2.5-14b": "qwen2_5_14b"}
GATE = 1e-5
ORACLE = 5e-2  # the reference's own decode-vs-forward bound (test_smoke_archs.py)
B, S, CAP, N_DECODE = 2, 32, 40, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke shapes run on one intra-op thread: the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _tree_rel(got: dict, want: dict) -> float:
    """The worst rel-L2 over the leaves of two cache trees of one structure."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    return max(_rel(g, w) for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The JAX model's prefill of B prompts of S tokens, its greedy tokens
    and the caches after each of N_DECODE greedy decode steps (jitted
    ``make_prefill_step`` / ``make_decode_step``), and the port's model on
    the same parameters."""
    arch = request.param
    jcfg, cfg = jax_registry.get_smoke_config(arch), registry.get_smoke_config(arch)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(from_jax_params(_np(params), cfg, device="cpu"), strict=True)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    pf = jax.jit(jax_steps.make_prefill_step(jcfg, cache_cap=CAP))
    dc = jax.jit(jax_steps.make_decode_step(jcfg))
    logits, caches = pf(params, jnp.asarray(tokens))
    trace = [(np.asarray(logits), _np(caches))]
    greedy = [np.argmax(trace[0][0], axis=-1).astype(np.int32)]
    for i in range(N_DECODE):
        logits, caches = dc(params, caches, jnp.asarray(greedy[-1][:, None]), S + i)
        trace.append((np.asarray(logits), _np(caches)))
        greedy.append(np.argmax(trace[-1][0], axis=-1).astype(np.int32))
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, params=params, model=model, tokens=tokens,
                trace=trace, greedy=np.stack(greedy, axis=1))


# -- configurations ------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(NEW_CONFIGS))
@pytest.mark.parametrize("fn", ["config", "smoke_config"])
def test_new_configs_match(arch, fn):
    mod = __import__(f"repro_torch.configs.{NEW_CONFIGS[arch]}", fromlist=[fn])
    jmod = __import__(f"repro.configs.{NEW_CONFIGS[arch]}", fromlist=[fn])
    assert dataclasses.asdict(getattr(mod, fn)()) == dataclasses.asdict(getattr(jmod, fn)())
    get = registry.get_config if fn == "config" else registry.get_smoke_config
    assert get(arch) == getattr(mod, fn)()


@pytest.mark.parametrize("arch", sorted(NEW_CONFIGS))
def test_new_optimizers_match(arch):
    """minicpm-2b trains with WSD: the same config and the same learning
    rate at every phase of the schedule (warmup, plateau, decay)."""
    opt, jopt = registry.get_optimizer(arch), jax_registry.get_optimizer(arch)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
    f, jf = opt.schedule_fn(), jopt.schedule_fn()
    for step in (0, 50, 199, 200, 5000, 8999, 9000, 9500, 10_000, 12_000):
        assert f(step) == pytest.approx(float(jf(step)), rel=1e-6, abs=1e-12)
    if arch == "minicpm-2b":
        assert opt.schedule == "wsd" and f(5000) == opt.peak_lr > f(9500)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_init_cache_shapes_match(arch, smoke):
    """Every layer's cache shapes and dtypes equal the JAX ``init_cache``'s
    (full configs in shapes only: JAX's ``eval_shape``, the port's meta
    device)."""
    get, jget = ((registry.get_smoke_config, jax_registry.get_smoke_config) if smoke
                 else (registry.get_config, jax_registry.get_config))
    cfg, jcfg = get(arch), jget(arch)
    want = jax.eval_shape(lambda: JT.init_cache(jcfg, 3, CAP))
    got = T.init_cache(cfg, 3, CAP, device="cpu" if smoke else "meta")
    assert len(got) == cfg.n_layers
    for (where, j), cache in zip(lm_layers(cfg), got):
        if where in ("lead", "tail"):
            ref = {k: (v.shape, v.dtype) for k, v in want[where][j].items()}
        else:
            ref = {k: (v.shape[1:], v.dtype) for k, v in want["blocks"][where].items()}
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in
                cache.items()} == {k: (tuple(s), str(d)) for k, (s, d) in ref.items()}
        if smoke:
            assert all(not v.any() for v in cache.values())


# -- the pieces ----------------------------------------------------------------------


@pytest.mark.parametrize("n_rep", [1, 5])
@pytest.mark.parametrize("cache_len", [1, 11])
def test_decode_attention_and_repeat_kv_match(n_rep, cache_len):
    rng = np.random.default_rng(n_rep)
    q = rng.standard_normal((3, 1, 2 * n_rep, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 11, 2, 16)).astype(np.float32) for _ in range(2))
    got_kv = TA.repeat_kv(torch.from_numpy(kc), n_rep)
    assert np.array_equal(got_kv.numpy(), np.asarray(JA.repeat_kv(jnp.asarray(kc), n_rep)))
    want = JA.decode_attention(jnp.asarray(q), JA.repeat_kv(jnp.asarray(kc), n_rep),
                               JA.repeat_kv(jnp.asarray(vc), n_rep), cache_len)
    got = TA.decode_attention(torch.from_numpy(q), got_kv,
                              TA.repeat_kv(torch.from_numpy(vc), n_rep),
                              torch.arange(11) < cache_len)
    assert _rel(got, want) <= GATE


@pytest.fixture(scope="module")
def mamba_layer():
    jcfg = jax_registry.get_smoke_config("mamba2-2.7b")
    cfg = registry.get_smoke_config("mamba2-2.7b")
    params = JT.init_params(jax.random.PRNGKey(2), jcfg)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(from_jax_params(_np(params), cfg, device="cpu"), strict=True)
    p = jax.tree.map(lambda a: a[0], params["blocks"]["s0"]["mixer"])
    return jcfg.ssm, p, model.blocks[0].mixer


@pytest.mark.parametrize("s", [32, 23, 3], ids=["aligned", "padded_tail", "one_conv_window"])
def test_apply_ssm_cache_matches_jax(mamba_layer, s):
    """The output and the cache; a prompt that is not a multiple of the
    chunk gives the reference's padded-tail cache (wrong for decode in both
    packages, and the same)."""
    jssm, p, mixer = mamba_layer
    x = np.random.default_rng(s).standard_normal((2, s, 64)).astype(np.float32)
    out_j, cache_j = JS.apply_ssm(p, jnp.asarray(x), jssm, return_cache=True)
    with torch.inference_mode():
        out_t, cache_t = TS.apply_ssm(mixer, torch.from_numpy(x), registry.get_smoke_config(
            "mamba2-2.7b").ssm, return_cache=True)
    assert _rel(out_t, out_j) <= GATE
    assert sorted(cache_t) == ["conv", "state"]
    for k in cache_t:
        assert cache_t[k].shape == cache_j[k].shape and cache_t[k].is_contiguous()
        assert _rel(cache_t[k], cache_j[k]) <= GATE


def test_apply_ssm_decode_matches_jax(mamba_layer):
    jssm, p, mixer = mamba_layer
    cfg = registry.get_smoke_config("mamba2-2.7b").ssm
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    cache = {"conv": rng.standard_normal((3, 3, 160)).astype(np.float32),
             "state": rng.standard_normal((3, 8, 16, 16)).astype(np.float32)}
    out_j, new_j = JS.apply_ssm_decode(p, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), jssm)
    with torch.inference_mode():
        out_t, new_t = TS.apply_ssm_decode(
            mixer, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in cache.items()}, cfg)
    assert _rel(out_t, out_j) <= GATE
    for k in ("conv", "state"):
        assert _rel(new_t[k], new_j[k]) <= GATE
    zero = TS.ssm_cache_init(3, 64, cfg, torch.float32, "cpu")
    want = JS.ssm_cache_init(3, 64, jssm, jnp.float32)
    assert {k: tuple(v.shape) for k, v in zero.items()} == {k: v.shape for k, v in want.items()}


# -- the model's serving functions ---------------------------------------------------


def test_prefill_logits_and_caches_match(served):
    logits, caches = steps.make_prefill_step(served["cfg"], CAP)(
        served["model"], torch.from_numpy(served["tokens"]))
    want_logits, want_caches = served["trace"][0]
    assert logits.dtype == torch.float32 and _rel(logits, want_logits) <= GATE
    assert _tree_rel(caches_to_numpy(caches, served["cfg"]), want_caches) <= GATE


def test_decode_steps_match(served):
    """Four decode steps fed the JAX prefill's caches (through ``convert``)
    and the JAX greedy tokens: logits and caches after every step."""
    cfg = served["cfg"]
    caches = caches_from_jax(served["trace"][0][1], cfg, device="cpu")
    decode = steps.make_decode_step(cfg)
    for i in range(N_DECODE):
        token = torch.from_numpy(served["greedy"][:, i : i + 1].copy())
        logits, caches = decode(served["model"], caches, token, S + i)
        want_logits, want_caches = served["trace"][i + 1]
        assert _rel(logits, want_logits) <= GATE
        assert _tree_rel(caches_to_numpy(caches, cfg), want_caches) <= GATE


def test_greedy_tokens_match_jax(served):
    cfg, model = served["cfg"], served["model"]
    logits, caches = steps.make_prefill_step(cfg, CAP)(model, torch.from_numpy(served["tokens"]))
    decode = steps.make_decode_step(cfg)
    out = [logits.argmax(dim=-1)]
    for i in range(N_DECODE):
        logits, caches = decode(model, caches, out[-1][:, None].to(torch.int32), S + i)
        out.append(logits.argmax(dim=-1))
    assert np.array_equal(torch.stack(out, dim=1).numpy(), served["greedy"])


def test_decode_matches_the_forward_over_the_extended_sequence(served):
    """The reference's oracle: the logits of one decode step against the
    forward over the prompt and the new token, at the new position."""
    cfg, model = served["cfg"], served["model"]
    tokens = torch.from_numpy(served["tokens"])
    with torch.inference_mode():
        logits, caches = T.prefill(model, tokens, S + 4)
        tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        got, _ = T.decode_step(model, caches, tok, S)
        h, _ = model(torch.cat([tokens, tok], dim=1))
        oracle = (h[:, -1] @ model.embed.T).float()
    assert float((got - oracle).abs().max()) < ORACLE


def test_decode_refusals():
    cfg = registry.get_smoke_config("llama3.2-1b")
    model = T.Transformer(cfg, device="cpu")
    tokens = torch.zeros((1, 6), dtype=torch.int32)
    with torch.inference_mode():
        _, caches = T.prefill(model, tokens, 8)
        with pytest.raises(ValueError, match="outside the attention cache"):
            T.decode_step(model, caches, tokens[:, :1], 8)  # JAX would clamp to slot 7
        with pytest.raises(TypeError, match="Python int"):
            T.decode_step(model, caches, tokens[:, :1], torch.tensor(6))
        _, long = T.prefill(model, torch.zeros((1, 10), dtype=torch.int32), 8)
    assert long[0]["k"].shape[1] == 10  # never truncated
    with pytest.raises(ValueError, match="needs an LM config"):
        steps.make_prefill_step(registry.get_smoke_config("wan2.1-1.3b"), 8)
    with pytest.raises(ValueError, match="needs an LM config"):
        steps.make_decode_step(registry.get_smoke_config("wan2.1-1.3b"))


def test_paged_engine_still_refuses_ssm():
    """``forward(collect_cache=True)`` collects SSM caches now; the paged
    engine still refuses the model (``tests/test_torch_ssm.py`` holds
    ``paged_prefill`` and the pools to the same refusal)."""
    cfg = registry.get_smoke_config("mamba2-2.7b")
    model = T.Transformer(cfg, device="cpu")
    with torch.inference_mode():
        _, caches = model(torch.zeros((1, 16), dtype=torch.int32), collect_cache=True)
    assert [sorted(c) for c in caches] == [["conv", "state"]] * cfg.n_layers
    with pytest.raises(ValueError, match="paged serving"):
        ServeEngine(model, cfg, CostModel(a=0.01, b=1e-6, p=2.0, r2=1.0),
                    ServeConfig(target_step=0.1, page_size=8, num_pages=8, decode_slots=2,
                                max_seq=32))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b"])
def test_caches_convert_round_trip_in_bf16(arch):
    """bf16 conv windows and k/v (and f32 SSM states) cross both ways
    bitwise as raw bits, with a tail layer in the plan."""
    jcfg = dataclasses.replace(jax_registry.get_smoke_config(arch), n_layers=3,
                               dtype="bfloat16")
    cfg = dataclasses.replace(registry.get_smoke_config(arch), n_layers=3, dtype="bfloat16")
    if arch == "llama3.2-1b":  # 3 layers of ("attn", "attn"): one superblock and a tail
        jcfg = dataclasses.replace(jcfg, pattern=("attn", "attn"))
        cfg = dataclasses.replace(cfg, pattern=("attn", "attn"))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(rng.standard_normal(a.shape), a.dtype)),
                        JT.init_cache(jcfg, 2, 8))
    caches = caches_from_jax(tree, cfg, device="cpu")
    assert [c["conv" if arch == "mamba2-2.7b" else "k"].dtype for c in caches] == [
        torch.bfloat16] * 3
    back = caches_to_numpy(caches, cfg, keep_dtype=True)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.shape == want.shape and got.tobytes() == want.tobytes()


# -- engines, the example and the launcher --------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-14b"])
def test_paged_engine_gives_the_contiguous_tokens(arch):
    """``benchmarks/bench_serve.py``'s parity leg in the port: a stream
    through ``ServeEngine``, then each request decoded alone."""
    cfg = registry.get_smoke_config(arch)
    model = T.Transformer(cfg, seed=3, device="cpu")
    serve = ServeConfig(target_step=0.1, page_size=8, num_pages=32, decode_slots=3, max_seq=32)
    eng = ServeEngine(model, cfg, CostModel(a=0.01, b=1e-6, p=2.0, r2=1.0), serve)
    rng = np.random.default_rng(0)
    specs, clock = [], 0.0
    for i in range(8):
        clock += float(rng.exponential(0.01))
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(3, 14))).astype(np.int32)
        specs.append((prompt, 3 + (i % 3)))
        eng.submit(prompt, specs[-1][1], arrival=clock)
    done = eng.run()
    assert any(len(it["decodes"]) >= 2 for it in eng.iterations)
    prefill, decode = steps.make_prefill_step(cfg, serve.max_seq), steps.make_decode_step(cfg)
    mismatches = 0
    for r in done:
        prompt, max_new = specs[r.rid]
        logits, caches = prefill(model, torch.from_numpy(prompt)[None])
        ref = [int(logits[0].argmax())]
        for pos in range(len(prompt), len(prompt) + max_new - 1):
            logits, caches = decode(model, caches, torch.tensor([[ref[-1]]], dtype=torch.int32),
                                    pos)
            ref.append(int(logits[0].argmax()))
        mismatches += sum(a != b for a, b in zip(ref, r.out)) + abs(len(ref) - len(r.out))
    assert len(done) == 8 and mismatches == 0


def test_example_serve_lm_on_cpu(capsys):
    out = serve_lm.main(["--device", "cpu"])
    assert out["requests"] == 6 and out["token_mismatches"] == 0 and out["leaked_pages"] == 0
    assert out["arch"] == "llama3.2-smoke" and out["dtype"] == "float32"
    printed = capsys.readouterr().out
    assert "parity: token_mismatches 0 over 6 requests" in printed
    assert "all generations token-identical" in printed


def test_launcher_serves_qwen_on_cpu_and_needs_a_device(monkeypatch, capsys):
    eng = launch_serve.main(["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu",
                             "--requests", "3", "--gen", "4"])
    assert isinstance(eng, ServeEngine) and len(eng.done) == 3
    assert eng.cfg == registry.get_smoke_config("qwen2.5-14b") and eng.cfg.qkv_bias
    assert "served 3 LM requests" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2.5-14b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(registry.get_smoke_config("mamba2-2.7b"), 1, 8)
