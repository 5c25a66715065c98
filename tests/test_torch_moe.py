"""Routed MoE (the ``"moe"`` block kind) in the port against the JAX package,
on the CPU in f32 at the smoke sizes of Llama-4-Scout (``llama4-smoke``: 2
MoE layers, 4 experts, top-1, a shared expert) and Kimi-K2
(``kimi-smoke``: a dense lead layer and 2 MoE layers, 8 experts, top-2, a
shared expert): the configurations, the layer and serving.

* the configurations, the registry, the layer plan and the full models'
  parameter and decode-cache sizes;
* ``apply_moe`` with capacity factors 8 (no drop), 1 and 0.5 (drops) and
  with ``no_drop``, at 1 and 2 dispatch groups (Kimi; Llama-4 at 1): the
  output, the router loss, and every gradient (x, the router, the
  experts, the shared expert), the keep masks and the slots equal;
* contiguous prefill (the prompts' tokens routed with capacity) and 4
  decode steps (no drop): logits and the whole cache tree; two paged
  prefills (padding routed too) and 4 decode waves over three slots, one
  inactive: logits and pools; ``ServeEngine`` against the JAX engine
  (identical tokens and iteration records); the serve launcher's route.

Training is ``tests/test_torch_moe_train.py`` (the two files share the
JAX compiles' cost between two test workers).  The parameters are drawn
by the port and carried to JAX with ``convert.to_numpy``.  Every
comparison is rel-L2 <= 1e-5 unless stated; the one stated exception
(Llama-4's top-1 router gradient) comes with both packages agreeing in
f64.
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
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import caches_to_numpy, to_numpy  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402

GATE = 1e-5
ARCHS = {"llama4": "llama4-scout-17b-a16e", "kimi": "kimi-k2-1t-a32b"}
COST = dict(a=0.01, b=1e-6, p=2.0, r2=1.0)
SERVE = dict(target_step=0.1, page_size=8, num_pages=32, decode_slots=3, max_seq=32)
VARIANTS = (8.0, 1.0, 0.5, "no_drop")  # capacity factors (8: no drop) and no_drop
GROUPS = {"kimi": (1, 2), "llama4": (1,)}  # apply_moe's dispatch groups (a compile each)
X_SHAPE = (2, 12)  # apply_moe's x: B, S (24 tokens)
# at top-1 the router's gradient through the combine is the round-off of
# p/p's derivative (1/p - p/p^2), and the two packages' roundings differ
# there: Llama-4's router gradients read up to 1.2e-5; both packages in
# f64 agree to F64_GATE (test_top1_router_gradient_agrees_in_f64)
TOP1_ROUTER_GATE = 2e-5
F64_GATE = 1e-10


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
def models():
    """Each smoke model drawn from seed 0 by the port, and its parameters as
    the JAX tree."""
    out = {}
    for key, arch in ARCHS.items():
        cfg, jcfg = registry.get_smoke_config(arch), jax_registry.get_smoke_config(arch)
        model = T.Transformer(cfg, seed=0, device="cpu")
        params = jax.tree.map(jnp.asarray, to_numpy(dict(model.state_dict()), cfg))
        out[key] = (jcfg, cfg, params, model)
    return out


# -- configuration and layer plan ---------------------------------------------------------


@pytest.mark.parametrize("key", ARCHS)
@pytest.mark.parametrize("fn", ["config", "smoke_config"])
def test_configs_match(key, fn):
    arch = ARCHS[key]
    get = registry.get_config if fn == "config" else registry.get_smoke_config
    jget = jax_registry.get_config if fn == "config" else jax_registry.get_smoke_config
    assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    assert get(arch).superblocks() == jget(arch).superblocks()
    opt, jopt = registry.get_optimizer(arch), jax_registry.get_optimizer(arch)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
    assert "moe" in steps.TRAINED and "moe" in T.KINDS and "moe" in T.PAGED_KINDS


def test_full_models_sizes():
    """The full models' parameter trees (abstract) and decode caches (on the
    meta device): one Llama-4-Scout MoE layer holds 2,202,101,760 values and
    its embedding 1,034,485,760; one Kimi-K2 MoE layer 17,090,361,344, its
    dense lead layer 176,175,104 and its embedding 1,174,405,120 (the two
    norms' 2 d values included in each layer)."""
    sizes = {}
    for key, arch in ARCHS.items():
        jcfg, cfg = jax_registry.get_config(arch), registry.get_config(arch)
        tree = jax.eval_shape(lambda c=jcfg: JT.init_params(jax.random.PRNGKey(0), c))
        n_rep = cfg.superblocks()[2]
        sizes[key] = dict(
            moe=sum(a.size for a in jax.tree.leaves(tree["blocks"])) // n_rep,
            lead=sum(a.size for a in jax.tree.leaves(tree["lead"])),
            embed=tree["embed"].size)
        caches = T.init_cache(cfg, 2, 8, device="meta")
        want = jax.eval_shape(lambda c=jcfg: JT.init_cache(c, 2, 8))
        assert len(caches) == cfg.n_layers
        for c, (where, j) in zip(caches, T.lm_layers(cfg)):
            leaf = want[where][j] if where == "lead" else want["blocks"][where]
            for name, t in c.items():
                assert leaf[name].shape[-4:] == tuple(t.shape), (key, name)
    assert sizes == {
        "llama4": dict(moe=2_202_101_760, lead=0, embed=1_034_485_760),
        "kimi": dict(moe=17_090_361_344, lead=176_175_104, embed=1_174_405_120),
    }


# -- apply_moe ----------------------------------------------------------------------------


def _moe_layer(models, key):
    """The last layer's MoE (a stacked MoE layer of both models): the port's
    module and the JAX leaves of its superblock entry."""
    jcfg, cfg, params, model = models[key]
    where, j = T.lm_layers(cfg)[-1]
    return model.blocks[-1].moe, jax.tree.map(lambda a: a[j], params["blocks"][where]["moe"])


def _variant_cfg(cfg, variant):
    if variant == "no_drop":
        return cfg.moe, True
    return dataclasses.replace(cfg.moe, capacity_factor=variant), False


def _moe_inputs(cfg, groups):
    rng = np.random.default_rng(groups)
    return tuple(rng.standard_normal((*X_SHAPE, cfg.d_model)).astype(np.float32)
                 for _ in range(2))  # x and the cotangent of y


def _jax_moe(cfg, groups, variants):
    """The JAX ``apply_moe`` at each variant, in one function of (MoE
    leaves, x): y, aux, the gradients of ``sum(y * c) + 3 aux`` (leaves and
    x), and the routing's slots and keep mask."""
    _, cot = _moe_inputs(cfg, groups)
    t_loc = X_SHAPE[0] * X_SHAPE[1] // groups

    def run(p, xx):
        out = []
        for variant in variants:
            mcfg, no_drop = _variant_cfg(cfg, variant)

            def f(q, xi):
                y, aux = JM.apply_moe(q, xi, mcfg, n_groups=groups, no_drop=no_drop)
                return jnp.sum(y * cot) + 3.0 * aux, (y, aux)

            (_, (y, aux)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, xx)
            cap = M.capacity(t_loc, mcfg, no_drop=no_drop)
            logits = jnp.einsum("gtd,de->gte", xx.reshape(groups, t_loc, -1),
                                p["router"]).astype(jnp.float32)
            slot, keep = jax.vmap(lambda li: JM._routing_indices(li, mcfg, cap))(logits)[:2]
            out.append((y, aux, grads, slot, keep))
        return out

    return run


@pytest.fixture(scope="module")
def jfns(models):
    """The JAX functions the tests share, jitted once a model and compiled
    together on threads before the first test (a compile costs seconds):
    ``apply_moe`` at every variant; the contiguous prefill (caches of 16)
    and decode step; the paged prefill (one prompt of a 16-token width)
    and decode wave (3 slots), which the JAX engine of the engine test
    runs too."""
    out, calls = {}, []
    i32 = lambda *shape: np.zeros(shape, np.int32)  # noqa: E731
    for key, (jcfg, cfg, params, _) in models.items():
        f = out[key] = dict(
            moe={g: jax.jit(_jax_moe(cfg, g, VARIANTS)) for g in GROUPS[key]},
            prefill=jax.jit(jax_steps.make_prefill_step(jcfg, cache_cap=16)),
            decode=jax.jit(jax_steps.make_decode_step(jcfg)),
            paged_prefill=jax.jit(jax_steps.make_paged_prefill_step(jcfg)),
            paged_decode=jax.jit(jax_steps.make_paged_decode_step(jcfg)))
        jp = _moe_layer(models, key)[1]
        caches = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jax.eval_shape(
            f["prefill"], params, i32(2, 11))[1])
        pools = JT.init_paged_pools(jcfg, SERVE["num_pages"], SERVE["page_size"])
        calls += [(f["moe"][g], (jp, _moe_inputs(cfg, g)[0])) for g in GROUPS[key]]
        calls += [(f["prefill"], (params, i32(2, 11))),
                  (f["decode"], (params, caches, i32(2, 1), 11)),
                  (f["paged_prefill"], (params, i32(1, 16), i32(1), i32(1, 2), pools)),
                  (f["paged_decode"], (params, pools, i32(3, 4), i32(3), i32(3, 1)))]
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        results = [pool.submit(fn, *args) for fn, args in calls]
        results = [jax.block_until_ready(r.result()) for r in results]
    for key in out:  # the apply_moe calls' results are the tests' references
        jp = _moe_layer(models, key)[1]
        out[key]["moe_out"] = {g: dict(zip(VARIANTS, out[key]["moe"][g](
            jp, _moe_inputs(models[key][1], g)[0]))) for g in GROUPS[key]}
    return out


def _port_moe(moe, cfg, groups, variant, dtype=torch.float32):
    """The port's y, aux, gradients (x's, and the module's by JAX leaf name)
    and routing on the test's x."""
    x, cot = (torch.from_numpy(a).to(dtype) for a in _moe_inputs(cfg, groups))
    mcfg, no_drop = _variant_cfg(cfg, variant)
    moe.zero_grad(set_to_none=True)
    x.requires_grad_()
    y, aux = M.apply_moe(moe, x, mcfg, n_groups=groups, no_drop=no_drop)
    ((y * cot).sum() + 3.0 * aux).backward()
    t_loc = X_SHAPE[0] * X_SHAPE[1] // groups
    with torch.no_grad():
        logits = (x.reshape(groups, t_loc, -1) @ moe.router.to(x.dtype)).float()
        slot, keep = M.route(logits, mcfg, M.capacity(t_loc, mcfg, no_drop=no_drop))[:2]
    g = {n: p.grad for n, p in moe.named_parameters()}
    grads = {"router": g["router"], "w1": g["w1"], "w2": g["w2"], "w3": g["w3"],
             "shared": {k: g[f"shared.{k}"] for k in ("w1", "w2", "w3")}}
    return y, aux, grads, x.grad, slot, keep


@pytest.mark.parametrize("variant", VARIANTS, ids=["cf8", "cf1", "cf0.5", "no_drop"])
@pytest.mark.parametrize("key,groups", [(k, g) for k in ARCHS for g in GROUPS[k]],
                         ids=lambda v: f"g{v}" if isinstance(v, int) else v)
def test_apply_moe_matches_jax(models, jfns, key, groups, variant):
    """Layer 2's MoE on x [2, 12, 64]: y, aux and every gradient (x, the
    router, the experts, the shared expert) at 1e-5 (Llama-4's top-1
    router at ``TOP1_ROUTER_GATE``); the keep mask and the slots equal.
    Capacity factor 8 and ``no_drop`` keep every assignment, 0.5 drops."""
    cfg = models[key][1]
    jy, jaux, (jgp, jgx), jslot, jkeep = jfns[key]["moe_out"][groups][variant]
    y, aux, grads, gx, slot, keep = _port_moe(_moe_layer(models, key)[0], cfg, groups, variant)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(slot.numpy(), np.asarray(jslot))
    if variant in (8.0, "no_drop"):
        assert bool(keep.all())
    if variant == 0.5:
        assert not bool(keep.all())
    assert _rel(y, jy) <= GATE and _rel(aux, jaux) <= GATE and _rel(gx, jgx) <= GATE
    if cfg.moe.top_k == 1:
        assert _rel(grads.pop("router"), jgp.pop("router")) <= TOP1_ROUTER_GATE
    _assert_trees_close(grads, jgp)


class _TorchF64:
    """``torch`` with ``float32`` meaning f64, for the modules of the port
    that name the dtype; ``torch`` itself stays as it is."""

    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def _f64(mp):
    """Both packages in f64 for ``apply_moe``: JAX's casts to f32 and the
    port's (``float()``, ``torch.float32`` in ``models.moe``) become casts
    to f64."""
    mp.setattr(jnp, "float32", jnp.float64)
    mp.setattr(torch.Tensor, "float", torch.Tensor.double)
    mp.setattr(M, "torch", _TorchF64())


def test_top1_router_gradient_agrees_in_f64(models):
    """Llama-4's MoE (top-1) with drops, both packages in f64: every output
    and gradient, the router's included, at ``F64_GATE``."""
    cfg = models["llama4"][1]
    moe = copy.deepcopy(_moe_layer(models, "llama4")[0]).double()
    jp = jax.tree.map(lambda a: np.asarray(a, np.float64), _moe_layer(models, "llama4")[1])
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        _f64(mp)
        x = jnp.asarray(_moe_inputs(cfg, 1)[0], jnp.float64)
        jy, jaux, (jgp, jgx), _, jkeep = jax.jit(_jax_moe(cfg, 1, (0.5,)))(jp, x)[0]
        y, aux, grads, gx, _, keep = _port_moe(moe, cfg, 1, 0.5, torch.float64)
    assert y.dtype == torch.float64 and np.asarray(jy).dtype == np.float64
    assert np.array_equal(keep.numpy(), np.asarray(jkeep)) and not bool(keep.all())
    assert _rel(y, jy) <= F64_GATE and _rel(aux, jaux) <= F64_GATE
    assert _rel(gx, jgx) <= F64_GATE
    _assert_trees_close(grads, jgp, F64_GATE)


def test_apply_moe_refuses_uneven_groups(models):
    cfg = models["kimi"][1]
    with pytest.raises(ValueError, match="not divisible into 5 groups"):
        M.apply_moe(_moe_layer(models, "kimi")[0], torch.zeros(2, 12, cfg.d_model), cfg.moe,
                    n_groups=5)


# -- serving ------------------------------------------------------------------------------


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("key", ARCHS)
def test_prefill_and_decode_match_jax(models, jfns, key):
    """Contiguous prefill of 2 prompts of 11 tokens (the 22 tokens routed
    with capacity) into caches of 16, then 4 greedy decode steps (no drop):
    logits and the whole cache tree against JAX's jitted steps."""
    jcfg, cfg, params, model = models[key]
    tok = _tokens(cfg, 2, 11, 3)
    jlogits, jcaches = jfns[key]["prefill"](params, tok)
    logits, caches = steps.make_prefill_step(cfg, 16)(model, torch.from_numpy(tok))
    assert _rel(logits, jlogits) <= GATE
    _assert_trees_close(caches_to_numpy(caches, cfg), jcaches)
    decode = steps.make_decode_step(cfg)
    for i in range(4):
        nxt = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)[:, None]
        jlogits, jcaches = jfns[key]["decode"](params, jcaches, nxt, 11 + i)
        logits, caches = decode(model, caches, torch.from_numpy(nxt), 11 + i)
        assert _rel(logits, jlogits) <= GATE, i
    _assert_trees_close(caches_to_numpy(caches, cfg), jcaches)


@pytest.mark.parametrize("key", ARCHS)
def test_paged_prefill_and_decode_waves_match_jax(models, jfns, key):
    """Two paged prefills (prompts of 13 and 6 tokens, each padded to 16:
    the MoE routes the padding too) into a fragmented pool, then 4 decode
    waves over 3 slots (the third inactive, on the scratch page): logits
    and pools against the JAX steps, at the engine test's shapes."""
    jcfg, cfg, params, model = models[key]
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
        lg_j, pools_j = jfns[key]["paged_prefill"](params, *args, pools_j)
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
        lg_j, pools_j = jfns[key]["paged_decode"](params, pools_j, *args)
        lg_t, pools_t = decode(model, pools_t, *map(torch.from_numpy, args))
        assert _rel(lg_t[:2], np.asarray(lg_j)[:2]) <= GATE
        last[:2] = np.argmax(np.asarray(lg_j)[:2], axis=-1)
        kv_lens[:2] += 1
    pools_match()


def _records(eng):
    return [(it["prefills"], it["decodes"], it["decode_load"], it["prefill_load"],
             it["price"], it["clock"], it["oversize"]) for it in eng.iterations]


@pytest.mark.parametrize("key", ARCHS)
def test_engine_matches_jax_engine(models, jfns, key):
    """5 requests through both engines (the JAX engine running the shared
    jitted steps, its own ``jax.jit`` of the same functions): the same
    admissions, waves, loads and clock, and the same generated ids."""
    jcfg, cfg, params, model = models[key]
    eng_j = JaxServeEngine(params, jcfg, JaxCostModel(**COST), JaxServeConfig(**SERVE))
    eng_j._prefill, eng_j._decode = jfns[key]["paged_prefill"], jfns[key]["paged_decode"]
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


@pytest.mark.parametrize("key", ARCHS)
def test_serve_launcher_routes_the_moe_smoke_models_on_cpu(key, capsys):
    eng = launch_serve.main(["--arch", ARCHS[key], "--smoke", "--device", "cpu", "--requests",
                             "3", "--gen", "4"])
    assert isinstance(eng, ServeEngine) and len(eng.done) == 3
    assert "served 3 LM requests" in capsys.readouterr().out
