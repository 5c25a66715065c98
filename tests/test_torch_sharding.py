"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``), on the CPU.

* ``sanitize_spec`` on random shapes and specs (and under hypothesis, as
  ``tests/test_sharding_rules.py``);
* every parameter of every full-size architecture, Wan included, built on
  ``meta``, on both production meshes: the reference's spec for its JAX
  leaf (``convert.jax_keys``; a stacked leaf's scan axis dropped),
  MiniCPM's embedding fallback included; the reference's policy runs on a
  ``jax.sharding.AbstractMesh`` of the same axes, the port's on a
  duck-typed mesh (axis names and sizes only);
* the decode caches' and the training batch's specs, ``tp_heads``,
  ``n_dispatch_groups``;
* on a 2x2 mesh, each rank's shard under the port's DTensor placements is
  JAX's ``NamedSharding(...).devices_indices_map`` block for the device at
  the same mesh coordinate (the port's ranks run in one subprocess over a
  fake process group, one rank after another);
* ``constrain``: a plain tensor passes on a (1, 1) mesh and raises on a
  2x2 one; a DTensor is redistributed to the hook's placements;
* the smoke MoE's loss and every gradient with 2 dispatch groups against
  the reference's ``make_loss_fn`` under a policy on a real 2x2 JAX mesh,
  rel-L2 <= 1e-5.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import mmdit as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import jax_keys, to_numpy  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch.dryrun import DeviceProgram  # noqa: E402
from repro_torch.models.config import lm_layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.mmdit import MMDiT  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GATE = 1e-5


class FakeMesh:
    """Duck-typed mesh carrying only .shape/.axis_names."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multipod": FakeMesh({"pod": 2, "data": 16, "model": 16})}
ABSTRACT = {k: AbstractMesh(tuple(m.shape.values()), m.axis_names) for k, m in MESHES.items()}
ENTRIES = [None, "data", "model", ("data", "model")]


def _ref_spec(spec, rank: int) -> tuple:
    """A reference ``PartitionSpec`` as the port's tuple, padded to rank."""
    out = tuple(spec)
    return out + (None,) * (rank - len(out))


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


# -- sanitize_spec --------------------------------------------------------------------------


@given(
    dims=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
    entries=st.lists(st.sampled_from(ENTRIES), min_size=0, max_size=4),
)
@settings(max_examples=200, deadline=None)
def test_sanitize_spec_always_valid(dims, entries):
    mesh = MESHES["single"]
    spec = S.sanitize_spec(tuple(dims), tuple(entries), mesh)
    assert len(spec) == len(dims)
    for dim, entry in zip(dims, spec):
        if entry is not None:
            assert dim % S.axes_size(mesh, entry) == 0


@pytest.mark.parametrize("seed", range(4))
def test_sanitize_spec_matches_reference(seed):
    """Random shapes (many divisible by the axes) and specs: the port's
    sanitized spec is the reference's, entry for entry, and divides."""
    rng = np.random.default_rng(seed)
    mesh = MESHES["multipod" if seed % 2 else "single"]
    entries = ENTRIES + ([("pod", "data"), "pod"] if seed % 2 else [])
    for _ in range(250):
        rank = int(rng.integers(1, 5))
        dims = tuple(int(rng.choice([1, 2, 8, 16, 32, 48, 256, 4096, 122753, 36 * 128]))
                     for _ in range(rank))
        spec = tuple(entries[i] for i in rng.integers(0, len(entries), int(rng.integers(0, 6))))
        got = S.sanitize_spec(dims, spec, mesh)
        assert got == _ref_spec(JS.sanitize_spec(dims, P(*spec), mesh), rank), (dims, spec)
        for dim, entry in zip(dims, got):
            assert entry is None or dim % S.axes_size(mesh, entry) == 0


# -- parameters, caches, batches ----------------------------------------------------------------


def _port_model(cfg):
    return (MMDiT if cfg.family == "mmdit" else T.Transformer)(cfg, device="meta")


def _ref_params(arch):
    jcfg = jax_registry.get_config(arch)
    init = JM.init_params if jcfg.family == "mmdit" else JT.init_params
    return jcfg, jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_every_parameter_gets_the_reference_spec(arch, mesh):
    """Every parameter of the full-size port model (on ``meta``) gets the
    spec the reference's ``param_sharding`` gives its JAX leaf (the
    embedding fallback included), the stacked scan axis dropped; and the
    port's parameters cover every JAX leaf."""
    cfg = registry.get_config(arch)
    jcfg, params = _ref_params(arch)
    want = {p: (sh.spec, params_leaf.shape) for (p, sh), params_leaf in zip(
        _paths(JS.make_policy(ABSTRACT[mesh], jcfg).param_sharding(params)).items(),
        _paths(params).values())}
    model = _port_model(cfg)
    got = S.make_policy(MESHES[mesh], cfg).param_sharding(model)
    keys = jax_keys(got, cfg)
    assert {keys[n][0] for n in got} == set(want)
    for name, spec in got.items():
        path, idx = keys[name]
        ref, shape = want[path]
        ref = _ref_spec(ref, len(shape))
        assert spec == (ref if idx is None else ref[1:]), (name, spec, ref)
        assert len(spec) == model.get_parameter(name).ndim


def test_minicpm_embedding_falls_back_to_the_feature_dim():
    cfg = registry.get_config("minicpm-2b")
    assert cfg.vocab % 16
    specs = S.make_policy(MESHES["single"], cfg).param_sharding(_port_model(cfg))
    assert specs["embed"] == (None, "model")
    llama = registry.get_config("llama3.2-1b")
    assert S.make_policy(MESHES["single"], llama).param_sharding(
        _port_model(llama))["embed"] == ("model", "data")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", [a for a in registry.ARCHS if a != "wan2.1-1.3b"])
def test_cache_specs_match_the_reference(arch, mesh):
    """The decode caches of the full config (decode_32k's 128 rows of
    32768, on ``meta``): each layer's leaves get the spec the reference's
    ``cache_sharding`` gives the leaf it sits in."""
    cfg, jcfg = registry.get_config(arch), jax_registry.get_config(arch)
    caches = T.init_cache(cfg, 128, 32768, device="meta")
    got = S.make_policy(MESHES[mesh], cfg).cache_sharding(caches)
    jcaches = jax.eval_shape(lambda: JT.init_cache(jcfg, 128, 32768))
    want = JS.make_policy(ABSTRACT[mesh], jcfg).cache_sharding(jcaches)
    for (where, j), layer, cache in zip(lm_layers(cfg), got, caches):
        for k, spec in layer.items():
            if where in ("lead", "tail"):
                ref, shape = want[where][j][k].spec, jcaches[where][j][k].shape
                assert spec == _ref_spec(ref, len(shape)), (where, j, k)
            else:
                ref, shape = want["blocks"][where][k].spec, jcaches["blocks"][where][k].shape
                assert spec == _ref_spec(ref, len(shape))[1:], (where, k)
            assert len(spec) == cache[k].ndim


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_match_the_reference(mesh):
    """``data_sharding`` and the specs' batch placements (train_4k's batch
    of the LM, the VLM's memory, the MMDiT's latents and text)."""
    from repro_torch.launch import specs

    for arch in ("llama3.2-1b", "llama-3.2-vision-90b", "wan2.1-1.3b"):
        cfg, jcfg = registry.get_config(arch), jax_registry.get_config(arch)
        policy = S.make_policy(MESHES[mesh], cfg)
        shape = registry.SHAPES["train_4k"]
        batch, pls = specs.batch_specs(cfg, shape, policy)
        jbatch, jsh = jax_specs.batch_specs(
            jcfg, jax_registry.SHAPES["train_4k"], JS.make_policy(ABSTRACT[mesh], jcfg))
        assert set(batch) == set(jbatch)
        data = policy.data_sharding(batch)
        for k, t in batch.items():
            assert tuple(t.shape) == jbatch[k].shape and str(t.dtype)[6:] == str(jbatch[k].dtype)
            want = _ref_spec(jsh[k].spec, t.ndim)
            assert data[k] == want, (arch, k)
            assert pls[k] == S.placements(want, MESHES[mesh])


def test_tp_heads_and_dispatch_groups():
    """The SP fallback triggers exactly for the head counts 16 does not
    divide (36, 40); the dispatch groups are the batch axes' devices."""
    expect = {
        "tinyllama-1.1b": True, "minicpm-2b": False, "qwen2.5-14b": False, "llama3.2-1b": True,
        "llama4-scout-17b-a16e": False, "kimi-k2-1t-a32b": True, "recurrentgemma-9b": True,
        "llama-3.2-vision-90b": True, "mamba2-2.7b": True, "musicgen-large": True,
    }
    for arch, tp in expect.items():
        cfg = registry.get_config(arch)
        policy = S.make_policy(MESHES["single"], cfg)
        assert policy.tp_heads is tp is JS.make_policy(ABSTRACT["single"], cfg).tp_heads, arch
    cfg = registry.get_config("kimi-k2-1t-a32b")
    assert S.make_policy(MESHES["single"], cfg).n_dispatch_groups == 16
    assert S.make_policy(MESHES["multipod"], cfg).n_dispatch_groups == 32
    host = S.make_policy(FakeMesh({"data": 1, "model": 1}), cfg)
    assert host.n_dispatch_groups == 1 and host.batch_axes == ("data",)
    assert S.make_policy(MESHES["multipod"], cfg).batch_axes == ("pod", "data")
    assert S.make_policy(MESHES["single"], cfg).resid_mode == "seq"


def test_activation_specs_match_the_reference():
    """Every hook kind's spec for each resid mode, heads that divide and
    heads that do not (the reference builds the same P before its
    constraint)."""
    kinds = {"resid": (16, 4096, 2048), "attn_q": (16, 4096, 32, 64),
             "attn_kv": (16, 4096, 8, 64), "moe_tokens": (16, 4096, 7168),
             "moe_gathered": (16, 32768, 7168), "moe_buffer": (16, 384, 160, 7168),
             "moe_expert_tokens": (384, 2560, 7168)}
    captured = {}

    def wsc(x, sharding):
        captured["spec"] = sharding.spec
        return x

    import unittest.mock as mock

    for arch in ("llama3.2-1b", "qwen2.5-14b"):
        cfg = registry.get_config(arch)
        for mode in ("feature", "replicated", "seq"):
            for mesh in MESHES:
                port = S.make_policy(MESHES[mesh], cfg, resid_mode=mode)
                ref = JS.make_policy(ABSTRACT[mesh], cfg, resid_mode=mode)
                for kind, shape in kinds.items():
                    with mock.patch.object(JS.jax.lax, "with_sharding_constraint", wsc):
                        ref.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
                    assert port.activation_spec(shape, kind) == _ref_spec(
                        captured["spec"], len(shape)), (arch, mode, mesh, kind)
                assert port.activation_spec((2, 3), "unknown") is None


# -- placements on a 2x2 mesh against JAX's index map ------------------------------------------

CASES = [
    ((8, 12), ("data", "model")),
    ((8, 12), ("model", "data")),
    ((8, 12, 4), (("data", "model"), None, None)),
    ((8, 12), (None, ("data", "model"))),
    ((8, 6, 4), ("data", None, "model")),
    ((6, 8), ("model",)),
    ((4, 4), ()),
    ((8, 4, 4), (None, None, ("data", "model"))),
]

_RANKS = r"""
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.distributed import sharding as S
from repro_torch.configs.registry import get_config

cases = json.loads(sys.argv[1])
out = {"ranks": [], "constrain": None}
for rank in range(4):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    blocks = []
    for shape, spec in cases:
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        full = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
        local = S.place(full, S.placements(spec, mesh), mesh).to_local()
        start = [int(i) for i in torch.unravel_index(local.flatten()[0], tuple(shape))]
        assert torch.equal(local, full[tuple(slice(a, a + n) for a, n in zip(start, local.shape))])
        blocks.append([[a, a + n] for a, n in zip(start, local.shape)])
    out["ranks"].append(blocks)
    if rank == 0:
        policy = S.make_policy(mesh, get_config("llama3.2-1b"))
        x = distribute_tensor(torch.zeros(4, 8, 2048), mesh, [Replicate(), Replicate()])
        y = policy.constrain(x, "resid")
        q = policy.constrain(distribute_tensor(torch.zeros(4, 8, 32, 64), mesh,
                                               [Replicate(), Replicate()]), "attn_q")
        out["constrain"] = [str(y.placements), str(S.placements(("data", None, None), mesh)),
                            str(q.placements), str(S.placements(("data", None, "model", None), mesh)),
                            list(y.to_local().shape), list(q.to_local().shape)]
    dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_blocks():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _RANKS, json.dumps(CASES)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("case", range(len(CASES)), ids=lambda i: f"{CASES[i][0]}-{CASES[i][1]}")
def test_placements_match_jax_index_map(port_blocks, case):
    shape, spec = CASES[case]
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    imap = jax.sharding.NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    for rank in range(4):
        dev = mesh.devices[rank // 2, rank % 2]
        want = [[s.start or 0, s.stop if s.stop is not None else n]
                for s, n in zip(imap[dev], shape)]
        assert port_blocks["ranks"][rank][case] == want, (rank, spec)


def test_constrain_redistributes_a_dtensor(port_blocks):
    y_pl, y_want, q_pl, q_want, y_local, q_local = port_blocks["constrain"]
    assert y_pl == y_want and q_pl == q_want
    assert y_local == [2, 8, 2048] and q_local == [2, 8, 16, 64]


def test_constrain_a_plain_tensor():
    cfg = registry.get_config("llama3.2-1b")
    x = torch.zeros(2, 8, 2048)
    one = S.make_policy(FakeMesh({"data": 1, "model": 1}), cfg)
    assert one.constrain(x, "resid") is x and one.constrain(x, "attn_q") is x
    four = S.make_policy(FakeMesh({"data": 2, "model": 2}), cfg)
    with pytest.raises(ValueError, match="4 devices"):
        four.constrain(x, "resid")
    assert four.constrain(x, "not-a-hook") is x  # the reference leaves other kinds alone


def test_placements_refuse_an_order_against_the_mesh():
    with pytest.raises(ValueError, match="axis order"):
        S.placements((("model", "data"),), MESHES["single"])


# -- the MoE at 2 dispatch groups --------------------------------------------------------------


def _rel(got, want) -> float:
    got = np.asarray(got.detach().double().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_moe_loss_and_gradients_at_two_dispatch_groups_match_jax():
    """Kimi's smoke model (a dense lead layer, 2 MoE layers of 8 experts,
    top-2; capacity factor 0.5) under a policy of 2 dispatch groups: the port's ``make_loss_fn``
    (the dry run's ``DeviceProgram`` over a 2x2 policy: one device holding
    the whole program) against the reference's under ``make_policy`` on a
    real 2x2 mesh."""
    arch = "kimi-k2-1t-a32b"
    cfg, jcfg = registry.get_smoke_config(arch), jax_registry.get_smoke_config(arch)
    # capacity factor 0.5: tokens drop, so where the groups split matters
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=0.5))
    model = T.Transformer(cfg, seed=0, device="cpu")
    params = jax.tree.map(jnp.asarray, to_numpy(dict(model.state_dict()), cfg))
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    jmesh = jax.make_mesh((2, 2), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jpolicy = JS.make_policy(jmesh, jcfg)
    assert jpolicy.n_dispatch_groups == 2
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.make_loss_fn(jcfg, jpolicy)(p, b, None)))(params, batch)

    policy = DeviceProgram(S.make_policy(FakeMesh({"data": 2, "model": 2}), cfg), 1)
    assert policy.n_dispatch_groups == 2
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    loss = steps.make_loss_fn(cfg, policy)(model, tb, None)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= GATE * abs(float(jloss))
    grads = to_numpy({n: p.grad for n, p in model.named_parameters()}, cfg)
    want = dict(_paths(jgrads))
    got = dict(_paths(grads))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= GATE, (k, _rel(got[k], want[k]))
    with torch.no_grad():  # one group routes differently: the groups are real
        one = steps.make_loss_fn(cfg)(model, tb, None)
    assert abs(one.item() - loss.item()) > 1e-6
