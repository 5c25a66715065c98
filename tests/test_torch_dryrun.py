"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.specs``,
``launch.comm_stats``, the registry's shape catalogue and the kernels'
``meta`` route) against the JAX package's, on the CPU.

* ``SHAPES``, ``arch_ids``, ``cell_supported`` (every pair, reasons
  included) and ``probe_config`` equal the reference's;
* ``collective_stats`` equals ``hlo_stats.collective_stats`` on an HLO
  text that holds the same ops and output shapes, tuples included;
* at full size on the single mesh (a fake process group of 256 ranks in a
  subprocess): the dry run's ``argument_bytes`` of the train state and
  batch of a dense LM, an MoE and the MMDiT, and of the parameters, caches
  and token of two decode cells, equal what the reference's leaves give
  divided by the axes its ``param_spec`` / ``cache_sharding`` / batch
  rules name (JAX's own ``shard_shape`` on an ``AbstractMesh``; the
  reference's int32 ``step`` and ``pos`` and its key are left out: the
  port passes them as Python values);
* one device (``--mesh host`` on the CPU, a one-rank gloo group, in the
  same subprocess): two cells traced whole, ``argument_bytes`` exactly the
  arguments' bytes, the decode cell's operations exactly its products'
  count, no collectives;
* the kernels' ``meta`` route: shapes and dtypes as the plain versions',
  the flash kernels' operation counts, the refusals (no shape function,
  segment ids), and the ``LiveBytes`` tracker's peak on a small program;
* a failing cell makes the run exit non-zero.
"""

import importlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import hlo_stats  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import mmdit as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import meta as kmeta  # noqa: E402
from repro_torch.kernels.flash_attention.flash import live_tile_pairs  # noqa: E402
from repro_torch.launch import comm_stats, dryrun  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SINGLE = AbstractMesh((16, 16), ("data", "model"))


@pytest.fixture(scope="module")
def jax_dryrun():
    """The reference's dry-run module, imported with the environment put
    back: it sets ``XLA_FLAGS`` when imported (for its own process)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


# -- the catalogue -------------------------------------------------------------------------


def test_shapes_and_arch_ids_match_the_reference():
    assert registry.arch_ids() == jax_registry.arch_ids()
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in registry.SHAPES.items()} \
        == {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in jax_registry.SHAPES.items()}


@pytest.mark.parametrize("arch", jax_registry.arch_ids())
def test_cell_supported_matches_the_reference(arch):
    cfg, jcfg = registry.get_config(arch), jax_registry.get_config(arch)
    assert cfg.subquadratic == jcfg.subquadratic
    for name in jax_registry.SHAPES:
        assert registry.cell_supported(cfg, registry.SHAPES[name]) == \
            jax_registry.cell_supported(jcfg, jax_registry.SHAPES[name]), name


def test_the_catalogue_has_33_cells_a_mesh():
    cells = [registry.cell_supported(registry.get_config(a), s)[0]
             for a in registry.arch_ids() for s in registry.SHAPES.values()]
    assert sum(cells) == 33 and len(cells) - sum(cells) == 11
    long = [a for a in registry.arch_ids()
            if registry.cell_supported(registry.get_config(a), registry.SHAPES["long_500k"])[0]]
    assert long == ["recurrentgemma-9b", "mamba2-2.7b"]


@pytest.mark.parametrize("arch", jax_registry.arch_ids())
def test_probe_config_matches_the_reference(arch, jax_dryrun):
    for k in (2, 4):
        got = dryrun.probe_config(registry.get_config(arch), k)
        want = jax_dryrun.probe_config(jax_registry.get_config(arch), k)
        assert got.n_layers == want.n_layers and got.layer_kinds() == want.layer_kinds()


# -- collective accounting -----------------------------------------------------------------

HLO_CASES = {
    "gather-reduce": (
        "%all-gather.3 = bf16[16,128]{1,0} all-gather(bf16[1,128]{1,0} %p), dimensions={0}\n"
        "%ar = f32[4096]{0} all-reduce(f32[4096]{0} %x), to_apply=%sum\n"
        "%rs.1 = f32[256,7]{1,0} reduce-scatter(f32[4096,7]{1,0} %y), dimensions={0}\n",
        [("all-gather", [((16, 128), torch.bfloat16)]), ("all-reduce", [((4096,), torch.float32)]),
         ("reduce-scatter", [((256, 7), torch.float32)])]),
    "tuple": (
        "ROOT %t = (f32[2,4]{1,0}, bf16[8]{0}) all-reduce(f32[2,4]{1,0} %a, bf16[8]{0} %b)\n"
        "%a2a = s32[8,2]{1,0} all-to-all(s32[8,2]{1,0} %c), dimensions={0}\n"
        "%cp = bf16[3,5]{1,0} collective-permute(bf16[3,5]{1,0} %d), pairs={{0,1}}\n"
        "%ag = (f32[6]{0}, f32[2,3]{1,0}) all-gather-start(f32[3]{0} %e, f32[1,3]{1,0} %f)\n",
        [("all-reduce", [((2, 4), torch.float32), ((8,), torch.bfloat16)]),
         ("all-to-all", [((8, 2), torch.int32)]),
         ("collective-permute", [((3, 5), torch.bfloat16)]),
         ("all-gather", [((6,), torch.float32), ((2, 3), torch.float32)])]),
    "torch-names": (
        "%ag = f32[64,32]{1,0} all-gather(f32[4,32]{1,0} %p)\n"
        "%rs = bf16[2,2,2]{2,1,0} reduce-scatter(bf16[4,2,2]{2,1,0} %q)\n"
        "%ar = f64[5]{0} all-reduce(f64[5]{0} %r)\n",
        [("_c10d_functional.all_gather_into_tensor.default", [((64, 32), torch.float32)]),
         ("_c10d_functional.reduce_scatter_tensor.default", [((2, 2, 2), torch.bfloat16)]),
         ("_c10d_functional.all_reduce.default", [((5,), torch.float64)])]),
}


@pytest.mark.parametrize("case", list(HLO_CASES))
def test_collective_stats_matches_hlo_stats(case):
    text, ops = HLO_CASES[case]
    got = comm_stats.collective_stats([comm_stats.record(op, outs) for op, outs in ops])
    assert got == hlo_stats.collective_stats(text)


def test_collective_names_are_the_reference_five():
    assert comm_stats.COLLECTIVES == hlo_stats.COLLECTIVES
    with pytest.raises(ValueError):
        comm_stats.op_name("aten.mm.default")


# -- argument bytes at full size, and one device -------------------------------------------

FULL = [("llama3.2-1b", "train_4k"), ("kimi-k2-1t-a32b", "train_4k"),
        ("wan2.1-1.3b", "train_4k"), ("llama3.2-1b", "decode_32k"),
        ("kimi-k2-1t-a32b", "decode_32k"), ("llama-3.2-vision-90b", "prefill_32k")]
HOST = [("llama3.2-1b", "train_4k", 1), ("llama3.2-1b", "decode_32k", 2)]

_CHILD = r"""
import json, sys
import torch.distributed as dist
from repro_torch.configs.registry import SHAPES, get_config, get_optimizer
from repro_torch.distributed.sharding import make_policy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

full, host = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {"full": {}, "host": {}}
mesh = make_production_mesh()
for arch, shape in full:
    cfg = get_config(arch)
    cell = dryrun.prepare_cell(cfg, SHAPES[shape], make_policy(mesh, cfg), get_optimizer(arch))
    out["full"][f"{arch}|{shape}"] = cell.argument_bytes
dist.destroy_process_group()
mesh = make_host_mesh("cpu")
for arch, shape, batch in host:
    out["host"][f"{arch}|{shape}"] = dryrun.run_cell(arch, shape, "host", global_batch=batch,
                                                     mesh=mesh)
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def child():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(FULL), json.dumps(HOST)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _shard_bytes(leaf, sharding) -> int:
    return int(np.prod(sharding.shard_shape(leaf.shape))) * jnp.dtype(leaf.dtype).itemsize


def _tree_bytes(tree, shardings) -> int:
    return sum(_shard_bytes(leaf, sh) for leaf, sh in
               zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)))


def _reference_argument_bytes(arch: str, shape_name: str) -> int:
    jcfg = jax_registry.get_config(arch)
    shape = jax_registry.SHAPES[shape_name]
    policy = JS.make_policy(SINGLE, jcfg)
    if shape.kind == "train":
        st = jax_steps.state_shapes(jcfg, jax_registry.get_optimizer(arch))
        total = sum(_tree_bytes(t, policy.param_sharding(t))
                    for t in (st["params"], st["opt"]["m"], st["opt"]["v"]))
        batch, sh = jax_specs.batch_specs(jcfg, shape, policy)
        return total + _tree_bytes(batch, sh)
    init = JM.init_params if jcfg.family == "mmdit" else JT.init_params
    params = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
    total = _tree_bytes(params, policy.param_sharding(params))
    if shape.kind == "prefill":
        args, in_sh, _ = jax_specs.prefill_specs(jcfg, shape, policy)
        return total + _tree_bytes(args[1:], in_sh[1:])
    args, in_sh, _ = jax_specs.decode_specs(jcfg, shape, policy)
    caches, token = args[1], args[2]
    return total + _tree_bytes(caches, in_sh[1]) + _tree_bytes(token, in_sh[2])


@pytest.mark.parametrize("cell", FULL, ids=lambda c: "|".join(c))
def test_argument_bytes_equal_the_reference_shards(child, cell):
    assert child["full"]["|".join(cell)] == _reference_argument_bytes(*cell)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def test_host_train_cell(child):
    """llama3.2-1b train_4k on one device at batch 1: the arguments are
    the parameters, both f32 moments and the batch, exactly; the
    operations scale with the batch; nothing is gathered."""
    from repro_torch.models.transformer import Transformer

    rec = child["host"]["llama3.2-1b|train_4k"]
    cfg = registry.get_config("llama3.2-1b")
    params = sum(_nbytes(p) for p in Transformer(cfg, device="meta").parameters())
    n = sum(p.numel() for p in Transformer(cfg, device="meta").parameters())
    assert rec["status"] == "ok" and rec["n_chips"] == 1 and rec["batch_shards"] == 1
    assert rec["memory"]["argument_bytes"] == params + 2 * 4 * n + 2 * 4096 * 4
    assert rec["memory"]["peak_bytes"] == rec["memory"]["argument_bytes"] + \
        rec["memory"]["temp_bytes"]
    assert rec["memory"]["alias_bytes"] == params + 8 * n
    assert rec["collectives"]["total_bytes"] == 0 and rec["collectives"]["total_count"] == 0
    # at least the 6 N D of a dense step and the recompute's 2 N D over the
    # matmul weights, at most twice that
    flops = rec["flops"]
    assert 8 * (n - cfg.vocab * cfg.d_model) * 4096 < flops < 16 * n * 4096
    assert rec["flops_scope"] == "global / n_chips" and rec["collectives_scope"] == "params"


def test_host_decode_cell_counts_its_products(child):
    """llama3.2-1b decode_32k on one device at batch 2, ``pos`` the cache's
    last slot: the arguments are the parameters, the caches and the token;
    the operations are exactly the products of one decode step: the
    projections, the attention over every cached position (kv repeated to
    every head) and the LM head, 2 a multiply-add."""
    from repro_torch.models.transformer import Transformer

    rec = child["host"]["llama3.2-1b|decode_32k"]
    cfg = registry.get_config("llama3.2-1b")
    b, cap = 2, 32768
    d, h, hkv, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    params = sum(_nbytes(p) for p in Transformer(cfg, device="meta").parameters())
    caches = cfg.n_layers * 2 * b * cap * hkv * dh * 2
    assert rec["memory"]["argument_bytes"] == params + caches + b * 4
    per_layer = d * (h + 2 * hkv) * dh + h * dh * d + 3 * d * f
    attn = 2 * h * cap * dh
    want = 2 * b * (cfg.n_layers * (per_layer + attn) + cfg.vocab * d)
    assert rec["flops"] == want
    assert rec["memory"]["alias_bytes"] == caches  # the caches are written in place
    assert rec["memory"]["output_bytes"] == caches + b * cfg.vocab * 4
    assert rec["collectives"]["total_count"] == 0


# -- the kernels' meta route ---------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cpu(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(dtype)


def test_norm_shape_functions_match_the_plain_versions():
    """The forward and backward outputs on ``meta`` have the shapes and
    dtypes of the plain versions' on the CPU, and a norm counts no
    operations."""
    kmeta.reset_flops()
    cases = [
        (kernels.rms_norm, ((2, 8, 64), (64,))),
        (kernels.gated_rms_norm, ((2, 8, 64), (64,), (2, 8, 64))),
        (kernels.adaln_modulate, ((2, 8, 64), (2, 64), (2, 64))),
    ]
    for fn, shapes in cases:
        for grad in (False, True):
            m_in = [_meta(*s, dtype=torch.float32).requires_grad_(grad) for s in shapes]
            c_in = [_cpu(*s).requires_grad_(grad) for s in shapes]
            mo, co = fn(*m_in), fn(*c_in)
            assert mo.device.type == "meta" and mo.shape == co.shape and mo.dtype == co.dtype
            if grad:
                mg = torch.autograd.grad(mo.sum(), m_in)
                cg = torch.autograd.grad(co.sum(), c_in)
                assert [(g.shape, g.dtype) for g in mg] == [(g.shape, g.dtype) for g in cg]
    q, k = _meta(2, 8, 4, 64).requires_grad_(), _meta(2, 8, 2, 64).requires_grad_()
    wq, wk = _meta(64, dtype=torch.float32), _meta(64, dtype=torch.float32)
    yq, yk = kernels.qk_norm(q, k, wq.requires_grad_(), wk.requires_grad_())
    grads = torch.autograd.grad((yq.float().sum() + yk.float().sum()), (q, k, wq, wk))
    assert [g.shape for g in grads] == [q.shape, k.shape, wq.shape, wk.shape]
    assert kmeta.flops() == 0 and kmeta.bytes_moved() > 0


@pytest.mark.parametrize("causal", [False, True])
def test_flash_shape_functions_count_live_tile_products(causal):
    b, s, hq, hkv, dh = 2, 320, 8, 2, 64
    q = _meta(b, s, hq, dh).requires_grad_()
    k, v = _meta(b, s, hkv, dh).requires_grad_(), _meta(b, s, hkv, dh).requires_grad_()
    unit = live_tile_pairs(s, s, causal=causal) * b * hq * 2 * 64 * 64 * dh
    kmeta.reset_flops()
    with torch.no_grad():
        out = kernels.attention(q, k, v, causal=causal)
    assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "meta"
    assert kmeta.flops() == 2 * unit
    kmeta.reset_flops()
    out = kernels.attention(q, k, v, causal=causal)
    dq, dk, dv = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert kmeta.flops() == (2 + 3 + 4) * unit  # K7, then K8 and K9


def test_meta_refusals():
    q = _meta(2, 64, 4, 64)
    ids = torch.zeros(2, 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="segment ids"):
        kernels.attention(q, q, q, causal=True, q_segment_ids=ids, kv_segment_ids=ids)
    pages = _meta(5, 16, 4, 64)
    table = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="no shape function"):
        kernels.paged_attention(_meta(2, 4, 64), pages, pages, table, table[:, 0])
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        kernels.attention(q, q, q, causal=True, seq_group=object())  # the ring
    with pytest.raises(NotImplementedError, match="no shape function"):
        kmeta.on_device(kernels.KERNELS["adaln_bwd_dmod_naive"], q)
    assert kmeta.pick(kernels.KERNELS["rms_fwd"], "plain", torch.zeros(1)) == "plain"
    assert kmeta.on_device(kernels.KERNELS["rms_fwd"], q) is kmeta.SHAPES["rms_fwd"]


def test_live_bytes_counts_what_ops_allocate():
    a = _meta(1000, dtype=torch.float32)  # an argument: not counted
    tracer = dryrun.LiveBytes()
    with tracer:
        b = a * 2  # 4000 live
        c = b.view(10, 100)  # a view: nothing new
        d = c + 1  # 8000 live: the peak
        del b, c
        e = d.sum()  # 4004 live
        a.mul_(3)  # in place on the argument: nothing new
    assert tracer.peak == 8000 and tracer.live == 4004
    assert tracer.moved == 2 * 4000 + 2 * 4000 + 4000 + 4 + 2 * 4000  # b, d, e, the mul_
    del d, e
    assert tracer.live == 0


def test_optimizer_blocks_on_meta_are_one_of_each_shape():
    big = adamw.CHUNK_THRESHOLD_ELEMS
    t = torch.empty((5, big // 2 + 7), device="meta")
    blocks = adamw._blocks(t)
    assert [b.shape[0] for b in blocks] == [1]  # every block one row: one shape
    t = torch.empty((3 * 4 + 1, big // 4), device="meta")
    assert [b.shape[0] for b in adamw._blocks(t)] == [4, 1]
    cpu = torch.empty((9, 2**23 + 1))  # above the threshold: every block on the CPU
    assert sum(b.shape[0] for b in adamw._blocks(cpu)) == 9


def test_models_build_on_meta_without_drawing():
    """Full-size models on ``meta`` hold their shapes and dtypes; the
    seeded weights of a CPU model are unchanged by the meta route."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import Transformer

    cfg = registry.get_smoke_config("llama3.2-1b")
    cpu, met = Transformer(cfg, device="cpu"), Transformer(cfg, device="meta")
    assert [(n, p.shape, p.dtype) for n, p in cpu.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in met.named_parameters()]
    g = torch.Generator().manual_seed(5)
    w = layers.dense_init(g, 8, 4, torch.float32, "cpu")
    want = torch.randn((8, 4), generator=torch.Generator().manual_seed(5)) * 8**-0.5
    assert torch.equal(w.data, want)
    assert layers.init_generator(0, "meta") is None


def test_a_failing_cell_makes_the_run_fail(monkeypatch, tmp_path):
    def boom(*a, **k):
        raise RuntimeError("no")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    monkeypatch.setattr(dryrun, "_mesh", lambda *a, **k: None)
    out = tmp_path / "res.json"
    rc = dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--results", str(out)])
    assert rc == 1
    assert json.loads(out.read_text())["llama3.2-1b|train_4k|single"]["status"] == "error"
    monkeypatch.undo()
    rc = dryrun.main(["--arch", "wan2.1-1.3b", "--shape", "decode_32k", "--results", str(out)])
    assert rc == 0  # a skipped cell is no failure
