"""The port's checkpoint store against the JAX package's on the CPU.

Both write manifest v2, so each restores the other's checkpoints: the
port's train state ``{"model", "opt", "step"}`` is stored as the JAX tree
``{"params", "opt", "step"}`` (the MMDiT's blocks stacked, the LM's
``blocks/s<i>`` stacked and its ``tail/<i>`` one a layer), bf16 leaves as
``uint16_bits``.  Every value must come back bitwise, either way, on the
Wan-2.1, Llama-3.2, Mamba-2, Kimi-K2, MusicGen and Llama-3.2-Vision smoke
configurations; the two manifests must
name the same keys, shapes, dtypes and stored markers.  The store's own
contract (retention, the age-gated sweep, retries, mismatch errors, run
state) is checked as the JAX package's tests check it.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import kimi_k2_1t_a32b as jax_kimi  # noqa: E402
from repro.configs import llama3_2_1b as jax_llama  # noqa: E402
from repro.configs import llama3_2_vision_90b as jax_vlm  # noqa: E402
from repro.configs import mamba2_2_7b as jax_mamba  # noqa: E402
from repro.configs import musicgen_large as jax_musicgen  # noqa: E402
from repro.configs import wan2_1_mmdit as jax_wan  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.steps import init_state as jax_init_state  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import kimi_k2_1t_a32b as torch_kimi  # noqa: E402
from repro_torch.configs import llama3_2_1b as torch_llama  # noqa: E402
from repro_torch.configs import llama3_2_vision_90b as torch_vlm  # noqa: E402
from repro_torch.configs import mamba2_2_7b as torch_mamba  # noqa: E402
from repro_torch.configs import musicgen_large as torch_musicgen  # noqa: E402
from repro_torch.configs import wan2_1_mmdit as torch_wan  # noqa: E402
from repro_torch.convert import BF16_BITS, from_jax_params, to_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.steps import init_state  # noqa: E402

#: (JAX config module, port config module, overrides).  The Llama case has
#: 3 layers of the pattern (attn, attn): one stacked superblock and a tail
#: layer.  Kimi-K2's smoke model leads with its first dense layer (an
#: unstacked ``lead/0``) before two stacked MoE layers, and keeps its AdamW
#: moments in bf16 (``opt_state_dtype``).  MusicGen's LayerNorms carry
#: biases (``norm1.b`` and ``norm2.b`` stacked, ``final_norm.b`` not), and
#: the VLM's cross layer a scalar f32 ``gate`` stacked to [n_rep]
CASES = {
    "wan": (jax_wan, torch_wan, {}),
    "wan-bf16": (jax_wan, torch_wan, {"dtype": "bfloat16"}),
    "llama-tail": (jax_llama, torch_llama, {"n_layers": 3, "pattern": ("attn", "attn")}),
    "llama-bf16": (jax_llama, torch_llama, {"dtype": "bfloat16"}),
    "mamba2": (jax_mamba, torch_mamba, {}),
    "kimi": (jax_kimi, torch_kimi, {}),
    "musicgen": (jax_musicgen, torch_musicgen, {}),
    "vlm": (jax_vlm, torch_vlm, {}),
}
OPT = dict(peak_lr=1e-3, schedule="constant", warmup=0)  # state_dtype: the config's


def _cfgs(case):
    jm, tm, kw = CASES[case]
    return (dataclasses.replace(jm.smoke_config(), **kw),
            dataclasses.replace(tm.smoke_config(), **kw))


def _port_state(cfg, seed: int, step: int):
    """The port's train state with moments drawn from ``seed`` (init's are
    zero: a restore into zeros would prove nothing)."""
    state = init_state(cfg, adamw.OptimizerConfig(**OPT, state_dtype=cfg.opt_state_dtype),
                       seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for moment in ("m", "v"):
            for t in state["opt"][moment].values():
                t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape))).to(t.dtype))
    state["step"] = step
    return state


def _jax_opt(jcfg):
    return jax_adamw.OptimizerConfig(**OPT, state_dtype=jcfg.opt_state_dtype)


def _jax_state(jcfg, seed: int, step: int):
    state = jax_init_state(jax.random.PRNGKey(seed), jcfg, _jax_opt(jcfg))
    rng = np.random.default_rng(seed)
    state["opt"] = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)).astype(a.dtype),
        state["opt"])
    state["step"] = jnp.int32(step)
    return state


def _jax_like(jcfg):
    return jax.eval_shape(lambda: jax_init_state(jax.random.PRNGKey(0), jcfg, _jax_opt(jcfg)))


def _bits(a) -> np.ndarray:
    """An array's raw bits (bf16 and its kept form as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind in "Vf" else a


def _port_tree(state) -> dict:
    """The port's train state as the JAX tree of numpy arrays (bf16 kept)."""
    cfg = state["model"].cfg
    return {"params": to_numpy(dict(state["model"].named_parameters()), cfg, keep_dtype=True),
            "opt": {k: to_numpy(state["opt"][k], cfg, keep_dtype=True) for k in ("m", "v")},
            "step": np.int32(state["step"])}


def _assert_bitwise(port_tree, jax_tree):
    got = jax.tree_util.tree_leaves_with_path(port_tree)
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jax_tree))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w)), jax.tree_util.keystr(path)


def _manifest(d) -> dict:
    step_dir = sorted(p for p in d.iterdir() if p.name.startswith("step-"))[-1]
    return json.loads((step_dir / "manifest.json").read_text())


@pytest.mark.parametrize("case", CASES)
def test_port_round_trip_is_bitwise(case, tmp_path):
    _, cfg = _cfgs(case)
    saved = _port_state(cfg, seed=0, step=7)
    store.save(saved, 7, tmp_path)
    if cfg.dtype == "bfloat16":
        leaves = _manifest(tmp_path)["leaves"]
        assert leaves["params/embed" if cfg.family != "mmdit" else "params/x_in"][
            "stored"] == "uint16_bits"
    fresh = _port_state(cfg, seed=1, step=0)
    params = dict(fresh["model"].named_parameters())
    out = store.restore(tmp_path, fresh)
    assert out["step"] == 7 and isinstance(out["step"], int)
    assert out["model"] is fresh["model"] and out["opt"] is fresh["opt"]
    for name, p in saved["model"].named_parameters():
        assert params[name] is dict(out["model"].named_parameters())[name]
        assert torch.equal(p.view(torch.int16) if p.dtype == torch.bfloat16 else p,
                           params[name].view(torch.int16)
                           if p.dtype == torch.bfloat16 else params[name]), name
    for moment in ("m", "v"):
        for name, t in saved["opt"][moment].items():
            assert torch.equal(t, out["opt"][moment][name]), (moment, name)


@pytest.mark.parametrize("case", CASES)
def test_jax_checkpoint_restores_into_the_port(case, tmp_path):
    jcfg, cfg = _cfgs(case)
    jstate = _jax_state(jcfg, seed=0, step=5)
    jstore.save(jstate, 5, tmp_path)
    out = store.restore(tmp_path, _port_state(cfg, seed=3, step=0))
    assert out["step"] == 5
    # the converter's reading of the same tree, bitwise
    want = from_jax_params(jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu")
    got = dict(out["model"].named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    _assert_bitwise(_port_tree(out), jstate)


@pytest.mark.parametrize("case", CASES)
def test_port_checkpoint_restores_into_jax(case, tmp_path):
    jcfg, cfg = _cfgs(case)
    state = _port_state(cfg, seed=4, step=9)
    store.save(state, 9, tmp_path)
    restored = jstore.restore(tmp_path, _jax_like(jcfg))
    assert int(restored["step"]) == 9
    _assert_bitwise(_port_tree(state), restored)


@pytest.mark.parametrize("case", CASES)
def test_manifests_name_the_same_leaves(case, tmp_path):
    jcfg, cfg = _cfgs(case)
    jstore.save(_jax_state(jcfg, seed=0, step=2), 2, tmp_path / "jax")
    store.save(_port_state(cfg, seed=0, step=2), 2, tmp_path / "port")
    j, t = _manifest(tmp_path / "jax"), _manifest(tmp_path / "port")
    assert (t["version"], t["step"]) == (j["version"], j["step"]) == (2, 2)
    assert t["leaves"] == j["leaves"]  # keys, entries, shapes, dtypes, stored markers
    if cfg.dtype == "bfloat16":
        assert any(m.get("stored") == "uint16_bits" for m in t["leaves"].values())


def test_to_numpy_keeps_bf16_bits_on_request():
    """``to_numpy`` widens bf16 to f32 for its parity callers; the store's
    dtype-keeping path carries the bits exactly, and the converter reads
    them back."""
    _, cfg = _cfgs("wan-bf16")
    model = init_state(cfg, adamw.OptimizerConfig(**OPT), seed=5, device="cpu")["model"]
    params = dict(model.named_parameters())
    wide = to_numpy(params, cfg)
    kept = to_numpy(params, cfg, keep_dtype=True)
    assert wide["x_in"].dtype == np.float32 and kept["x_in"].dtype == BF16_BITS
    assert kept["blocks"]["mlp"]["w1"].dtype == BF16_BITS
    assert kept["blocks"]["mlp"]["w1"].shape[0] == cfg.n_layers
    assert np.array_equal(kept["x_in"].view(np.uint16),
                          params["x_in"].detach().view(torch.int16).numpy().view(np.uint16))
    # the widened values are the kept bits' values exactly
    assert np.array_equal(wide["x_in"], (kept["x_in"].view(np.uint16).astype(np.uint32) << 16)
                          .view(np.float32))
    back = from_jax_params(kept, cfg, device="cpu")
    for name, p in params.items():
        assert back[name].dtype == p.dtype and torch.equal(back[name], p.detach()), name


# -- the store's own contract (tests/test_checkpoint.py, tests/test_chaos.py) ------------


def test_plain_tree_round_trip_and_bf16(tmp_path):
    x = torch.linspace(-3.0, 3.0, 64).to(torch.bfloat16)
    state = {"w": x, "n": np.arange(5, dtype=np.int64), "blocks": [torch.ones(2), 3]}
    store.save(state, 1, tmp_path)
    manifest = _manifest(tmp_path)
    assert manifest["leaves"]["w"] == {"entry": "a3", "shape": [64], "dtype": "bfloat16",
                                       "stored": "uint16_bits"}
    like = {"w": torch.zeros(64, dtype=torch.bfloat16), "n": np.zeros(5, np.int64),
            "blocks": [torch.zeros(2), 0]}
    out = store.restore(tmp_path, like)
    assert out["w"] is like["w"] and torch.equal(like["w"].view(torch.int16), x.view(torch.int16))
    assert np.array_equal(out["n"], state["n"]) and out["blocks"][1] == 3
    assert torch.equal(like["blocks"][0], torch.ones(2))
    # the JAX package reads the same checkpoint
    jout = jstore.restore(tmp_path, {"w": jax.ShapeDtypeStruct((64,), jnp.bfloat16),
                                     "n": jax.ShapeDtypeStruct((5,), jnp.int64),
                                     "blocks": [jax.ShapeDtypeStruct((2,), jnp.float32),
                                                jax.ShapeDtypeStruct((), jnp.int64)]})
    assert np.array_equal(np.asarray(jout["w"]).view(np.uint16),
                          x.view(torch.int16).numpy().view(np.uint16))


def test_retention_keeps_newest_k(tmp_path):
    state = {"w": torch.zeros(2)}
    for s in range(1, 6):
        store.save(state, s, tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step-*")) == ["step-000000004",
                                                               "step-000000005"]
    assert store.latest_step(tmp_path) == 5


def test_restore_mismatch_errors(tmp_path):
    store.save({"a": torch.zeros(2), "b": torch.ones(3)}, 1, tmp_path)
    with pytest.raises(ValueError, match="mismatch"):
        store.restore(tmp_path, {"a": torch.zeros(2)})  # a leaf missing from like
    with pytest.raises(ValueError, match="mismatch"):
        store.restore(tmp_path, {"a": torch.zeros(2), "b": torch.ones(3), "c": torch.ones(())})
    with pytest.raises(ValueError, match="shape"):
        store.restore(tmp_path, {"a": torch.zeros(5), "b": torch.ones(3)})
    a = torch.full((2,), 7.0)
    with pytest.raises(ValueError, match="dtype"):
        store.restore(tmp_path, {"a": a, "b": torch.ones(3, dtype=torch.float64)})
    assert torch.equal(a, torch.full((2,), 7.0))  # every leaf checked before any write
    # a train state of another configuration: its leaves differ
    _, cfg = _cfgs("wan")
    store.save(_port_state(cfg, seed=0, step=1), 1, tmp_path / "wan")
    other = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    with pytest.raises(ValueError, match="shape"):
        store.restore(tmp_path / "wan", _port_state(other, seed=0, step=0))


def test_stale_tmp_swept_but_live_writes_spared(tmp_path):
    old = time.time() - 2 * store.TMP_SWEEP_MIN_AGE_S
    (tmp_path / "tmp-3").mkdir(parents=True)
    (tmp_path / "tmp-3" / "arrays.npz").write_bytes(b"partial garbage")
    os.utime(tmp_path / "tmp-3", (old, old))
    store.save({"w": torch.zeros(1)}, 4, tmp_path)
    assert not list(tmp_path.glob("tmp-*"))
    (tmp_path / "tmp-9").mkdir()
    os.utime(tmp_path / "tmp-9", (old, old))
    (tmp_path / "tmp-11").mkdir()  # fresh: a concurrent writer's
    assert store.latest_step(tmp_path) == 4
    assert [p.name for p in tmp_path.glob("tmp-*")] == ["tmp-11"]


def test_run_state_round_trip_and_weights_only(tmp_path):
    state = {"w": torch.arange(4.0)}
    rs = {"step": 7, "trainer": {"rng": [0, 7]}, "loader": {"seq": 7}}
    store.save(state, 7, tmp_path, run_state=rs)
    assert store.load_run_state(tmp_path) == rs
    store.save(state, 8, tmp_path)
    assert store.load_run_state(tmp_path) is None
    assert store.load_run_state(tmp_path, step=7) == rs
    # a v1 manifest (no version field) restores and has no run state
    final = tmp_path / "step-000000008"
    manifest = json.loads((final / "manifest.json").read_text())
    del manifest["version"]
    (final / "manifest.json").write_text(json.dumps(manifest))
    out = store.restore(tmp_path, {"w": torch.zeros(4)})
    assert torch.equal(out["w"], state["w"])


def _flaky_replace(monkeypatch, n_failures: int, message: str = "transient"):
    real_replace = os.replace
    fails = {"n": n_failures}

    def flaky(src, dst):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError(message)
        return real_replace(src, dst)

    monkeypatch.setattr("repro_torch.checkpoint.store.os.replace", flaky)


def test_save_retries_transient_os_errors(tmp_path, monkeypatch):
    _flaky_replace(monkeypatch, 2)
    seen = []
    state = {"w": np.arange(4, dtype=np.float32)}
    store.save(state, 1, tmp_path, backoff_s=0.0, on_retry=lambda a, e: seen.append(a))
    assert seen == [1, 2]
    out = store.restore(tmp_path, {"w": np.zeros(4, np.float32)})
    np.testing.assert_array_equal(out["w"], state["w"])


def test_save_gives_up_after_max_attempts(tmp_path, monkeypatch):
    _flaky_replace(monkeypatch, 10, "disk on fire")
    with pytest.raises(OSError, match="disk on fire"):
        store.save({"w": np.ones(2, np.float32)}, 1, tmp_path, max_attempts=3, backoff_s=0.0)
    with pytest.raises(ValueError):
        store.save({"w": np.ones(2, np.float32)}, 1, tmp_path, max_attempts=0)


def test_missing_checkpoint_is_not_retried(tmp_path):
    calls = []
    with pytest.raises(FileNotFoundError):
        store.restore(tmp_path / "nope", {"w": np.zeros(2)},
                      on_retry=lambda a, e: calls.append(a))
    assert calls == []  # a missing checkpoint is an answer, not a flake
    assert store.latest_step(tmp_path / "nope") is None
