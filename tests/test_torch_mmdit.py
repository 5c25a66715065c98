"""The port's MMDiT against the JAX MMDiT: configuration copies, parameter
conversion, and the denoise-step velocity on the smoke config in f32
(rel-L2 <= 1e-5, the oracle gate of the JAX package's own model tests)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import wan2_1_mmdit as jax_wan  # noqa: E402
from repro.models import config as jax_config  # noqa: E402
from repro.models import mmdit as M  # noqa: E402
from repro.train.steps import make_denoise_step as jax_denoise_step  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs import wan2_1_mmdit as torch_wan  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import config as torch_config  # noqa: E402
from repro_torch.models.mmdit import MMDiT, timestep_embedding  # noqa: E402
from repro_torch.train.steps import make_denoise_step  # noqa: E402


def _fields(cls):
    return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelConfig", "MoEConfig", "SSMConfig"])
def test_config_dataclass_copies_field_for_field(name):
    assert _fields(getattr(torch_config, name)) == _fields(getattr(jax_config, name))


@pytest.mark.parametrize("fn", ["config", "config_14b", "smoke_config"])
def test_wan_configs_match(fn):
    assert dataclasses.asdict(getattr(torch_wan, fn)()) == dataclasses.asdict(
        getattr(jax_wan, fn)()
    )
    if fn == "config":
        assert registry.get_config("wan2.1-1.3b") == torch_wan.config()


def _jax_params(cfg, seed=1):
    return M.init_params(jax.random.PRNGKey(seed), cfg)


def _port(cfg, params):
    model = MMDiT(cfg, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu"), strict=True
    )
    return model


def test_from_jax_params_maps_every_leaf():
    cfg = jax_wan.smoke_config()
    params = jax.tree.map(np.asarray, _jax_params(cfg))
    state = from_jax_params(params, cfg, device="cpu")
    model_state = MMDiT(cfg, device="cpu").state_dict()
    assert set(state) == set(model_state)
    n_leaves = sum(
        cfg.n_layers if path[0].key == "blocks" else 1
        for path, _ in jax.tree_util.tree_leaves_with_path(params)
    )
    assert len(state) == n_leaves
    for name, t in state.items():
        assert t.shape == model_state[name].shape and t.dtype == model_state[name].dtype
    # [d_in, d_out] kept as is (x @ W), one entry per stacked layer
    np.testing.assert_array_equal(state["blocks.1.wqkv"].numpy(), params["blocks"]["wqkv"][1])
    np.testing.assert_array_equal(state["blocks.0.mlp.w2"].numpy(), params["blocks"]["mlp"]["w2"][0])
    np.testing.assert_array_equal(state["x_out"].numpy(), params["x_out"])


def test_from_jax_params_bf16_bits():
    cfg = dataclasses.replace(jax_wan.smoke_config(), dtype="bfloat16")
    params = jax.tree.map(np.asarray, _jax_params(cfg))
    state = from_jax_params(params, cfg, device="cpu")
    assert state["x_in"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["x_in"].view(torch.int16).numpy(), params["x_in"].view(np.int16)
    )


def test_timestep_embedding_matches():
    t = np.array([0.0, 0.25, 0.9, 1.0], np.float32)
    ej = np.asarray(M.timestep_embedding(jnp.asarray(t), 256))
    et = timestep_embedding(torch.from_numpy(t), 256).numpy()
    # XLA's and PyTorch's f32 exp differ by an ulp on some frequencies, and
    # angles reach t * 1000 rad: 1000 * 2^-24 ~ 6e-5
    np.testing.assert_allclose(et, ej, atol=1e-4)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("segmented", [True, False])
def test_denoise_velocity_matches_jax(segmented):
    cfg = jax_wan.smoke_config()
    params = _jax_params(cfg)
    model = _port(cfg, params)
    rng = np.random.default_rng(3)
    b, s = 2, 24
    lat = rng.standard_normal((b, s, cfg.in_channels * 4)).astype(np.float32)
    txt = rng.standard_normal((b, cfg.text_len, 4096)).astype(np.float32)
    t = np.array([0.3, 0.9], np.float32)
    kw_j, kw_t = {}, {}
    if segmented:
        seg = np.stack([
            np.array([0] * 10 + [1] * 10 + [-1] * 4, np.int32),
            np.zeros(s, np.int32),
        ])
        tseg = np.stack([
            np.array([0] * 8 + [1] * 6 + [-1] * 2, np.int32),
            np.zeros(cfg.text_len, np.int32),
        ])
        kw_j = dict(segment_ids=jnp.asarray(seg), text_segment_ids=jnp.asarray(tseg))
        kw_t = dict(segment_ids=torch.from_numpy(seg), text_segment_ids=torch.from_numpy(tseg))
    v_j = np.asarray(jax_denoise_step(cfg)(
        params, jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(t), **kw_j
    ))
    v_t = make_denoise_step(cfg)(
        model, torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(t), **kw_t
    )
    assert v_t.shape == v_j.shape and v_t.dtype == torch.float32
    assert _rel_l2(v_t.numpy(), v_j) <= 1e-5
    # the explicit plain route is the CPU path itself
    with torch.inference_mode():
        v_p = model(torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(t),
                    ops="plain", **kw_t)
    assert torch.equal(v_p, v_t)


def test_entry_points_need_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_wan.smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MMDiT(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({}, cfg)
    assert MMDiT(cfg, device="cpu").device.type == "cpu"
