"""Gradient compression (``repro_torch.distributed.compression``) against
the JAX package's ``repro.distributed.compression`` on the CPU, on the
same trees (nested dicts of f32 and bf16 leaves, numpy draws from a
seed): the int8 values and scales equal, the error-feedback residual
within f32 rounding, the decompressed and bf16-cast values equal, the
wire bytes equal; and the reference's own three tests
(``tests/test_substrate.py``): the round-trip bound, the error-feedback
convergence over 64 steps, the wire bytes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.distributed import compression as JC  # noqa: E402
from repro_torch.convert import to_numpy_leaf  # noqa: E402
from repro_torch.distributed import compression as C  # noqa: E402

SHAPES = {"w": (64, 48), "blocks": {"0": {"b": (48,), "gate": ()}, "1": {"w": (3, 5, 7)}}}


def _draw(seed: int, scale: float = 1.0) -> dict:
    """A tree of f32 draws shaped like ``SHAPES``, one leaf all zeros and one
    spanning six decades."""
    rng = np.random.default_rng(seed)

    def one(shape):
        return np.asarray(scale * rng.standard_normal(shape), dtype=np.float32)

    def tree(shapes):
        return {k: tree(v) if isinstance(v, dict) else one(v) for k, v in shapes.items()}

    out = tree(SHAPES)
    out["blocks"]["0"]["b"][:] = 0.0
    out["blocks"]["1"]["w"] *= np.logspace(-6, 0, 7, dtype=np.float32)
    return out


def _torch(tree, dtype=torch.float32):
    return {k: _torch(v, dtype) if isinstance(v, dict) else torch.from_numpy(v).to(dtype)
            for k, v in tree.items()}


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _np(x):
    return to_numpy_leaf(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _pairs(port, ref):
    got, want = dict(_leaves(port)), dict(_leaves(ref))
    assert set(got) == set(want)
    return [(k, _np(got[k]), _np(want[k])) for k in sorted(want)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_and_bf16_match_jax(dtype):
    """Four steps of int8 compression with error feedback on new gradients
    each step (f32 or bf16 leaves): every step's int8 values and scales
    equal, the residual within f32 rounding of the reference's (1e-6 of
    each leaf's scale), the decompressed values equal (f32 and bf16
    outputs), the bf16 casts equal, the wire bytes equal."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ef, jef = C.init_error_feedback(_torch(_draw(0), tdt)), JC.init_error_feedback(
        _jax(_draw(0), jdt))
    for k, a, b in _pairs(ef, jef):
        assert a.dtype == np.float32 and not a.any() and a.shape == b.shape, k
    for step in range(4):
        g_np = _draw(10 + step, scale=10.0 ** (step - 2))
        g, jg = _torch(g_np, tdt), _jax(g_np, jdt)
        q, s, ef = C.compress_int8(g, ef)
        jq, js, jef = JC.compress_int8(jg, jef)
        for k, a, b in _pairs(q, jq):
            assert a.dtype == np.int8 and np.array_equal(a, b), (step, k)
        scales = dict(_leaves(s))
        for k, a, b in _pairs(s, js):
            assert a.shape == () and a.dtype == np.float32 and a == b, (step, k)
        for k, a, b in _pairs(ef, jef):
            assert np.abs(a - b).max() <= 1e-6 * float(scales[k]), (step, k)
        for out_dtype, jout in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            for k, a, b in _pairs(C.decompress_int8(q, s, out_dtype),
                                  JC.decompress_int8(jq, js, jout)):
                assert np.array_equal(a, np.asarray(b, np.float32)), (step, k, out_dtype)
        for k, a, b in _pairs(C.compress_bf16(g), JC.compress_bf16(jg)):
            assert np.array_equal(a, np.asarray(b, np.float32)), (step, k)
        for method in ("none", "bf16", "int8"):
            assert C.wire_bytes(g, method) == JC.wire_bytes(jg, method) == 3226 * C.WIRE_BYTES[
                method]


def test_the_functions_keep_the_tensors_device_and_shapes():
    g = _torch(_draw(1))
    q, s, ef = C.compress_int8(g, C.init_error_feedback(g))
    for tree in (q, s, ef, C.decompress_int8(q, s), C.compress_bf16(g)):
        assert all(t.device == torch.device("cpu") for _, t in _leaves(tree))
    assert {k: tuple(t.shape) for k, t in _leaves(q)} == {k: tuple(t.shape)
                                                          for k, t in _leaves(g)}
    assert float(s["blocks"]["0"]["b"]) == pytest.approx(1e-12 / 127.0)  # the all-zero leaf


# -- the reference's own tests (tests/test_substrate.py), on the port -----------------------


def test_int8_roundtrip_error_bounded():
    g = {"w": torch.linspace(-3, 3, 101)}
    ef = C.init_error_feedback(g)
    q, s, ef2 = C.compress_int8(g, ef)
    out = C.decompress_int8(q, s, torch.float32)
    assert float((out["w"] - g["w"]).abs().max()) <= float(s["w"]) * 0.5 + 1e-6


def test_error_feedback_accumulates():
    """With EF, the time-average of decompressed grads converges to the
    true gradient (the EF-SignSGD convergence mechanism)."""
    g = {"w": torch.tensor([0.004, -0.003, 1.0])}  # tiny comps vs big scale
    ef = C.init_error_feedback(g)
    acc = torch.zeros(3)
    for _ in range(64):
        q, s, ef = C.compress_int8(g, ef)
        acc = acc + C.decompress_int8(q, s, torch.float32)["w"]
    mean = acc / 64
    assert torch.allclose(mean, g["w"], atol=2e-3)


def test_wire_bytes():
    g = {"w": torch.zeros(100, dtype=torch.bfloat16)}
    assert C.wire_bytes(g, "none") == 400
    assert C.wire_bytes(g, "bf16") == 200
    assert C.wire_bytes(g, "int8") == 100
