"""RecurrentGemma's two mixers in the port against the JAX package, on the
CPU in f32 at the smoke width (d 64, window 16, 4 heads of 16):

* ``rglru.apply_rglru`` for S in {1, 2, 23, 64}, its output and its decode
  cache (the conv rows front-padded when S < 3), a chain of
  ``apply_rglru_decode`` steps from that cache, and the decode chain
  against the prefix scan over the extended sequence;
* ``rglru.linear_scan`` against the sequential recurrence, with decays of
  e^-32 a step;
* ``attention.local_attention`` in its three branches (S <= w, S = 2w,
  S = 2w + 7), with and without segment ids, output and the gradients of
  q, k and v; ``blocked_attention`` (KV padding, segment ids, KV blocks
  that divide S); ``decode_attention`` under a local layer's ring mask.

The reference's ``_causal_conv`` raises for S < 3 (its shifts of i >= S
are longer than the sequence); the port's conv takes them as zeros, so at
S 1 and 2 ``apply_rglru`` is held to the reference's decode chain from a
zero cache instead.  Every comparison is rel-L2 <= 1e-5 (the oracle gate
of the JAX package's README); the JAX functions run under ``jax.jit``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import recurrentgemma_9b as jax_rg  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import recurrentgemma_9b as torch_rg  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402

GATE = 1e-5
W, H, DH = 16, 4, 16  # the smoke config's window and (repeated) attention heads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def mixer():
    """The JAX RG-LRU parameters at the smoke width and the port's module
    carrying them."""
    jcfg, cfg = jax_rg.smoke_config(), torch_rg.smoke_config()
    params = JR.rglru_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    mod = TR.RGLRU(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                        strict=True)
    jits = dict(
        apply=jax.jit(lambda p, x: JR.apply_rglru(p, x, jcfg, return_cache=True)),
        decode=jax.jit(lambda p, x, c: JR.apply_rglru_decode(p, x, c, jcfg)),
    )
    return jcfg, cfg, params, mod, jits


def _jax_chain(jits, params, x, cache):
    """The reference's decode steps over x [B, n, d] from ``cache``: the
    outputs [B, n, d] and the last cache."""
    outs = []
    for t in range(x.shape[1]):
        out, cache = jits["decode"](params, jnp.asarray(x[:, t : t + 1]), cache)
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=1), cache


def _x(s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((2, s, 64)).astype(np.float32)


def test_parameters_keep_the_references_names_and_dtypes(mixer):
    _, _, params, mod, _ = mixer
    got = {n: (tuple(p.shape), p.dtype) for n, p in mod.named_parameters()}
    want = {n: (tuple(a.shape), torch.float32) for n, a in params.items()}
    assert got == want
    bf16 = TR.RGLRU(dataclasses.replace(torch_rg.smoke_config(), dtype="bfloat16"),
                    torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert bf16.lam.dtype == torch.float32 and bf16.conv_w.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.lam.detach().numpy(), params["lam"], rtol=1e-6)


@pytest.mark.parametrize("s", [1, 2, 23, 64])
def test_apply_rglru_and_its_cache_match_jax(mixer, s):
    jcfg, cfg, params, mod, jits = mixer
    x = _x(s)
    if s >= 3:
        jout, jcache = jits["apply"](params, jnp.asarray(x))
    else:  # the reference's conv raises here; its decode chain is the oracle
        with pytest.raises(TypeError, match="incompatible shapes"):
            JR.apply_rglru(params, jnp.asarray(x), jcfg)
        jout, jcache = _jax_chain(jits, params, x, JR.rglru_cache_init(2, jcfg, jnp.float32))
    with torch.no_grad():
        out, cache = TR.apply_rglru(mod, torch.from_numpy(x), cfg, return_cache=True)
        plain = TR.apply_rglru(mod, torch.from_numpy(x), cfg)
    assert _rel(out, jout) <= GATE
    assert torch.equal(out, plain)
    assert sorted(cache) == sorted(jcache) == ["conv", "h"]
    assert cache["h"].dtype == torch.float32 and cache["conv"].shape == (2, 3, 64)
    for k in ("h", "conv"):
        assert _rel(cache[k], jcache[k]) <= GATE, k
    if s < 3:  # front-padded with zeros
        assert not cache["conv"][:, : 3 - s].any()


@pytest.mark.parametrize("s", [1, 23])
def test_decode_chain_matches_jax_and_the_scan(mixer, s):
    """Eight ``apply_rglru_decode`` steps from the prefill's cache: each
    output and cache against JAX's, and the outputs against the port's
    own prefix scan over the extended sequence."""
    jcfg, cfg, params, mod, jits = mixer
    n = 8
    x = _x(s + n, seed=1)
    _, jcache = _jax_chain(jits, params, x[:, :s], JR.rglru_cache_init(2, jcfg, jnp.float32))
    with torch.no_grad():
        _, cache = TR.apply_rglru(mod, torch.from_numpy(x[:, :s]), cfg, return_cache=True)
        full = TR.apply_rglru(mod, torch.from_numpy(x), cfg)
        for t in range(s, s + n):
            xt = x[:, t : t + 1]
            jout, jcache = jits["decode"](params, jnp.asarray(xt), jcache)
            out, cache = TR.apply_rglru_decode(mod, torch.from_numpy(xt), cache, cfg)
            assert _rel(out, jout) <= GATE, t
            assert all(_rel(cache[k], jcache[k]) <= GATE for k in ("h", "conv")), t
            assert _rel(out, full[:, t : t + 1]) <= GATE, t


def test_cache_init_matches_jax():
    cfg = torch_rg.smoke_config()
    got = TR.rglru_cache_init(3, cfg, torch.float32, "cpu")
    want = JR.rglru_cache_init(3, jax_rg.smoke_config(), jnp.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert not any(v.any() for v in got.values())


@pytest.mark.parametrize("s", [1, 5, 64, 100])
def test_linear_scan_is_the_recurrence(s):
    """The doubling scan against h_t = a_t h_{t-1} + u_t step by step, with
    decays down to e^-32 (a cumulative product of them underflows)."""
    rng = np.random.default_rng(s)
    a = np.exp(-32.0 * rng.random((2, s, 8))).astype(np.float32)
    u = rng.standard_normal((2, s, 8)).astype(np.float32)
    h = np.zeros((2, 8), np.float32)
    want = []
    for t in range(s):
        h = a[:, t] * h + u[:, t]
        want.append(h)
    got = TR.linear_scan(torch.from_numpy(a), torch.from_numpy(u))
    assert torch.isfinite(got).all()
    assert _rel(got, np.stack(want, axis=1)) <= GATE


# -- local attention ---------------------------------------------------------------------


def _qkv(s: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, s, H, DH)).astype(np.float32) for _ in range(3)]


def _segments(s: int) -> np.ndarray:
    """Two rows of documents of 5-13 tokens, the second with a -1 tail."""
    rng = np.random.default_rng(s)
    rows = []
    for tail in (0, 5):
        ids, d = [], 0
        while len(ids) < s - tail:
            ids += [d] * int(rng.integers(5, 14))
            d += 1
        rows.append(ids[: s - tail] + [-1] * tail)
    return np.asarray(rows, np.int32)


def _vjp_pair(jfn, tfn, arrays, dy):
    """Outputs and the vjp of dy of a JAX (jitted) and a torch function of
    the same float inputs."""

    @jax.jit
    def jvjp(args, dy):
        out, vjp = jax.vjp(jfn, *args)
        return out, vjp(dy)

    jout, jgrads = jvjp(tuple(map(jnp.asarray, arrays)), jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = tfn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(dy))
    return (out, jout), list(zip(grads, jgrads))


@pytest.mark.parametrize("seg", [False, True], ids=["unpacked", "segment_ids"])
@pytest.mark.parametrize("s", [12, 2 * W, 2 * W + 7], ids=["s_le_w", "2w", "2w_plus_7"])
def test_local_attention_matches_jax(s, seg):
    q, k, v = _qkv(s, seed=s)
    ids = _segments(s) if seg else None
    dy = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    jids = None if ids is None else jnp.asarray(ids)
    tids = None if ids is None else torch.from_numpy(ids)
    (out, jout), grads = _vjp_pair(
        lambda a, b, c: JA.local_attention(a, b, c, window=W, segment_ids=jids),
        lambda a, b, c: TA.local_attention(a, b, c, window=W, segment_ids=tids),
        (q, k, v), dy)
    assert _rel(out, jout) <= GATE
    for name, (g, jg) in zip("qkv", grads):
        assert _rel(g, jg) <= GATE, name
    if seg:  # the ids matter
        with torch.no_grad():
            free = TA.local_attention(*map(torch.from_numpy, (q, k, v)), window=W)
        assert _rel(free, jout) > 1e-3


@pytest.mark.parametrize("case", ["kv_padded", "segments", "kv_blocks_divide"])
def test_blocked_attention_matches_jax(case):
    """Causal, queries and keys from position 0 (the port keeps only the
    reference's defaults): S 20 over KV blocks of 8 (the last padded), the
    same with segment ids, and S 16 (no padding)."""
    s = 16 if case == "kv_blocks_divide" else 20
    q = _qkv(s, seed=1)[0]
    k, v = _qkv(s, seed=2)[1:]
    jkw, tkw = dict(kv_block=8), dict(kv_block=8)
    if case == "segments":
        ids = _segments(s)
        jkw.update(q_segment_ids=jnp.asarray(ids), kv_segment_ids=jnp.asarray(ids))
        tkw.update(q_segment_ids=torch.from_numpy(ids), kv_segment_ids=torch.from_numpy(ids))
    dy = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    (out, jout), grads = _vjp_pair(lambda a, b, c: JA.blocked_attention(a, b, c, **jkw),
                                   lambda a, b, c: TA.blocked_attention(a, b, c, **tkw),
                                   (q, k, v), dy)
    assert _rel(out, jout) <= GATE
    for name, (g, jg) in zip("qkv", grads):
        assert _rel(g, jg) <= GATE, name
    with pytest.raises(ValueError, match="both q_segment_ids and kv_segment_ids"):
        TA.blocked_attention(*map(torch.from_numpy, (q, k, v)),
                             q_segment_ids=torch.zeros(2, s, dtype=torch.int32))


def test_masked_decode_attention_matches_jax():
    """A ring of W slots, some empty (-1) and some older than the window."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, H, DH)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, W, H, DH)).astype(np.float32) for _ in range(2))
    pos, p = np.full(W, -1, np.int32), 40
    pos[:12] = np.arange(28, 40)  # 12 slots filled, the current position 40
    pos[3] = 20  # one stale entry, outside (40 - W, 40]
    valid = (pos >= 0) & (p - pos < W) & (pos <= p)
    want = jax.jit(JT._masked_decode_attention)(*map(jnp.asarray, (q, kc, vc, valid)))
    got = TA.decode_attention(*map(torch.from_numpy, (q, kc, vc, valid)))
    assert _rel(got, want) <= GATE
