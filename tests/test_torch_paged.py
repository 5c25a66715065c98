"""The port's plain K12 (paged decode attention) and plain row RMSNorm
(K4 on model rows) against the JAX package, and their dispatch on the CPU.

Inputs are drawn once with numpy and handed to both sides.  The pool holds
random values everywhere, the scratch page and the slots past each
``kv_len`` included, so a masking or page-addressing slip shows.  Gates
mirror ``tests/test_paged_attention.py``: f32 1e-5 and bf16 1e-3 against
the Pallas kernel in interpret mode (dh 128, the width it tiles); the jnp
twin at dh 64 and 16 (1e-5, f32); the norms those of
``tests/test_kernels.py`` (2e-4 f32, 6e-2 bf16).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.paged import (  # noqa: E402
    paged_attention_pallas,
    paged_tile_counts,
)
from repro.kernels.flash_attention.paged import (  # noqa: E402
    paged_attention_ref as jax_paged_ref,
)
from repro.kernels.fused_rmsnorm.ops import rms_norm as jax_rms_norm  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention.paged import live_pages, paged_decode  # noqa: E402
from repro_torch.kernels.flash_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.ref import rms_norm_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.rmsnorm import rms_fwd  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
PAGED_TOL = {"f32": 1e-5, "bf16": 1e-3}
NORM_TOL = {"f32": 2e-4, "bf16": 6e-2}


def _pool(rng, b, hq, hkv, dh, ps, lens, *, fragmented, spare=2):
    """q [B, Hq, dh] and a pool of random pages; each slot owns
    ceil(len / ps) pages (a shuffled free list when ``fragmented``), its
    table row points at the scratch page (the last) past them."""
    pages_max = max(1, max(-(-n // ps) for n in lens)) + 1  # one entry past every allocation
    owned = [-(-n // ps) for n in lens]
    num_pages = sum(owned) + spare
    order = rng.permutation(num_pages) if fragmented else np.arange(num_pages)
    table = np.full((b, pages_max), num_pages, np.int32)  # scratch = num_pages
    nxt = 0
    for bi, n in enumerate(owned):
        table[bi, :n] = order[nxt : nxt + n]
        nxt += n
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    kp = rng.standard_normal((num_pages + 1, ps, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((num_pages + 1, ps, hkv, dh)).astype(np.float32)
    return q, kp, vp, table, np.asarray(lens, np.int32)


def _both(arrays, dt):
    jdt, tdt = DTYPES[dt]
    q, kp, vp, table, lens = arrays
    j = (*(jnp.asarray(a, jdt) for a in (q, kp, vp)), jnp.asarray(table), jnp.asarray(lens))
    t = (*(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)), torch.from_numpy(table),
         torch.from_numpy(lens))
    return j, t


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j.astype(jnp.float32)) - t.float().numpy())))


CASES = [
    # (B, Hq, Hkv, page_size, kv_lens, fragmented)
    (3, 8, 2, 8, (11, 24, 5), True),  # GQA 4, ragged last pages, fragmented
    (3, 8, 2, 16, (0, 33, 0), True),  # inactive slots -> exact zeros
    (2, 4, 4, 8, (1, 16), False),  # MHA, single token, page-aligned
    (4, 8, 2, 16, (47, 2, 16, 0), True),  # mixed depths in one wave
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_paged_plain_matches_pallas(case, dt):
    b, hq, hkv, ps, lens, fragmented = case
    rng = np.random.default_rng(hash(case) % 2**32)
    arrays = _pool(rng, b, hq, hkv, 128, ps, lens, fragmented=fragmented)
    (qj, kj, vj, tj, lj), (qt, kt, vt, tt, lt) = _both(arrays, dt)
    out_j = paged_attention_pallas(qj, kj, vj, tj, lj, interpret=True)
    out_t = paged_attention_ref(qt, kt, vt, tt, lt)
    assert out_t.dtype == qt.dtype and out_t.shape == qt.shape
    assert _err(out_j, out_t) <= PAGED_TOL[dt]
    for bi, n in enumerate(lens):
        if n == 0:  # inactive slot: exactly zero, not just close
            assert torch.count_nonzero(out_t[bi]) == 0


@pytest.mark.parametrize("dh", [64, 16])
@pytest.mark.parametrize("case", CASES[:2])
def test_paged_plain_matches_jnp_twin(case, dh):
    b, hq, hkv, ps, lens, fragmented = case
    rng = np.random.default_rng(dh)
    arrays = _pool(rng, b, hq, hkv, dh, ps, lens, fragmented=fragmented)
    (qj, kj, vj, tj, lj), (qt, kt, vt, tt, lt) = _both(arrays, "f32")
    assert _err(jax_paged_ref(qj, kj, vj, tj, lj), paged_attention_ref(qt, kt, vt, tt, lt)) <= 1e-5


def test_paged_plain_reads_no_page_past_kv_len():
    """Poisoning every page a slot does not own (scratch included) and the
    slots past kv_len in its last page changes nothing."""
    rng = np.random.default_rng(5)
    q, kp, vp, table, lens = _pool(rng, 3, 8, 2, 64, 8, (11, 24, 5), fragmented=True)
    want = paged_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, table, lens)))
    live = np.zeros(kp.shape[:2], bool)
    for bi, n in enumerate(lens):
        for j in range(n):
            live[table[bi, j // 8], j % 8] = True
    kp[~live], vp[~live] = 1e4, -1e4
    got = paged_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, table, lens)))
    assert torch.equal(got, want)


def test_live_pages_follows_the_skip_rule():
    lens = [0, 1, 16, 17, 100, 4096]
    assert live_pages(torch.tensor(lens, dtype=torch.int32), 16, 8) == \
        paged_tile_counts(np.asarray(lens), 16, 8)[0] == 0 + 1 + 1 + 2 + 7 + 8


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 5, 256), (1, 12, 2048)])
def test_rms_norm_plain_matches_pallas(shape, dt):
    rng = np.random.default_rng(shape[-1])
    x = (rng.standard_normal(shape) * 1.5 + 0.2).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    y_j = jax_rms_norm(jnp.asarray(x, jdt), jnp.asarray(w), eps=1e-6, interpret=True)
    y_t, rstd = rms_norm_ref(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    assert y_t.dtype == tdt and rstd.shape == shape[:-1] and rstd.dtype == torch.float32
    assert _err(y_j, y_t) <= NORM_TOL[dt]


def test_dispatch_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in
                              _pool(rng, 2, 4, 2, 64, 8, (9, 0), fragmented=True))
    assert torch.equal(kernels.paged_attention(q, kp, vp, table, lens),
                       paged_attention_ref(q, kp, vp, table, lens))
    x, w = torch.randn(3, 4, 64), torch.rand(64) + 0.5
    assert torch.equal(kernels.rms_norm(x, w), rms_norm_ref(x, w)[0])
    # on the CPU, autograd runs through the plain version
    xg = x.clone().requires_grad_()
    kernels.rms_norm(xg, w).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    assert kernels.launch_counts()["paged_decode"] == kernels.launch_counts()["rms_fwd"] == 0


def test_wrappers_take_cuda_tensors_only():
    q, kp = torch.zeros(2, 4, 64), torch.zeros(3, 8, 2, 64)
    table, lens = torch.zeros(2, 1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode(q, kp, kp, table, lens)
    with pytest.raises(ValueError, match="CUDA"):
        rms_fwd(torch.zeros(4, 64), torch.ones(64))
