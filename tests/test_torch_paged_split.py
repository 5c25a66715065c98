"""The split of K12's page sweep on the CPU, where the kernel cannot run
(``paged_decode.cu``, paged decode attention).

- ``split_plan`` fixes the chunks from shapes alone (the wrapper never
  reads ``kv_lens`` on the host): chunks of at most ``CHUNK_TOKENS``
  tokens, enough of them to cover the table row, every live page in
  exactly one live chunk, and at least 132 live blocks (one an SM) at the
  decode waves the LM serving path runs.
- ``time_paged``'s cases, which ``chip_smoke.py`` phase 2 shares: the
  kv_lens draw, each table's slots on disjoint pages of the pool, the
  entries past them at the scratch page, and the byte and flop counts of
  the bound.
- ``_split_decode`` emulates the kernel's arithmetic in plain PyTorch f32:
  each warp's 64 tokens of a chunk (live rows only, so nothing past
  kv_len is read), its softmax state in base 2 (on bf16 inputs P V takes
  p rounded to bf16, the mma's A operand, while l sums the unrounded p,
  as the kernel does), the block's warps combined
  in warp order, then the chunks' partials merged in chunk order by
  ``m = max m_c, l = sum l_c 2^(m_c - m), out = sum acc_c 2^(m_c - m) /
  max(l, LSE_FLOOR)``, an empty part weighing exactly 0, and a slot that
  fits one chunk written straight from it.  It must match the JAX
  package's jnp twin at dh 64 and ``paged_attention_pallas`` in interpret
  mode at dh 128, at the gates of ``tests/test_torch_paged.py`` (f32 1e-5;
  bf16 1e-3 on the f32 result before its rounding to bf16, against the
  JAX function run in f32 on the same bf16 values, and one bf16 step more
  between the bf16 outputs), on slots with kv_len 0 (exact zeros), a context ending on a
  chunk boundary, one filling the whole table row, single-chunk slots,
  ragged last pages, and large finite pool values past every kv_len.
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.paged import (  # noqa: E402
    paged_attention_pallas,
)
from repro.kernels.flash_attention.paged import (  # noqa: E402
    paged_attention_ref as jax_paged_ref,
)
from repro_torch.kernels.flash_attention.paged import (  # noqa: E402
    CHUNK_TOKENS,
    MAX_GROUP,
    MAX_PAGE,
    split_plan,
)
from repro_torch.kernels.flash_attention.ref import LSE_FLOOR, NEG_INF  # noqa: E402
from repro_torch.launch.time_paged import CASES, case_lens, paged_case, paged_work  # noqa: E402

WARP_TOKENS = 64  # kSub: tokens a warp takes of its chunk
WARPS = CHUNK_TOKENS // WARP_TOKENS
PAGED_TOL = {"f32": 1e-5, "bf16": 1e-3}
LOG2E = 1.4426950408889634
SMS = 132  # the H100's SMs


def live_blocks(lens, hkv, pages_max, ps):
    """Blocks of the grid (n_chunks, Hkv, B) whose chunk holds a live page."""
    chunk_pages, _ = split_plan(pages_max, ps)
    pages = [min(-(-n // ps), pages_max) for n in lens]
    return hkv * sum(-(-p // chunk_pages) for p in pages)


@pytest.mark.parametrize("ps", [8, 16, 24, 32, 40, 48, 56, 64])
@pytest.mark.parametrize("pages_max", [1, 7, 65, 256, 1025])
def test_split_plan_covers_every_live_page_once(pages_max, ps):
    chunk_pages, n_chunks = split_plan(pages_max, ps)
    assert (chunk_pages, n_chunks) == split_plan(pages_max, ps)  # shapes in, shapes out
    assert chunk_pages * ps <= CHUNK_TOKENS and (chunk_pages + 1) * ps > CHUNK_TOKENS
    assert (n_chunks - 1) * chunk_pages < pages_max <= n_chunks * chunk_pages
    for n in sorted({0, 1, ps - 1, ps, ps + 1, CHUNK_TOKENS, chunk_pages * ps,
                     chunk_pages * ps + 1, pages_max * ps // 2, pages_max * ps - 1,
                     pages_max * ps}):
        live = min(-(-n // ps), pages_max)
        seen = np.zeros(pages_max, int)
        for c in range(n_chunks):
            first = c * chunk_pages
            if first >= live:  # the block exits at once
                continue
            seen[first: min(first + chunk_pages, live)] += 1
        np.testing.assert_array_equal(seen, np.arange(pages_max) < live)


def test_split_fills_the_card_at_the_lm_decode_waves():
    # chip_smoke.py phase 2's wave (phase 6's geometry: 8 slots, one
    # inactive; Llama-3.2-1B's 8 kv heads; pages of 16, 256 a table row)
    assert live_blocks(case_lens(np.random.default_rng(6))["wave"], 8, 256, 16) >= SMS
    # profile_serve's LM decode wave: prompts of 64 to 2000, one token decoded
    prompts = (64, 128, 256, 512, 768, 1024, 1536, 2000)
    assert live_blocks([n + 1 for n in prompts], 8, 256, 16) >= SMS
    # the whole grid stays within a few waves of resident blocks
    chunk_pages, n_chunks = split_plan(256, 16)
    assert chunk_pages == 16 and 8 * 8 * n_chunks <= 8 * SMS


@pytest.mark.parametrize("copies", [1, 3])
def test_timed_cases_own_disjoint_pages(copies):
    # chip_smoke.py phase 2 and time_paged.py build K12's cases and bound here
    lens_of = case_lens(np.random.default_rng(6))
    assert lens_of == case_lens(np.random.default_rng(6)) and set(lens_of) == set(CASES)
    hq, hkv, dh, ps, pages_max = CASES["dh128"]
    lens = lens_of["dh128"]
    g = torch.Generator().manual_seed(0)
    q, kp, vp, tables, kl = paged_case(torch.device("cpu"), g, np.random.default_rng(0), lens,
                                       hq, hkv, dh, ps, torch.bfloat16, pages_max=pages_max,
                                       spare=5, copies=copies)
    owned = [-(-n // ps) for n in lens]
    scratch = kp.shape[0] - 1
    assert kp.shape == vp.shape == (copies * sum(owned) + 5 + 1, ps, hkv, dh)
    assert q.shape == (len(lens), hq, dh) and kl.tolist() == lens and len(tables) == copies
    used = np.concatenate([t[bi, :n].numpy() for t in tables for bi, n in enumerate(owned)])
    assert len(set(used.tolist())) == used.size and scratch not in used  # each page once
    for t in tables:
        for bi, n in enumerate(owned):
            assert (t[bi, n:] == scratch).all()
    nbytes, flops = paged_work(q, kp, vp, tables[0], kl)
    assert nbytes == sum(owned) * (hkv * 2 * ps * dh * 2 + 4) + 2 * q.numel() * 2 + len(lens) * 4
    assert flops == 4 * sum(lens) * hq * dh


def _split_decode(q, k_pages, v_pages, table, lens, *, scale=None, f32_out=False):
    """K12's chunked partials and their merge, in plain PyTorch f32 (see
    the module docstring).  Returns [B, Hq, dh] in q's dtype, or in f32
    before that rounding with ``f32_out``."""
    b, hq, dh = q.shape
    _, ps, hkv, _ = k_pages.shape
    g = hq // hkv
    pages_max = table.shape[1]
    scale = dh**-0.5 if scale is None else scale
    chunk_pages, _ = split_plan(pages_max, ps)
    out = torch.zeros((b, hq, dh), dtype=torch.float32)
    for bi in range(b):
        n = max(0, min(int(lens[bi]), pages_max * ps))
        n_pages = -(-n // ps)
        n_live = -(-n_pages // chunk_pages)
        for h in range(hkv):
            qh = q[bi, h * g:(h + 1) * g].float()
            parts = []
            for c in range(n_live):
                c0 = c * chunk_pages * ps
                end = min(n, c0 + chunk_pages * ps)
                warps = []
                for w in range(WARPS):
                    lo, hi = c0 + w * WARP_TOKENS, min(end, c0 + (w + 1) * WARP_TOKENS)
                    if lo >= hi:  # no live token: the warp's state is empty
                        warps.append((torch.full((g,), NEG_INF), torch.zeros(g), torch.zeros(g, dh)))
                        continue
                    toks = torch.arange(lo, hi)
                    pages = table[bi, toks // ps].long()
                    kr = k_pages[pages, toks % ps, h].float()  # live rows only
                    vr = v_pages[pages, toks % ps, h].float()
                    s = (qh @ kr.T) * (scale * LOG2E)
                    m = s.amax(-1)
                    p = torch.exp2(s - m[:, None])
                    # bf16: P V takes p rounded to bf16 (the mma's A operand); l sums p
                    pv = p.to(torch.bfloat16).float() if q.dtype == torch.bfloat16 else p
                    warps.append((m, p.sum(-1), pv @ vr))
                parts.append(_combine(warps))
            if n_live == 0:
                continue
            m, l, a = parts[0] if n_live == 1 else _combine(parts)
            out[bi, h * g:(h + 1) * g] = a / torch.clamp(l, min=LSE_FLOOR)[:, None]
    return out if f32_out else out.to(q.dtype)


def _combine(states):
    """(m, l, acc) states merged in list order; an empty one weighs 0."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l, a = torch.zeros_like(m), torch.zeros_like(states[0][2])
    for mi, li, ai in states:
        w = torch.where(mi == NEG_INF, torch.zeros_like(mi), torch.exp2(mi - m))
        l = l + li * w
        a = a + ai * w[:, None]
    return m, l, a


def _case(rng, lens, hq, hkv, dh, ps, pages_max, dt):
    """q and a pool of random pages; each slot owns ceil(len / ps) pages of
    a shuffled free list, table entries past them at the scratch page (the
    last); every slot past each kv_len, scratch included, holds large
    finite values."""
    owned = [-(-n // ps) for n in lens]
    num_pages = sum(owned) + 1
    order = rng.permutation(num_pages)
    table = np.full((len(lens), pages_max), num_pages, np.int32)
    live = np.zeros((num_pages + 1, ps), bool)
    nxt = 0
    for bi, (n, o) in enumerate(zip(lens, owned)):
        table[bi, :o] = order[nxt: nxt + o]
        nxt += o
        for j in range(n):
            live[table[bi, j // ps], j % ps] = True
    q = rng.standard_normal((len(lens), hq, dh)).astype(np.float32)
    kp = rng.standard_normal((num_pages + 1, ps, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((num_pages + 1, ps, hkv, dh)).astype(np.float32)
    kp[~live], vp[~live] = 1e4, -1e4
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    lens = np.asarray(lens, np.int32)
    j = (*(jnp.asarray(a, jdt) for a in (q, kp, vp)), jnp.asarray(table), jnp.asarray(lens))
    t = (*(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)), torch.from_numpy(table),
         torch.from_numpy(lens))
    return j, t


def _check(ref, j, t, lens, dt):
    """The emulation against the JAX function ``ref`` on the same inputs.
    f32: the outputs within 1e-5.  bf16: the emulation's f32 result (p
    rounded to bf16 for P V, as the kernel rounds it) within 1e-3 of
    ``ref`` run in f32 on the same bf16 values, and the bf16 outputs no
    further apart than that and one bf16 step (2^-7 of the magnitude):
    each output's rounding moves it by at most half a step."""
    out_t = _split_decode(*t)
    out_j = ref(*j)
    assert out_t.shape == out_j.shape
    for bi, n in enumerate(lens):
        if n == 0:  # an inactive slot: exactly zero
            assert torch.count_nonzero(out_t[bi]) == 0
    want = np.asarray(out_j.astype(jnp.float32))
    if dt == "f32":
        err = float(np.max(np.abs(want - out_t.numpy())))
        assert err <= PAGED_TOL[dt], err
        return
    want32 = np.asarray(ref(*(a.astype(jnp.float32) for a in j[:3]), *j[3:]))
    err = float(np.max(np.abs(want32 - _split_decode(*t, f32_out=True).numpy())))
    assert err <= PAGED_TOL[dt], err
    step = np.abs(want - out_t.float().numpy())
    assert np.all(step <= PAGED_TOL[dt] + 2.0**-7 * np.abs(want)), float(step.max())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_split_emulation_matches_jnp_twin_dh64(dt):
    ps, pages_max = 16, 40  # chunks of 16 pages: 3 a slot, the last of 8
    chunk = split_plan(pages_max, ps)[0] * ps
    # inactive; two chunks ending on a boundary; the whole row (3 chunks,
    # the last short); one chunk, ragged; two chunks, ragged last page;
    # one token past a boundary; a single token
    lens = [0, 2 * chunk, pages_max * ps, 100, 300, chunk + 1, 1]
    rng = np.random.default_rng(64)
    j, t = _case(rng, lens, 8, 2, 64, ps, pages_max, dt)
    _check(jax_paged_ref, j, t, lens, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_split_emulation_matches_pallas_dh128(dt):
    ps, pages_max = 32, 18  # chunks of 8 pages (256 tokens): 3 a slot, the last of 2
    chunk = split_plan(pages_max, ps)[0] * ps
    lens = [pages_max * ps, chunk, 0, 2 * chunk + 33]
    rng = np.random.default_rng(128)
    j, t = _case(rng, lens, 5, 1, 128, ps, pages_max, dt)  # Qwen2.5-14B's group of 5
    _check(functools.partial(paged_attention_pallas, interpret=True), j, t, lens, dt)


def test_wrapper_limits_match_the_kernel():
    # the mma's 16 rows hold a kv head's query heads; a chunk is at most
    # four warps of 64 tokens; a page at most kMaxPage tokens
    assert MAX_GROUP == 16 and CHUNK_TOKENS == WARPS * WARP_TOKENS == 256
    assert MAX_PAGE == 64 and math.gcd(CHUNK_TOKENS, MAX_PAGE) == MAX_PAGE
