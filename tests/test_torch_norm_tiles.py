"""The work split of two norm kernels on the CPU, where they cannot run: K1
(the fused AdaLN forward, ``adaln_fwd.cu``) and the q/k K6 (the joint
RMSNorm weight gradient, ``rmsnorm_bwd.cu``).

- ``fwd_walk`` mirrors K1's blocks, sized by the wrapper's
  ``fwd_row_blocks``: each takes a run of rows of one sample and its teams
  of warps take every ``teams``-th row of the run.  Every row
  of [B, S] must be taken exactly once, and no block may reach into the
  next sample (whose modulation it has not staged), for B 1-10 and the S
  of the paths (1637, 4757, 7877 in training, 6240 in serving, 37 in the
  tests, and 1).
- ``qk_dw_chunks`` sizes the q/k K6's chunks.  ``_k6_sum`` emulates its
  summation order in numpy f32: each lane group adds its run of rows in
  order, one fused multiply-add a row (in f64, rounded to f32, as ``fmaf``
  rounds once), the block adds its groups in order, and pass 2 adds each
  column's partials in eight interleaved groups, then the groups in order.
  The result must stay within the card's ``sum_f32`` gate (2e-5 of the
  largest magnitude, ``chip_smoke.py`` ``BWD_TOL``) of the JAX package's
  ``rms_bwd_dw_pallas`` in interpret mode, at dh 32, 64 and 128, in f32
  and bf16, with Hq != Hk and row counts that are not a multiple of the
  chunk.
- ``naive_walk`` mirrors K10's block (the naive-access AdaLN reduction,
  ``adaln_bwd.cu``), sized by the wrapper's ``naive_plan``: one block a
  sample, stages of ``rows`` consecutive rows, group g of its consumer
  threads taking the rows ``s % groups == g`` in order.  Every row of each
  sample must be taken exactly once and no row of another sample, and the
  block must fit the card (1024 threads with its producer warp, the two
  stages in shared memory).  ``_k10_sum`` emulates its summation order in
  numpy f32 (each group's rows in order, x_hat by one fused multiply-add,
  then the groups in order) and must stay within the ``sum_f32`` gate of
  the JAX package's ``adaln_bwd_dmod_naive_pallas`` in interpret mode, in
  f32 and bf16.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.fused_adaln.adaln import adaln_bwd_dmod_naive_pallas  # noqa: E402
from repro.kernels.fused_rmsnorm.rmsnorm import rms_bwd_dw_pallas  # noqa: E402
from repro_torch.kernels.fused_adaln.adaln import (  # noqa: E402
    FWD_BLOCKS,
    FWD_WARPS,
    MAX_ROW_CHUNKS,
    fwd_row_blocks,
    naive_plan,
)
from repro_torch.kernels.fused_adaln.ref import adaln_bwd_dmod_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.ref import qk_rms_bwd_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.rmsnorm import (  # noqa: E402
    DW_UNROLL,
    qk_dw_chunks,
)

SUM_F32_GATE = 2e-5  # chip_smoke.py BWD_TOL["sum_f32"], of the largest magnitude
RED_GROUPS = 8  # K6 pass 2: interleaved groups of partials a column (kRedGroups)

# -- K1: the fused AdaLN forward's rows --------------------------------------------


def fwd_team(d: int, itemsize: int) -> tuple[int, int]:
    """K1's team for a row of D elements, as ``dispatch`` in adaln_fwd.cu
    picks it: ``(warps, chunks)``, the warps that share a row (1 up to 256
    16-byte chunks, then 2, then 4) and the chunks a lane holds (4, 6 or
    8, the lanes past the row's end idle)."""
    nch = d * itemsize // 16
    assert nch <= MAX_ROW_CHUNKS
    warps = 1 if nch <= 256 else 2 if nch <= 512 else 4
    per = -(-nch // (32 * warps))
    return warps, 4 if per <= 4 else 6 if per <= 6 else 8


def fwd_walk(b: int, s: int, d: int, itemsize: int) -> np.ndarray:
    """The rows of [B, S] as K1's blocks take them, one row an entry:
    ``(block_x, sample, team, row)``.  Block (block_x, sample) takes the run
    ``[s0, s1)`` of its sample, ``s0 = block_x * rows``, and its teams take
    rows ``s0 + team, s0 + team + teams, ...`` of it."""
    rows, per_sample = fwd_row_blocks(b, s)
    teams = FWD_WARPS // fwd_team(d, itemsize)[0]
    out = []
    for bx in range(per_sample):
        s0, s1 = bx * rows, min(bx * rows + rows, s)
        for team in range(teams):
            r = np.arange(s0 + team, s1, teams)
            for bi in range(b):
                out.append(np.stack([np.full_like(r, bx), np.full_like(r, bi),
                                     np.full_like(r, team), r], axis=1))
    return np.concatenate(out)


@pytest.mark.parametrize("d, itemsize", [(1536, 2), (8192, 2), (1536, 4), (4096, 4)])
@pytest.mark.parametrize("s", [1, 37, 1637, 4757, 6240, 7877])
def test_k1_walk_takes_every_row_once_within_its_sample(s, d, itemsize):
    warps, _ = fwd_team(d, itemsize)
    for b in range(1, 11):
        rows, per_sample = fwd_row_blocks(b, s)
        # the grid (per_sample, b): no block is empty, none past the sample
        assert (per_sample - 1) * rows < s <= per_sample * rows
        assert b * per_sample <= max(FWD_BLOCKS, b)  # one wave of resident blocks
        walk = fwd_walk(b, s, d, itemsize)
        bx, sample, team, row = walk.T
        assert ((row >= bx * rows) & (row < np.minimum(bx * rows + rows, s))).all()
        assert ((team >= 0) & (team < FWD_WARPS // warps)).all()
        flat = np.sort(sample.astype(np.int64) * s + row)
        np.testing.assert_array_equal(flat, np.arange(b * s))


@pytest.mark.parametrize("d, itemsize, want", [
    (256, 4, (1, 4)), (1536, 2, (1, 6)), (2048, 2, (1, 8)), (2304, 2, (2, 6)),
    (1536, 4, (2, 6)), (4096, 2, (2, 8)), (8192, 2, (4, 8)), (4096, 4, (4, 8)),
])
def test_k1_team_holds_each_row_in_registers(d, itemsize, want):
    warps, chunks = fwd_team(d, itemsize)
    assert (warps, chunks) == want
    nch = d * itemsize // 16
    assert nch <= chunks * 32 * warps  # a lane holds its share of the row
    assert warps == 1 or nch > 8 * 32 * warps // 2  # the fewest warps that can


def test_k1_grid_fills_the_card_at_the_path_shapes():
    # serving [4, 6240], training [10, 1637] and [1, 7877]: about three
    # blocks an SM, each at least two rows a warp
    for b, s in ((4, 6240), (10, 1637), (1, 7877)):
        rows, per_sample = fwd_row_blocks(b, s)
        assert 0.8 * FWD_BLOCKS <= b * per_sample <= FWD_BLOCKS
        assert rows >= 2 * FWD_WARPS


# -- K6 on q/k rows: the weight gradient's summation order ------------------------


def _fma_f32(a, b, c):
    """fmaf on f32 arrays: the product exact in f64, one rounding to f32."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _k6_sum(dy, x, rstd, b, s, h_max, dh, itemsize):
    """The q/k K6's dw of one tensor, in its order.  dy, x: [rows, dh] f32
    (the values the kernel reads), rows in (b, s, h) order; rstd [rows]."""
    groups, chunk, n_chunks = qk_dw_chunks(b, s, h_max, dh, itemsize)
    rows = dy.shape[0]
    run = chunk // groups
    pad = n_chunks * chunk - rows
    assert pad >= 0 and chunk % (groups * DW_UNROLL) == 0
    xh = (x * rstd[:, None]).astype(np.float32)  # to_f32(x) * rstd, rounded
    dyp = np.pad(dy, ((0, pad), (0, 0))).reshape(n_chunks, groups, run, dh)
    xhp = np.pad(xh, ((0, pad), (0, 0))).reshape(n_chunks, groups, run, dh)
    acc = np.zeros((n_chunks, groups, dh), np.float32)
    for i in range(run):  # each group's rows in order (a padded row adds 0 exactly)
        acc = _fma_f32(dyp[:, :, i], xhp[:, :, i], acc)
    part = np.zeros((n_chunks, dh), np.float32)
    for g in range(groups):  # the block's groups in order
        part = (part + acc[:, g]).astype(np.float32)
    grp = np.zeros((RED_GROUPS, dh), np.float32)
    for k in range(RED_GROUPS):  # pass 2: chunks k, k + 8, ... then the groups
        for c in range(k, n_chunks, RED_GROUPS):
            grp[k] = (grp[k] + part[c]).astype(np.float32)
    dw = np.zeros(dh, np.float32)
    for k in range(RED_GROUPS):
        dw = (dw + grp[k]).astype(np.float32)
    return dw, n_chunks, chunk


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_k6_qk_order_within_gate_of_pallas(dh, dtype):
    b, s, hq, hk = 2, 301, 4, 3
    rng = np.random.default_rng(dh)
    itemsize = 4 if dtype == "f32" else 2
    qkv = (rng.standard_normal((b, s, 3 * hq * dh)) * 1.5).astype(np.float32)
    qkv_t = torch.from_numpy(qkv)
    if dtype == "bf16":
        qkv_t = qkv_t.bfloat16()
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    # q and k: strided views of the fused projection, as the model hands them over
    xs_t = [qkv_t[..., : hq * dh].reshape(b, s, hq, dh),
            qkv_t[..., hq * dh: (hq + hk) * dh].reshape(b, s, hk, dh)]
    dys_t = [torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32)).to(qkv_t.dtype)
             for h in (hq, hk)]
    w = [torch.from_numpy((1 + 0.1 * rng.standard_normal(dh)).astype(np.float32)) for _ in range(2)]
    rstds, dws_ref = [], []
    for x_t, dy_t, h in zip(xs_t, dys_t, (hq, hk)):
        rows = b * s * h
        x2d = jnp.asarray(x_t.float().numpy().reshape(rows, dh), dtype=jdt)
        dy2d = jnp.asarray(dy_t.float().numpy().reshape(rows, dh), dtype=jdt)
        # the forward's rstd, an input here (rms_fwd_pallas takes dh 128 only)
        xf = x_t.float().numpy().reshape(rows, dh)
        rstd = (1 / np.sqrt((xf * xf).mean(-1) + 1e-6)).astype(np.float32)
        want = np.asarray(rms_bwd_dw_pallas(dy2d, x2d, jnp.asarray(rstd), d_block=128,
                                            row_block=rows, interpret=True))
        got, n_chunks, chunk = _k6_sum(dy_t.float().numpy().reshape(rows, dh), xf, rstd,
                                       b, s, max(hq, hk), dh, itemsize)
        assert rows % chunk and n_chunks > RED_GROUPS  # a ragged last chunk; pass 2 interleaves
        err = np.abs(got - want).max()
        assert err <= SUM_F32_GATE * np.abs(want).max(), (err, np.abs(want).max())
        rstds.append(torch.from_numpy(rstd).reshape(b, s, h))
        dws_ref.append(got)
    # the plain version the wrapper takes on the CPU agrees with the emulated order too
    dwq, dwk = qk_rms_bwd_ref(*dys_t, *xs_t, *w, *rstds)[2:]
    for plain, emulated in zip((dwq, dwk), dws_ref):
        assert plain.dtype == torch.float32
        np.testing.assert_allclose(plain.numpy(), emulated,
                                   atol=SUM_F32_GATE * np.abs(emulated).max(), rtol=0)


@pytest.mark.parametrize("b, s", [(10, 1637), (1, 7877)])
def test_k6_qk_chunks_fill_the_card_at_the_training_shapes(b, s):
    # Wan-2.1 1.3B: 12 heads of 128, bf16; both tensors take n_chunks blocks
    groups, chunk, n_chunks = qk_dw_chunks(b, s, 12, 128, 2)
    assert groups == 16 and chunk % (groups * DW_UNROLL) == 0
    assert (n_chunks - 1) * chunk < b * s * 12 <= n_chunks * chunk
    assert 3 * 132 <= 2 * n_chunks <= 4 * 132


# -- K10: the naive-access AdaLN reduction's in-block walk --------------------------

SMEM_MAX = 232448  # a block's shared memory on the H100


def naive_walk(s: int, d: int, itemsize: int) -> np.ndarray:
    """The rows of one sample's [S, D] slab as K10's block takes them, one
    row an entry: ``(stage, group, row)``.  Stage i holds rows ``[i * rows,
    min((i + 1) * rows, S))`` and group g takes the stage's rows
    ``i * rows + g, i * rows + g + groups, ...``."""
    _, groups, rows = naive_plan(d, itemsize)
    out = []
    for i in range(-(-s // rows)):
        nr = min(rows, s - i * rows)
        for g in range(groups):
            r = np.arange(g, nr, groups) + i * rows
            out.append(np.stack([np.full_like(r, i), np.full_like(r, g), r], axis=1))
    return np.concatenate(out)


@pytest.mark.parametrize("d, itemsize", [(1536, 2), (5120, 2), (8192, 2), (256, 4), (1536, 4),
                                         (4096, 4), (8, 4)])
@pytest.mark.parametrize("s", [1, 37, 301, 1637, 8192])
def test_k10_walk_takes_every_row_of_its_sample_once(s, d, itemsize):
    threads, groups, rows = naive_plan(d, itemsize)
    stages = 2  # kNaiveStages
    cols = d * itemsize // 16
    per_group = cols if cols <= 992 else -(-cols // 2)  # two columns a thread past 992
    assert threads == -(-groups * per_group // 32) * 32 + 32 <= 1024  # consumers and a producer warp
    assert rows % groups == 0
    # the two stages of dy and x and their mu, rstd, or the groups' sums
    smem = max(stages * rows * (2 * d * itemsize + 8) + 16 * stages, 2 * groups * d * 4)
    assert smem <= SMEM_MAX
    stage, group, row = naive_walk(s, d, itemsize).T
    np.testing.assert_array_equal(np.sort(row), np.arange(s))  # each row once, none past S
    assert ((row // rows == stage) & (row % groups == group)).all()
    for g in range(groups):  # a group's rows in order: the emulated summation order
        assert (np.diff(row[group == g]) > 0).all()


def test_k10_feeds_its_sm_at_the_paths_widths():
    # K3's shape (D 1536) and the paper's Fig. 1 width (D 5120), bf16:
    # about 100 KB a stage, the two filling most of the shared memory
    for d in (1536, 5120):
        threads, groups, rows = naive_plan(d, 2)
        stage = rows * 2 * d * 2
        assert 80 * 1024 <= stage <= 100 * 1024 and threads >= 640
    assert naive_plan(1536, 2) == (992, 5, 15)


def _k10_sum(dy, x, mu, rstd, itemsize):
    """K10's (dscale, dshift) of one sample in its order, in numpy f32.
    dy, x: [S, D] f32 (the values the kernel reads, of ``itemsize`` bytes
    in the kernel's dtype); mu, rstd: [S]."""
    s, d = x.shape
    _, groups, _ = naive_plan(d, itemsize)
    ash = np.zeros((groups, d), np.float32)
    asc = np.zeros((groups, d), np.float32)
    for r in range(s):  # group r % groups adds row r after its earlier rows
        g = r % groups
        rs = np.float32(rstd[r])
        mr = np.float32(-mu[r] * rs)  # rounded once, as -mu * rs in f32
        xh = _fma_f32(x[r], np.full(d, rs, np.float32), np.full(d, mr, np.float32))
        ash[g] = (ash[g] + dy[r]).astype(np.float32)
        asc[g] = _fma_f32(dy[r], xh, asc[g])
    dshift, dscale = ash[0].copy(), asc[0].copy()
    for g in range(1, groups):  # the groups in order
        dshift = (dshift + ash[g]).astype(np.float32)
        dscale = (dscale + asc[g]).astype(np.float32)
    return dscale, dshift


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 1536])
def test_k10_order_within_gate_of_pallas(d, dtype):
    b, s = 2, 301
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((b, s, d)) * 2.0 + 0.3).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    if dtype == "bf16":  # the values the kernel reads
        x = torch.from_numpy(x).bfloat16().float().numpy()
        dy = torch.from_numpy(dy).bfloat16().float().numpy()
    mu = x.mean(-1, dtype=np.float32)
    rstd = (1 / np.sqrt(x.var(-1, dtype=np.float32) + 1e-6)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = adaln_bwd_dmod_naive_pallas(jnp.asarray(dy, jdt), jnp.asarray(x, jdt), jnp.asarray(mu),
                                       jnp.asarray(rstd), interpret=True)
    itemsize = 4 if dtype == "f32" else 2
    groups = naive_plan(d, itemsize)[1]
    assert groups > 1 and s % naive_plan(d, itemsize)[2]  # groups to combine; a short last stage
    for bi in range(b):
        got = _k10_sum(dy[bi], x[bi], mu[bi], rstd[bi], itemsize)
        for g_, w_ in zip(got, (np.asarray(want[0][bi]), np.asarray(want[1][bi]))):
            err = np.abs(g_ - w_).max()
            assert err <= SUM_F32_GATE * np.abs(w_).max(), (err, np.abs(w_).max())
    # the plain version the wrapper takes on the CPU agrees with the emulated order too
    plain = adaln_bwd_dmod_ref(*(torch.from_numpy(a) for a in (dy, x, mu, rstd)))
    emu = _k10_sum(dy[0], x[0], mu[0], rstd[0], itemsize)
    for p_, e_ in zip(plain, emu):
        np.testing.assert_allclose(p_[0].numpy(), e_, atol=SUM_F32_GATE * np.abs(e_).max(), rtol=0)
