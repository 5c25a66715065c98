"""Mamba-2 SSD (state-space duality) mixer: the chunked forward of training
and prefill, and the recurrent decode step.  The counterpart of
``repro.models.ssm`` (``ssm_params``, ``_causal_conv``, ``_split_proj``,
``apply_ssm``, ``ssm_cache_init``, ``apply_ssm_decode``).

Follows arXiv:2405.21060's block decomposition: within a chunk of length Q
the output is the quadratic "attention-like" form; across chunks a [H, hd,
ds] state is carried with a scalar decay per head.

Layout (one group, as in the 2.7b config):
  in_proj:   d_model -> [z (di), x (di), B (ds), C (ds), dt (H)]
  conv1d:    causal depthwise width-4 over the (x, B, C) channels
  SSD:       y[t] = sum_{j<=t} C[t]·h-contribution, h decays by exp(dt*A)
  gate:      gated_rms_norm(y, w, z), through the kernel dispatch (K13)
  out_proj:  di -> d_model

Decode carries ``{"conv": [B, cw-1, di+2ds] in the model's dtype, "state":
[B, H, hd, ds] f32}``: the last cw-1 rows of the pre-conv (x, B, C)
channels and the SSD state.  The SSD arithmetic (einsums, cumulative sums,
``exp``, the causal conv, the recurrent update) is plain PyTorch, as the
JAX model leaves it to XLA outside any Pallas kernel; only the gated norm
is a kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import kernels

from .config import SSMConfig
from .layers import dense_init, draw


class SSM(nn.Module):
    """The mixer's parameters under the reference's names (``ssm_params``):
    ``in_proj`` [d, 2 di + 2 ds + H], ``conv_w`` [cw, di + 2 ds] and
    ``conv_b`` in the model's dtype, ``A_log``, ``dt_bias``, ``D`` [H] and
    ``norm_w`` [di] in f32, ``out_proj`` [di, d]."""

    def __init__(self, d_model: int, cfg: SSMConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        di = cfg.expand * d_model
        nh = di // cfg.head_dim
        ds = cfg.d_state
        conv_dim = di + 2 * ds
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = dense_init(gen, d_model, 2 * di + 2 * ds + nh, dtype, device)
        self.conv_w = nn.Parameter(draw(gen, (cfg.conv_width, conv_dim), device, 0.2, dtype))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, dtype=dtype, device=device))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, nh, **f32)))
        self.dt_bias = nn.Parameter(torch.zeros(nh, **f32))
        self.D = nn.Parameter(torch.ones(nh, **f32))
        self.norm_w = nn.Parameter(torch.ones(di, **f32))
        self.out_proj = dense_init(gen, di, d_model, dtype, device)


def _causal_conv(x, w, b):
    """Depthwise causal conv via shifted adds.  x: [B, S, C]; w: [cw, C].

    A shift of i >= S is all zeros (the reference's ``pad(x[:, :-i])``
    takes no such shift: its conv raises for S < cw - 1); shorter shifts
    are the reference's, value for value."""
    cw, s = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, cw):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[cw - 1 - i]
    return out + b


def _split_proj(zxbcdt, di: int, ds: int):
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : di + di + 2 * ds]
    dt = zxbcdt[..., di + di + 2 * ds :]
    return z, xbc, dt


def ssd(xs, bmat, cmat, dt, p: SSM, chunk: int, head_dim: int):
    """The chunked SSD scan of one sequence batch, S a multiple of ``chunk``.

    xs [B, S, di], bmat and cmat [B, S, ds] (after the conv), dt [B, S, H]
    (before softplus).  Returns ``(y [B, S, di] f32, the skip term ``D x``
    included, h [B, H, hd, ds] f32, the state after the last chunk)``: the
    inter-chunk recurrence computes h either way; prefill keeps it as the
    decode cache."""
    bsz, s, di = xs.shape
    ds = bmat.shape[-1]
    nh, hd, q = di // head_dim, head_dim, chunk
    nc = s // q
    dt = F.softplus(dt.float() + p.dt_bias)  # [B, S, H]
    a = -torch.exp(p.A_log)  # [H]
    da = dt * a

    # chunk views
    xh = xs.reshape(bsz, nc, q, nh, hd).float()
    bm = bmat.reshape(bsz, nc, q, ds).float()
    cm = cmat.reshape(bsz, nc, q, ds).float()
    dac = da.reshape(bsz, nc, q, nh)
    dtc = dt.reshape(bsz, nc, q, nh)

    # within-chunk cumulative decay
    cs = torch.cumsum(dac, dim=2)  # [B, nc, Q, H]
    # intra-chunk (quadratic) term: L[t, j] = exp(cs_t - cs_j) for t >= j.
    # Mask BEFORE exp: masked rel is positive and can overflow exp, and
    # exp(rel) * mask still produces NaN gradients.
    rel = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # [B, nc, Q, Q, H]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xs.device))
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], rel, -math.inf))
    cb = torch.einsum("bnts,bnjs->bntj", cm, bm)  # [B, nc, Q, Q]
    w_mat = cb[..., None] * l_mat * dtc[:, :, None, :, :]  # [B, nc, Q(t), Q(j), H]
    y_intra = torch.einsum("bntjh,bnjhd->bnthd", w_mat, xh)

    # chunk-final states: S_n = sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # [B, nc, Q, H]
    # (the three-operand einsum "bnjh,bnjs,bnjhd->bnhds" in the order that
    # keeps the largest intermediate at [B, nc, Q, H, hd])
    sb = torch.einsum("bnjhd,bnjs->bnhds", xh * (decay_to_end * dtc)[..., None], bm)

    # inter-chunk recurrence over nc (sequential; nc is small): the state
    # entering each chunk, before that chunk's own contribution
    chunk_decay = torch.exp(cs[:, :, -1, :])  # [B, nc, H]
    h = torch.zeros((bsz, nh, hd, ds), dtype=torch.float32, device=xs.device)
    h_in = []
    for n in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, n, :, None, None] + sb[:, n]
    h_in = torch.stack(h_in, dim=1)  # [B, nc, H, hd, ds]

    # inter-chunk contribution: y += exp(cs_t) * C_t · h_in
    y_inter = torch.einsum("bnts,bnhds->bnthd", cm, h_in) * torch.exp(cs)[..., None]
    y = y_intra + y_inter + xh * p.D[None, None, None, :, None]
    return y.reshape(bsz, s, di), h


def _conv_silu(p: SSM, xbc, di: int, ds: int):
    """The causal conv with its silu over the (x, B, C) channels, split:
    ``(xs [..., di], bmat [..., ds], cmat [..., ds])``."""
    xbc = F.silu(_causal_conv(xbc, p.conv_w, p.conv_b))
    return xbc[..., :di], xbc[..., di : di + ds], xbc[..., di + ds :]


def ssd_inputs(p: SSM, x, cfg: SSMConfig):
    """The mixer up to the SSD scan: the input projection, split, and the
    causal conv with its silu over the (x, B, C) channels.  x [B, S,
    d_model] -> ``(z, xs, bmat, cmat, dt)``, the gate and :func:`ssd`'s
    inputs."""
    di, ds = cfg.expand * x.shape[-1], cfg.d_state
    z, xbc, dt = _split_proj(x @ p.in_proj, di, ds)
    return (z, *_conv_silu(p, xbc, di, ds), dt)


def apply_ssm(p: SSM, x, cfg: SSMConfig, ops=kernels, *, return_cache: bool = False):
    """Chunked SSD forward.  x: [B, S, d_model] -> [B, S, d_model], and with
    ``return_cache`` the decode cache too: ``(out, {"conv": the last cw-1
    rows of the pre-conv (x, B, C) channels, "state": the final SSD
    state})``.  The gated norm runs through ``ops.gated_rms_norm`` (the
    kernel dispatch, or ``kernels.plain``)."""
    s = x.shape[1]
    q = min(cfg.chunk, s)
    if s % q != 0:
        # pad at the end (causal: padded positions never influence real ones)
        pad = q - s % q
        res = apply_ssm(p, F.pad(x, (0, 0, 0, pad)), cfg, ops, return_cache=return_cache)
        if return_cache:
            # as in the reference: the cache is the padded sequence's (its conv
            # window and state have run over the padding), which is wrong for
            # decode; prefill callers use chunk-aligned lengths
            return res[0][:, :s], res[1]
        return res[:, :s]

    di, ds = cfg.expand * x.shape[-1], cfg.d_state
    z, xbc, dt = _split_proj(x @ p.in_proj, di, ds)
    xs, bmat, cmat = _conv_silu(p, xbc, di, ds)
    y, h_final = ssd(xs, bmat, cmat, dt, p, q, cfg.head_dim)

    # Gate + Norm fusion (paper §4.4) then output projection
    y = ops.gated_rms_norm(y.to(x.dtype), p.norm_w, z)
    out = y @ p.out_proj
    if not return_cache:
        return out
    # the last cw-1 rows (the conv above takes no shorter sequence), copied
    # so the cache does not hold the whole projection alive
    return out, {"conv": xbc[:, -(cfg.conv_width - 1):].contiguous(), "state": h_final}


def ssm_cache_init(batch: int, d_model: int, cfg: SSMConfig, dtype, device) -> dict:
    """Zero decode caches: conv [B, cw-1, di+2ds] in ``dtype``, state [B, H,
    hd, ds] f32."""
    di = cfg.expand * d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * cfg.d_state), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, di // cfg.head_dim, cfg.head_dim, cfg.d_state),
                             dtype=torch.float32, device=device),
    }


def apply_ssm_decode(p: SSM, x, cache: dict, cfg: SSMConfig, ops=kernels):
    """Single-token recurrent update.  x: [B, 1, d_model] -> ``(out [B, 1,
    d_model], new cache)``.  The conv window and the state update run in
    f32; the gate is the z slice of the projection (a strided view), through
    ``ops.gated_rms_norm``."""
    bsz, _, d_model = x.shape
    di, ds = cfg.expand * d_model, cfg.d_state
    hd = cfg.head_dim
    nh = di // hd

    z, xbc, dt = _split_proj((x @ p.in_proj)[:, 0], di, ds)  # [B, *]

    # conv cache: window = [cache, current]
    win = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # [B, cw, C]
    conv_out = torch.einsum("bwc,wc->bc", win.float(), p.conv_w.float())
    xbc_c = F.silu(conv_out + p.conv_b.float()).to(x.dtype)
    xs, bm, cm = xbc_c[..., :di], xbc_c[..., di : di + ds], xbc_c[..., di + ds :]

    dtv = F.softplus(dt.float() + p.dt_bias)  # [B, H]
    dec = torch.exp(dtv * -torch.exp(p.A_log))  # [B, H]
    xh = xs.reshape(bsz, nh, hd).float()
    # the reference's einsum "bh,bs,bhd->bhds" (products only, no sum) as
    # broadcasts: a three-operand einsum searches its contraction path on
    # the host at every call
    dbx = (dtv[..., None] * xh)[..., None] * bm.float()[:, None, None, :]  # [B, H, hd, ds]
    h = cache["state"] * dec[..., None, None] + dbx
    y = torch.einsum("bs,bhds->bhd", cm.float(), h) + xh * p.D[None, :, None]
    y = ops.gated_rms_norm(y.reshape(bsz, 1, di).to(x.dtype), p.norm_w, z[:, None, :])
    return y @ p.out_proj, {"conv": win[:, 1:], "state": h}
