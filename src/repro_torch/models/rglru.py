"""Griffin / RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427): the
counterpart of ``repro.models.rglru`` (``rglru_params``, ``_gates``,
``_causal_conv``, ``apply_rglru``, ``rglru_cache_init``,
``apply_rglru_decode``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full recurrent block is: linear-in -> causal conv1d(4) -> RG-LRU ->
gated merge with a GeLU branch -> linear-out, as in the paper's Fig. 2.

Training and prefill run the linear recurrence as a parallel prefix scan
(:func:`linear_scan`: the reference's ``jax.lax.associative_scan`` combine
in ceil(log2 S) doubling steps over f32 tensors); decode is one fused
update of the f32 state.  All of it is plain PyTorch, as the JAX model
leaves it to XLA outside any Pallas kernel.  The prefill conv runs in the
model's dtype and the decode conv in f32, then cast, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import dense_init, draw
from .ssm import _causal_conv

_C = 8.0  # Griffin's fixed temperature on the recurrence gate
CONV_WIDTH = 4  # the causal conv's taps; the decode cache keeps the last 3 rows


class RGLRU(nn.Module):
    """The mixer's parameters under the reference's names (``rglru_params``;
    the recurrent width is ``d_model``): ``in_x`` (recurrent branch),
    ``in_y`` (GeLU gate branch), ``w_a`` (recurrence gate), ``w_i`` (input
    gate) and ``out`` [d, d], ``conv_w`` [4, d] and ``conv_b`` [d] in the
    model's dtype, and ``lam`` (Lambda) [d] in f32."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.in_x = dense_init(gen, d, d, dtype, device)
        self.in_y = dense_init(gen, d, d, dtype, device)
        self.w_a = dense_init(gen, d, d, dtype, device)
        self.w_i = dense_init(gen, d, d, dtype, device)
        self.lam = nn.Parameter(torch.linspace(0.5, 4.0, d, dtype=torch.float32, device=device))
        self.conv_w = nn.Parameter(draw(gen, (CONV_WIDTH, d), device, 0.2, dtype))
        self.conv_b = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))
        self.out = dense_init(gen, d, d, dtype, device)


def _gates(p: RGLRU, xr):
    """``(a, beta, i)`` f32 of the conv output xr [B, S, d]: the decay
    ``a = exp(log_a)``, the input scale ``sqrt(1 - a^2)`` (floored at
    1e-12 under the root) and the input gate."""
    r = torch.sigmoid((xr @ p.w_a).float())
    i = torch.sigmoid((xr @ p.w_i).float())
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns into the identity above 20
    log_a = -_C * torch.logaddexp(p.lam, torch.zeros_like(p.lam)) * r  # [B, S, d] (<= 0)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta, i


def linear_scan(a, u):
    """h_t = a_t h_{t-1} + u_t along axis 1 from h_{-1} = 0, for a, u [B,
    S, d] f32: the reference's associative combine ``(a1 a2, u1 a2 + u2)``
    in ceil(log2 S) doubling steps (Hillis-Steele), each position combined
    with the one k before it.  No cumulative product of ``a`` is formed:
    a single step's a can be e^-32, so such products underflow."""
    s = a.shape[1]
    k = 1
    while k < s:
        u = u + a * F.pad(u[:, :-k], (0, 0, k, 0))
        if 2 * k < s:  # the last step needs no combined decay
            a = a * F.pad(a[:, :-k], (0, 0, k, 0), value=1.0)
        k *= 2
    return u


def apply_rglru(p: RGLRU, x, cfg: ModelConfig, *, return_cache: bool = False):
    """x [B, S, d] -> [B, S, d], and with ``return_cache`` the decode cache
    too: ``(out, {"h": the state after the last position [B, d] f32,
    "conv": the last 3 rows of the conv's input [B, 3, d]})``, the conv rows
    front-padded with zeros when S < 3."""
    xin = x @ p.in_x
    xr = _causal_conv(xin, p.conv_w, p.conv_b)
    xg = F.gelu((x @ p.in_y).float(), approximate="tanh")  # jax.nn.gelu's default

    a, beta, i = _gates(p, xr)
    u = beta * i * xr.float()  # forced input
    h = linear_scan(a, u)
    y = (h * xg).to(x.dtype)
    out = y @ p.out
    if not return_cache:
        return out
    s = x.shape[1]
    keep = CONV_WIDTH - 1
    tail = xin[:, -keep:] if s >= keep else F.pad(xin, (0, 0, keep - s, 0))
    # copies, so the cache does not hold the whole sequence's tensors alive
    return out, {"h": h[:, -1].clone(), "conv": tail.contiguous()}


def rglru_cache_init(batch: int, cfg: ModelConfig, dtype, device) -> dict:
    """Zero decode caches: h [B, d] f32, conv [B, 3, d] in ``dtype``."""
    d = cfg.d_model
    return {
        "h": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, d), dtype=dtype, device=device),
    }


def apply_rglru_decode(p: RGLRU, x, cache: dict, cfg: ModelConfig):
    """One token a row: x [B, 1, d] -> ``(out [B, 1, d], new cache)``.  The
    conv window runs in f32 and is cast to x's dtype; the state update is
    one fused expression."""
    xin = x @ p.in_x  # [B, 1, d]
    win = torch.cat([cache["conv"], xin], dim=1)  # [B, 4, d]
    xr = (
        torch.einsum("bwc,wc->bc", win.float(), p.conv_w.float()) + p.conv_b.float()
    )[:, None, :].to(x.dtype)
    xg = F.gelu((x @ p.in_y).float(), approximate="tanh")

    a, beta, i = _gates(p, xr)
    u = beta * i * xr.float()
    h = cache["h"][:, None, :] * a + u  # [B, 1, d]
    y = (h * xg).to(x.dtype)
    return y @ p.out, {"h": h[:, 0], "conv": win[:, 1:]}
