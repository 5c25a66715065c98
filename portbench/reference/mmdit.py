"""The plain reference of a Wan-2.1 training step: the MMDiT forward, the
rectified-flow loss, its gradient by autograd, the pool mean over a step's
microbatches and one AdamW update, in plain PyTorch and f32 with TF32 off.

It imports nothing of the program.  It gets from the benchmark only what
the benchmark hands the program too: the configuration, the seed (the
weights and every microbatch are drawn again by ``feed``) and the
microbatches each step held, as ``(B, S, stream, index)``.

Parameters are stored in the configuration's dtype between steps (a bf16
matrix is rounded to bf16 after each update, as the configuration states);
everything is computed in f32 from them.  To fit at the timed sizes a
microbatch runs one sample at a time (its loss is the mean of the samples'
equal-sized means) and the attention runs in query chunks; where a
sample's activations would not fit beside the state, each block is
recomputed in the backward, and a layer's attention chunks too where its
scores would not fit.

``precision="fp8"`` is the control: every projection and MLP product takes
its operands rounded to float8 e4m3 (per-tensor scales) and its output
gradient to e5m2, the step below the configuration's bf16.  ``fault="half"``
drops the second half of each step's rows and takes the mean over the rest.
"""

from __future__ import annotations

import math
import statistics

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import feed

SCORE_BYTES = 2 * 2**30  # f32 scores of one attention chunk
LAYER_SCORE_BYTES = 8 * 2**30  # above this a layer's chunks are recomputed in the backward
SAMPLE_BYTES = 24 * 2**30  # at most this for a sample's activations kept for the backward
STATE_ROOM = 64 * 2**30  # the card's room for the f32 state and a sample's activations


def _q8(x, fmt):
    s = x.detach().abs().amax().clamp_min(1e-30) / torch.finfo(fmt).max
    return (x / s).to(fmt).to(torch.float32) * s


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to e4m3; the weight ``b`` is
    kept as it is and rounded again in the backward, where the output's
    gradient is rounded to e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        a8 = _q8(a, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b)
        return a8 @ _q8(b, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        a8, b = ctx.saved_tensors
        b8 = _q8(b, torch.float8_e4m3fn)
        g8 = _q8(g, torch.float8_e5m2)
        ga = g8 @ b8.T
        gb = a8.reshape(-1, a8.shape[-1]).T @ g8.reshape(-1, g8.shape[-1])
        return ga, gb


def _matmul(precision: str):
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"precision is 'f32' or 'fp8', not {precision!r}")


def layer_norm(x, eps):
    mu = x.mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(dim=-1, keepdim=True) + eps)


def adaln_modulate(x, scale, shift, eps):
    """LayerNorm without affine, then ``x * (1 + scale) + shift``."""
    return layer_norm(x, eps) * (1.0 + scale[:, None, :]) + shift[:, None, :]


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _attend(q, k, v, scale):
    return torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1) @ v


def attention(q, k, v):
    """Non-causal softmax attention; q [B, Sq, H, dh], k, v [B, Skv, H, dh]."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scale = dh ** -0.5
    chunk = max(64, SCORE_BYTES // (4 * b * h * skv))
    remat = 4 * b * h * sq * skv > LAYER_SCORE_BYTES
    outs = []
    for i in range(0, sq, chunk):
        qc = q[:, :, i:i + chunk]
        outs.append(checkpoint(_attend, qc, k, v, scale, use_reentrant=False) if remat
                    else _attend(qc, k, v, scale))
    return torch.cat(outs, dim=2).transpose(1, 2)


def timestep_embedding(t, dim: int, max_period: float = 10_000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t[:, None] * 1000.0 * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def block(p: dict, i: int, x, txt, mod, cfg: dict, mm):
    g = f"blocks.{i}."
    b, s, _ = x.shape
    h, dh, eps = cfg["n_heads"], cfg["head_dim"], cfg["norm_eps"]
    m = mod + p[g + "mod_bias"][None]
    shift1, scale1, gate1, shift2, scale2, gate2 = m.unbind(dim=1)
    qkv = mm(adaln_modulate(x, scale1, shift1, eps), p[g + "wqkv"])
    q, k, v = (t.reshape(b, s, h, dh) for t in qkv.split(h * dh, dim=-1))
    ctx = attention(rms_norm(q, p[g + "qnorm"], eps), rms_norm(k, p[g + "knorm"], eps), v)
    x = x + gate1[:, None, :] * mm(ctx.reshape(b, s, h * dh), p[g + "wo"])
    hn = layer_norm(x, eps) * p[g + "norm3.w"] + p[g + "norm3.b"]
    qx = mm(hn, p[g + "xq"]).reshape(b, s, h, dh)
    kx, vx = (t.reshape(b, -1, h, dh) for t in mm(txt, p[g + "xkv"]).split(h * dh, dim=-1))
    x = x + mm(attention(qx, kx, vx).reshape(b, s, h * dh), p[g + "xo"])
    hm = adaln_modulate(x, scale2, shift2, eps)
    mlp = mm(F.silu(mm(hm, p[g + "mlp.w1"])) * mm(hm, p[g + "mlp.w3"]), p[g + "mlp.w2"])
    return x + gate2[:, None, :] * mlp


def activation_bytes(cfg: dict, s: int) -> int:
    """About what one sample's f32 forward keeps for the backward without
    recompute: each block's d-, head- and d_ff-wide rows and its attention
    scores and probabilities, self and cross."""
    d, dff, h, n = cfg["d_model"], cfg["d_ff"], cfg["n_heads"], cfg["text_len"]
    per_token = 4 * (12 * d + 4 * dff) + 8 * h * (s + n)
    return cfg["n_layers"] * s * per_token


def forward(p: dict, cfg: dict, latents, text, t, mm, room: int = SAMPLE_BYTES):
    """The velocity of one sample; its blocks are recomputed in the
    backward where its activations would take more than ``room`` bytes."""
    d = cfg["d_model"]
    remat = activation_bytes(cfg, latents.shape[1]) > room
    x = mm(latents, p["x_in"])
    txt = mm(text, p["txt_in"])
    temb = F.silu(mm(timestep_embedding(t, cfg["freq_dim"]), p["t_mlp1"]))
    mod = mm(temb, p["t_mlp2"]).reshape(-1, 6, d)
    for i in range(cfg["n_layers"]):
        x = (checkpoint(block, p, i, x, txt, mod, cfg, mm, use_reentrant=False) if remat
             else block(p, i, x, txt, mod, cfg, mm))
    fm = mm(temb, p["final_mod"]).reshape(-1, 2, d)
    return mm(adaln_modulate(x, fm[:, 0], fm[:, 1], cfg["norm_eps"]), p["x_out"])


def sample_loss(p: dict, cfg: dict, batch: dict, r: int, mm, room: int = SAMPLE_BYTES):
    """The rectified-flow loss of row ``r``: ``xt = (1 - t) x0 + t eps``,
    the target ``eps - x0``, the mean of the squared differences."""
    x0 = batch["latents"][r:r + 1].float()
    eps = batch["eps"][r:r + 1]
    t = batch["t"][r:r + 1]
    tt = t[:, None, None]
    v = forward(p, cfg, (1.0 - tt) * x0 + tt * eps, batch["text"][r:r + 1].float(), t, mm, room)
    return ((v - (eps - x0)) ** 2).mean()


def _rows(step, fault):
    """``{microbatch: [rows]}`` of a step's rows that count."""
    rows = [(j, r) for j, (b, _, _, _) in enumerate(step) for r in range(b)]
    if fault == "half" and len(rows) > 1:
        rows = rows[: -(-len(rows) // 2)]
    elif fault is not None and fault != "half":
        raise ValueError(f"fault is None or 'half', not {fault!r}")
    out: dict[int, list[int]] = {}
    for j, r in rows:
        out.setdefault(j, []).append(r)
    return out


def _norms(tree: dict) -> dict[str, float]:
    names = list(tree)
    vals = torch.stack([tree[n].float().norm() for n in names]).tolist()
    return dict(zip(names, vals))


def follow(cfg: dict, opt: dict, seed: int, steps, device, *, precision: str = "f32",
           fault: str | None = None) -> dict:
    """Run ``steps`` (each a list of ``(B, S, stream, index)``) from the
    seed's weights.  Returns the step losses, the per-leaf norms of the
    first step's pool-mean gradient (``grad``) and of AdamW's first moment
    after it (``m``), and of each leaf's change over all the steps
    (``change``)."""
    mm = _matmul(precision)
    stored = feed.DTYPES[cfg["dtype"]]
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        groups = feed.param_groups(cfg)
        p = {n: w.float().requires_grad_()
             for n, w in feed.draw_weights(seed, cfg, device).items()}
        low = {n for _, specs in groups for n, _, k in specs if k == "normal"}
        # AdamW's moments wait in pinned host memory where the f32 state would
        # crowd the card (the 14B's); the card keeps the weights and gradients
        n_params = sum(w.numel() for w in p.values())
        host = torch.device(device).type == "cuda" and 16 * n_params > STATE_ROOM // 2
        room = min(SAMPLE_BYTES, STATE_ROOM - (8 if host else 16) * n_params)
        m = {n: torch.zeros(w.shape, device="cpu" if host else device, pin_memory=host)
             for n, w in p.items()}
        v = {n: torch.zeros(w.shape, device="cpu" if host else device, pin_memory=host)
             for n, w in p.items()}
        out = {"losses": []}
        for k_step, step in enumerate(steps):
            rows = _rows(step, fault)
            loss_sum = 0.0
            for j, rs in rows.items():
                b, s, stream, index = step[j]
                batch = feed.make_batch(seed, stream, index, b, s, cfg, device)
                for r in rs:
                    loss = sample_loss(p, cfg, batch, r, mm, room) / (len(rs) * len(rows))
                    loss.backward()
                    loss_sum += loss.item()
                del batch
            out["losses"].append(loss_sum)
            grads = {n: w.grad for n, w in p.items()}
            if k_step == 0:
                out["grad"] = _norms(grads)
            m_norms = _adamw(p, grads, m, v, k_step, opt, low, stored)
            if k_step == 0:
                out["m"] = m_norms
            for w in p.values():
                w.grad = None
        change = {}
        with torch.no_grad():
            for i, (_, specs) in enumerate(groups):
                w0 = feed.draw_group(seed, i, specs, stored, device)
                change.update({n: float((p[n] - w0[n].float()).norm()) for n in w0})
        out["change"] = change
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@torch.no_grad()
def _adamw(p, grads, m, v, step: int, opt: dict, low: set, stored) -> dict[str, float]:
    """AdamW with global-norm clipping, bias correction by ``step + 1``,
    decoupled decay on every leaf (each MMDiT leaf is a matrix or a stacked
    block's), a constant rate; a stored-bf16 leaf is rounded after.
    Returns the norm of each leaf's new first moment."""
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    clip = torch.clamp(opt["clip_norm"] / gnorm.clamp_min(1e-9), max=1.0)
    b1, b2 = opt["beta1"], opt["beta2"]
    bc1, bc2 = 1.0 - b1 ** (step + 1.0), 1.0 - b2 ** (step + 1.0)
    norms = {}
    for n, w in p.items():
        g = grads[n] * clip
        mn, vn = m[n].to(w.device), v[n].to(w.device)
        mn.mul_(b1).add_((1 - b1) * g)
        vn.mul_(b2).add_((1 - b2) * g * g)
        delta = (mn / bc1) / (torch.sqrt(vn / bc2) + opt["eps"]) + opt["weight_decay"] * w
        new = w - opt["peak_lr"] * delta
        w.copy_(new.to(stored).float() if n in low else new)
        norms[n] = mn.norm()
        if mn is not m[n]:
            m[n].copy_(mn)
            v[n].copy_(vn)
    names = list(norms)
    return dict(zip(names, torch.stack([norms[n] for n in names]).tolist()))


def gaps(prog: dict, ref: dict) -> dict[str, float]:
    """The compared numbers, each the worst of its kind:

    * ``loss``: the largest relative gap of a step's loss;
    * ``grad``: the largest gap between a leaf's first-moment norm after
      step 1 (the first gradient as the optimizer gets it, times 1 - beta1)
      in the program and in the reference, over the larger of the
      reference's norm of that leaf and of the median leaf;
    * ``change``: the same for each leaf's change over the compared steps,
      leaving out leaves whose reference gradient is under a thousandth of
      the median leaf's (they move by round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med_m = statistics.median(ref["m"].values())
    grad = max(abs(prog["m"][n] - r) / max(r, med_m) for n, r in ref["m"].items())
    med_g = statistics.median(ref["grad"].values())
    counted = [n for n, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][n] for n in counted)
    change = max(abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], med_c)
                 for n in counted)
    return {"loss": loss, "grad": grad, "change": change}
