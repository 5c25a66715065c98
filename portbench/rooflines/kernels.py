"""The least time the work of the kernels K1-K9 could take on an H100,
from its shapes: the larger of its operations over the peak rate and its
bytes over the memory rate.  The norms' arithmetic is a copy of
``chip_smoke.py``'s (``bound`` and its phases 2 and 5), frozen here so that
a change to the program cannot move the yardstick.

Bytes count each input read once and each output written once.  Norm
kernels count their f32 arithmetic against the f32 rate outside the tensor
cores.  Attention is bounded by the work the function needs, not by the
launches that run it: each attention call's forward (two ``Sq x Skv x dh``
products a head, ``Q K^T`` and ``P V``) and backward (five: the scores
again, ``dP``, ``dV``, ``dK`` and ``dQ``) against the bf16 tensor-core
rate, every tile live (these batches carry no segment ids).  The recompute
launches of K7 and the split of the backward into K8 and K9 are the
program's choice and take time without adding to the bound.

A training microbatch of ``L`` blocks with per-block recompute launches
(:func:`launches`): K1 4L+1, K2 and K3 2L+1 each, K4 2L, K5 and K6 L each,
K7 4L (self and cross, forward and recompute), K8 and K9 2L each.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores

#: kernel -> (family of ``trace.FAMILIES``, name of the launch's main CUDA kernel)
KERNELS = {
    "adaln_fwd": ("K1 adaln_fwd", "adaln_fwd_kernel"),
    "adaln_bwd_dx": ("K2 adaln_bwd_dx", "adaln_bwd_dx_kernel"),
    "adaln_bwd_dmod": ("K3 adaln_bwd_dmod", "adaln_bwd_dmod_partial_kernel"),
    "qk_rms_fwd": ("K4 qk_rms_fwd", "qk_rms_fwd_kernel"),
    "qk_rms_bwd_dx": ("K5 qk_rms_bwd_dx", "qk_rms_bwd_dx_kernel"),
    "qk_rms_bwd_dw": ("K6 qk_rms_bwd_dw", "qk_rms_bwd_dw_partial_kernel"),
    "flash_fwd": ("K7 flash_fwd", "flash_fwd_wg_kernel"),
    "flash_bwd_dq": ("K8 flash_bwd_dq", "flash_bwd_dq_wg_kernel"),
    "flash_bwd_dkv": ("K9 flash_bwd_dkv", "flash_bwd_dkv_wg_kernel"),
}
NORMS = ("adaln_fwd", "adaln_bwd_dx", "adaln_bwd_dmod", "qk_rms_fwd", "qk_rms_bwd_dx",
         "qk_rms_bwd_dw")
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def adaln_fwd(b, s, d):
    n = b * s
    return bound_s(2 * n * d * 2 + 2 * b * d * 4 + 2 * n * 4, 8 * n * d, F32_FLOPS)


def adaln_bwd_dx(b, s, d):
    n = b * s
    return bound_s(3 * n * d * 2 + 2 * n * 4 + b * d * 4, 10 * n * d, F32_FLOPS)


def adaln_bwd_dmod(b, s, d):
    n = b * s
    return bound_s(2 * n * d * 2 + 2 * n * 4 + 2 * b * d * 4, 4 * n * d, F32_FLOPS)


def qk_rms_fwd(b, s, h, dh):
    n = b * s * h * dh  # elements of q (and of k)
    return bound_s(4 * n * 2 + 2 * dh * 4 + 2 * b * s * h * 4, 2 * 4 * n, F32_FLOPS)


def qk_rms_bwd_dx(b, s, h, dh):
    n = b * s * h * dh
    return bound_s(2 * 3 * n * 2 + 2 * dh * 4 + 2 * (n // dh) * 4, 2 * 6 * n, F32_FLOPS)


def qk_rms_bwd_dw(b, s, h, dh):
    n = b * s * h * dh
    return bound_s(2 * 2 * n * 2 + 2 * (n // dh) * 4 + 2 * dh * 4, 2 * 3 * n, F32_FLOPS)


def flash_fwd(b, sq, skv, h, dh):
    q, kv = b * sq * h * dh, b * skv * h * dh
    nbytes = q * 2 + 2 * kv * 2 + q * 4 + b * h * sq * 4  # q, k, v; out f32, lse
    return bound_s(nbytes, 2 * 2 * b * h * sq * skv * dh, BF16_FLOPS)


def flash_bwd(b, sq, skv, h, dh):
    q, kv, st = b * sq * h * dh, b * skv * h * dh, b * h * sq * 4
    # read q do, k v, out (f32), lse; write dq, dk dv
    nbytes = 2 * q * 2 + 2 * kv * 2 + q * 4 + st + q * 2 + 2 * kv * 2
    return bound_s(nbytes, 5 * 2 * b * h * sq * skv * dh, BF16_FLOPS)


def attention(b, sq, skv, h, dh):
    """One attention call, forward and backward."""
    return flash_fwd(b, sq, skv, h, dh) + flash_bwd(b, sq, skv, h, dh)


def launches(n_layers: int) -> dict[str, int]:
    """Launches of each kernel in one training microbatch."""
    L = n_layers
    return {"adaln_fwd": 4 * L + 1, "adaln_bwd_dx": 2 * L + 1, "adaln_bwd_dmod": 2 * L + 1,
            "qk_rms_fwd": 2 * L, "qk_rms_bwd_dx": L, "qk_rms_bwd_dw": L,
            "flash_fwd": 4 * L, "flash_bwd_dq": 2 * L, "flash_bwd_dkv": 2 * L}


def norm_bounds(cfg: dict, b: int, s: int) -> float:
    """Seconds of bound of one microbatch's K1-K6 launches."""
    L, d = cfg["n_layers"], cfg["d_model"]
    h, dh = cfg["n_heads"], cfg["head_dim"]
    per = launches(L)
    return (per["adaln_fwd"] * adaln_fwd(b, s, d)
            + per["adaln_bwd_dx"] * adaln_bwd_dx(b, s, d)
            + per["adaln_bwd_dmod"] * adaln_bwd_dmod(b, s, d)
            + per["qk_rms_fwd"] * qk_rms_fwd(b, s, h, dh)
            + per["qk_rms_bwd_dx"] * qk_rms_bwd_dx(b, s, h, dh)
            + per["qk_rms_bwd_dw"] * qk_rms_bwd_dw(b, s, h, dh))


def flash_bound(cfg: dict, b: int, s: int) -> float:
    """Seconds of bound of one microbatch's attention: each layer's self
    (s x s) and cross (s x text) call, forward and backward once."""
    L, n, h, dh = cfg["n_layers"], cfg["text_len"], cfg["n_heads"], cfg["head_dim"]
    return L * (attention(b, s, s, h, dh) + attention(b, s, n, h, dh))


def roofline_pct(run, names, bound) -> float | None:
    """The share of their bound that the launches of ``names`` in the
    traced steps reached: the sum over the traced microbatches of
    ``bound(cfg, b, s)`` over the sum of those launches' device time, in
    percent; None without a trace or with no such launch.
    Raises where the trace does not hold exactly one main kernel for every
    launch the program counted and the microbatches call for."""
    tr = run.trace
    if tr is None:
        return None
    mbs = run.traced_microbatches
    if not tr.kernels and not any(run.traced_launches.get(n) for n in names):
        return None  # the plain path ran: no launch to read
    for n in names:
        main = KERNELS[n][1]
        seen = sum(1 for k, _, _ in tr.kernels if main in k)
        want = launches(run.cfg["n_layers"])[n] * len(mbs)
        if not seen == run.traced_launches.get(n) == want:
            raise RuntimeError(f"{n}: the trace holds {seen} launches, the program counted "
                               f"{run.traced_launches.get(n)}, the microbatches call for {want}")
    fams = {KERNELS[n][0] for n in names}
    from portbench.trace import family

    spent = sum(b - a for k, a, b in tr.kernels if family(k) in fams) / 1e6
    if spent <= 0:
        return None
    return 100.0 * sum(bound(run.cfg, b, s) for b, s in mbs) / spent
