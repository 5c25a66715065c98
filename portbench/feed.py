"""What the benchmark hands to both the program and the reference: the
weights and the microbatches, all made from seeds.

* The weights are drawn on the device one group at a time (the top-level
  projections, then each block), in one ``torch.randn`` call a group, in the
  configuration's dtype; the norm gains start at one and the biases at zero,
  as Wan-2.1 initialises them.  A group's generator is seeded by ``(seed,
  group)``, so one block can be drawn again alone.
* A microbatch's latents, text states, diffusion times and noise are drawn
  on the device from ``(seed, stream, index)``: the loader's stream is
  stream 0 and numbers its microbatches in the order it draws them, the
  warm-up is stream 1, and a compared step that set-up draws itself (a
  cell's ``compared_steps`` name it) is stream 2.  Nothing is taken from
  the loader's generator, whose seed is fixed: the bucket order is the same
  for every ``--seed``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LOADER_STREAM, WARMUP_STREAM = 0, 1


def key(*words: int) -> int:
    """A 64-bit generator seed from whole numbers of any size."""
    return int(np.random.SeedSequence([w % 2**64 for w in words]).generate_state(1, np.uint64)[0])


def patch_dim(cfg: dict) -> int:
    return cfg["in_channels"] * math.prod(cfg["patch"])


# -- weights ---------------------------------------------------------------------


def param_groups(cfg: dict) -> list[tuple[str, list[tuple[str, tuple, str]]]]:
    """``[(group, [(name, shape, init), ...]), ...]`` in the MMDiT's
    parameter names; ``init`` is ``"normal"`` (N(0, 1) / sqrt(fan-in), the
    configuration's dtype), ``"ones"`` or ``"zeros"`` (f32)."""
    d, dff, hd, dh = cfg["d_model"], cfg["d_ff"], cfg["n_heads"] * cfg["head_dim"], cfg["head_dim"]
    top = [
        ("x_in", (patch_dim(cfg), d), "normal"),
        ("txt_in", (cfg["text_dim"], d), "normal"),
        ("t_mlp1", (cfg["freq_dim"], d), "normal"),
        ("t_mlp2", (d, 6 * d), "normal"),
        ("final_mod", (d, 2 * d), "normal"),
        ("x_out", (d, patch_dim(cfg)), "normal"),
    ]
    block = [
        ("wqkv", (d, 3 * hd), "normal"),
        ("wo", (hd, d), "normal"),
        ("qnorm", (dh,), "ones"),
        ("knorm", (dh,), "ones"),
        ("xq", (d, hd), "normal"),
        ("xkv", (d, 2 * hd), "normal"),
        ("xo", (hd, d), "normal"),
        ("norm3.w", (d,), "ones"),
        ("norm3.b", (d,), "zeros"),
        ("mlp.w1", (d, dff), "normal"),
        ("mlp.w3", (d, dff), "normal"),
        ("mlp.w2", (dff, d), "normal"),
        ("mod_bias", (6, d), "zeros"),
    ]
    groups = [("top", top)]
    for i in range(cfg["n_layers"]):
        groups.append((f"blocks.{i}", [(f"blocks.{i}.{n}", s, k) for n, s, k in block]))
    return groups


def draw_group(seed: int, index: int, specs, dtype, device) -> dict[str, torch.Tensor]:
    """One group's initial weights: its matrices from ONE draw of
    ``(seed, index)``'s generator, each scaled by its fan-in."""
    gen = torch.Generator(device=device).manual_seed(key(seed, 0x57, index))
    normal = [(n, s) for n, s, k in specs if k == "normal"]
    flat = torch.randn(sum(math.prod(s) for _, s in normal), generator=gen, dtype=dtype,
                       device=device)
    out, at = {}, 0
    for name, shape in normal:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(shape[0] ** -0.5)
        at += n
    for name, shape, kind in specs:
        if kind != "normal":
            fill = torch.ones if kind == "ones" else torch.zeros
            out[name] = fill(shape, dtype=torch.float32, device=device)
    return out


def draw_weights(seed: int, cfg: dict, device) -> dict[str, torch.Tensor]:
    dt = DTYPES[cfg["dtype"]]
    out = {}
    for i, (_, specs) in enumerate(param_groups(cfg)):
        out.update(draw_group(seed, i, specs, dt, device))
    return out


# -- microbatches ------------------------------------------------------------------


def make_batch(seed: int, stream: int, index: int, b: int, s: int, cfg: dict, device) -> dict:
    """Latent tokens [b, s, patch_dim] and text states [b, text_len,
    text_dim] in the configuration's dtype, the diffusion times [b] and
    the noise [b, s, patch_dim] in f32 (the noise the engine's hook hands
    to the loss)."""
    gen = torch.Generator(device=device).manual_seed(key(seed, stream, index))
    dt = DTYPES[cfg["dtype"]]
    c = patch_dim(cfg)
    return {
        "latents": torch.randn((b, s, c), generator=gen, dtype=dt, device=device),
        "text": torch.randn((b, cfg["text_len"], cfg["text_dim"]), generator=gen, dtype=dt,
                            device=device),
        "t": torch.rand((b,), generator=gen, dtype=torch.float32, device=device),
        "eps": torch.randn((b, s, c), generator=gen, dtype=torch.float32, device=device),
    }
