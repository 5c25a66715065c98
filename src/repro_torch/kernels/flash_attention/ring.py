"""K11: ring segment-aware flash attention, one packed window over k
sequence shards: the counterpart of ``repro.kernels.flash_attention.ring``
(``ring_flash_attention`` and its jnp twin ``ring_attention_ref``).

Each ring rank holds a contiguous shard of the window's queries, keys and
values (``[B, S/k, H, dh]``, the model's layout, with ``[B, S/k]`` segment
ids).  The keys and values travel around the ring one hop at a time, so
after k hops every query shard has seen the whole window and no rank held
more than ``S/k`` of it.  The hop schedule is written once, over a
*group* of ring ranks:

* :class:`LocalRing` holds all k shards in one process, stacked rank-major
  along the batch axis (``[k B, S/k, ...]``); its rotation is a roll of a
  list of views.  It carries the on-card check of the ring on one GPU, as
  the reference's tests run ``shard_map`` on forced host devices;
* :class:`ProcessRing` holds one shard per process and rotates with
  ``torch.distributed.batch_isend_irecv`` into buffers allocated before the
  loop (gloo on CPU tensors, NCCL on CUDA tensors).

At hop t, ring rank r attends the key/value block of rank (r - t) mod k:
the diagonal block (t = 0) with the caller's ``causal``; under ``causal`` a
block from a lower rank is fully visible and one from a higher rank is
skipped; and a block whose per-row segment-id ranges do not meet the query
shard's is skipped (``_block_overlap``'s exact predicate, padding -1
included).  The skips form a k x k *live table*, worked out once per
microbatch from the shards' per-row (min, max) segment ids (on the host for
``LocalRing``, by one ``all_gather`` for ``ProcessRing``) and read by every
layer's ring: no predicate is read back from the device per hop.

Per live hop the forward runs K7 (``flash_fwd``, f32 output) and merges the
block's (o, lse) into a running fp32 log-sum-exp state with the
``ring_merge`` kernel (``csrc/ring_merge.cu``); ``ring_finalize`` turns the
state into the output and its lse.  A skipped hop merges nothing: merging
the reference's skipped block (o = 0, lse = -2e38) leaves every finished
output and lse bitwise unchanged (tests/test_torch_ring.py shows it).  The
backward (:class:`RingAttention`) upcasts q, k, v and the output gradient
to f32 once, runs K8 then K9 in f32 per live hop against the merged output
and lse, accumulates dq, dk and dv in f32, and rotates (k, v, ids, dk, dv)
on every hop, k times in all, so each dk/dv lands on its owner; they are
cast once at the end.  Both groups add the contributions in the same hop
order.  CPU tensors run the plain versions of the same schedule
(``ref.attention_ref`` in f32-out mode, ``ref.attention_bwd_ref`` and
:func:`merge_ref`); a CUDA tensor runs the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from .flash import HEAD_DIMS, flash_bwd_dkv, flash_bwd_dq, flash_fwd
from .ref import LSE_FLOOR, NEG_INF, attention_bwd_ref, attention_delta_ref, attention_ref

SHARD_GRANULE = 128  # shards are planned to 128-token granules (ring.py:65-75)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_MERGE_ARGTYPES = [_P] * 5 + [_L, _I, _I, _I, _P]
_FINALIZE_ARGTYPES = [_P] * 3 + [_L, _I, _I, _I, _P]


# --------------------------------------------------------------------------
# the merge: kernels and plain versions
# --------------------------------------------------------------------------


def _check_state(name, m, s, num, *extra):
    _build.require_cuda(name, m, s, num, *(t for _, t, _ in extra))
    if num.dim() != 4 or num.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name} needs num [B, Sq, Hq, dh] with dh in {HEAD_DIMS}")
    b, sq, hq, dh = num.shape
    for nm, t, shape in (("m", m, (b, hq, sq)), ("s", s, (b, hq, sq)), ("num", num, num.shape),
                         *extra):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} needs {nm} contiguous {list(shape)} f32")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs {nm} 16-byte aligned")
    return b, sq, hq, dh


def ring_merge(m, s, num, o, lse) -> None:
    """Merge one hop's block result into the running state, in place on the
    card: m, s [B, Hq, Sq] and num [B, Sq, Hq, dh] (the state), o [B, Sq,
    Hq, dh] and lse [B, Hq, Sq] (K7's f32 output and lse), all contiguous
    f32.  The arithmetic of :func:`merge_ref`."""
    b, sq, hq, dh = _check_state("ring_merge", m, s, num, ("o", o, num.shape),
                                 ("lse", lse, m.shape))
    if b * sq * hq == 0:
        return
    fn = _build.bind("ring_merge", "ring_merge", _MERGE_ARGTYPES)
    with torch.cuda.device(m.device):
        code = fn(m.data_ptr(), s.data_ptr(), num.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  b * hq * sq, hq, sq, dh, torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(code, "ring_merge")
    ring_merge.launches += 1


ring_merge.launches = 0


def ring_finalize(m, s, num):
    """The output and its lse from the merged state, in place on the card:
    ``num <- num / max(s, LSE_FLOOR)``, ``m <- m + log(max(s, LSE_FLOOR))``.
    Returns ``(out, lse)``, which are ``num`` and ``m``."""
    b, sq, hq, dh = _check_state("ring_finalize", m, s, num)
    if b * sq * hq:
        fn = _build.bind("ring_merge", "ring_finalize", _FINALIZE_ARGTYPES)
        with torch.cuda.device(m.device):
            code = fn(m.data_ptr(), s.data_ptr(), num.data_ptr(), b * hq * sq, hq, sq, dh,
                      torch.cuda.current_stream(m.device).cuda_stream)
        _build.check(code, "ring_finalize")
        ring_finalize.launches += 1
    return num, m


ring_finalize.launches = 0


def merge_ref(m, s, num, o, lse):
    """Plain ``_merge``: the new ``(m, s, num)`` after one hop's ``(o,
    lse)``, in the port's layouts (statistics [B, Hq, Sq], rows [B, Sq, Hq,
    dh])."""
    m_new = torch.maximum(m, lse)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(lse - m_new)
    s = s * alpha + beta
    num = num * alpha.transpose(1, 2)[..., None] + beta.transpose(1, 2)[..., None] * o
    return m_new, s, num


def finalize_ref(m, s, num):
    """Plain normalisation of the merged state: ``(out, lse)``."""
    denom = torch.clamp(s, min=LSE_FLOOR)
    return num / denom.transpose(1, 2)[..., None], m + torch.log(denom)


# --------------------------------------------------------------------------
# the groups
# --------------------------------------------------------------------------


def live_table(ranges: np.ndarray, causal: bool) -> np.ndarray:
    """The k x k live table ``[t, r]``: whether ring rank r attends a block
    at hop t.  ``ranges`` [k, B, 4] holds each shard's per-row (q min, q
    max, kv min, kv max) segment ids.  The diagonal hop always runs; a later
    hop runs when some batch row's ranges meet (``_block_overlap``) and,
    under ``causal``, when its block comes from a lower rank (t <= r)."""
    k = ranges.shape[0]
    t = np.arange(k)[:, None]
    r = np.arange(k)[None, :]
    src = (r - t) % k
    q_lo, q_hi = ranges[r, :, 0], ranges[r, :, 1]  # [k, k, B]
    k_lo, k_hi = ranges[src, :, 2], ranges[src, :, 3]
    live = ((q_lo <= k_hi) & (k_lo <= q_hi)).any(axis=-1)
    if causal:
        live &= t <= r
    live[0] = True
    return live


def _row_ranges(q_seg, kv_seg):
    """[..., B, 4] per-row (q min, q max, kv min, kv max) over the last axis."""
    return torch.stack([q_seg.amin(-1), q_seg.amax(-1), kv_seg.amin(-1), kv_seg.amax(-1)], -1)


class _Ring:
    """What both groups share: the live table, worked out once for each
    pair of segment-id tensors (a microbatch's ids reach every layer as the
    same tensor objects) and kept until other ids arrive."""

    k: int
    local_ranks: tuple[int, ...]

    def __init__(self):
        self._memo = None

    def table(self, q_seg, kv_seg, causal: bool) -> np.ndarray:
        memo = self._memo
        if memo is None or memo[0] is not q_seg or memo[1] is not kv_seg or memo[2] != causal:
            memo = (q_seg, kv_seg, causal, live_table(self.ranges(q_seg, kv_seg), causal))
            self._memo = memo
        return memo[3]


class LocalRing(_Ring):
    """All k ring ranks in one process: every tensor of the ring is the k
    shards stacked rank-major along the batch axis, and a hop rotates a
    list of views."""

    def __init__(self, k: int):
        super().__init__()
        if k < 1:
            raise ValueError(f"a ring needs k >= 1 ranks, got {k}")
        self.k = k
        self.local_ranks = tuple(range(k))

    def _check(self, x) -> None:
        if x.shape[0] % self.k:
            raise ValueError(f"LocalRing({self.k}) needs the shards stacked along the batch "
                             f"axis: batch {x.shape[0]} is not a multiple of {self.k}")

    def split(self, x) -> list:
        self._check(x)
        return list(x.chunk(self.k, dim=0))

    def join(self, xs: Sequence) -> torch.Tensor:
        return torch.cat(list(xs), dim=0)

    def ranges(self, q_seg, kv_seg) -> np.ndarray:
        k = self.k
        self._check(q_seg)
        self._check(kv_seg)
        rng = _row_ranges(q_seg.reshape(k, -1, q_seg.shape[-1]),
                          kv_seg.reshape(k, -1, kv_seg.shape[-1]))
        return rng.cpu().numpy()

    def buffers(self, blocks: list) -> tuple[list, None]:
        return blocks, None

    def rotate(self, cur: list, spare):
        return cur[-1:] + cur[:-1], spare

    def mean(self, loss, grads: dict):
        """The group's mean of per-rank losses and gradients: this process
        holds every shard, so its loss is already the mean of the k shard
        means."""
        return loss, grads


class ProcessRing(_Ring):
    """One ring rank per process over ``torch.distributed`` (its ``group``,
    the default group when None).  ``k`` is the ring size this rank's
    shards were cut for; every rank's is gathered, and a group whose ranks
    disagree on it, or whose size differs, raises."""

    def __init__(self, k: int | None = None, group=None):
        super().__init__()
        self.group = group
        self.k = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local_ranks = (self.rank,)
        claim = torch.tensor([self.k if k is None else k], dtype=torch.int64,
                             device=self._device())
        claims = [torch.empty_like(claim) for _ in range(self.k)]
        dist.all_gather(claims, claim, group=group)
        seen = sorted({int(c) for c in claims})
        if seen != [self.k]:
            raise ValueError(f"ring ranks disagree on k: {seen} in a group of {self.k}")
        peers = [(self.rank + 1) % self.k, (self.rank - 1) % self.k]
        self._next, self._prev = (p if group is None else dist.get_global_rank(group, p)
                                  for p in peers)

    def _device(self):
        return torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(self.group) == "nccl" else torch.device("cpu")

    def split(self, x) -> list:
        return [x]

    def join(self, xs: Sequence) -> torch.Tensor:
        return xs[0]

    def ranges(self, q_seg, kv_seg) -> np.ndarray:
        shape = torch.tensor([*q_seg.shape, kv_seg.shape[-1]], dtype=torch.int64,
                             device=q_seg.device)
        shapes = [torch.empty_like(shape) for _ in range(self.k)]
        dist.all_gather(shapes, shape, group=self.group)
        if any(not torch.equal(s_, shape) for s_ in shapes):
            raise ValueError(f"ring ranks hold shards of different shapes: "
                             f"{[s_.tolist() for s_ in shapes]}")
        local = _row_ranges(q_seg, kv_seg)
        parts = [torch.empty_like(local) for _ in range(self.k)]
        dist.all_gather(parts, local, group=self.group)
        return torch.stack(parts).cpu().numpy()

    def buffers(self, blocks: list) -> tuple[list, list]:
        """Contiguous copies of this rank's blocks (the inputs are never
        overwritten) and as many receive buffers, both made before the
        loop."""
        cur = [tuple(t.clone(memory_format=torch.contiguous_format) for t in blocks[0])]
        return cur, [tuple(torch.empty_like(t) for t in cur[0])]

    def rotate(self, cur: list, spare: list):
        """One hop: send what this rank holds to the next rank and receive
        the previous rank's into the spare buffers; returns (new, spare)."""
        if self.k == 1:
            return cur, spare
        ops = []
        for tag, (a, b) in enumerate(zip(cur[0], spare[0])):
            ops.append(dist.P2POp(dist.isend, a, self._next, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, b, self._prev, self.group, tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return spare, cur

    def mean(self, loss, grads: dict):
        """The group's mean: every rank's loss and gradients summed by one
        ``all_reduce`` each and divided by k (the reference's ``psum / k``)."""
        loss = loss.clone()
        dist.all_reduce(loss, group=self.group)
        for g in grads.values():
            dist.all_reduce(g, group=self.group)
            g.div_(self.k)
        return loss / self.k, grads


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------


def _ring_fwd(q, k, v, q_seg, kv_seg, group, table, causal: bool, scale: float, card: bool):
    """The forward ring: ``(out32 [B, Sq, Hq, dh] f32, lse [B, Hq, Sq] f32)``
    over the group's local shards, stacked as the inputs are; the kernels
    with ``card``, else the plain versions."""
    b, sq, hq, dh = q.shape
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    num = torch.zeros((b, sq, hq, dh), dtype=torch.float32, device=q.device)
    states = list(zip(group.split(m), group.split(s), group.split(num)))
    qs, q_segs = group.split(q), group.split(q_seg)
    cur, spare = group.buffers(list(zip(group.split(k), group.split(v), group.split(kv_seg))))
    for t in range(group.k):
        for i, r in enumerate(group.local_ranks):
            if not table[t, r]:
                continue
            kc, vc, segc = cur[i]
            args = (qs[i], kc, vc, q_segs[i], segc)
            kw = dict(causal=causal and t == 0, scale=scale, out_dtype=torch.float32)
            if card:
                ring_merge(*states[i], *flash_fwd(*args, **kw))
            else:
                for dst, src in zip(states[i], merge_ref(*states[i], *attention_ref(*args, **kw))):
                    dst.copy_(src)
        if t < group.k - 1:
            cur, spare = group.rotate(cur, spare)
    if card:
        return ring_finalize(m, s, num)
    out, lse = finalize_ref(m, s, num)
    return out, lse


def _ring_bwd(g, q, k, v, q_seg, kv_seg, out32, lse, group, table, causal: bool, scale: float,
              card: bool):
    """The backward ring: ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    qf, gf = q.float(), g.float().contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    delta = None if card else attention_delta_ref(gf, out32)  # K8 forms it on the card
    split = group.split
    rows = list(zip(split(qf), split(gf), split(out32), split(lse), split(q_seg), split(dq),
                    split(delta) if delta is not None else [None] * len(group.local_ranks)))
    kf, vf = k.float(), v.float()
    blocks = list(zip(split(kf), split(vf), split(kv_seg), split(torch.zeros_like(kf)),
                      split(torch.zeros_like(vf))))
    cur, spare = group.buffers(blocks)
    for t in range(group.k):
        for i, r in enumerate(group.local_ranks):
            if not table[t, r]:
                continue
            qr, gr, outr, lser, qsr, dqr, der = rows[i]
            kc, vc, segc, dkc, dvc = cur[i]
            kw = dict(causal=causal and t == 0, scale=scale)
            if card:
                dq_t, de = flash_bwd_dq(qr, kc, vc, outr, gr, lser, qsr, segc, **kw)
                dk_t, dv_t = flash_bwd_dkv(qr, kc, vc, gr, lser, de, qsr, segc, **kw)
            else:
                dq_t, dk_t, dv_t = attention_bwd_ref(qr, kc, vc, gr, lser, der, qsr, segc, **kw)
            dqr += dq_t
            dkc += dk_t
            dvc += dv_t
        # every hop, k in all: the travelling dk/dv come home
        cur, spare = group.rotate(cur, spare)
    dk = group.join([c[3] for c in cur])
    dv = group.join([c[4] for c in cur])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """Differentiable K11: the forward keeps ``(q, k, v, ids, out32, lse)``
    (the reference's ``_ring_fwd`` residuals) and returns ``out32`` in q's
    dtype; the backward runs the backward ring.  Under ``remat`` the
    recompute runs the forward ring again, in the same block order on every
    rank, so a ``ProcessRing``'s rotations meet."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, group, causal, scale, card):
        table = group.table(q_seg, kv_seg, causal)
        out32, lse = _ring_fwd(q, k, v, q_seg, kv_seg, group, table, causal, scale, card)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out32, lse)
        ctx.group, ctx.table, ctx.causal, ctx.scale, ctx.card = group, table, causal, scale, card
        ring_attention.launches += card
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_seg, kv_seg, out32, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(g, q, k, v, q_seg, kv_seg, out32, lse, ctx.group, ctx.table,
                               ctx.causal, ctx.scale, ctx.card)
        ring_attention.launches += ctx.card
        return dq, dk, dv, None, None, None, None, None, None


def ring_attention(q, k, v, q_segment_ids=None, kv_segment_ids=None, *, group,
                   causal: bool = True, scale: float | None = None, plain: bool = False):
    """Sequence-parallel segment-aware attention over ``group``'s ring.

    q: [B, S/k, Hq, dh]; k, v: [B, S/k, Hkv, dh] (for a ``LocalRing`` the k
    shards stacked rank-major along the batch axis); segment ids [B, S/k]
    int32 (``-1`` pads), both or neither (one document).  The shard width
    must be a multiple of 128.  Returns out in q's dtype; differentiable
    where autograd records the call.  CUDA tensors run the kernels, CPU
    tensors (or ``plain``, the on-card comparison) the plain versions.
    ``launches`` counts the ring passes that ran the kernels (each forward,
    recompute and backward pass).
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for tensors on {q.device}")
    card = q.device.type == "cuda" and not plain
    sq, skv = q.shape[1], k.shape[1]
    for n in (sq, skv):
        if n % SHARD_GRANULE:
            raise ValueError(
                f"ring attention needs the local sequence ({n}) to be a multiple "
                f"of {SHARD_GRANULE}; the split planner only emits {SHARD_GRANULE}-aligned shards"
            )
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    if q_segment_ids is None:
        q_segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
        kv_segment_ids = torch.zeros(k.shape[:2], dtype=torch.int32, device=q.device)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RingAttention.apply(q, k, v, q_segment_ids, kv_segment_ids, group, causal, scale,
                                   card)
    table = group.table(q_segment_ids, kv_segment_ids, causal)
    out32, _ = _ring_fwd(q, k, v, q_segment_ids, kv_segment_ids, group, table, causal, scale,
                         card)
    ring_attention.launches += card
    return out32.to(q.dtype)


ring_attention.launches = 0

