"""Continuous-batching engines: plans from the scheduler, waves on the
device.

:class:`ServeEngine` is the LM path, the counterpart of
``repro.serve.engine.ServeEngine``.  Each iteration it (1) asks the
scheduler for a plan against the live free-token/free-slot state, (2)
prefills admitted prompts into pool pages (B=1, width padded to a
power-of-two page multiple), and (3) runs ONE decode wave over the full
slot array — per-slot ``kv_lens`` carry each request's depth, inactive
slots aim at the scratch page and contribute exact zeros.  Sampling is
greedy (argmax, on the device; the first maximum on ties, as numpy's).
The page table, depths and last tokens are host arrays, as in the JAX
engine, sent to the device with each wave; the pools live on the model's
device and are updated in place.

:class:`DiffusionServeEngine` is the counterpart of
``repro.serve.engine.DiffusionServeEngine``: a request is a chain of
``n_steps`` velocity evaluations, every iteration re-runs full
self-attention over the clip (``step_load = S_vis^p``), and mixed clip
lengths share one padded wave scoped by segment ids.  Each iteration asks
the scheduler for a plan against the free-token/free-slot state, admits
the planned requests into slots, runs ONE denoise step over the whole slot
array and advances a simulated clock by ``scheduler.price(plan)``, so the
admissions, waves and clock match the JAX engine's for the same stream.

The slot arrays (latents, text states, segment ids, times) live on the
model's device: a request's data crosses to the device once, at admission,
and its result comes back once, when it finishes.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.mmdit import TEXT_DIM, MMDiT
from repro_torch.serve.page_pool import PagePool
from repro_torch.serve.request import DONE, RUNNING, DenoiseRequest, Request
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, ServeConfig
from repro_torch.train.steps import (
    make_denoise_step,
    make_paged_decode_step,
    make_paged_prefill_step,
)


class ServeEngine:
    """Continuous batching for the transformer LM over a paged KV cache.
    The engine runs where ``model`` lives."""

    def __init__(
        self,
        model: T.Transformer,
        cfg: ModelConfig,
        cost: CostModel,
        serve: ServeConfig,
    ):
        self.model = model
        self.cfg = cfg
        self.serve = serve
        self.device = model.device
        self.scheduler = ContinuousBatchingScheduler(cost, serve)
        self.pool = PagePool(serve.num_pages, serve.page_size)
        self.pools = T.init_paged_pools(cfg, serve.num_pages, serve.page_size,
                                        device=self.device)
        self.scratch = serve.num_pages  # the always-masked sink page
        slots = serve.decode_slots
        self.page_table = np.full((slots, serve.pages_max), self.scratch, np.int32)
        self.kv_lens = np.zeros((slots,), np.int32)
        self.last_tok = np.zeros((slots,), np.int32)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.waiting: collections.deque[Request] = collections.deque()
        self.done: list[Request] = []
        self.clock = 0.0
        self.iterations: list[dict] = []  # per-step records for invariants
        self._next_rid = 0
        self._prefill = make_paged_prefill_step(cfg)
        self._decode = make_paged_decode_step(cfg)

    # -- admission-facing state -------------------------------------------

    @property
    def free_tokens(self) -> int:
        resident = sum(
            r.reserve_tokens for r in self.slot_req if r is not None
        )
        return min(self.pool.free_tokens, self.serve.mem_tokens - resident)

    @property
    def free_slots(self) -> int:
        return sum(1 for r in self.slot_req if r is None)

    def submit(
        self, prompt: np.ndarray, max_new: int, arrival: float = 0.0
    ) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1 or max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        reserve = prompt.shape[0] + max_new
        if reserve > self.serve.max_seq:
            raise ValueError(
                f"prompt+max_new = {reserve} exceeds max_seq "
                f"{self.serve.max_seq}"
            )
        if self.serve.page_tokens(reserve) > self.serve.mem_tokens:
            raise ValueError(
                f"request needs {self.serve.page_tokens(reserve)} tokens "
                f"({reserve} rounded to whole pages), budget is "
                f"{self.serve.mem_tokens}"
            )
        r = Request(self._next_rid, prompt, max_new, arrival=float(arrival))
        self._next_rid += 1
        self.waiting.append(r)
        return r

    # -- execution ---------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _pad_width(self, n: int) -> int:
        """Power-of-two prompt bucket (page multiple), capped at max_seq."""
        w = self.serve.page_size
        while w < n:
            w *= 2
        return min(w, self.serve.max_seq)

    def _start(self, r: Request) -> None:
        self.waiting.remove(r)
        slot = self.slot_req.index(None)
        n_pages = self.pool.pages_for(r.reserve_tokens)
        r.pages = self.pool.alloc(n_pages, r.rid)
        r.slot = slot
        r.state = RUNNING
        row = np.full((self.serve.pages_max,), self.scratch, np.int32)
        row[: len(r.pages)] = r.pages
        s_pad = self._pad_width(r.prompt_len)
        tokens = np.zeros((1, s_pad), np.int32)
        tokens[0, : r.prompt_len] = r.prompt
        logits, self.pools = self._prefill(
            self.model,
            self._dev(tokens),
            self._dev(np.array([r.prompt_len], np.int32)),
            self._dev(row[None, : s_pad // self.serve.page_size].copy()),
            self.pools,
        )
        tok = int(logits[0].argmax())
        r.ctx = r.prompt_len
        r.out = [tok]
        self.page_table[slot] = row
        self.kv_lens[slot] = r.prompt_len
        self.last_tok[slot] = tok
        self.slot_req[slot] = r

    def _finish(self, r: Request) -> None:
        slot = r.slot
        self.pool.free(r.pages, r.rid)
        r.pages = []
        r.state = DONE
        r.t_done = self.clock
        self.page_table[slot] = self.scratch
        self.kv_lens[slot] = 0
        self.slot_req[slot] = None
        self.done.append(r)

    def step(self) -> bool:
        """One engine iteration.  Returns False when fully drained."""
        running = [r for r in self.slot_req if r is not None]
        arrived = [r for r in self.waiting if r.arrival <= self.clock]
        if not running and not arrived:
            if not self.waiting:
                return False
            # idle: jump the clock to the next arrival
            self.clock = max(
                self.clock, min(r.arrival for r in self.waiting)
            )
            arrived = [r for r in self.waiting if r.arrival <= self.clock]
        plan = self.scheduler.plan(
            arrived,
            running,
            free_tokens=self.free_tokens,
            free_slots=self.free_slots,
        )
        for r in plan.prefills:
            self._start(r)
        if running:
            # ONE wave over the full slot array; only the slots that were
            # running before admission advance (fresh prefills join the
            # wave next iteration, matching the plan's pricing)
            logits, self.pools = self._decode(
                self.model,
                self.pools,
                self._dev(self.page_table),
                self._dev(self.kv_lens),
                self._dev(self.last_tok[:, None].copy()),
            )
            toks = logits.argmax(dim=-1).cpu().numpy()
            for r in running:
                tok = int(toks[r.slot])
                r.ctx += 1
                self.kv_lens[r.slot] += 1
                r.out.append(tok)
                self.last_tok[r.slot] = tok
        self.clock += self.scheduler.price(plan)
        self.iterations.append(
            {
                "clock": self.clock,
                "prefills": [r.rid for r in plan.prefills],
                "decodes": [r.rid for r in running],
                "decode_load": plan.decode_load,
                "prefill_load": plan.prefill_load,
                "price": self.scheduler.price(plan),
                "oversize": plan.oversize,
            }
        )
        for r in plan.prefills:
            r.t_first = self.clock
        for r in [*plan.prefills, *running]:
            if r.state is not DONE and len(r.out) >= r.max_new:
                self._finish(r)
        return True

    def run(self) -> list[Request]:
        """Drain the queue; returns completed requests in finish order."""
        while self.step():
            pass
        self.pool.assert_empty()
        return self.done


class DiffusionServeEngine:
    """Batched MMDiT denoise sampling under the dual-constraint admission.

    Euler rectified-flow sampling: ``t`` walks 1 -> 0 in ``n_steps`` equal
    steps and each wave updates ``x <- x - v * dt`` per request.  Clips of
    different lengths share one padded wave; segment ids (-1 = pad) scope
    self- and cross-attention per slot, so padding never contaminates a
    neighbour.  The engine runs where ``mmdit`` lives.
    """

    TEXT_DIM = TEXT_DIM  # text-encoder stub width (matches mmdit.txt_in)

    def __init__(
        self,
        mmdit: MMDiT,
        cfg: ModelConfig,
        model: CostModel,
        serve: ServeConfig,
    ):
        if cfg.family != "mmdit":
            raise ValueError(
                f"DiffusionServeEngine needs an mmdit config, got "
                f"{cfg.family!r}"
            )
        self.mmdit = mmdit
        self.cfg = cfg
        self.serve = serve
        self.scheduler = ContinuousBatchingScheduler(model, serve)
        self.device = mmdit.device
        slots = serve.decode_slots
        self.max_vis = serve.max_seq
        c = cfg.in_channels * 4
        dev = self.device
        self.latents = torch.zeros((slots, self.max_vis, c), dtype=torch.float32, device=dev)
        self.text = torch.zeros((slots, cfg.text_len, TEXT_DIM), dtype=torch.float32, device=dev)
        self.seg = torch.full((slots, self.max_vis), -1, dtype=torch.int32, device=dev)
        self.tseg = torch.full((slots, cfg.text_len), -1, dtype=torch.int32, device=dev)
        self.t = torch.ones((slots,), dtype=torch.float32, device=dev)
        self.slot_req: list[Optional[DenoiseRequest]] = [None] * slots
        self.waiting: collections.deque[DenoiseRequest] = collections.deque()
        self.done: list[DenoiseRequest] = []
        self.clock = 0.0
        self.iterations: list[dict] = []
        self._next_rid = 0
        self._denoise = make_denoise_step(cfg)

    @property
    def free_tokens(self) -> int:
        resident = sum(
            r.reserve_tokens for r in self.slot_req if r is not None
        )
        return self.serve.mem_tokens - resident

    @property
    def free_slots(self) -> int:
        return sum(1 for r in self.slot_req if r is None)

    def submit(
        self,
        latents: np.ndarray,
        text: np.ndarray,
        n_steps: int,
        arrival: float = 0.0,
    ) -> DenoiseRequest:
        latents = np.asarray(latents, np.float32)
        text = np.asarray(text, np.float32)
        if latents.ndim != 2 or latents.shape[0] < 1:
            raise ValueError("latents must be [S_vis, in_channels*4]")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if latents.shape[0] > self.max_vis:
            raise ValueError(
                f"clip of {latents.shape[0]} tokens exceeds max_seq "
                f"{self.max_vis}"
            )
        if self.serve.page_tokens(latents.shape[0]) > self.serve.mem_tokens:
            raise ValueError("clip exceeds the token budget")
        if text.shape[0] > self.cfg.text_len:
            raise ValueError(
                f"text of {text.shape[0]} tokens exceeds text_len "
                f"{self.cfg.text_len}"
            )
        r = DenoiseRequest(
            self._next_rid, latents, text, n_steps, arrival=float(arrival)
        )
        self._next_rid += 1
        self.waiting.append(r)
        return r

    def _start(self, r: DenoiseRequest) -> None:
        self.waiting.remove(r)
        slot = self.slot_req.index(None)
        r.slot = slot
        r.state = RUNNING
        n_txt = r.text.shape[0]
        self.latents[slot] = 0.0
        self.latents[slot, : r.tokens] = torch.from_numpy(r.latents).to(self.device)
        self.text[slot] = 0.0
        self.text[slot, :n_txt] = torch.from_numpy(r.text).to(self.device)
        self.seg[slot] = -1
        self.seg[slot, : r.tokens] = 0
        self.tseg[slot] = -1
        self.tseg[slot, :n_txt] = 0
        self.t[slot] = 1.0
        self.slot_req[slot] = r

    def _finish(self, r: DenoiseRequest) -> None:
        slot = r.slot
        # a copy even on the CPU, where .cpu() would alias the slot buffer
        r.result = self.latents[slot, : r.tokens].to("cpu", copy=True).numpy()
        r.state = DONE
        r.t_done = self.clock
        self.seg[slot] = -1
        self.tseg[slot] = -1
        self.t[slot] = 1.0
        self.slot_req[slot] = None
        self.done.append(r)

    def step(self) -> bool:
        """One engine iteration.  Returns False when fully drained."""
        running = [r for r in self.slot_req if r is not None]
        arrived = [r for r in self.waiting if r.arrival <= self.clock]
        if not running and not arrived:
            if not self.waiting:
                return False
            self.clock = max(
                self.clock, min(r.arrival for r in self.waiting)
            )
            arrived = [r for r in self.waiting if r.arrival <= self.clock]
        plan = self.scheduler.plan(
            arrived,
            running,
            free_tokens=self.free_tokens,
            free_slots=self.free_slots,
        )
        for r in plan.prefills:
            self._start(r)
        wave = [*running, *plan.prefills]
        if wave:
            v = self._denoise(
                self.mmdit, self.latents, self.text, self.t, self.seg, self.tseg
            )
            for r in wave:
                dt = 1.0 / r.n_steps
                self.latents[r.slot, : r.tokens] -= v[r.slot, : r.tokens] * dt
                r.step += 1
                self.t[r.slot] = 1.0 - r.step / r.n_steps
        self.clock += self.scheduler.price(plan)
        self.iterations.append(
            {
                "clock": self.clock,
                "admitted": [r.rid for r in plan.prefills],
                "wave": [r.rid for r in wave],
                "price": self.scheduler.price(plan),
                "oversize": plan.oversize,
            }
        )
        for r in plan.prefills:
            r.t_first = self.clock
        for r in wave:
            if r.state is not DONE and r.step >= r.n_steps:
                self._finish(r)
        return True

    def run(self) -> list[DenoiseRequest]:
        """Drain the queue; returns completed requests in finish order."""
        while self.step():
            pass
        return self.done
