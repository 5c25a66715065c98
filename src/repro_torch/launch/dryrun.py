"""Dry run: trace every (arch x shape) step on the ``meta`` device on the
production meshes and record its memory, operations and collectives per
device, the counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single              # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell

A production mesh is a ``DeviceMesh`` over a fake process group of 256 or
512 ranks that must be the process's only group, so ``--all`` runs each
mesh in subprocesses of its own (``JOBS`` a mesh, the cells split by
their cost, all at once).  ``--mesh host`` dry-runs
one device (``launch.mesh.make_host_mesh``: the card unless ``--device
cpu``); ``--batch`` cuts the shape's global batch.  Results accumulate in
``build/repro_torch_dryrun.json`` (resumable; keys
``arch|shape|mesh[|probeK][|variant]``).  A cell that fails is recorded as
an ``error`` and makes the run exit non-zero.

How a record's fields are made (the reference compiles with XLA; the
port traces):

* the step is built as the reference builds it (``make_train_step``,
  ``make_prefill_step``, ``make_decode_step``) and run once on ``meta``
  for one device's share of the batch: the global batch over the batch
  shards (``"activations": "batch-sharded only"``: the model axis splits
  no activation here), its MoE layers in that device's dispatch groups
  (:class:`DeviceProgram`);
* ``argument_bytes`` is exact: the local shard bytes of every argument
  under the policy's placements, read from DTensors
  (``distributed.sharding.distribute_state`` and the specs' placements);
* ``flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the aten products plus the hand kernels' own counts
  (``kernels.meta``), scaled from the share to the global batch and
  divided by the chips (``"flops_scope": "global / n_chips"``);
* ``bytes_accessed`` is the share's sum of every dispatched op's input
  and output bytes (views and allocations excluded), an unfused upper
  bound;
* ``temp_bytes`` is the peak of the live bytes the step allocates above
  its arguments, a parameter's gradient kept at its shard's size once it
  is complete; ``peak_bytes`` is ``argument_bytes + temp_bytes``;
  ``output_bytes`` the step's outputs (those that are arguments updated in
  place at their shard's size, also in ``alias_bytes``);
* ``collectives`` are the ``CommDebugMode`` records of one step's
  parameter collectives under the placements (``"collectives_scope":
  "params"``): each leaf sharded on a mesh dim of more than one device is
  all-gathered for the forward and, in training, again for the recompute;
  its gradient is reduce-scattered, and all-reduced over each batch axis
  the leaf is replicated on (``launch.comm_stats``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.registry import (
    SHAPES,
    arch_ids,
    cell_supported,
    get_config,
    get_optimizer,
)
from repro_torch.distributed.sharding import (
    ShardingPolicy,
    distribute_state,
    make_policy,
    place,
)
from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch.comm_stats import collective_stats, comm_recorder
from repro_torch.launch.specs import batch_specs, decode_specs, prefill_specs, train_specs
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "build" / "repro_torch_dryrun.json"
MESHES = ("single", "multipod")
JOBS = 2  # subprocesses a production mesh with --all


def probe_config(cfg, k: int):
    """Shallow probe variant: len(lead) + k * len(pattern) layers (the
    reference's two-point per-layer extrapolation; the port's trace runs
    every layer, so a probe is simply a shallower model)."""
    lead, pat, n_rep, tail = cfg.superblocks()
    n_layers = len(lead) + k * max(len(pat), 1)
    return dataclasses.replace(cfg, n_layers=n_layers)


@dataclasses.dataclass(frozen=True)
class DeviceProgram:
    """One device's program under ``policy``: the steps' ``policy`` while
    the dry run traces a device's share of the batch.  The device holds
    ``n_dispatch_groups / batch_shards`` of the MoE's dispatch groups; the
    activation constraints belong to the global program and place nothing
    in one device's (their collectives are not counted)."""

    policy: ShardingPolicy
    batch_shards: int

    @property
    def n_dispatch_groups(self) -> int:
        return self.policy.n_dispatch_groups // self.batch_shards

    def constrain(self, x, kind: str):
        return x


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(obj) -> list[torch.Tensor]:
    """The tensors of a step's arguments or outputs (a module's parameters)."""
    if isinstance(obj, torch.nn.Module):
        return [p for _, p in obj.named_parameters()]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return [obj] if isinstance(obj, torch.Tensor) else []


class LiveBytes(TorchDispatchMode):
    """Counts what the ops dispatched under it allocate: a storage an op
    returns that none of its inputs holds is new, counted until it is freed
    (``live``, ``peak``); and ``moved``, the input and output bytes of
    every op that reads a tensor and is not a view."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.moved = 0
        self._held: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def resize(self, t: torch.Tensor, factor: float) -> None:
        """Count ``t``'s storage at ``factor`` of its bytes from now on."""
        k = _key(t)
        if k in self._held:
            new = int(self._held[k] * factor)
            self.live -= self._held[k] - new
            self._held[k] = new

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        seen = {_key(t) for t in ins}
        for t in outs:
            k = _key(t)
            if k in seen or k in self._held:
                continue
            st = t.untyped_storage()
            self._held[k] = st.nbytes()
            weakref.finalize(st, self._free, k)
            self.live += self._held[k]
            self.peak = max(self.peak, self.live)
        if ins and not func.is_view:
            self.moved += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


def _pairs(args, pls):
    """(tensor, placements) of every tensor argument, the model's
    parameters by name."""
    if isinstance(args, torch.nn.Module):
        return [(p, pls[n]) for n, p in args.named_parameters()]
    if isinstance(args, dict):
        return [x for k in args for x in _pairs(args[k], pls[k])]
    if isinstance(args, (list, tuple)):
        return [x for a, pl in zip(args, pls) for x in _pairs(a, pl)]
    return [(args, pls)] if isinstance(args, torch.Tensor) else []


def param_collectives(params: dict, mesh, batch_axes, *, train: bool) -> dict:
    """``collective_stats`` of one step's parameter collectives: each
    leaf's all-gather on every mesh dim of more than one device that shards
    it (forward, and in training the recompute), then its gradient's
    reduce-scatter there and all-reduce over the batch axes that replicate
    it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    rec = comm_recorder()
    with rec:
        for d in params.values():
            pls = d.placements
            sharded = [i for i, p in enumerate(pls) if p.is_shard() and sizes[names[i]] > 1]
            if sharded:
                for _ in range(2 if train else 1):
                    d.redistribute(mesh, [Replicate()] * len(pls))
            if not train:
                continue
            partial = [i in sharded or (names[i] in batch_axes and sizes[names[i]] > 1)
                       for i in range(len(pls))]
            if any(partial):
                grad = DTensor.from_local(
                    torch.empty(d.shape, dtype=d.dtype, device="meta"), mesh,
                    [Partial() if partial[i] else Replicate() for i in range(len(pls))],
                    run_check=False, shape=d.shape, stride=d.stride())
                grad.redistribute(mesh, pls)
    return collective_stats(rec.records)


def _mesh(kind: str, device=None):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    if kind == "host":
        return make_host_mesh(device)
    return make_production_mesh(multi_pod=kind == "multipod")


@dataclasses.dataclass
class Cell:
    """A cell ready to trace: the step built with ``DeviceProgram`` as its
    policy and the arguments of one device's share (``trace_args``); the
    parameters as DTensors (``params``), the local bytes under its
    placements of the argument each tensor of ``trace_args`` stands for, by
    storage (``arg_local``), and the arguments' sum (``argument_bytes``)."""

    train: bool
    step: object
    trace_args: tuple
    params: dict
    param_pairs: list
    arg_local: dict
    argument_bytes: int
    batch_shards: int


def prepare_cell(cfg, shape, policy: ShardingPolicy, opt=None) -> Cell:
    """The specs of ``shape``'s step under ``policy``, placed on its mesh
    (a ``DeviceMesh``)."""
    mesh = policy.mesh
    # one device's share of the batch: the batch over the batch shards,
    # when they divide it (data_sharding), else the whole batch
    groups = policy.n_dispatch_groups
    batch_shards = groups if shape.global_batch % groups == 0 else 1
    share_shape = dataclasses.replace(shape, global_batch=shape.global_batch // batch_shards)
    prog = DeviceProgram(policy, batch_shards)
    train = shape.kind == "train"
    if train:
        args, pls, opt = train_specs(cfg, shape, policy, opt)
        state, batch, _ = args
        placed = distribute_state(state, policy)
        params = placed["params"]
        named = dict(state["model"].named_parameters())
        param_pairs = [(named[n], d) for n, d in params.items()]
        arg_pairs = param_pairs + [(state["opt"][k][n], d) for k in ("m", "v")
                                   for n, d in placed["opt"][k].items()]
        data, share_data = batch, batch_specs(cfg, share_shape, policy)[0]
        data_pls = pls[1]
        step = make_train_step(cfg, opt, policy=prog)
        trace_args = (state, share_data, None)
    else:
        maker = prefill_specs if shape.kind == "prefill" else decode_specs
        args, pls = maker(cfg, shape, policy)
        model = args[0]
        params = {n: place(p, pls[0][n], mesh) for n, p in model.named_parameters()}
        param_pairs = arg_pairs = [(p, params[n]) for n, p in model.named_parameters()]
        data, share_data = list(args[1:]), list(maker(cfg, share_shape, policy)[0][1:])
        data_pls = list(pls[1:])
        if shape.kind == "prefill":
            step = make_prefill_step(cfg, cache_cap=shape.seq_len, policy=prog)
        else:
            step = make_decode_step(cfg, policy=prog)
        trace_args = (model, *share_data)
    # keyed by the storages the trace takes (the global batch is dropped
    # after this, and its storages' keys would be reused)
    arg_local = {_key(t): _nbytes(d.to_local()) for t, d in arg_pairs}
    argument_bytes = sum(arg_local.values())
    for (t, pl), (s, _) in zip(_pairs(data, data_pls), _pairs(share_data, data_pls)):
        arg_local[_key(s)] = _nbytes(place(t, pl, mesh).to_local())
        argument_bytes += arg_local[_key(s)]
    return Cell(train, step, trace_args, params, param_pairs, arg_local, argument_bytes,
                batch_shards)


def run_cell(arch: str, shape_name: str, mesh_kind: str, probe_k: int = 0,
             resid_mode: str = "seq", *, global_batch: int | None = None, mesh=None,
             device=None) -> dict:
    """One cell's record (``status`` ``ok`` or ``skipped``; raises on a
    failure).  ``global_batch`` cuts the shape's batch; ``mesh`` is the
    mesh of ``mesh_kind`` when the caller holds it already."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    if probe_k > 0:
        cfg = probe_config(cfg, probe_k)
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    t0 = time.time()
    mesh = mesh if mesh is not None else _mesh(mesh_kind, device)
    policy = make_policy(mesh, cfg, resid_mode=resid_mode)
    cell = prepare_cell(cfg, shape, policy, get_optimizer(arch))
    arg_local = cell.arg_local
    tracer = LiveBytes()
    hooks = []
    if cell.train:  # a complete gradient is kept at its shard's size
        for p, d in cell.param_pairs:
            f = d.to_local().numel() / max(p.numel(), 1)
            if f < 1:
                hooks.append(p.register_hook(lambda g, f=f: tracer.resize(g, f)))
    kernel_meta.reset_flops()
    t1 = time.time()
    try:
        with FlopCounterMode(display=False) as counter, tracer:
            out = cell.step(*cell.trace_args)
    finally:
        for h in hooks:
            h.remove()
    trace_s = time.time() - t1
    outs = {_key(t): t for t in _tensors(out)}
    output_bytes = sum(arg_local.get(k, _nbytes(t)) for k, t in outs.items())
    alias_bytes = sum(arg_local[k] for k in outs if k in arg_local)
    flops = (counter.get_total_flops() + kernel_meta.flops()) * cell.batch_shards
    coll = param_collectives(cell.params, mesh, tuple(policy.batch_axes), train=cell.train)
    n_chips = int(mesh.size())
    return {
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "probe_k": probe_k,
        "n_layers": cfg.n_layers,
        "n_chips": n_chips,
        "global_batch": shape.global_batch,
        "batch_shards": cell.batch_shards,
        "flops": float(flops / n_chips),
        "flops_scope": "global / n_chips",
        "bytes_accessed": float(tracer.moved + kernel_meta.bytes_moved()),
        "bytes_accessed_scope": "one device's batch share: inputs and outputs of every "
                                "dispatched op, unfused upper bound",
        "collectives": coll,
        "collectives_scope": "params",
        "memory": {
            "argument_bytes": int(cell.argument_bytes),
            "output_bytes": int(output_bytes),
            "temp_bytes": int(tracer.peak),
            "peak_bytes": int(cell.argument_bytes + tracer.peak),
            "alias_bytes": int(alias_bytes),
        },
        "activations": "batch-sharded only",
        "trace_s": round(trace_s, 2),
        "cell_s": round(time.time() - t0, 2),
        "tp_heads": policy.tp_heads,
    }


def cell_key(arch: str, shape: str, mesh: str, probe_k: int = 0, variant: str = "") -> str:
    key = f"{arch}|{shape}|{mesh}"
    if probe_k:
        key += f"|probe{probe_k}"
    if variant:
        key += f"|{variant}"
    return key


def load_results(path: Path = RESULTS) -> dict:
    return json.loads(path.read_text()) if path.exists() else {}


def save_results(res: dict, path: Path = RESULTS) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(res, indent=1))
    tmp.replace(path)


def _print(key: str, out: dict) -> None:
    stat = out["status"]
    if stat == "ok":
        mem, gib = out["memory"], 2**30
        print(f"  {key} ok: trace {out['trace_s']}s  flops/dev {out['flops']:.3e}  arg/dev "
              f"{mem['argument_bytes'] / gib:.2f}GiB  temp/dev {mem['temp_bytes'] / gib:.2f}GiB  "
              f"peak/dev {mem['peak_bytes'] / gib:.2f}GiB  coll/dev "
              f"{out['collectives']['total_bytes'] / gib:.3f}GiB", flush=True)
    elif stat == "skipped":
        print(f"  {key} skipped: {out['reason']}", flush=True)
    else:
        print(f"  {key} ERROR: {out['error']}", flush=True)


def run_cells(cells, args, results: Path, cached: dict) -> int:
    """Run ``cells`` (one mesh kind) in this process, writing ``results``
    after each; returns the number of errors."""
    res = load_results(results)
    errors, mesh = 0, None
    for arch, shape_name, mesh_kind, probe_k in cells:
        key = cell_key(arch, shape_name, mesh_kind, probe_k, args.variant)
        hit = res.get(key) or cached.get(key)
        if hit and hit.get("status") in ("ok", "skipped") and not args.force:
            print(f"[skip-cached] {key}", flush=True)
            continue
        print(f"[run] {key} ...", flush=True)
        try:
            if mesh is None and cell_supported(get_config(arch), SHAPES[shape_name])[0]:
                mesh = _mesh(mesh_kind, args.device)
            out = run_cell(arch, shape_name, mesh_kind, probe_k, resid_mode=args.resid_mode,
                           global_batch=args.batch, mesh=mesh, device=args.device)
        except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
            errors += 1
            out = {"status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        res[key] = out
        save_results(res, results)
        _print(key, out)
    return errors


def _cost(arch: str, shape_name: str) -> float:
    """A cell's trace cost, roughly its traced ops: layers, times 5 for a
    train step (forward, recompute, backward, AdamW) and 4 for an SSM's
    chunked scan over a long prompt."""
    cfg, kind = get_config(arch), SHAPES[shape_name].kind
    ssm = "ssm" in cfg.pattern
    return cfg.n_layers * {"train": 5.0, "prefill": 4.0 if ssm else 1.0}.get(kind, 0.5)


def split_cells(cells, jobs: int) -> list[list]:
    """``cells`` over ``jobs`` workers, the costliest first to the least
    loaded (longest processing time first)."""
    parts, load = [[] for _ in range(jobs)], [0.0] * jobs
    for cell in sorted(cells, key=lambda c: -_cost(c[0], c[1])):
        i = load.index(min(load))
        parts[i].append(cell)
        load[i] += _cost(cell[0], cell[1])
    return [p for p in parts if p]


def _spawn(kind: str, cells, args, part: Path) -> subprocess.Popen:
    """A subprocess running ``cells`` on the ``kind`` mesh: this module's
    ``main``, with the package's ``src`` first on its path."""
    argv = ["--mesh", kind, "--cells", ";".join(f"{a}|{s}" for a, s, _, _ in cells),
            "--results", str(part), "--cached", str(RESULTS), "--resid-mode", args.resid_mode,
            "--probe", str(args.probe)]
    argv += ["--force"] * args.force + (["--variant", args.variant] if args.variant else [])
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
            f"from repro_torch.launch.dryrun import main; sys.exit(main({argv!r}))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=arch_ids())
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default=None, choices=[*MESHES, "host"],
                    help="default: single, or both production meshes with --all")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="", help="optional tag for perf experiments")
    ap.add_argument("--probe", type=int, default=0,
                    help="probe depth multiplier k (shallow model)")
    ap.add_argument("--probe-sweep", action="store_true",
                    help="run k=2 and k=4 probes for every cell (single mesh)")
    ap.add_argument("--resid-mode", default="seq", choices=["feature", "replicated", "seq"])
    ap.add_argument("--batch", type=int, default=None, help="cut the shape's global batch")
    ap.add_argument("--device", default=None, help="the host mesh's device (default: cuda)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds the subprocesses of --all may take")
    ap.add_argument("--results", default=str(RESULTS), help=argparse.SUPPRESS)
    ap.add_argument("--cached", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cells", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.all and args.mesh is None:
        work = {(k, j): cells for k in MESHES for j, cells in enumerate(split_cells(
            [(a, s, k, args.probe) for a in arch_ids() for s in SHAPES], JOBS))}
        parts = {w: RESULTS.with_name(f"repro_torch_dryrun.{w[0]}{w[1]}.json") for w in work}
        for p in parts.values():
            p.unlink(missing_ok=True)
        procs = {w: _spawn(w[0], cells, args, parts[w]) for w, cells in work.items()}
        failed = 0
        t0 = time.time()
        for w, proc in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, args.timeout - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = "timeout"
            if rc != 0:
                print(f"[{w[0]} {w[1]}] the subprocess ended with {rc}", flush=True)
                failed += 1
        res = load_results()
        for p in parts.values():
            res.update(load_results(p))
            p.unlink(missing_ok=True)
        save_results(res)
        return 1 if failed else 0

    mesh_kind = args.mesh or "single"
    if args.cells:
        cells = [(*c.split("|"), mesh_kind, args.probe) for c in args.cells.split(";")]
    elif args.probe_sweep:
        cells = [(a, s, "single", k) for a in arch_ids() for s in SHAPES for k in (2, 4)]
    elif args.all:
        cells = [(a, s, mesh_kind, args.probe) for a in arch_ids() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, mesh_kind, args.probe)]
    cached = load_results(Path(args.cached)) if args.cached else {}
    errors = run_cells(cells, args, Path(args.results), cached)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
