"""The control and the faults that ``correct`` has to catch, read at a
cell's own size on the card.

    python3 portbench/control.py --workload wan1.3b-train-mix --seeds 1 2 3

For each seed, the cell's compared steps (``compared_steps`` in its
``cells/<cell>.json``, as the harness records them) are followed by the
f32 reference, by the control (the same reference with float8 products,
the precision below the configuration's bf16) and by the reference with
half of each step's rows left out; each of the latter two is held against the first by the
harness's numbers.  A step that leaves the state unchanged reads 1 on the
change number by its definition and needs no run.  Prints one JSON line a
seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.reference import mmdit as ref  # noqa: E402


def readings(workload: str, seeds, device="cuda") -> list[dict]:
    spec = harness.load_spec(workload)
    cfg, steps = spec["cfg"], spec["compared_steps"]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        want = ref.follow(cfg, cfg["optimizer"], seed, steps, device)
        t1 = time.perf_counter()
        row = {"workload": workload, "seed": seed, "reference_s": t1 - t0,
               "control": ref.gaps(ref.follow(cfg, cfg["optimizer"], seed, steps, device,
                                              precision="fp8"), want),
               "half": ref.gaps(ref.follow(cfg, cfg["optimizer"], seed, steps, device,
                                           fault="half"), want),
               "losses": want["losses"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    readings(args.workload, args.seeds)
