"""Run one cell of the benchmark and print its result as the last line.

    python3 portbench/run.py --workload wan1.3b-train-mix --seed 7 --seconds 40 --trace 0

From the root of a checkout holding ``BENCHMARK.json``, ``portbench/`` and
the program under ``src/``.  Needs as many CUDA devices as the cell names;
without them it exits non-zero and prints no result.  The compared numbers
are printed beside their limits as the last lines of standard error and,
under ``checks``, last in the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # before the heavy imports: set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
