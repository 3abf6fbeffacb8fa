#!/usr/bin/env python3
"""The control of a benchmark cell: the plain reference computed in the
next lower precision (every 64-bit hash cut to its top 32 bits) and put in
the program's place, then judged as a run's outputs are.  It has to come
out not correct, which shows that the cell's comparison can fail.

    python3 benchmark/control.py --workload <cell> --seed <n> [--device cuda|cpu]

Prints one JSON line per seed: the cell, the seed, `correct` and the
compared numbers with their limits.  The program is not run.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control(cell, seed: int, device: str) -> dict:
    from benchmark import harness

    drv = harness.job_kind(cell.workload["kind"])
    with tempfile.TemporaryDirectory(prefix="bench-control-") as tmp:
        run = harness.Run(cell, seed, device, Path(tmp), trace=False)
        t0 = time.perf_counter()
        drv.setup(run)
        drv.release(run)
        drv.control(run)
        checks = drv.judge(run)
    return {"workload": cell.name, "seed": seed,
            "correct": all(v <= lim for v, lim in checks.values()),
            "seconds": time.perf_counter() - t0,
            "checks": {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seed:
        print(json.dumps(control(cell, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
