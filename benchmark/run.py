#!/usr/bin/env python3
"""One run of one benchmark cell of miekki_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds or loads the port's CUDA kernels (build/ in this checkout),
makes the cell's inputs from the seed and runs one warm job at the cell's
own shapes.  The window then runs whole jobs back to back for `--seconds`
seconds of job wall, and the judge holds what they produced against the
plain reference (benchmark/reference).  The last line of standard output
is one JSON object: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics read from a torch.profiler trace of the
window.  Every compared number and its limit are printed last on standard
error, and last in the line under "checks".  Without a CUDA card, or with
fewer cards than the cell asks for, it exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# any Triton kernel cache stays in this checkout, at a fixed path
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False; the benchmark runs only "
              "on a CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}; the port may load neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 3
    print(f"setup parts (s): {json.dumps(result['setup_parts'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
