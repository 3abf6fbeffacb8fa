"""Which kernels a torch.profiler window loses late in a process, and what
keeps them (the measurement behind utils/profiling.py).

    python -m miekki_tpu_torch.tools.profiler_drops [--rounds 7] [--idle 25]

In one process, each round idles the card for --idle seconds, then opens
one profiler window per variant (their order rotates from round to round).
Every window ends with the same work: 20 one-element kernels, 2 ms apart,
under a "work" span.  Variants: `plain`; `pause_before` and `pause_after`
(0.25 s of sleep inside the window before or after the work);
`flush` (CUPTI's forced flush inside the window after the work);
`pre_session` (a throwaway one-kernel window just before); `warm64` and
`warm1024` (utils.profiling.warm_up_window with that many kernels before
the work).  For each it counts the launches whose kernel has no device
record, in the work and in the warm-up.  Prints one JSON line per round,
then the card's name and power limit.  KINETO_LOG_LEVEL=0 in the
environment makes the profiler log its per-window "Out-of-range" counts.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..utils import profiling

CUPTI_ACTIVITY_FLAG_FLUSH_FORCED = 1


def _cupti_flush() -> None:
    major = (torch.version.cuda or "").split(".")[0]
    lib = ctypes.CDLL(f"libcupti.so.{major}", mode=os.RTLD_NOLOAD)
    lib.cuptiActivityFlushAll(ctypes.c_uint32(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED))


def window(x: torch.Tensor, variant: str) -> dict:
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if variant == "pre_session":
        with profile(activities=activities):
            x.add_(1)
            torch.cuda.synchronize()
    warm = {"warm64": 64, "warm1024": 1024}.get(variant, 0)
    with profile(activities=activities) as prof:
        if warm:
            profiling.warm_up_window(x.device, launches=warm)
        if variant == "pause_before":
            time.sleep(0.25)
        with record_function("work"):
            for _ in range(20):
                x.add_(1)
                time.sleep(0.002)
            torch.cuda.synchronize()
        if variant == "pause_after":
            time.sleep(0.25)
        if variant == "flush":
            _cupti_flush()
    events = prof.profiler.kineto_results.events()
    lost_all = profiling.missing_device_records(events)
    lost_work = profiling.missing_device_records(events, skip=warm)
    return {"work_lost": lost_work, "warmup_lost": lost_all - lost_work}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--idle", type=float, default=25.0)
    args = ap.parse_args(argv)
    x = torch.zeros(1, device="cuda")
    variants = ["plain", "pause_before", "pause_after", "flush", "pre_session",
                "warm64", "warm1024"]
    t0 = time.perf_counter()
    for r in range(args.rounds):
        if r:
            time.sleep(args.idle)
        order = variants[r % len(variants):] + variants[:r % len(variants)]
        line = {"round": r, "process_s": time.perf_counter() - t0, "order": order}
        for v in order:
            line[v] = window(x, v)
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
