"""The benchmark's harness: one run of one cell, driven by data.

A cell of BENCHMARK.json names a configuration (`configs/<config>.json`,
found through BENCHMARK.json's `configs`) and its own workload file
(`workloads/<cell>.json`).  The workload file names the job kind, whose
module is `jobs/<kind>.py`, the end-to-end rate its jobs report, and the
traffic's parameters.  Each per-layer metric is read by
`metrics/<metric>.py`.  A cell, a configuration, a job kind or a metric is
added by adding files and entries; nothing here names one.

A job kind (jobs/<kind>.py) has
  setup(run)       make the cell's inputs from the seed (files under run.tmp)
  job(run, j)      one whole job through the program's entry (j = -1: the warm job)
  keep(run, j)     after the job's wall: record what it produced for the
                   judge (j >= 0) and return its work, in the rate's units
  release(run)     drop the program's state before the reference runs
  judge(run)       {check: (value, limit)} from the window's outputs
  control(run)     put the control's outputs in place of the window's
A kind whose jobs sweep tiles sets run.state["tiles"], the tiles of one
job, in setup.  The benchmark's CPU tests find the kind's cut to CPU
sizes, its control's sizes and its planted faults in
`tests/kinds/<kind>.py`.
A metric reader has read(run) -> number, or None where it finds nothing.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "miekki_tpu")
JOB_SPAN = "bench_job"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str) -> Cell:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return Cell(name=name, chips=entry["chips"],
                config=json.loads((ROOT / conf["file"]).read_text()),
                workload=json.loads((BENCH / "workloads" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


class Run:
    """One run's inputs, the window's records and the program's handles,
    shared by the job kind, the metric readers and the judge."""

    def __init__(self, cell: Cell, seed: int, device, tmp: Path, trace: bool):
        import torch

        self.cell, self.seed, self.tmp, self.trace = cell, int(seed), Path(tmp), trace
        self.device = torch.device(device)
        self.config, self.workload = cell.config, cell.workload
        self.state: dict = {}    # the job kind's inputs and the program's handles
        self.outputs: list = []  # what each window job produced
        self.walls: list = []    # host seconds of each window job
        self.work: list = []     # work of each window job, in the rate's units
        self.summary: dict = {}  # the window's trace (traced runs)
        self.peaks = None        # roofline.peaks of the card
        self._memo: dict = {}

    @property
    def window_s(self) -> float:
        return sum(self.walls)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, key: str, fn, min_s: float = 0.5) -> float:
        """Host seconds a call of `fn`, once warm: calls are repeated until
        they span `min_s` together (kept per key for the run)."""
        if key not in self._memo:
            fn()
            self.sync()
            n, t0 = 0, time.perf_counter()
            while True:
                fn()
                self.sync()
                n += 1
                if time.perf_counter() - t0 >= min_s:
                    break
            self._memo[key] = (time.perf_counter() - t0) / n
        return self._memo[key]


def job_kind(kind: str):
    return importlib.import_module(f"benchmark.jobs.{kind}")


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def _window(run: Run, drv, seconds: float) -> dict:
    """Whole jobs back to back until their walls add up to `seconds`; under
    the profiler when the run is traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .yardstick import trace as ytrace

    prof = None
    if run.trace:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        ytrace.warm_up_window(run.device)
    j = 0
    while True:
        span = record_function(JOB_SPAN) if run.trace else contextlib.nullcontext()
        with span:
            t0 = time.perf_counter()
            drv.job(run, j)
            run.sync()
            wall = time.perf_counter() - t0
        run.walls.append(wall)
        run.work.append(drv.keep(run, j))
        j += 1
        if run.window_s >= seconds:
            break
    info: dict = {}
    if prof is not None:
        prof.__exit__(None, None, None)
        path = run.tmp / "window.trace.json"
        prof.export_chrome_trace(str(path))
        info["missing_kernel_records"] = ytrace.missing_device_records(
            prof.profiler.kineto_results.events(), skip=ytrace.WARMUP_LAUNCHES)
        del prof
        run.summary = ytrace.summarize(path, JOB_SPAN)
        path.unlink()
    if run.device.type == "cuda":
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(run.device))
    return info


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float) -> dict:
    """One run of `cell`; returns the result line as a dict (the judge's
    checks last)."""
    import torch

    from .yardstick import roofline
    from .yardstick import trace as ytrace

    drv = job_kind(cell.workload["kind"])
    parts: dict = {"start_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        run = Run(cell, seed, device, Path(tmp), trace)
        dev = run.device
        t = time.perf_counter()
        if dev.type == "cuda":
            from miekki_tpu_torch.ops import _build

            _build.build_all()
            run.peaks = roofline.peaks(torch.cuda.get_device_name(dev))
        parts["build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        drv.setup(run)
        run.sync()
        parts["inputs_s"] = time.perf_counter() - t
        if dev.type == "cuda":  # the peak is the program's, not the input makers'
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        drv.job(run, -1)
        run.sync()
        drv.keep(run, -1)
        parts["warm_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t0

        info = _window(run, drv, seconds)
        metrics = {}
        if trace:
            for m in cell.per_layer:
                value = metric_reader(m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            rate = sum(run.work) / run.window_s
            for m in cell.end_to_end:
                if m["name"] == "setup_s":
                    value = setup_s
                elif m["name"] == cell.workload["end_to_end"]:
                    value = rate
                else:
                    raise ValueError(f"cell {cell.name} has no reading of {m['name']}")
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        drv.release(run)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks = drv.judge(run)
        parts["judge_s"] = time.perf_counter() - t

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": info.get("memory_peak_bytes", 0)}
    if dev.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(run.walls), "failed": 0, "metrics": metrics,
              "device": device_info}
    if trace and run.summary:
        device_info["busy_s"] = run.summary["busy_us"] / 1e6
        device_info["window_s"] = run.summary["window_us"] / 1e6
        device_info["missing_kernel_records"] = info.get("missing_kernel_records")
        result["breakdown"] = {"device_ops": ytrace.top(run.summary["device_us"]),
                               "idle_gaps": ytrace.top(run.summary["idle_under_us"])}
        result["idle_under_s"] = {name: us / 1e6 for name, us in
                                  run.summary["idle_under_us"].items()}
    result["setup_parts"] = parts
    result["job_walls"] = run.walls
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
