"""Reading a torch.profiler trace of the measured window.

`summarize` takes a chrome trace and the name of the spans the harness
wraps around each job: the card's busy time inside them (the union of
kernels, copies and memsets), the device time of each operation by name,
and what the host was doing while the card idled: the innermost program
span open then (the program's `record_function` annotations), or, where
none is, the top-level torch operation (idle time under neither is
Python and ctypes).

On an H100 (torch 2.11, CUDA 12.8), late in a long-lived process the
profiler drops the first kernel records of a window: the launches are in
the trace, their kernels are not.  A burst of tiny kernels at the start of
the window takes the losses (`warm_up_window`), and
`missing_device_records` counts what was still lost after it.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

WARMUP_LAUNCHES = 1024   # one-element kernels; about 5 ms of launches
WARMUP_SPAN = "profiler_warmup"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_OP = "(no torch op: Python, ctypes)"


def warm_up_window(device="cuda", launches: int = WARMUP_LAUNCHES) -> None:
    """Inside an open profiler window: launch exactly `launches`
    one-element kernels on `device` under a WARMUP_SPAN span, then wait
    for them."""
    from torch.profiler import record_function

    with record_function(WARMUP_SPAN):
        t = torch.empty(1, device=device)
        for _ in range(launches):
            t.zero_()
        torch.cuda.synchronize(t.device)


def missing_device_records(events, skip: int = 0) -> int:
    """Kernel launches on the host, in launch order after the first `skip`,
    whose kernel has no device record in `events` (a profiler's
    ``kineto_results.events()``)."""
    from torch.autograd import DeviceType

    recorded = {e.correlation_id() for e in events if e.device_type() == DeviceType.CUDA}
    launches = sorted((e for e in events if e.device_type() != DeviceType.CUDA
                       and "LaunchKernel" in e.name()), key=lambda e: e.start_ns())
    return sum(e.correlation_id() not in recorded for e in launches[skip:])


def _clip(intervals, spans):
    """The parts of sorted (start, end, name) intervals inside sorted
    disjoint spans."""
    out, si = [], 0
    for a, b, name in intervals:
        while si < len(spans) and spans[si][1] <= a:
            si += 1
        j = si
        while j < len(spans) and spans[j][0] < b:
            lo, hi = max(a, spans[j][0]), min(b, spans[j][1])
            if hi > lo:
                out.append((lo, hi, name))
            j += 1
    return out


def _innermost(intervals):
    """Sorted disjoint (start, end, name) pieces of the union of (start,
    end, name) intervals, each instant under the innermost interval open
    then (the latest started; of two started together, the first to end)."""
    points = sorted([(a, 1, i) for i, (a, _, _) in enumerate(intervals)]
                    + [(b, 0, i) for i, (_, b, _) in enumerate(intervals)])
    out, open_, last = [], set(), None
    for t, starts, i in points:
        if open_ and t > last:
            inner = max(open_, key=lambda j: (intervals[j][0], -intervals[j][1]))
            out.append((last, t, intervals[inner][2]))
        last = t
        if starts:
            open_.add(i)
        else:
            open_.discard(i)
    return out


def _outside(spans, covers):
    """The parts of sorted disjoint (start, end) spans that no sorted
    disjoint cover overlaps."""
    out, ci = [], 0
    for a, b in spans:
        while ci < len(covers) and covers[ci][1] <= a:
            ci += 1
        at, j = a, ci
        while j < len(covers) and covers[j][0] < b:
            if covers[j][0] > at:
                out.append((at, covers[j][0]))
            at = max(at, covers[j][1])
            j += 1
        if at < b:
            out.append((at, b))
    return out


def summarize(path: Path, span: str) -> dict:
    """Times in microseconds: `window_us` (the spans' total), `busy_us`,
    `device_us` {operation name: time}, `kernel_us` {kernel name: time} and
    `idle_under_us` {program span, else top-level host operation: the
    card's idle time under it}, which adds up to window_us - busy_us.  The
    job spans `span` and the warm-up burst are not program spans."""
    ev = [e for e in json.loads(Path(path).read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("cat") == "user_annotation" and e["name"] == span)
    if not spans:
        return {}
    window = sum(b - a for a, b in spans)
    dev = sorted(_clip(sorted((e["ts"], e["ts"] + e["dur"], (e["cat"], e["name"]))
                              for e in ev if e.get("cat") in DEVICE_CATS), spans))
    device_us, kernel_us = {}, {}
    for a, b, (cat, name) in dev:
        device_us[name] = device_us.get(name, 0.0) + (b - a)
        if cat == "kernel":
            kernel_us[name] = kernel_us.get(name, 0.0) + (b - a)
    busy, gaps, di = 0.0, [], 0
    for s0, s1 in spans:  # every clipped interval starts inside one span
        at = s0
        while di < len(dev) and dev[di][0] < s1:
            a, b, _ = dev[di]
            di += 1
            if a > at:
                gaps.append((at, a))
            busy += max(0.0, b - max(a, at))
            at = max(at, b)
        if at < s1:
            gaps.append((at, s1))
    program = _innermost([(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                          if e.get("cat") == "user_annotation"
                          and e["name"] not in (span, WARMUP_SPAN)])
    tops, end = [], None
    for e in sorted((e for e in ev if e.get("cat") == "cpu_op"),
                    key=lambda e: (e["ts"], -e["dur"])):
        if end is None or e["ts"] >= end:
            tops.append((e["ts"], e["ts"] + e["dur"], e["name"]))
            end = e["ts"] + e["dur"]
    idle_under, covered = {}, 0.0
    for a, b, name in _clip(program, gaps) + _clip(tops, _outside(gaps, program)):
        idle_under[name] = idle_under.get(name, 0.0) + (b - a)
        covered += b - a
    idle_under[NO_OP] = (window - busy) - covered
    return {"window_us": window, "busy_us": busy, "device_us": device_us,
            "kernel_us": kernel_us, "idle_under_us": idle_under}


def top(times: dict, n: int = 10):
    """[[name, seconds], ...] of the n largest microsecond times."""
    return [[name[:120], us / 1e6] for name, us in
            sorted(times.items(), key=lambda kv: -kv[1])[:n]]
