"""Keep a command's kernels in its torch.profiler trace.

On an NVIDIA H100 (torch 2.11, CUDA 12.8), late in a long-lived process
and more so after the card has idled, the profiler drops the first kernel
records of a window as "out of range": the host's launches are in the
trace, their kernels are not.  The count grows with the process's age (2
more after each 25 s idle in a bare loop; 10 or more by the end of
chip_smoke.py), and a short command such as `dist` of 64 sketches then
traced no kernel at all.  It is a count, not a time: a pause at the start
of the window does not help, while a burst of tiny kernels there takes
the losses and every later kernel is kept.  `warm_up_window` opens a
window with such a burst, and `missing_device_records` counts what was
lost after it, so that a caller can say when a trace is incomplete.

`span(name, **counts)` names a stage of the program in the trace.  While
a torch profiler records on the calling thread it opens
`torch.profiler.record_function(name)`, so the stage lands in the chrome
trace as a `user_annotation` event on the device records' clock, with the
kernel launches made inside it nested under it, and on exit it adds to
`SPANS[name]`: one call, its host seconds `s`, its self seconds `self_s`
(less the spans it encloses on its thread) and its counts (`bytes=`,
`rows=`, ... or `add()` on the object it yields).  Otherwise it returns
one shared object that does nothing.  A span opens and closes on one
thread and is never left open across a `yield`.  `idle_under_spans` reads
an exported trace: the card's idle time under each span as the innermost
open one.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import torch

WARMUP_LAUNCHES = 1024   # one-element kernels; about 5 ms of launches
WARMUP_SPAN = "profiler_warmup"


def warm_up_window(device="cuda", launches: int = WARMUP_LAUNCHES) -> None:
    """Inside an open profiler window: launch exactly `launches`
    one-element kernels on `device`, all under a WARMUP_SPAN span, then
    wait for them."""
    from torch.profiler import record_function

    with record_function(WARMUP_SPAN):
        t = torch.empty(1, device=device)   # allocates; launches nothing
        for _ in range(launches):
            t.zero_()
        if t.device.type == "cuda":
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


# ------------------------------------------------------------------ spans

SPANS: dict = {}  # {name: {"calls", "s", "self_s", <count keys>}}, in first-open order
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_local = threading.local()


def reset_spans() -> None:
    SPANS.clear()


class _Off:
    """What `span` returns while no profiler records: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "counts", "child_s", "t0", "rf")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts, self.child_s = name, counts, 0.0

    def add(self, **counts) -> None:
        for key, v in counts.items():
            self.counts[key] = self.counts.get(key, 0) + v

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.rec = SPANS.get(self.name)
        if self.rec is None:
            self.rec = SPANS[self.name] = {"calls": 0, "s": 0.0, "self_s": 0.0}
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_s += dt
        rec = self.rec
        rec["calls"] += 1
        rec["s"] += dt
        rec["self_s"] += dt - self.child_s
        for key, v in self.counts.items():
            rec[key] = rec.get(key, 0) + v


def span(name: str, **counts):
    """A context manager over one stage of the program named `name`: a
    profiler span and an entry of SPANS while a torch profiler records on
    this thread, else a shared no-op (one check, no clock read)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, counts)


def idle_under_spans(trace_path, names) -> dict:
    """{span name: microseconds} of an exported chrome trace: each instant
    at which the card runs no kernel, copy or memset while some span
    named in `names` is open goes to the innermost open one (the latest
    started; of two started together, the first to end)."""
    events = [e for e in json.loads(Path(trace_path).read_text())["traceEvents"]
              if e.get("ph") == "X"]
    names = set(names)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in names]
    points = []  # (time, 0 = an end / 1 = a start, span index or -1 for the card)
    for i, (a, b, _) in enumerate(spans):
        points += [(a, 1, i), (b, 0, i)]
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            points += [(e["ts"], 1, -1), (e["ts"] + e["dur"], 0, -1)]
    points.sort()
    idle = {name: 0.0 for name in names}
    open_spans, busy, last = set(), 0, None
    for t, starts, i in points:
        if open_spans and not busy and t > last:
            inner = max(open_spans, key=lambda j: (spans[j][0], -spans[j][1]))
            idle[spans[inner][2]] += t - last
        last = t
        if i < 0:
            busy += 1 if starts else -1
        elif starts:
            open_spans.add(i)
        else:
            open_spans.discard(i)
    return idle


def span_rows(trace_path=None) -> dict:
    """SPANS in first-open order, each with `idle_s`: the card's idle
    seconds under the span as the innermost open one in the trace at
    `trace_path` (None without a trace of the card)."""
    idle = idle_under_spans(trace_path, SPANS) if trace_path is not None else {}
    return {name: {**rec, "idle_s": idle[name] / 1e6 if name in idle else None}
            for name, rec in SPANS.items()}
