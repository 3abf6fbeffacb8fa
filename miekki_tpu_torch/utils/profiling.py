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
"""

from __future__ import annotations

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
