"""What the per-layer metric readers share: the window's trace, the kernels'
device time by name, and their bounds over the window's jobs."""

from __future__ import annotations

from . import roofline

K1_KERNEL = "hash_windows_kernel"
K3_KERNEL = "tile_counts_kernel<long"  # the int64-key instance of the merge kernel


def idle_share(run):
    """Share of the jobs' spans in which the card ran nothing."""
    s = run.summary
    if not s or not s["window_us"]:
        return None
    return 1.0 - s["busy_us"] / s["window_us"]


def kernel_s(run, match):
    """Device seconds of the window's kernels whose name `match` accepts
    (None where the trace holds none)."""
    if not run.summary:
        return None
    us = sum(t for name, t in run.summary["kernel_us"].items() if match(name))
    return us / 1e6 if us > 0 else None


def host_to_device_s(run):
    """Device seconds of the window's host-to-device copies (the trace's
    `Memcpy HtoD` operations, pinned and pageable; None where it holds
    none)."""
    if not run.summary:
        return None
    us = sum(t for name, t in run.summary["device_us"].items()
             if name.startswith("Memcpy HtoD"))
    return us / 1e6 if us > 0 else None


def k1_s(run):
    return kernel_s(run, lambda n: K1_KERNEL in n)


def k3_s(run):
    return kernel_s(run, lambda n: K3_KERNEL in n)


def k1_bound_s(run):
    """Least card time of the K1 work of the window's jobs."""
    if not run.peaks:
        return None
    ops, nbytes = roofline.k1_work(run.state["hashed_lengths"], run.config["k"])
    return len(run.walls) * roofline.bound_s(ops, nbytes, run.peaks)


def k3_bound_s(run):
    """Least card time of the K3 work of the window's jobs."""
    if not run.peaks:
        return None
    ops, nbytes = roofline.k3_work_self(run.state["sizes"])
    return len(run.walls) * roofline.bound_s(ops, nbytes, run.peaks)


def share(bound, seconds):
    """100 * bound / seconds, or None where either is missing."""
    if bound is None or not seconds:
        return None
    return 100.0 * bound / seconds


def tile_loop_s(run):
    """Host seconds of engine.dist_tiles drained alone over the job's index."""
    return run.timed("tile_loop", run.state["drain_tiles"])
