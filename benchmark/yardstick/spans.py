"""What the program-span readers share: the window's spans as the program
recorded them (`miekki_tpu_torch.utils.profiling.SPANS`, which the
program fills only while a profiler records on its thread: in a traced
run, the window and nothing else) and the window's work counted from the
benchmark's inputs.  A program without spans gives None."""

from __future__ import annotations


def _spans() -> dict:
    from miekki_tpu_torch.utils import profiling

    return getattr(profiling, "SPANS", None) or {}


def seconds(*names):
    """Host seconds of the named spans together (None where one is absent)."""
    spans = _spans()
    if not names or any(n not in spans for n in names):
        return None
    return sum(spans[n]["s"] for n in names)


def count(name: str, key: str):
    """The count `key` summed over span `name` (None where it is absent)."""
    return _spans().get(name, {}).get(key)


def gbase(run) -> float:
    """FASTA Gbase the window's sketch jobs read."""
    return len(run.walls) * run.state["gbase"]


def tiles(run) -> int:
    """Tiles the window's dist jobs swept: the tiles of one job, as the job
    kind's set-up counts them, a job."""
    return len(run.walls) * run.state["tiles"]


def per(value, base, scale: float = 1.0):
    """scale * value / base, or None where the value is missing or 0."""
    if not value or not base:
        return None
    return scale * value / base
