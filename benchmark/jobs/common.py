"""Helpers shared by the job kinds."""

from __future__ import annotations

import numpy as np


def cli(args) -> None:
    """One command of the port's CLI, in this process; raises on a
    non-zero exit code."""
    from miekki_tpu_torch import cli as port_cli

    rc = port_cli.main([str(a) for a in args])
    if rc != 0:
        raise RuntimeError(f"miekki_tpu_torch.cli {args[0]} exited {rc}")


def lines_differing(got: bytes, want: bytes) -> int:
    """Lines of `got` that differ from `want` at the same place, plus the
    difference in their line counts."""
    a, b = got.split(b"\n"), want.split(b"\n")
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def job_rng(seed: int, j: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), j])

