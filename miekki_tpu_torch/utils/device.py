"""Device selection for the port's entry points.

Every entry point takes a `device` argument that defaults to ``"cuda"``.
Asking for CUDA where torch sees no card raises: nothing silently falls
back to the CPU.  The CPU is used only when the caller passes
``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """`device` (str or torch.device) → torch.device, checked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (or --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
