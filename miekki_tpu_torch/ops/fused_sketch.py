"""Fused hash + threshold + candidate reduction (counterpart of the JAX
package's ops/pallas_sketch.py): the plain torch version of kernel K2.

For code rows [R, W], n = W - k + 1 windows per row: the canonical hash of
every window (ops.hash), kept where it is strictly below the row's
threshold (INF otherwise), then `levels` rounds that each sort every
GROUP_W-value group of a row and keep its GROUP_CAP smallest.  A level-1
group is windows [128 j, 128 j + 128) of a row; a level-2 group is four
consecutive level-1 outputs, and so on, so the candidate array is
determined exactly.  Each row also reports its largest group count of
finite values over all levels: a count above GROUP_CAP means a group may
have dropped a needed value, and the caller redoes that genome exactly.
"""

from __future__ import annotations

import torch

from . import u64
from .hash import hash_windows

GROUP_W = 128   # values per sorted group at each level
GROUP_CAP = 32  # candidates kept per group per level (4x reduction/level)


def check_levels(n: int, levels: int) -> None:
    """The JAX kernel's width rule: n divisible by 4^levels * GROUP_W / 4."""
    if levels < 0:
        raise ValueError(f"levels must be >= 0, got {levels}")
    if n % (4 ** levels * GROUP_W // 4):
        raise ValueError(f"window count {n} incompatible with {levels} levels")


def row_thresholds(thr: torch.Tensor, rows: int) -> torch.Tensor:
    """Per-row int64 threshold keys [rows] from [rows] keys, or from [G]
    keys broadcast over the rows // G consecutive rows of each genome."""
    thr = thr.reshape(-1).to(torch.int64)
    if thr.numel() == rows:
        return thr
    if thr.numel() == 0 or rows % thr.numel():
        raise ValueError(f"{thr.numel()} thresholds do not divide {rows} rows")
    return thr.repeat_interleave(rows // thr.numel())


def hash_reduce_plain(codes: torch.Tensor, k: int, thr: torch.Tensor,
                      levels: int = 2):
    """codes [R, W] → (candidates int64 keys [R, n / 4^levels], INF-padded
    per group; int32 [R] largest group count of finite values).  `thr` is
    [R] or [G] int64 keys; kept hashes are strictly below it."""
    r, w = codes.shape
    check_levels(w - k + 1, levels)
    h = hash_windows(codes, k)
    thr = row_thresholds(thr, r).to(h.device)
    h = torch.where(h < thr[:, None], h, u64.INF_KEY)
    cmax = torch.zeros(r, dtype=torch.int32, device=h.device)
    for _ in range(levels):
        groups = h.reshape(r, -1, GROUP_W)
        counts = (groups != u64.INF_KEY).sum(-1, dtype=torch.int32)
        cmax = torch.maximum(cmax, counts.amax(-1))
        h = torch.sort(groups, dim=-1).values[..., :GROUP_CAP].reshape(r, -1)
    return h, cmax
