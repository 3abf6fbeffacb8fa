"""Wrapper of kernel K4 (csrc/tile_counts_merge.cu, 32-bit keys): all-pairs
intersection counts of a compact sketch tile.

Replaces miekki_tpu/ops/pallas_intersect.py:463 tile_counts_pallas32.  On
CUDA tensors the wrapper launches the kernel (or raises); on CPU tensors
it runs the plain torch version, ops.intersect.tile_counts_compact_plain,
with the same outputs.  `tile_counts32_cuda.launches` counts kernel
launches.  K4 is K3's kernel (ops.cuda_intersect) instantiated for int32
keys.

Input contract: every row of `rows` and `cols` holds strictly increasing
int32 code keys (ops.compact) followed by INF_KEY32 padding — the layout
compact SketchIndex tables have by construction (to_compact dedups each
row).  The kernel relies on it and does not check it.  Bound on the H100
(see the source note): int32 operations of the linear merge, n_a + n_b
per pair.
"""

from __future__ import annotations

import torch

from . import intersect as _intersect
from .compact import INF_KEY32
from .cuda_intersect import launch_tile_counts


def tile_counts32_cuda(rows: torch.Tensor, cols: torch.Tensor, s: int) -> dict:
    """rows [Ti, sp], cols [Tj, sp] int32 code keys → {"shared_in_x",
    "union_size", "inter_full"} int32 [Ti, Tj], "n_a" int32 [Ti], "n_b"
    int32 [Tj] (semantics of ops.intersect.pair_counts_merge)."""
    if (rows.dim() != 2 or cols.dim() != 2 or rows.dtype != torch.int32
            or cols.dtype != torch.int32 or rows.shape[1] != cols.shape[1]):
        raise ValueError(f"expected int32 [Ti, sp] / [Tj, sp] code keys, got "
                         f"{rows.dtype} {tuple(rows.shape)} / {cols.dtype} "
                         f"{tuple(cols.shape)}")
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if rows.device != cols.device:
        raise ValueError(f"rows on {rows.device}, cols on {cols.device}")
    if rows.device.type == "cpu":
        return _intersect.tile_counts_compact_plain(rows, cols, s)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    counts, launched = launch_tile_counts(rows, cols, s, INF_KEY32)
    tile_counts32_cuda.launches += launched
    return counts


tile_counts32_cuda.launches = 0
