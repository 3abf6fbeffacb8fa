"""Wrapper of kernel K4 (csrc/tile_counts32.cu): all-pairs intersection
counts of a compact sketch tile.

Replaces miekki_tpu/ops/pallas_intersect.py:463 tile_counts_pallas32.  On
CUDA tensors the wrapper launches the kernel (or raises); on CPU tensors
it runs the plain torch version, ops.intersect.tile_counts_compact_plain,
with the same outputs.  `tile_counts32_cuda.launches` counts kernel
launches.

Input contract: every row of `rows` and `cols` holds strictly increasing
int32 code keys (ops.compact) followed by INF_KEY32 padding — the layout
compact SketchIndex tables have by construction (to_compact dedups each
row).  The kernel relies on it and does not check it.  Bound on the H100
(see the source note): int32 operations of the linear merge, ~n_a + n_b
per pair.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import intersect as _intersect
from .compact import INF_KEY32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("tile_counts32")
    p = ctypes.c_void_p
    lib.miekki_tile_counts32.argtypes = [p] * 7 + [ctypes.c_int] * 4 + [p]
    lib.miekki_tile_counts32.restype = ctypes.c_int
    return lib


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
    if not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("rows and cols must be contiguous")
    ti, sp = rows.shape
    tj = cols.shape[0]
    if ti >= 1 << 31 or -(-tj // 8) > 65535:  # grid (ti, tj / COLS_PER_BLOCK), 8 columns
        raise ValueError(f"tile {ti} x {tj} exceeds the launch grid")
    n_a = (rows != INF_KEY32).sum(-1, dtype=torch.int32)
    n_b = (cols != INF_KEY32).sum(-1, dtype=torch.int32)
    out = [torch.empty((ti, tj), dtype=torch.int32, device=rows.device)
           for _ in range(3)]
    if ti and tj and sp:
        with torch.cuda.device(rows.device):
            rc = _lib().miekki_tile_counts32(
                rows.data_ptr(), cols.data_ptr(), n_a.data_ptr(),
                n_b.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), ti, tj, sp, s,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"tile_counts32 kernel launch failed: CUDA error {rc}")
        tile_counts32_cuda.launches += 1
    else:
        for o in out:
            o.zero_()
    return {"shared_in_x": out[0], "union_size": out[1], "inter_full": out[2],
            "n_a": n_a, "n_b": n_b}


tile_counts32_cuda.launches = 0
