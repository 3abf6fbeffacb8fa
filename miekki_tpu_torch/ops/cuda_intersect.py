"""Wrapper of kernel K3 (csrc/tile_counts_merge.cu, 64-bit keys): all-pairs
intersection counts of a sketch tile.

Replaces miekki_tpu/ops/pallas_intersect.py:265 tile_counts_pallas.  On
CUDA tensors the wrapper launches the kernel (or raises); on CPU tensors
it runs the plain torch version, ops.intersect.tile_counts_plain, with
the same outputs.  `tile_counts_cuda.launches` counts kernel launches.
`launch_tile_counts` also serves K4 (ops.cuda_intersect32), the same
kernel on 32-bit keys.

Input contract: every row of `rows` and `cols` holds strictly increasing
finite order keys followed by INF_KEY padding — the layout SketchIndex
tables have by construction.  The kernel relies on it and does not check
it.  Bound on the H100 (see the source note): int32 operations of the
linear merge, 2 (n_a + n_b) per pair.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import intersect as _intersect
from . import u64

TILE_ROWS = TILE_COLS = 32  # pairs per block of the kernel: 32 rows x 32 columns


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("tile_counts_merge")
    p = ctypes.c_void_p
    for fn in (lib.miekki_tile_counts64, lib.miekki_tile_counts32):
        fn.argtypes = [p] * 5 + [ctypes.c_int] * 4 + [p]
        fn.restype = ctypes.c_int
    lib.miekki_tile_counts_info.argtypes = [ctypes.c_int, p, p, p]
    lib.miekki_tile_counts_info.restype = ctypes.c_int
    return lib


def kernel_info(key_bytes: int) -> dict:
    """Dynamic shared memory per block, resident blocks per SM and
    occupancy (resident threads over the SM's limit) of the kernel for
    8-byte (K3) or 4-byte (K4) keys, on the current card."""
    smem, blocks, limit = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _lib().miekki_tile_counts_info(key_bytes, ctypes.byref(smem), ctypes.byref(blocks),
                                        ctypes.byref(limit))
    if rc != 0:
        raise RuntimeError(f"tile_counts occupancy query failed: CUDA error {rc}")
    threads = TILE_ROWS * TILE_COLS
    return {"threads_per_block": threads, "dynamic_smem_bytes": smem.value,
            "blocks_per_sm": blocks.value, "occupancy": blocks.value * threads / limit.value}


def launch_tile_counts(rows: torch.Tensor, cols: torch.Tensor, s: int,
                       inf: int) -> tuple:
    """Launch the kernel on CUDA key tables (int64 → K3, int32 → K4) padded
    with `inf`; returns (counts dict, whether it launched: an empty tile
    launches nothing)."""
    if not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("rows and cols must be contiguous")
    ti, sp = rows.shape
    tj = cols.shape[0]
    if -(-ti // TILE_ROWS) > 65535 or tj >= 1 << 31:  # grid (tj / 32, ti / 32)
        raise ValueError(f"tile {ti} x {tj} exceeds the launch grid")
    n_a = (rows != inf).sum(-1, dtype=torch.int32)
    n_b = (cols != inf).sum(-1, dtype=torch.int32)
    out = [torch.empty((ti, tj), dtype=torch.int32, device=rows.device)
           for _ in range(3)]
    counts = {"shared_in_x": out[0], "union_size": out[1], "inter_full": out[2],
              "n_a": n_a, "n_b": n_b}
    if not (ti and tj and sp):
        for o in out:
            o.zero_()
        return counts, False
    lib = _lib()
    entry = lib.miekki_tile_counts64 if rows.dtype == torch.int64 else lib.miekki_tile_counts32
    with torch.cuda.device(rows.device):
        rc = entry(rows.data_ptr(), cols.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                   out[2].data_ptr(), ti, tj, sp, s, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tile_counts kernel launch failed: CUDA error {rc}")
    return counts, True


def tile_counts_cuda(rows: torch.Tensor, cols: torch.Tensor, s: int) -> dict:
    """rows [Ti, sp], cols [Tj, sp] int64 keys → {"shared_in_x",
    "union_size", "inter_full"} int32 [Ti, Tj], "n_a" int32 [Ti], "n_b"
    int32 [Tj] (semantics of ops.intersect.pair_counts_merge)."""
    if (rows.dim() != 2 or cols.dim() != 2 or rows.dtype != torch.int64
            or cols.dtype != torch.int64 or rows.shape[1] != cols.shape[1]):
        raise ValueError(f"expected int64 [Ti, sp] / [Tj, sp] keys, got "
                         f"{rows.dtype} {tuple(rows.shape)} / {cols.dtype} "
                         f"{tuple(cols.shape)}")
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if rows.device != cols.device:
        raise ValueError(f"rows on {rows.device}, cols on {cols.device}")
    if rows.device.type == "cpu":
        return _intersect.tile_counts_plain(rows, cols, s)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    counts, launched = launch_tile_counts(rows, cols, s, u64.INF_KEY)
    tile_counts_cuda.launches += launched
    return counts


tile_counts_cuda.launches = 0
