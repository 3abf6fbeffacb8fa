"""Wrapper of kernel K2 (csrc/hash_reduce.cu): fused hash + threshold +
candidate reduction for the `fused` sketch strategy.

Replaces miekki_tpu/ops/pallas_sketch.py:140 hash_reduce_pallas.  On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor
it runs the plain torch version, ops.fused_sketch.hash_reduce_plain, with
the same outputs.  `hash_reduce_cuda.launches` counts kernel launches
(one per call for levels <= 3, one more per level above 3).

Bound on the H100 (see the source note): int32 operations of the hash,
threshold and group count, ~30 per window; the bytes take half as long.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import fused_sketch as _fused

MAX_BLOCK_LEVELS = 3  # levels run inside one launch (csrc: MAX_BLOCK_LEVELS)
SPAN = 4096           # windows per block (csrc: SPAN)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("hash_reduce")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.miekki_hash_reduce.argtypes = [p, p, i, ctypes.c_longlong, p, p, i, i, i, i, p]
    lib.miekki_hash_reduce.restype = ctypes.c_int
    lib.miekki_group_reduce.argtypes = [p, p, p, i, i, p]
    lib.miekki_group_reduce.restype = ctypes.c_int
    lib.miekki_hash_reduce_info.argtypes = [p, p, p]
    lib.miekki_hash_reduce_info.restype = ctypes.c_int
    return lib


def kernel_info() -> dict:
    """Threads per block, resident blocks per SM and occupancy (resident
    threads over the SM's limit) of the block kernel on the current card;
    registers and shared memory are in the build's ptxas log."""
    threads, blocks, limit = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _lib().miekki_hash_reduce_info(ctypes.byref(threads), ctypes.byref(blocks),
                                        ctypes.byref(limit))
    if rc != 0:
        raise RuntimeError(f"hash_reduce occupancy query failed: CUDA error {rc}")
    return {"threads_per_block": threads.value, "blocks_per_sm": blocks.value,
            "occupancy": blocks.value * threads.value / limit.value}


def _check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"hash_reduce kernel launch failed: CUDA error {rc}")
    hash_reduce_cuda.launches += 1


def hash_reduce_cuda(codes: torch.Tensor, k: int, thr: torch.Tensor,
                     levels: int = 2):
    """uint8 code rows [R, W] (0..3 valid), int64 threshold keys [R] (or [G],
    broadcast over R // G consecutive rows) → (int64 candidate keys
    [R, n / 4^levels], int32 [R] largest group count per row), n = W - k + 1
    divisible by 4^levels * 32 (ops.fused_sketch.hash_reduce_plain)."""
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"expected uint8 [R, W] code rows, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not 1 <= k <= 64:
        raise ValueError(f"k must be in [1, 64], got {k}")
    r, w = codes.shape
    n = w - k + 1
    if n <= 0:
        raise ValueError(f"sequence shorter than k: {w} < {k}")
    _fused.check_levels(n, levels)
    if thr.dtype != torch.int64 or thr.device != codes.device:
        raise ValueError(f"thresholds must be int64 keys on {codes.device}, got "
                         f"{thr.dtype} on {thr.device}")
    if codes.device.type == "cpu":
        return _fused.hash_reduce_plain(codes, k, thr, levels)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if not codes.is_contiguous():
        raise ValueError("code rows must be contiguous")
    if r >= 1 << 31 or -(-n // SPAN) > 65535:
        raise ValueError(f"code block {tuple(codes.shape)} exceeds the launch grid")
    # the kernel reads each genome's threshold in place (no per-row copy)
    thr = thr.reshape(-1)
    if thr.numel() != r and (thr.numel() == 0 or r % thr.numel()):
        raise ValueError(f"{thr.numel()} thresholds do not divide {r} rows")
    lb = min(levels, MAX_BLOCK_LEVELS)
    cnt = torch.empty(r, dtype=torch.int32, device=codes.device)  # zeroed by the launch
    if r == 0:
        return torch.empty((0, n >> (2 * levels)), dtype=torch.int64,
                           device=codes.device), cnt
    out = torch.empty((r, n >> (2 * lb)), dtype=torch.int64, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with torch.cuda.device(codes.device):
        lib = _lib()
        _check(lib.miekki_hash_reduce(codes.data_ptr(), thr.data_ptr(), thr.numel(),
                                      thr.stride(0), out.data_ptr(), cnt.data_ptr(), r, w, k,
                                      lb, stream))
        for _ in range(levels - lb):
            nxt = torch.empty((r, out.shape[1] // 4), dtype=torch.int64,
                              device=codes.device)
            _check(lib.miekki_group_reduce(out.data_ptr(), nxt.data_ptr(),
                                           cnt.data_ptr(), r, out.shape[1], stream))
            out = nxt
    return out, cnt


hash_reduce_cuda.launches = 0
