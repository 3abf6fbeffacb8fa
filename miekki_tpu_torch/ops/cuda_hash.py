"""Wrapper of kernel K1 (csrc/hash_windows.cu): canonical k-mer hashing.

Replaces miekki_tpu/ops/pallas_hash.py:42 hash_windows_pallas.  On a CUDA
tensor the wrapper launches the kernel (or raises); on a CPU tensor it
runs the plain torch version, ops.hash.hash_windows, with the same
output.  `hash_windows_cuda.launches` counts kernel launches.

Bound on the H100 (see the source note): memory, 1 B read per base and
8 B written per window.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import hash as _hash


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("hash_windows")
    p = ctypes.c_void_p
    lib.miekki_hash_windows.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.miekki_hash_windows.restype = ctypes.c_int
    return lib


def hash_windows_cuda(codes: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 code rows [R, W] (0..3 valid, anything else invalid) → int64
    order keys [R, W - k + 1]; INF_KEY marks windows holding an invalid
    code.  Rows are independent (callers overlap chunk rows by k - 1)."""
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"expected uint8 [R, W] code rows, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not 1 <= k <= 64:
        raise ValueError(f"k must be in [1, 64], got {k}")
    r, w = codes.shape
    n = w - k + 1
    if n <= 0:
        raise ValueError(f"sequence shorter than k: {w} < {k}")
    if codes.device.type == "cpu":
        return _hash.hash_windows(codes, k)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if not codes.is_contiguous():
        raise ValueError("code rows must be contiguous")
    if r >= 1 << 31 or -(-n // 2048) > 65535:  # grid (rows, n / TILE), TILE = 2048
        raise ValueError(f"code block {tuple(codes.shape)} exceeds the launch grid")
    out = torch.empty((r, n), dtype=torch.int64, device=codes.device)
    if r == 0:
        return out
    with torch.cuda.device(codes.device):
        rc = _lib().miekki_hash_windows(
            codes.data_ptr(), out.data_ptr(), r, w, k,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hash_windows kernel launch failed: CUDA error {rc}")
    hash_windows_cuda.launches += 1
    return out


hash_windows_cuda.launches = 0
