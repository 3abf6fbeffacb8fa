"""uint64 sketch values as int64 order keys (counterpart of the JAX
package's (hi, lo) uint32 plane layer).

On the device a sketch value v (numpy uint64) is carried as the order key
``v ^ 2**63`` viewed as int64.  Flipping the sign bit is a monotone
bijection from unsigned to signed order, so `torch.sort`,
`torch.searchsorted`, `torch.minimum` and `<` order keys exactly as u64,
and the UINT64_MAX padding sentinel (+inf) becomes INT64_MAX (`INF_KEY`).

The plain torch hash works on RAW u64 bit patterns stored in int64
tensors; `rol`/`ror`/`less`/`minimum` below are those raw-bit helpers.
torch's int64 `>>` is arithmetic, so every right shift is masked.
CUDA kernels use native uint64_t and flip the sign bit only where they
load or store a key.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

U32_MASK = np.uint64(0xFFFFFFFF)
UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
INT64_MAX = (1 << 63) - 1
SIGN_BIT = -(1 << 63)  # int64 with only bit 63 set: `x ^ SIGN_BIT` flips it
INF_KEY = INT64_MAX  # order key of the UINT64_MAX (+inf) sentinel
_SIGN_U64 = np.uint64(1 << 63)


# ----------------------------------------------------------- host conversions


def split(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """numpy uint64 → (hi, lo) numpy uint32."""
    x = np.asarray(x, dtype=np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), (x & U32_MASK).astype(np.uint32)


def join(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) → numpy uint64."""
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def keys_from_u64(x: np.ndarray) -> np.ndarray:
    """numpy uint64 values → int64 order keys."""
    return (np.asarray(x, dtype=np.uint64) ^ _SIGN_U64).view(np.int64)


def u64_from_keys(keys) -> np.ndarray:
    """int64 order keys (numpy or a torch tensor) → numpy uint64 values."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    return np.asarray(keys, dtype=np.int64).view(np.uint64) ^ _SIGN_U64


def keys_from_planes(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 planes (the SketchIndex layout) → int64 order keys."""
    return keys_from_u64(join(hi, lo))


def planes_from_keys(keys) -> Tuple[np.ndarray, np.ndarray]:
    """int64 order keys → (hi, lo) uint32 planes."""
    return split(u64_from_keys(keys))


# ------------------------------------------------------ raw-bit torch helpers


def _lsr_mask(amount):
    """Mask keeping the low 64 - amount bits after an arithmetic right
    shift by `amount` (0 for amount == 0, where the caller's rotate term
    must vanish).  `amount` is an int or an int64 tensor in [0, 64)."""
    if isinstance(amount, int):
        return INT64_MAX >> ((amount - 1) % 64)
    return torch.full_like(amount, INT64_MAX) >> ((amount - 1) % 64)


def rol(x: torch.Tensor, r) -> torch.Tensor:
    """Rotate the raw u64 bits of int64 `x` left by r (mod 64); r is an
    int or an int64 tensor broadcastable against x."""
    r = r % 64
    back = (64 - r) % 64
    return (x << r) | ((x >> back) & _lsr_mask(back))


def ror(x: torch.Tensor, r) -> torch.Tensor:
    return rol(x, (64 - (r % 64)) % 64)


def less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned u64 a < b on raw bits."""
    return (a ^ SIGN_BIT) < (b ^ SIGN_BIT)


def equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a == b


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned u64 minimum on raw bits."""
    return torch.where(less(a, b), a, b)


def to_keys(raw: torch.Tensor) -> torch.Tensor:
    """Raw u64 bits → order keys (and back: the map is an involution)."""
    return raw ^ SIGN_BIT


def is_inf(keys: torch.Tensor) -> torch.Tensor:
    return keys == INF_KEY


def inf_like(shape, device=None) -> torch.Tensor:
    return torch.full(shape, INF_KEY, dtype=torch.int64, device=device)
