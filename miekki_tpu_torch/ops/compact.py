"""Compact (32-bit) sketch fingerprints (counterpart of the JAX package's
ops/compact.py).

Each 64-bit hash value is encoded as a 32-bit monotone float-like code,

    code = (msb_index << MANTISSA) | (top MANTISSA bits after the leading 1)

(6-bit exponent, 26-bit mantissa).  The map is monotone, so sorted order,
the merge counts and the bottom-s rank logic work on codes unchanged; only
equality becomes approximate (two distinct values can share a code), which
costs the Jaccard estimate a bias of ~3e-4 at s = 10,000.  Compact and raw
sketches are incomparable (``SketchParams.compact``).

`encode_u64`, `decode_approx` and `lo_plane_np` are the host (numpy)
functions, copied verbatim.  On the device a code is carried as an int32
order key ``code ^ 0x80000000``: signed int32 order equals uint32 code
order, and the sentinel 0xFFFFFFFF becomes INT32_MAX (`INF_KEY32`), the
same trick ops.u64 plays on int64.  `encode_pair` works on int64 tensors
holding uint32 values, so its right shifts never meet a sign bit; its left
shifts are masked back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import u64

MANTISSA = 26  # mantissa bits; exponent (msb index 0..63) uses the top 6

#: Codes equal to UINT32_MAX are reserved as the INF/padding sentinel.
#: Only v >= 2^64·(1 - 2^-27) could produce it (bottom-s sketch values
#: are ~2^64·s/n, nowhere near); encode clamps such values one code down.
_SENTINEL = np.uint32(0xFFFFFFFF)

U32 = 0xFFFFFFFF
INF_KEY32 = (1 << 31) - 1  # order key of the sentinel code
_SIGN32 = np.uint32(1 << 31)


def encode_u64(vals: np.ndarray) -> np.ndarray:
    """numpy uint64 values → uint32 monotone codes (host side).

    UINT64_MAX maps to the sentinel (it IS the padding value); any other
    value that would hit the sentinel code is clamped one below.
    """
    v = np.asarray(vals, dtype=np.uint64)
    out = np.empty(v.shape, dtype=np.uint32)
    zero = v == 0
    nz = ~zero
    vi = v[nz]
    # msb index via bit_length: uint64 -> object-free float trick is lossy,
    # use np.frexp on float128? No: derive from the hi/lo split exactly.
    e = np.zeros(vi.shape, dtype=np.uint32)
    x = vi.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = x >= (np.uint64(1) << np.uint64(shift))
        e[big] += np.uint32(shift)
        x[big] >>= np.uint64(shift)
    # mantissa: bits below the leading 1, left-aligned to MANTISSA bits
    m64 = vi ^ (np.uint64(1) << e.astype(np.uint64))          # strip leading 1
    down = e.astype(np.int64) - MANTISSA
    m = np.where(
        down >= 0,
        (m64 >> np.maximum(down, 0).astype(np.uint64)),
        (m64 << np.maximum(-down, 0).astype(np.uint64)),
    ).astype(np.uint32) & np.uint32((1 << MANTISSA) - 1)
    code = (e << np.uint32(MANTISSA)) | m
    out[nz] = code
    out[zero] = 0
    inf = v == np.uint64(0xFFFFFFFFFFFFFFFF)
    out[(out == _SENTINEL) & ~inf] = _SENTINEL - np.uint32(1)
    out[inf] = _SENTINEL
    return out


def decode_approx(codes: np.ndarray) -> np.ndarray:
    """uint32 codes → approximate uint64 values (cell lower bound).

    Exact enough for scale-dependent estimators (KMV cardinality, p-value
    null models): relative error <= 2^-26.  Sentinel → UINT64_MAX.
    """
    c = np.asarray(codes, dtype=np.uint32)
    e = (c >> np.uint32(MANTISSA)).astype(np.uint64)
    m = (c & np.uint32((1 << MANTISSA) - 1)).astype(np.uint64)
    down = e.astype(np.int64) - MANTISSA
    frac = np.where(
        down >= 0,
        m << np.maximum(down, 0).astype(np.uint64),
        m >> np.maximum(-down, 0).astype(np.uint64),
    )
    v = (np.uint64(1) << e) | frac
    v[c == 0] = np.uint64(0)
    v[c == _SENTINEL] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return v


def lo_plane_np(codes: np.ndarray) -> np.ndarray:
    """Host: the derived lo plane for compact codes — 0 for values, INF for
    the sentinel (one definition; used by store save/load and the engine)."""
    return np.where(codes == _SENTINEL, np.uint32(0xFFFFFFFF),
                    np.uint32(0)).astype(np.uint32)


# ------------------------------------------------------------ int32 order keys


def keys32_from_codes(codes: np.ndarray) -> np.ndarray:
    """numpy uint32 codes → int32 order keys."""
    return (np.asarray(codes, dtype=np.uint32) ^ _SIGN32).view(np.int32)


def codes_from_keys32(keys) -> np.ndarray:
    """int32 order keys (numpy or a torch tensor) → numpy uint32 codes."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    return np.asarray(keys, dtype=np.int32).view(np.uint32) ^ _SIGN32


# ------------------------------------------------------------- device side


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Branchless count-leading-zeros of uint32 values held in an int64
    tensor (clz(0) == 32)."""
    n = torch.full_like(x, 32)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        n = torch.where(big, n - shift, n)
        x = torch.where(big, x >> shift, x)
    return n - x  # x is 1 where any bit was set, 0 otherwise


def encode_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 planes → uint32 monotone codes, as int64 tensors
    (int32 inputs are read as raw uint32 bits).  Bit-identical to
    encode_u64 on join(hi, lo)."""
    hi = hi.to(torch.int64) & U32
    lo = lo.to(torch.int64) & U32
    hi_zero = hi == 0
    clz = torch.where(hi_zero, 32 + _clz32(lo), _clz32(hi))
    e = 63 - clz  # msb index; garbage for v == 0, masked below
    # 64-bit left shift by (clz + 1) to drop the leading 1 and left-align:
    # sh in [1, 64]; take the top MANTISSA bits of the result's hi word.
    sh = clz + 1
    big = sh >= 32  # value fits entirely in lo after the shift crosses words
    sh32 = torch.where(big, sh - 32, sh) & 31
    back = (32 - sh32) & 31
    lo_part = torch.where(sh32 == 0, 0, lo >> back)
    top = torch.where(big, (lo << sh32) & U32, ((hi << sh32) & U32) | lo_part)
    top = torch.where(sh == 64, 0, top)  # v == 1: no bits below the leading 1
    m = top >> (32 - MANTISSA)
    code = (e << MANTISSA) | m
    code = torch.where(hi_zero & (lo == 0), 0, code)
    inf = (hi == U32) & (lo == U32)
    code = torch.where((code == U32) & ~inf, U32 - 1, code)
    return torch.where(inf, U32, code)


def compact_rows(keys: torch.Tensor) -> torch.Tensor:
    """Device-side row compaction: sorted int64 order-key sketch rows
    [..., s] → sorted deduplicated int32 code keys [..., s], bit-identical
    to SketchIndex.to_compact's host pipeline (encode → within-row dup →
    sentinel → re-sort)."""
    raw = keys ^ u64.SIGN_BIT
    codes = encode_pair((raw >> 32) & U32, raw & U32)
    dup = torch.zeros_like(codes, dtype=torch.bool)
    dup[..., 1:] = codes[..., 1:] == codes[..., :-1]
    codes = codes.masked_fill(dup, U32)
    return torch.sort((codes - (1 << 31)).to(torch.int32), dim=-1).values


def lo_plane(keys32: torch.Tensor) -> torch.Tensor:
    """Device version of lo_plane_np on int32 code keys: the uint32 lo plane
    (0 for values, 0xFFFFFFFF for the sentinel) as an int64 tensor."""
    return torch.where(keys32 == INF_KEY32, U32, 0).to(torch.int64)
