"""Compact sketches (the index format 2 encoding) in plain torch, written
from the format's definition and importing nothing of the program.

A 64-bit value v becomes a 32-bit code

    code = (e << 26) | m

where the exponent e is the index of v's most significant bit and the
mantissa m is the 26 bits below that leading 1, left-aligned (padded with
zeros below when fewer than 26 bits lie under it).  0 has code 0; the
padding value 2**64 - 1 has the sentinel code 0xFFFFFFFF; any other value
whose code would be the sentinel gets 0xFFFFFFFE.  The map is monotone but
not one-to-one, so a compact sketch row is its codes with every code equal
to the one before it turned into the sentinel, sorted again.

Codes travel as int64 order keys (the code's value with its top bit
flipped), the sentinel as INF_KEY, so `compare.pair_counts` counts compact
rows as it counts raw ones.
"""

from __future__ import annotations

import torch

from .nthash import INF_KEY, SIGN, dedup_rows

MANTISSA = 26
SENTINEL = 0xFFFFFFFF
CHUNK_ROWS = 4096  # rows encoded at a time


def _msb32(x: torch.Tensor) -> torch.Tensor:
    """Index of the most significant bit of values below 2**32 (int64;
    -1 for 0): frexp's exponent, exact for these integers in float64."""
    return torch.frexp(x.double()).exponent.long() - 1


def encode(keys: torch.Tensor) -> torch.Tensor:
    """Codes (int64 holding 0 .. 2**32 - 1) of the values of int64 order
    keys (INF_KEY, the value 2**64 - 1, gives the sentinel)."""
    v = keys ^ SIGN  # the u64 value's bits
    hi = (v >> 32) & 0xFFFFFFFF
    lo = v & 0xFFFFFFFF
    e = torch.where(hi > 0, 32 + _msb32(hi), _msb32(lo))
    below = torch.where(e == 63, (1 << 63) - 1,
                        torch.bitwise_left_shift(torch.ones_like(e), e.clamp(0, 62)) - 1)
    rest = v & below  # the bits under the leading 1
    m = torch.where(e >= MANTISSA, rest >> (e - MANTISSA).clamp(min=0),
                    rest << (MANTISSA - e).clamp(min=0))
    code = (e << MANTISSA) | m
    code = torch.where(v == 0, 0, code)
    code = torch.where(code == SENTINEL, SENTINEL - 1, code)
    return torch.where(keys == INF_KEY, SENTINEL, code)


def code_keys(codes: torch.Tensor) -> torch.Tensor:
    """Order keys of codes; the sentinel becomes INF_KEY."""
    return torch.where(codes == SENTINEL, INF_KEY, codes ^ SIGN)


def compact_table(keys: torch.Tensor, chunk: int = CHUNK_ROWS) -> torch.Tensor:
    """[N, s] int64 order keys of raw sketch rows (sorted, INF-padded) →
    [N, s] int64 order keys of their compact rows: codes with repeats
    turned into the sentinel, sorted, INF-padded."""
    out = torch.empty_like(keys)
    for o in range(0, keys.shape[0], chunk):
        codes = torch.sort(encode(keys[o:o + chunk]), dim=1).values
        rep = torch.zeros_like(codes, dtype=torch.bool)
        rep[:, 1:] = codes[:, 1:] == codes[:, :-1]
        codes = torch.sort(codes.masked_fill(rep, SENTINEL), dim=1).values
        out[o:o + chunk] = code_keys(codes)
    return out


def to_codes16(keys: torch.Tensor, chunk: int = CHUNK_ROWS) -> torch.Tensor:
    """The control's precision for compact rows (order keys of codes): each
    code cut to its top 16 bits (code & 0xFFFF0000), repeats pushed out;
    INF_KEY stays.  In place, `chunk` rows at a time."""
    for o in range(0, keys.shape[0], chunk):
        part = keys[o:o + chunk]
        cut = ((part ^ SIGN) >> 16) << 16
        part.copy_(dedup_rows(torch.where(part == INF_KEY, part, cut ^ SIGN)))
    return keys
