"""Canonical ntHash (v1) of every k-mer window, in plain torch, and bottom-s
sketches of those hashes: a frozen copy of the formulas the port's
sketches follow, written straight from their definition and importing
nothing of the program.

  base codes   A=0, C=1, G=2, T=3; any other code is invalid
  forward      F(p) = XOR_{i<k} rol^{k-1-i}(SEED[c[p+i]])
  reverse      R(p) = XOR_{i<k} rol^{i}(SEED[3 - c[p+i]])
  canonical    H(p) = min(F(p), R(p)) as unsigned 64-bit values
  valid        every base of the window valid, and H != 2**64 - 1

A bottom-s sketch is the s smallest distinct valid H of a sequence.
Hashes are returned as int64 order keys (H with its top bit flipped), so a
signed sort orders them as unsigned; an invalid window gives INF_KEY.
"""

from __future__ import annotations

import numpy as np
import torch

SEEDS = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456)
MASK64 = (1 << 64) - 1
INF_KEY = (1 << 63) - 1
SIGN = -(1 << 63)


def _rol(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & MASK64 if r else v


def _signed(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def _table(values, device) -> torch.Tensor:
    # code 4 and up (invalid) looks up 0; the window is masked anyway
    return torch.tensor([_signed(v) for v in values] + [0] * 252, dtype=torch.int64,
                        device=device)


def canonical_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Order keys of every window of `codes` ([..., L] uint8) → [..., L-k+1]
    int64; INF_KEY where the window is invalid."""
    n = codes.shape[-1] - k + 1
    if n <= 0:
        return torch.empty(codes.shape[:-1] + (0,), dtype=torch.int64, device=codes.device)
    c = codes.long()
    fwd = torch.zeros(c.shape[:-1] + (n,), dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    for i in range(k):
        w = c[..., i:i + n]
        fwd ^= _table([_rol(SEEDS[b], k - 1 - i) for b in range(4)], c.device)[w]
        rev ^= _table([_rol(SEEDS[3 - b], i) for b in range(4)], c.device)[w]
    key = torch.minimum(fwd ^ SIGN, rev ^ SIGN)
    bad = torch.zeros(c.shape[:-1] + (c.shape[-1] + 1,), dtype=torch.int64, device=c.device)
    bad[..., 1:] = torch.cumsum((c > 3).long(), dim=-1)
    ok = (bad[..., k:] - bad[..., :n]) == 0
    return torch.where(ok, key, INF_KEY)


def to_codes32(keys: torch.Tensor) -> torch.Tensor:
    """The control's precision: each key's value cut to its top 32 bits and
    put back in place (value & ~(2**32 - 1)); INF_KEY stays."""
    cut = ((keys ^ SIGN) >> 32) << 32
    return torch.where(keys == INF_KEY, keys, cut ^ SIGN)


def bottom_s(keys: torch.Tensor, s: int) -> torch.Tensor:
    """The s smallest distinct valid keys of a 1-D key tensor, sorted."""
    vals = torch.unique(keys[keys != INF_KEY])
    return vals[:s]


def sketch_table(rows, s: int) -> torch.Tensor:
    """[N, s] INF-padded table of N sketches (1-D sorted key tensors)."""
    rows = list(rows)
    dev = rows[0].device if rows else "cpu"
    out = torch.full((len(rows), s), INF_KEY, dtype=torch.int64, device=dev)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return out


def dedup_rows(table: torch.Tensor) -> torch.Tensor:
    """Sorted rows with repeated values replaced by INF_KEY and pushed to
    the end (a table cut to 32-bit codes can repeat a value)."""
    v = torch.sort(table, dim=1).values
    dup = torch.zeros_like(v, dtype=torch.bool)
    dup[:, 1:] = v[:, 1:] == v[:, :-1]
    return torch.sort(v.masked_fill(dup, INF_KEY), dim=1).values


def u64(keys: torch.Tensor) -> np.ndarray:
    """Order keys → numpy uint64 values."""
    return (keys ^ SIGN).cpu().numpy().view(np.uint64)
