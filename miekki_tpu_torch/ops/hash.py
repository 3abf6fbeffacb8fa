"""Canonical k-mer hashing in plain torch (counterpart of the JAX
package's ops/hash.py).

The same closed form of the ntHash recurrence (spec frozen in
oracle.nthash): with
  u[j] = ror^{j mod 64}(SEEDS[s_j]),  v[j] = rol^{j mod 64}(SEEDS[comp(s_j)]),
  F(p) = rol^{(k-1+p) mod 64}( XOR_{j=p}^{p+k-1} u[j] )
  R(p) = ror^{p mod 64}      ( XOR_{j=p}^{p+k-1} v[j] )
  H(p) = min(F, R), INF where any base of the window is invalid.

The k-window XOR and the window validity use the reference's log2(k)
shift-XOR doubling.  This module is the plain version of kernel K1
(ops.cuda_hash): the CPU path runs it, and the card is held to it.
Output values are int64 order keys (ops.u64), INF_KEY for invalid
windows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle import nthash as _oracle
from . import u64

INVALID_CODE = 4

# raw u64 bits of the per-base seeds, forward and complement (SEEDS[3 - b])
_SEED_F = _oracle.SEEDS.view(np.int64)
_SEED_R = _oracle.SEEDS[::-1].copy().view(np.int64)


def _shift(x: torch.Tensor, m: int) -> torch.Tensor:
    """x[..., m:] followed by m zeros."""
    return torch.cat([x[..., m:], x.new_zeros(x.shape[:-1] + (m,))], dim=-1)


def _window_reduce(x: torch.Tensor, k: int, n: int, op) -> torch.Tensor:
    """out[p] = op-fold of x[p + t] over t < k, for p in [0, n), by the
    binary decomposition of k (doubling A_{2m}[p] = A_m[p] op A_m[p+m])."""
    res = x.new_zeros(x.shape[:-1] + (n,))
    offset, m = 0, 1
    while m <= k:
        if k & m:
            res = op(res, x[..., offset:offset + n])
            offset += m
        if (m << 1) <= k:
            x = op(x, _shift(x, m))
        m <<= 1
    return res


def hash_block_math(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Code block [..., L] (any integer dtype, 0..3 valid) → int64 order
    keys [..., n], n = L - k + 1; INF_KEY where the window is invalid."""
    L = codes.shape[-1]
    n = L - k + 1
    dev = codes.device
    c = codes.to(torch.int64)
    invalid = (c < 0) | (c >= 4)
    safe = torch.where(invalid, 0, c)

    j = torch.arange(L, device=dev) % 64
    u = u64.ror(torch.as_tensor(_SEED_F, device=dev)[safe], j)
    v = u64.rol(torch.as_tensor(_SEED_R, device=dev)[safe], j)
    wu = _window_reduce(u, k, n, torch.bitwise_xor)
    wv = _window_reduce(v, k, n, torch.bitwise_xor)

    p = torch.arange(n, device=dev)
    fh = u64.rol(wu, (k - 1 + p) % 64)
    rh = u64.ror(wv, p % 64)
    h = torch.minimum(u64.to_keys(fh), u64.to_keys(rh))

    bad = _window_reduce(invalid, k, n, torch.bitwise_or)
    return torch.where(bad, u64.INF_KEY, h)


def hash_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical hash keys of every k-window of `codes` ([..., L]);
    bitwise equal to oracle.nthash.hash_kmers (invalid → INF_KEY)."""
    L = codes.shape[-1]
    if L - k + 1 <= 0:
        raise ValueError(f"sequence shorter than k: {L} < {k}")
    return hash_block_math(codes, k)
