"""Pure-numpy uint64 oracle for the ntHash-style rolling hash.

This module IS the hash-function specification for the whole framework: the
TPU path (miekki_tpu.ops) must match it bit-for-bit.  Contract source:
SURVEY.md §2.1 (the reference source mount was empty — SURVEY.md §0 — so the
published ntHash v1 recurrence (Mohamadi et al. 2016, Bioinformatics) with its
standard per-base seeds is the frozen spec, per the survey's citation policy).

Spec (all arithmetic in uint64, rotations mod 64):

  base codes:      A=0, C=1, G=2, T=3; anything else is invalid (code 4).
  complement:      comp(b) = 3 - b.
  seeds:           SEEDS[4] — fixed 64-bit constants per base (ntHash v1).
  forward hash:    F(p) = XOR_{i=0}^{k-1} rol^{k-1-i}( SEEDS[s[p+i]] )
  reverse hash:    R(p) = XOR_{i=0}^{k-1} rol^{i}    ( SEEDS[comp(s[p+i])] )
                   (= forward hash of the reverse-complement k-mer)
  canonical hash:  H(p) = min(F(p), R(p))            (strand-independent)
  validity:        a window is valid iff all k bases are in {A,C,G,T}; in
                   addition the value UINT64_MAX is reserved as the invalid
                   sentinel — a (probability 2^-64) canonical hash equal to
                   UINT64_MAX is treated as invalid so that device code can use
                   it as +inf padding bit-compatibly.

Two independent implementations are provided and cross-checked in tests:
  * hash_kmers_scalar — the literal O(1)-per-base rolling recurrence
    (init + slide), mirroring the reference C++ hot loop (SURVEY.md §3.1).
  * hash_kmers — closed-form vectorized version via prefix-XOR of
    position-rotated seeds; this is the exact algebraic form the TPU kernel
    uses (SURVEY.md §7 design stance, item 1).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

# ntHash v1 per-base seeds (A, C, G, T) — SURVEY.md §2.1.
SEED_A = np.uint64(0x3C8BFBB395C60474)
SEED_C = np.uint64(0x3193C18562A02B4C)
SEED_G = np.uint64(0x20323ED082572324)
SEED_T = np.uint64(0x295549F54BE24456)
SEEDS = np.array([SEED_A, SEED_C, SEED_G, SEED_T], dtype=np.uint64)

INVALID_CODE = 4  # non-ACGT


def rol64(x: np.ndarray, r) -> np.ndarray:
    """Rotate-left uint64 by r (scalar or array), exponents taken mod 64."""
    x = np.asarray(x, dtype=np.uint64)
    r = np.asarray(r)
    r64 = (r % 64).astype(np.uint64)
    # r64 == 0 must not produce a shift by 64 (undefined); clamp the shift
    # amount itself, then mask the result.
    left = np.left_shift(x, r64)
    ramt = np.where(r64 == 0, np.uint64(1), np.uint64(64) - r64)
    right = np.where(r64 == 0, np.uint64(0), np.right_shift(x, ramt))
    return (left | right).astype(np.uint64)


def ror64(x: np.ndarray, r) -> np.ndarray:
    """Rotate-right uint64 by r (mod 64)."""
    r = np.asarray(r)
    return rol64(x, (-r) % 64)


def _check_codes(codes: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes)
    if codes.ndim != 1:
        raise ValueError("codes must be 1-D")
    return codes.astype(np.int64, copy=False)


def hash_kmers_scalar(codes: np.ndarray, k: int):
    """Reference rolling implementation: init + O(1) slide per base.

    Mirrors the reference hot loop (SURVEY.md §3.1, components C2-C4): one
    rol + xors per base per strand.  Returns (canonical uint64[n], valid
    bool[n]) for n = len(codes) - k + 1 window starts (n may be 0).
    """
    codes = _check_codes(codes)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)

    valid_base = (codes >= 0) & (codes < 4)
    safe = np.where(valid_base, codes, 0)
    seeds_f = SEEDS[safe]                 # seed of each base
    seeds_r = SEEDS[3 - safe]             # seed of each base's complement

    out = np.zeros(n, dtype=np.uint64)
    valid = np.zeros(n, dtype=bool)

    # init window [0, k)
    fh = np.uint64(0)
    rh = np.uint64(0)
    for i in range(k):
        fh = rol64(fh, 1) ^ seeds_f[i]
        rh ^= rol64(seeds_r[i], i)
    invalid_in_window = int(np.count_nonzero(~valid_base[:k]))

    for p in range(n):
        if p > 0:
            b_out, b_in = p - 1, p + k - 1
            fh = rol64(fh, 1) ^ rol64(seeds_f[b_out], k) ^ seeds_f[b_in]
            rh = ror64(rh ^ rol64(seeds_r[b_out], 0), 1) ^ rol64(seeds_r[b_in], k - 1)
            invalid_in_window += int(~valid_base[b_in]) - int(~valid_base[b_out])
        h = min(fh, rh)
        out[p] = h
        valid[p] = (invalid_in_window == 0) and (h != UINT64_MAX)
    return out, valid


def hash_kmers(codes: np.ndarray, k: int):
    """Closed-form vectorized canonical k-mer hashing (matches scalar bitwise).

    Algebra (SURVEY.md §7 item 1): with u[j] = ror^j(SEEDS[s_j]) and
    v[j] = rol^j(SEEDS[comp(s_j)]), and P/Q their exclusive prefix-XORs,
      F(p) = rol^{(k-1+p) mod 64}( P[p+k] ^ P[p] )
      R(p) = ror^{p mod 64}      ( Q[p+k] ^ Q[p] )
    Returns (canonical uint64[n], valid bool[n]).
    """
    codes = _check_codes(codes)
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)

    valid_base = (codes >= 0) & (codes < 4)
    safe = np.where(valid_base, codes, 0)
    j = np.arange(L, dtype=np.int64)
    u = ror64(SEEDS[safe], j)
    v = rol64(SEEDS[3 - safe], j)

    def exclusive_prefix_xor(a):
        p = np.zeros(len(a) + 1, dtype=np.uint64)
        np.bitwise_xor.accumulate(a, out=p[1:])
        return p

    P = exclusive_prefix_xor(u)
    Q = exclusive_prefix_xor(v)
    p = np.arange(n, dtype=np.int64)
    fh = rol64(P[p + k] ^ P[p], (k - 1 + p) % 64)
    rh = ror64(Q[p + k] ^ Q[p], p % 64)
    h = np.minimum(fh, rh)

    bad = (~valid_base).astype(np.int64)
    cbad = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(bad, out=cbad[1:])
    window_ok = (cbad[p + k] - cbad[p]) == 0
    valid = window_ok & (h != UINT64_MAX)
    return h, valid


def canonical_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """All valid canonical k-mer hashes of a code sequence (with duplicates)."""
    h, valid = hash_kmers(codes, k)
    return h[valid]
