"""Pure-numpy oracle for bottom-s MinHash sketch construction.

Contract: SURVEY.md §2.1 "Bottom-s semantics" (component C5; reference source
unavailable — SURVEY.md §0): a sketch is the s smallest **distinct** canonical
hash values of a genome, stored sorted ascending; genomes with fewer than s
distinct valid k-mers keep all of them.  UINT64_MAX never appears in a sketch
(reserved as the invalid/+inf sentinel — see oracle.nthash).
"""

from __future__ import annotations

import numpy as np

from . import nthash


def bottom_s(hashes: np.ndarray, s: int) -> np.ndarray:
    """s smallest distinct values of `hashes` (sorted ascending, uint64)."""
    hashes = np.asarray(hashes, dtype=np.uint64)
    distinct = np.unique(hashes)  # sorted + distinct
    distinct = distinct[distinct != nthash.UINT64_MAX]
    return distinct[:s]


def bottom_s_min_copies(hashes: np.ndarray, s: int, m: int) -> np.ndarray:
    """s smallest distinct values occurring at least m times (the
    `mash sketch -m` abundance filter for read sets — error k-mers appear
    once, real ones at ~coverage depth; Mash-family convention [K],
    reference source unavailable — SURVEY.md §0)."""
    hashes = np.asarray(hashes, dtype=np.uint64)
    vals, cnts = np.unique(hashes, return_counts=True)
    keep = (vals != nthash.UINT64_MAX) & (cnts >= m)
    return vals[keep][:s]


def sketch_codes(codes: np.ndarray, k: int, s: int) -> np.ndarray:
    """Sketch a single 2-bit-coded sequence (code 4 = invalid base)."""
    return bottom_s(nthash.canonical_hashes(codes, k), s)


def sketch_records(code_seqs, k: int, s: int) -> np.ndarray:
    """Sketch a genome given as multiple records (contigs/reads).

    Windows never span record boundaries (SURVEY.md §2 C2: sequence-boundary
    breaks); the sketch pools hashes from all records.
    """
    parts = [nthash.canonical_hashes(c, k) for c in code_seqs]
    if not parts:
        return np.zeros(0, dtype=np.uint64)
    return bottom_s(np.concatenate(parts), s)


def pad_sketch(sketch: np.ndarray, s: int) -> np.ndarray:
    """Pad a (possibly short) sketch to exactly s with the +inf sentinel."""
    sketch = np.asarray(sketch, dtype=np.uint64)
    if len(sketch) > s:
        raise ValueError(f"sketch longer than s: {len(sketch)} > {s}")
    out = np.full(s, nthash.UINT64_MAX, dtype=np.uint64)
    out[: len(sketch)] = sketch
    return out
