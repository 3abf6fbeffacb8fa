"""2-bit DNA encoding (component C2 — SURVEY.md §2; tokenizer contract §1 L1).

ASCII bytes → codes {A:0, C:1, G:2, T:3}, case-insensitive; every other byte
(N, ambiguity codes, '-', etc.) maps to INVALID_CODE=4, which invalidates any
k-mer window covering it.  A single LUT gather over uint8 — the host-side
analog of the reference's per-byte `nuc2int` (reference source unavailable,
SURVEY.md §0).
"""

from __future__ import annotations

import numpy as np

INVALID_CODE = 4

_LUT = np.full(256, INVALID_CODE, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _LUT[ord(_ch)] = _code
    _LUT[ord(_ch.lower())] = _code

SEPARATOR_CODE = INVALID_CODE  # inserted between records in packed streams


def pack_base5(codes: np.ndarray) -> np.ndarray:
    """Pack a code array (values 0..4 — ACGT + INVALID) 3 codes per byte
    along the LAST axis (base-5 digits: b = 25*c0 + 5*c1 + c2 <= 124).

    The host→device transfer of the sketch pipeline then carries 1/3 the
    bytes of raw uint8 codes — exact (INVALID survives, unlike 2-bit
    packing), cheap on both ends (one fused multiply-add host-side, two
    div/mods device-side), and bit-identical end to end (tested).  The
    last axis is INVALID-padded to a multiple of 3 first; the unpacker
    trims with the original width."""
    w = codes.shape[-1]
    wp = -(-w // 3) * 3
    if wp != w:
        pad = [(0, 0)] * (codes.ndim - 1) + [(0, wp - w)]
        codes = np.pad(codes, pad, constant_values=INVALID_CODE)
    tri = codes.reshape(codes.shape[:-1] + (wp // 3, 3))
    return (tri[..., 0] * np.uint8(25) + tri[..., 1] * np.uint8(5)
            + tri[..., 2])


def encode(seq: bytes | bytearray | memoryview | np.ndarray) -> np.ndarray:
    """ASCII sequence bytes → uint8 codes in {0..4}."""
    buf = np.frombuffer(bytes(seq), dtype=np.uint8) if not isinstance(seq, np.ndarray) else seq
    return _LUT[buf]


def encode_str(seq: str) -> np.ndarray:
    return encode(seq.encode("ascii"))


def pack_records(code_seqs, k: int) -> np.ndarray:
    """Concatenate per-record code arrays with k-1 invalid separator bases.

    Windows spanning a record boundary then cover >=1 invalid base and are
    masked automatically — this lets one flat device pass hash a whole batch
    of records (SURVEY.md §4 "sequence boundaries").  k-1 separators (not 1)
    keep window *positions* of each record recoverable if needed.
    """
    sep = np.full(k - 1, SEPARATOR_CODE, dtype=np.uint8) if k > 1 else np.zeros(0, np.uint8)
    parts = []
    for i, c in enumerate(code_seqs):
        if i:
            parts.append(sep)
        parts.append(np.asarray(c, dtype=np.uint8))
    if not parts:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(parts)
