"""Sketching parameters.

Capability contract: SURVEY.md §2 (C10) and §5 "Config / flag system".
The reference (Malfoy/Miekki, Mash-family CLI) keys every sketch on (k, s,
hash-function version) and refuses to compare sketches built with mismatched
parameters; we enforce the same invariant here.  (Reference source was
unavailable at survey time — see SURVEY.md §0 — so the contract is anchored
to BASELINE.json configs: k=31, s=10_000.)
"""

from __future__ import annotations

import dataclasses

# Version tag for the hash function spec implemented in miekki_tpu.oracle.nthash.
# Bump if the recurrence or the seed table ever changes.
HASH_VERSION = "nthash64-v1"

DEFAULT_K = 31
DEFAULT_S = 10_000


@dataclasses.dataclass(frozen=True)
class SketchParams:
    """Immutable sketch parameters embedded in every sketch-index header.

    Attributes:
      k: k-mer length (1 <= k <= 64 is representable; windows with any
         non-ACGT base are skipped).
      s: sketch size — the number of smallest distinct canonical hash values
         retained per genome (bottom-s MinHash).
      hash_version: identifier of the rolling-hash spec; sketches with
         different hash versions are incomparable.
      compact: True when sketch values are stored as 32-bit monotone
         fingerprints (ops/compact.py — HyperMinHash-style 2x index
         compression, PAPERS.md).  Compact and raw sketches are
         incomparable (equality semantics differ), which the dataclass
         equality in validate_compatible enforces automatically.
    """

    k: int = DEFAULT_K
    s: int = DEFAULT_S
    hash_version: str = HASH_VERSION
    compact: bool = False

    def __post_init__(self) -> None:
        if not (1 <= self.k <= 64):
            raise ValueError(f"k must be in [1, 64], got {self.k}")
        if self.s < 1:
            raise ValueError(f"s must be >= 1, got {self.s}")

    def validate_compatible(self, other: "SketchParams") -> None:
        """Raise if two sketches cannot be compared (Mash does the same check)."""
        if self != other:
            raise ValueError(
                f"incompatible sketch params: {self} vs {other}; "
                "re-sketch with matching (k, s, hash_version)"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SketchParams":
        return cls(k=int(d["k"]), s=int(d["s"]),
                   hash_version=str(d["hash_version"]),
                   compact=bool(d.get("compact", False)))
