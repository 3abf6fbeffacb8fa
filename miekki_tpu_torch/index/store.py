"""Sketch index: the on-disk and in-memory sketch database (counterpart of
the JAX package's index/store.py).

Same `.npz` format: version 1 holds the (hi, lo) uint32 planes of the
padded [N, s] sketch table plus a JSON header (format version, params,
names); version 2 is a compact index (32-bit fingerprints, ops.compact)
and leaves out `lo`, which follows from `hi`.  An index written by either
package loads in the other.  On the device the table is one [N, s] int64
order-key tensor, or for a compact index one [N, s] int32 code-key tensor
(`index_to_device`).  An index whose sketches were just made on a device
may carry that tensor as `device_planes`; it is never serialized.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..oracle import nthash
from ..ops import compact as _compact
from ..ops import u64
from ..params import SketchParams
from ..utils import device as _device

_FORMAT_VERSION = 1
# Compact files (32-bit fingerprints, no lo array) carry a higher version,
# so a reader without compact support refuses them cleanly.
_FORMAT_VERSION_COMPACT = 2


class SketchIndex:
    """In-memory [N, s] sketch table: sorted ascending, UINT64_MAX-padded."""

    def __init__(self, params: SketchParams, names: List[str], hi: np.ndarray, lo: np.ndarray):
        if hi.shape != lo.shape or hi.ndim != 2 or hi.shape[1] != params.s:
            raise ValueError(f"bad sketch table shape: {hi.shape} for s={params.s}")
        if len(names) != hi.shape[0]:
            raise ValueError("names/table length mismatch")
        self.params = params
        self.names = list(names)
        self.hi = np.ascontiguousarray(hi, dtype=np.uint32)
        self.lo = np.ascontiguousarray(lo, dtype=np.uint32)
        self._device_planes = None

    @property
    def device_planes(self) -> Optional[torch.Tensor]:
        """The same table on a device, in index_to_device's form and
        unpadded: int64 order keys [N, s], or int32 code keys for a compact
        index.  Attached by the builder (engine._build_index_from_codes,
        MIEKKI_KEEP_DEV) or by a tool whose DB was made on the card, so
        engine.dist_tiles slices its blocks there instead of forming them
        from the host planes.  Never serialized; an index made by load,
        load_sharded, to_compact or slicing has none."""
        return self._device_planes

    @device_planes.setter
    def device_planes(self, planes: Optional[torch.Tensor]) -> None:
        if planes is not None:
            want = torch.int32 if self.params.compact else torch.int64
            shape = (len(self), self.params.s)
            if (not isinstance(planes, torch.Tensor) or planes.dtype != want
                    or tuple(planes.shape) != shape or not planes.is_contiguous()):
                got = (f"{planes.dtype} {tuple(planes.shape)}"
                       if isinstance(planes, torch.Tensor) else type(planes).__name__)
                raise ValueError(f"device planes must be a contiguous {want} "
                                 f"tensor of shape {shape}, got {got}")
        self._device_planes = planes

    def __len__(self) -> int:
        return self.hi.shape[0]

    @classmethod
    def from_sketches(
        cls, sketches: Sequence[np.ndarray], names: Sequence[str], params: SketchParams
    ) -> "SketchIndex":
        n = len(sketches)
        table = np.full((n, params.s), nthash.UINT64_MAX, dtype=np.uint64)
        for i, sk in enumerate(sketches):
            sk = np.asarray(sk, dtype=np.uint64)
            if len(sk) > params.s:
                raise ValueError(f"sketch {i} longer than s={params.s}")
            table[i, : len(sk)] = sk
        hi = (table >> np.uint64(32)).astype(np.uint32)
        lo = (table & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return cls(params, list(names), hi, lo)

    def sketch_u64(self, i: int) -> np.ndarray:
        """Valid (non-sentinel) sketch values of genome i as uint64.

        For a compact index these are the stored codes embedded in u64
        (code << 32), the comparison domain."""
        row = (self.hi[i].astype(np.uint64) << np.uint64(32)) | self.lo[i]
        return row[row != nthash.UINT64_MAX]

    def to_compact(self) -> "SketchIndex":
        """32-bit fingerprint copy of this index (ops.compact): values become
        monotone uint32 codes in the hi plane (lo = 0; the sentinel stays
        UINT64_MAX), params.compact = True."""
        if self.params.compact:
            return self
        codes = _compact.encode_u64(
            (self.hi.astype(np.uint64) << np.uint64(32)) | self.lo)
        # Two distinct values can share a code, and the merge counts read
        # consecutive equal values as an intersection: a duplicate within a
        # row would match any partner.  Codes are sorted (the map is
        # monotone), so duplicates become sentinels and one re-sort pushes
        # them to the tail.
        dup = np.zeros_like(codes, dtype=bool)
        dup[:, 1:] = codes[:, 1:] == codes[:, :-1]
        codes = np.sort(np.where(dup, np.uint32(0xFFFFFFFF), codes), axis=1)
        params = dataclasses.replace(self.params, compact=True)
        return SketchIndex(params, self.names, codes, _compact.lo_plane_np(codes))

    def sizes(self) -> np.ndarray:
        full = (self.hi == 0xFFFFFFFF) & (self.lo == 0xFFFFFFFF)
        return (~full).sum(axis=1).astype(np.int64)

    def cardinalities(self) -> np.ndarray:
        """KMV estimate of each genome's distinct canonical-k-mer count (same
        estimator as oracle.compare.kmv_cardinality), in one vectorized pass:
        exact when a genome had fewer than s distinct k-mers, extrapolated
        from the s-th min otherwise.  A compact index decodes its codes to
        approximate values first and always extrapolates from the j-th min
        (its dedup can leave j < s codes for a large genome)."""
        n, s = self.hi.shape
        sentinel = (self.hi == 0xFFFFFFFF) & (self.lo == 0xFFFFFFFF)
        j = (s - sentinel.sum(axis=1)).astype(np.int64)  # valid counts
        last_col = np.maximum(j - 1, 0)
        rows = np.arange(n)
        if self.params.compact:
            v_last = _compact.decode_approx(self.hi[rows, last_col])
            rank, exact = j, j < 2
        else:
            v_last = ((self.hi[rows, last_col].astype(np.uint64) << np.uint64(32))
                      | self.lo[rows, last_col])
            rank, exact = s, j < s
        q = v_last.astype(np.float64) / 2.0 ** 64
        est = rank / np.maximum(2.0 * q - q * q, 1e-300) - 1.0
        return np.where(exact, j.astype(np.float64), est)

    # ---------- persistence ----------

    def _header(self) -> dict:
        return {
            "format_version": (_FORMAT_VERSION_COMPACT if self.params.compact
                               else _FORMAT_VERSION),
            "params": self.params.to_dict(),
            "names": self.names,
        }

    def save(self, path: str | os.PathLike) -> None:
        arrays = {"hi": self.hi}
        if not self.params.compact:  # a compact lo plane follows from hi
            arrays["lo"] = self.lo
        # through a file object: np.savez on a PATH appends ".npz"
        with open(path, "wb") as f:
            np.savez_compressed(
                f,
                header=np.frombuffer(json.dumps(self._header()).encode(),
                                     dtype=np.uint8),
                **arrays,
            )

    @classmethod
    def load(cls, path: str | os.PathLike) -> "SketchIndex":
        with np.load(path) as z:
            header = json.loads(bytes(z["header"]).decode())
            version = header.get("format_version")
            if version not in (_FORMAT_VERSION, _FORMAT_VERSION_COMPACT):
                raise ValueError(f"unsupported index format: {version}")
            params = SketchParams.from_dict(header["params"])
            hi = z["hi"]
            lo = (_compact.lo_plane_np(hi) if params.compact and "lo" not in z
                  else z["lo"])
            return cls(params, header["names"], hi, lo)

    def save_sharded(self, prefix: str, n_shards: int) -> List[str]:
        """Write n_shards files `<prefix>.shard{i:04d}-of-{n:04d}.npz`,
        splitting the genomes contiguously at np.linspace bounds (shards
        are empty when n_shards > N).  Returns the paths."""
        bounds = np.linspace(0, len(self), n_shards + 1).astype(int)
        paths = []
        for i in range(n_shards):
            a, b = bounds[i], bounds[i + 1]
            part = SketchIndex(self.params, self.names[a:b], self.hi[a:b], self.lo[a:b])
            path = f"{prefix}.shard{i:04d}-of-{n_shards:04d}.npz"
            part.save(path)
            paths.append(path)
        return paths

    @classmethod
    def load_sharded(cls, paths: Sequence[str]) -> "SketchIndex":
        parts = [cls.load(p) for p in sorted(paths)]
        params = parts[0].params
        for p in parts[1:]:
            params.validate_compatible(p.params)
        return cls(
            params,
            [n for p in parts for n in p.names],
            np.concatenate([p.hi for p in parts]),
            np.concatenate([p.lo for p in parts]),
        )


UPLOAD_CHUNK_VALUES = 1 << 26  # values per host key build and copy of a
# large table to a card (bounds the host's temporaries at ~1.5 GB)


def index_to_device(index: SketchIndex, device="cuda") -> torch.Tensor:
    """The index's (hi, lo) planes as one [N, s] int64 order-key tensor; a
    compact index's codes as one [N, s] int32 code-key tensor.  Built from
    the host planes (not from device_planes).  For a card the keys are
    built and copied UPLOAD_CHUNK_VALUES at a time into one device
    tensor."""
    dev = _device.resolve(device)

    def keys(a: int, b: int) -> np.ndarray:
        if index.params.compact:
            return _compact.keys32_from_codes(index.hi[a:b])
        return u64.keys_from_planes(index.hi[a:b], index.lo[a:b])

    n, s = index.hi.shape
    if dev.type == "cpu" or n * s <= UPLOAD_CHUNK_VALUES:
        return torch.from_numpy(keys(0, n)).to(dev)
    dtype = torch.int32 if index.params.compact else torch.int64
    out = torch.empty((n, s), dtype=dtype, device=dev)
    rows = max(1, UPLOAD_CHUNK_VALUES // s)
    for a in range(0, n, rows):
        b = min(a + rows, n)
        out[a:b].copy_(torch.from_numpy(keys(a, b)))
    return out
