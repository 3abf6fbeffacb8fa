"""Sketch intersection counts (counterpart of the JAX package's
ops/intersect.py, u64 and compact tile paths).

For a pair of sorted, distinct, INF-padded sketches A, B:

  merged   = sort(concat(A, B))
  dup[i]   = merged[i] == merged[i-1]  (and not INF)      # second of a pair
  distinct = valid & ~dup
  rank     = inclusive cumsum(distinct)                   # 1-based distinct rank

  shared_in_x = Σ dup & (rank <= s)     → Mash Jaccard numerator |X ∩ A ∩ B|
  union_size  = min(s, Σ distinct)      → |X|
  inter_full  = Σ dup                   → |A ∩ B| (containment numerator)

Values are int64 order keys (ops.u64) or, for compact indexes, int32
code keys (ops.compact); the padding sentinel is the dtype's maximum.
`tile_counts` and `tile_counts_compact` are the inner unit of the
all-vs-all scheduler.  Their route is one of the reference's
MIEKKI_INTERSECT values:

  * ``pallas`` (and ``auto``, unset and ``mxu``): kernel K3
    (ops.cuda_intersect) or K4 (ops.cuda_intersect32) on CUDA tensors,
    the plain batched merge below on CPU tensors;
  * ``bitonic``: a bitonic merge network of torch ops (`pair_counts_bitonic`)
    over the sketch width padded to a power of two, one broadcast merge
    per ROW_GROUP rows;
  * ``searchsorted``: `pair_counts` (a batched binary search) over every
    pair, ROW_GROUP rows at a time.

The last two are the reference's XLA routes written as torch ops; they run
on the tensors' device and launch no K3/K4.  No workload on the card
favours them (PERF.md times them far above K3/K4); they are there for the
reference's users.  The route is read from MIEKKI_INTERSECT by the tile
functions themselves, so no scheduler carries it.  The reference's
``mxu`` route counts tiles by one-hot matmuls over a sorted value stream,
a design for the TPU's matrix unit; on the card it is slower than K3/K4
at any tuning, so the value selects K3/K4 here and gives the same counts.

The per-pair and membership forms (`pair_counts`, `pair_counts_bitonic`,
`pair_counts_bitonic32`, `searchsorted_u64`, `member_u64`,
`containment_counts`) take keys where the reference takes (hi, lo) planes
or uint32 codes, and return its dict keys as int32.  `resolve_pairs`
counts named pairs of two host plane tables: the deferred pairs that the
reference's host-ring step files carry.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import u64

ROW_GROUP = 8  # rows per step of the plain tile version — bounds its
# [ROW_GROUP, Tj, 2 sp] merge temporaries
RESOLVE_BATCH = 8192  # pairs per merge of resolve_pairs without the native
# library (2 sp keys each)

# the values MIEKKI_INTERSECT takes, and those tile_counts takes
IMPLS = ("auto", "pallas", "bitonic", "searchsorted", "mxu")
TILE_IMPLS = ("auto", "pallas", "bitonic", "searchsorted")


def intersect_impl() -> str:
    """The dist route MIEKKI_INTERSECT names, read at call time: "bitonic"
    or "searchsorted" for those tile routes, else "pallas" (the
    reference's name of its tile kernel) for K3/K4 — for "auto", "mxu" or
    unset too: on a card the kernels, on the CPU their plain versions (the
    reference's off-TPU auto, searchsorted, is not taken: on the card
    K3/K4 are the measured choice).  Any other value raises."""
    impl = os.environ.get("MIEKKI_INTERSECT", "auto").lower()
    if impl not in IMPLS:
        raise ValueError(f"unknown MIEKKI_INTERSECT {impl!r}; expected one of "
                         f"{', '.join(IMPLS)}")
    return "pallas" if impl in ("auto", "mxu") else impl


def inf_key(dtype: torch.dtype) -> int:
    """Padding sentinel of a key table: INT64_MAX (u64 keys) or INT32_MAX
    (compact code keys)."""
    return torch.iinfo(dtype).max


def pair_counts_merge(a: torch.Tensor, b: torch.Tensor, s: int) -> dict:
    """Sort-merge counts of sketch pairs: a, b [..., sp] keys with the same
    leading shape → dict of int32 [...] (the reference count semantics)."""
    inf = inf_key(a.dtype)
    x = torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
    valid = x != inf
    dup = torch.zeros_like(valid)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
    dup &= valid
    distinct = valid & ~dup
    rank = torch.cumsum(distinct, dim=-1, dtype=torch.int32)
    i32 = torch.int32
    return {
        "shared_in_x": (dup & (rank <= s)).sum(-1, dtype=i32),
        "union_size": distinct.sum(-1, dtype=i32).clamp(max=s),
        "inter_full": dup.sum(-1, dtype=i32),
        "n_a": (a != inf).sum(-1, dtype=i32),
        "n_b": (b != inf).sum(-1, dtype=i32),
    }


def pair_counts(a: torch.Tensor, b: torch.Tensor, s: int) -> dict:
    """Exact counts of sketch pairs by binary search (the reference's
    pair_counts, batched): a, b [..., sp] sorted distinct INF-padded keys
    with the same leading shape → dict of int32 [...] (the
    pair_counts_merge keys).  A value of a at index i has distinct union
    rank i + #(b < v) - #(common values < v); it is in the bottom s of the
    union iff that rank is below s."""
    inf = inf_key(a.dtype)
    m = b.shape[-1]
    valid_a = a != inf
    if m:
        pos = torch.searchsorted(b.contiguous(), a.contiguous(), side="left")
        found = torch.gather(b, -1, pos.clamp(max=m - 1)) == a
        match = (pos < m) & found & valid_a
    else:
        pos = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
        match = torch.zeros_like(valid_a)
    match_i = match.to(torch.int32)
    shared_less = torch.cumsum(match_i, -1, dtype=torch.int32) - match_i
    i = torch.arange(a.shape[-1], dtype=torch.int32, device=a.device)
    rank = i + pos.to(torch.int32) - shared_less
    n_a = valid_a.sum(-1, dtype=torch.int32)
    n_b = (b != inf).sum(-1, dtype=torch.int32)
    inter = match_i.sum(-1, dtype=torch.int32)
    return {
        "shared_in_x": (match & (rank < s)).sum(-1, dtype=torch.int32),
        "union_size": (n_a + n_b - inter).clamp(max=s),
        "inter_full": inter,
        "n_a": n_a,
        "n_b": n_b,
    }


def pair_counts32(a: torch.Tensor, b: torch.Tensor, s: int) -> dict:
    """pair_counts on compact int32 code keys (the reference's
    pair_counts32)."""
    _check_dtype(torch.int32, a, b)
    return pair_counts(a, b, s)


def _check_dtype(dtype: torch.dtype, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != dtype:
            raise ValueError(f"expected {dtype} keys, got {x.dtype}")


def _bitonic_merge_u64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Bitonic MERGE of [..., 2s] keys whose first half is sorted ascending
    and second half descending (the whole row is bitonic): log2(2s)
    compare-exchange stages, at stage d the first of each pair (i, i + d)
    in a block of 2d keeping the minimum and the second the maximum.
    Returns the row sorted ascending (s must be a power of two)."""
    lead, n = x.shape[:-1], x.shape[-1]
    d = s
    while d >= 1:
        v = x.reshape(*lead, n // (2 * d), 2, d)
        lo, hi = v[..., 0, :], v[..., 1, :]
        x = torch.stack((torch.minimum(lo, hi), torch.maximum(lo, hi)), dim=-2)
        x = x.reshape(*lead, n)
        d //= 2
    return x


def _pair_counts_bitonic(a: torch.Tensor, b: torch.Tensor, s: int, name: str) -> dict:
    sp = a.shape[-1]
    if sp & (sp - 1) or b.shape[-1] != sp:
        raise ValueError(f"{name} needs equal power-of-two widths, got "
                         f"{a.shape[-1]} / {b.shape[-1]}")
    inf = inf_key(a.dtype)
    x = _bitonic_merge_u64(torch.cat([a, b.flip(-1)], dim=-1), sp)
    valid = x != inf
    dup = torch.zeros_like(valid)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
    dup &= valid
    distinct = valid & ~dup
    rank = torch.cumsum(distinct, dim=-1, dtype=torch.int32)
    i32 = torch.int32
    return {
        "shared_in_x": (dup & (rank <= s)).sum(-1, dtype=i32),
        "union_size": distinct.sum(-1, dtype=i32).clamp(max=s),
        "inter_full": dup.sum(-1, dtype=i32),
        "n_a": (a != inf).sum(-1, dtype=i32),
        "n_b": (b != inf).sum(-1, dtype=i32),
    }


def pair_counts_bitonic(a: torch.Tensor, b: torch.Tensor, s: int) -> dict:
    """Counts of sketch pairs through an explicit bitonic merge network:
    a, b [..., sp] int64 keys, sp a power of two (INF padding past s is
    allowed; counts are capped at the true s) → dict of int32 [...],
    bit-identical to pair_counts_merge."""
    _check_dtype(torch.int64, a, b)
    return _pair_counts_bitonic(a, b, s, "pair_counts_bitonic")


def pair_counts_bitonic32(a: torch.Tensor, b: torch.Tensor, s: int) -> dict:
    """pair_counts_bitonic on compact int32 code keys."""
    _check_dtype(torch.int32, a, b)
    return _pair_counts_bitonic(a, b, s, "pair_counts_bitonic32")


def resolve_pairs(rows: tuple, cols: tuple, amb_i: np.ndarray, amb_j: np.ndarray,
                  s: int) -> np.ndarray:
    """Exact shared_in_x of the pairs (row amb_i[k], column amb_j[k]) of two
    (hi, lo) uint32 host plane tables [N, sp] (sorted, UINT64_MAX padded; a
    compact index's codes and derived lo plane): int32 [K].  The native
    library's threaded two-pointer pass where it has one (io.native),
    else pair_counts_merge over the gathered keys, RESOLVE_BATCH pairs at
    a time; both give pair_counts_merge's count."""
    from ..io import native as _native

    amb_i = np.asarray(amb_i, np.int64)
    amb_j = np.asarray(amb_j, np.int64)
    if _native.has_resolve():
        return _native.resolve_pairs_native(rows[0], rows[1], cols[0], cols[1],
                                            amb_i, amb_j, s)
    out = np.empty(amb_i.size, np.int32)
    for o in range(0, amb_i.size, RESOLVE_BATCH):
        ci, cj = amb_i[o:o + RESOLVE_BATCH], amb_j[o:o + RESOLVE_BATCH]
        a = torch.from_numpy(u64.keys_from_planes(rows[0][ci], rows[1][ci]))
        b = torch.from_numpy(u64.keys_from_planes(cols[0][cj], cols[1][cj]))
        out[o:o + ci.size] = pair_counts_merge(a, b, s)["shared_in_x"].numpy()
    return out


def searchsorted_u64(hay: torch.Tensor, needles: torch.Tensor) -> torch.Tensor:
    """Lower bound of each needle (any shape) in the sorted keys `hay` [m]
    (INF padding sorts last) → int32 insertion indices of needles' shape."""
    pos = torch.searchsorted(hay.contiguous(), needles.reshape(-1), side="left")
    return pos.to(torch.int32).reshape(needles.shape)


def member_u64(hay: torch.Tensor, needles: torch.Tensor) -> torch.Tensor:
    """True where a needle occurs in the sorted keys `hay` (INF never
    matches)."""
    m = hay.shape[0]
    if m == 0:
        return torch.zeros(needles.shape, dtype=torch.bool, device=needles.device)
    idx = searchsorted_u64(hay, needles).to(torch.int64)
    hit = hay[idx.clamp(max=m - 1)] == needles
    return (idx < m) & hit & (needles != inf_key(needles.dtype))


def containment_counts(db: torch.Tensor, read_hashes: torch.Tensor) -> tuple:
    """Per-genome |S(g) ∩ H(reads)|: db [N, sp] sorted sketch keys,
    read_hashes [m] sorted distinct keys (INF-padded) → (hits int32 [N],
    sketch sizes int32 [N])."""
    hits = member_u64(read_hashes, db).sum(-1, dtype=torch.int32)
    sizes = (db != inf_key(db.dtype)).sum(-1, dtype=torch.int32)
    return hits, sizes


def tile_counts_plain(rows: torch.Tensor, cols: torch.Tensor, s: int) -> dict:
    """Plain version of kernel K3: rows [Ti, sp] × cols [Tj, sp] keys →
    {"shared_in_x", "union_size", "inter_full"} int32 [Ti, Tj], plus n_a
    int32 [Ti] and n_b int32 [Tj]; row groups of ROW_GROUP bound memory."""
    inf = inf_key(rows.dtype)
    tj = cols.shape[0]
    parts = {"shared_in_x": [], "union_size": [], "inter_full": []}
    for r0 in range(0, rows.shape[0], ROW_GROUP):
        r = rows[r0:r0 + ROW_GROUP]
        a = r[:, None, :].expand(r.shape[0], tj, r.shape[1])
        b = cols[None].expand(r.shape[0], tj, cols.shape[1])
        counts = pair_counts_merge(a, b, s)
        for key, acc in parts.items():
            acc.append(counts[key])
    out = {key: (torch.cat(acc) if acc else
                 torch.zeros((0, tj), dtype=torch.int32, device=rows.device))
           for key, acc in parts.items()}
    out["n_a"] = (rows != inf).sum(-1, dtype=torch.int32)
    out["n_b"] = (cols != inf).sum(-1, dtype=torch.int32)
    return out


def tile_counts_compact_plain(rows: torch.Tensor, cols: torch.Tensor, s: int) -> dict:
    """Plain version of kernel K4: tile_counts_plain's batched sort-merge on
    int32 code keys (sentinel INT32_MAX)."""
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise ValueError(f"expected int32 code keys, got {rows.dtype} / {cols.dtype}")
    return tile_counts_plain(rows, cols, s)


def _pad_to(keys: torch.Tensor, tgt: int) -> torch.Tensor:
    sp = keys.shape[-1]
    if tgt == sp:
        return keys
    pad = keys.new_full(keys.shape[:-1] + (tgt - sp,), inf_key(keys.dtype))
    return torch.cat([keys, pad], dim=-1)


def lane_width(sp: int) -> int:
    """The sketch width K3, K4 and their plain versions are held to on the
    dist path: the next multiple of 128 (minimum 128)."""
    return max(128, -(-sp // 128) * 128)


def _pad_lane(keys: torch.Tensor) -> torch.Tensor:
    """INF-pad the sketch width to lane_width."""
    return _pad_to(keys, lane_width(keys.shape[-1]))


def _pad_pow2(keys: torch.Tensor) -> torch.Tensor:
    """INF-pad the sketch width to a power of two, minimum 128 (the bitonic
    network's strides)."""
    sp = keys.shape[-1]
    return _pad_to(keys, max(128, 1 << max(0, (sp - 1).bit_length())))


def _tile_counts_torch(rows: torch.Tensor, cols: torch.Tensor, s: int, impl: str) -> dict:
    """The bitonic or searchsorted route over a tile, ROW_GROUP rows at a
    time: each group's [g, Tj] pairs in one broadcast call."""
    if impl == "bitonic":
        rows, cols = _pad_pow2(rows), _pad_pow2(cols)

        def pair(a, b):
            return _pair_counts_bitonic(a, b, s, "the bitonic tile route")
    else:
        def pair(a, b):
            return pair_counts(a, b, s)
    inf = inf_key(rows.dtype)
    tj = cols.shape[0]
    parts = {"shared_in_x": [], "union_size": [], "inter_full": []}
    for r0 in range(0, rows.shape[0], ROW_GROUP):
        r = rows[r0:r0 + ROW_GROUP]
        a = r[:, None, :].expand(r.shape[0], tj, r.shape[1])
        b = cols[None].expand(r.shape[0], tj, cols.shape[1])
        counts = pair(a, b)
        for key, acc in parts.items():
            acc.append(counts[key])
    out = {key: (torch.cat(acc) if acc else
                 torch.zeros((0, tj), dtype=torch.int32, device=rows.device))
           for key, acc in parts.items()}
    out["n_a"] = (rows != inf).sum(-1, dtype=torch.int32)
    out["n_b"] = (cols != inf).sum(-1, dtype=torch.int32)
    return out


def _route(impl: Optional[str]) -> str:
    if impl is None:
        return intersect_impl()
    if impl not in TILE_IMPLS:
        raise ValueError(f"unknown tile route {impl!r}; expected one of "
                         f"{', '.join(TILE_IMPLS)}")
    return "pallas" if impl == "auto" else impl


def tile_counts(rows: torch.Tensor, cols: torch.Tensor, s: int,
                impl: Optional[str] = None) -> dict:
    """All-pairs counts for a tile: rows [Ti, s'] and cols [Tj, s'] sorted
    INF-padded sketch keys → dict of int32 arrays (see tile_counts_plain).
    `impl` is a TILE_IMPLS value, or None for MIEKKI_INTERSECT's:
    pallas/auto is K3 on CUDA tensors and the plain
    version on CPU tensors; bitonic and searchsorted are those routes'
    torch ops on the tensors' device."""
    impl = _route(impl)
    if impl != "pallas":
        _check_dtype(torch.int64, rows, cols)
        return _tile_counts_torch(rows, cols, s, impl)
    from .cuda_intersect import tile_counts_cuda

    return tile_counts_cuda(_pad_lane(rows), _pad_lane(cols), s)


def tile_counts_compact(rows: torch.Tensor, cols: torch.Tensor, s: int,
                        impl: Optional[str] = None) -> dict:
    """tile_counts for compact sketches: [Ti, s'] / [Tj, s'] int32 code keys;
    pallas/auto is K4 on CUDA tensors and the plain version on CPU tensors."""
    impl = _route(impl)
    if impl != "pallas":
        _check_dtype(torch.int32, rows, cols)
        return _tile_counts_torch(rows, cols, s, impl)
    from .cuda_intersect32 import tile_counts32_cuda

    return tile_counts32_cuda(_pad_lane(rows), _pad_lane(cols), s)
