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
all-vs-all scheduler: they run kernel K3 (ops.cuda_intersect) or K4
(ops.cuda_intersect32) on CUDA tensors and the plain batched merge below
on CPU tensors.
"""

from __future__ import annotations

import os

import torch

ROW_GROUP = 8  # rows per step of the plain tile version — bounds its
# [ROW_GROUP, Tj, 2 sp] merge temporaries

IMPLS = ("auto", "pallas", "mxu")  # the values MIEKKI_INTERSECT takes


def intersect_impl() -> str:
    """The dist route MIEKKI_INTERSECT names, read at call time: "mxu" for
    the stream pass (ops.mxu_intersect); "pallas" (the reference's name of
    its tile kernel) for K3/K4 — also for "auto" or unset: on a card the
    kernels, on the CPU their plain versions.  Any other value raises."""
    impl = os.environ.get("MIEKKI_INTERSECT", "auto").lower()
    if impl not in IMPLS:
        raise ValueError(f"unknown MIEKKI_INTERSECT {impl!r}; expected one of "
                         f"{', '.join(IMPLS)}")
    return "mxu" if impl == "mxu" else "pallas"


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


def pair_counts32(a: torch.Tensor, b: torch.Tensor, s: int) -> dict:
    """Counts of one compact sketch pair (a, b: [sp] int32 code keys) by
    binary search, as the JAX package's pair_counts32: a value of a at
    index i has distinct union rank i + #(b < v) - #(common values < v).
    Returns int32 scalars (the pair_counts_merge keys)."""
    m = b.shape[0]
    valid_a = a != inf_key(a.dtype)
    pos = torch.searchsorted(b, a, side="left")
    match = (pos < m) & (b[pos.clamp(0, max(m - 1, 0))] == a) & valid_a
    match_i = match.to(torch.int32)
    shared_less = torch.cumsum(match_i, 0, dtype=torch.int32) - match_i
    rank = torch.arange(a.shape[0], dtype=torch.int32, device=a.device) + pos.to(torch.int32) - shared_less
    n_a = valid_a.sum(dtype=torch.int32)
    n_b = (b != inf_key(b.dtype)).sum(dtype=torch.int32)
    inter = match_i.sum(dtype=torch.int32)
    return {
        "shared_in_x": (match & (rank < s)).sum(dtype=torch.int32),
        "union_size": (n_a + n_b - inter).clamp(max=s),
        "inter_full": inter,
        "n_a": n_a,
        "n_b": n_b,
    }


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


def tile_counts(rows: torch.Tensor, cols: torch.Tensor, s: int) -> dict:
    """All-pairs counts for a tile: rows [Ti, s'] and cols [Tj, s'] sorted
    INF-padded sketch keys → dict of int32 arrays (see tile_counts_plain).
    K3 on CUDA tensors, the plain version on CPU tensors."""
    from .cuda_intersect import tile_counts_cuda

    return tile_counts_cuda(_pad_lane(rows), _pad_lane(cols), s)


def tile_counts_compact(rows: torch.Tensor, cols: torch.Tensor, s: int) -> dict:
    """tile_counts for compact sketches: [Ti, s'] / [Tj, s'] int32 code keys.
    K4 on CUDA tensors, the plain version on CPU tensors."""
    from .cuda_intersect32 import tile_counts32_cuda

    return tile_counts32_cuda(_pad_lane(rows), _pad_lane(cols), s)
