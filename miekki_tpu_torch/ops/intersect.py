"""Sketch intersection counts (counterpart of the JAX package's
ops/intersect.py, u64 tile path).

For a pair of sorted, distinct, INF-padded sketches A, B:

  merged   = sort(concat(A, B))
  dup[i]   = merged[i] == merged[i-1]  (and not INF)      # second of a pair
  distinct = valid & ~dup
  rank     = inclusive cumsum(distinct)                   # 1-based distinct rank

  shared_in_x = Σ dup & (rank <= s)     → Mash Jaccard numerator |X ∩ A ∩ B|
  union_size  = min(s, Σ distinct)      → |X|
  inter_full  = Σ dup                   → |A ∩ B| (containment numerator)

Values are int64 order keys (ops.u64).  `tile_counts` is the inner unit
of the all-vs-all scheduler: it runs kernel K3 (ops.cuda_intersect) on
CUDA tensors and the plain batched merge below on CPU tensors.
"""

from __future__ import annotations

import torch

from . import u64

ROW_GROUP = 8  # rows per step of the plain tile version — bounds its
# [ROW_GROUP, Tj, 2 sp] merge temporaries


def pair_counts_merge(a: torch.Tensor, b: torch.Tensor, s: int) -> dict:
    """Sort-merge counts of sketch pairs: a, b [..., sp] keys with the same
    leading shape → dict of int32 [...] (the reference count semantics)."""
    x = torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
    valid = x != u64.INF_KEY
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
        "n_a": (a != u64.INF_KEY).sum(-1, dtype=i32),
        "n_b": (b != u64.INF_KEY).sum(-1, dtype=i32),
    }


def tile_counts_plain(rows: torch.Tensor, cols: torch.Tensor, s: int) -> dict:
    """Plain version of kernel K3: rows [Ti, sp] × cols [Tj, sp] keys →
    {"shared_in_x", "union_size", "inter_full"} int32 [Ti, Tj], plus n_a
    int32 [Ti] and n_b int32 [Tj]; row groups of ROW_GROUP bound memory."""
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
    out["n_a"] = (rows != u64.INF_KEY).sum(-1, dtype=torch.int32)
    out["n_b"] = (cols != u64.INF_KEY).sum(-1, dtype=torch.int32)
    return out


def _pad_to(keys: torch.Tensor, tgt: int) -> torch.Tensor:
    sp = keys.shape[-1]
    if tgt == sp:
        return keys
    pad = keys.new_full(keys.shape[:-1] + (tgt - sp,), u64.INF_KEY)
    return torch.cat([keys, pad], dim=-1)


def _pad_lane(keys: torch.Tensor) -> torch.Tensor:
    """INF-pad the sketch width to the next multiple of 128 (minimum 128),
    the width K3 and its plain version are held to on the dist path."""
    sp = keys.shape[-1]
    return _pad_to(keys, max(128, -(-sp // 128) * 128))


def tile_counts(rows: torch.Tensor, cols: torch.Tensor, s: int) -> dict:
    """All-pairs counts for a tile: rows [Ti, s'] and cols [Tj, s'] sorted
    INF-padded sketch keys → dict of int32 arrays (see tile_counts_plain).
    K3 on CUDA tensors, the plain version on CPU tensors."""
    from .cuda_intersect import tile_counts_cuda

    return tile_counts_cuda(_pad_lane(rows), _pad_lane(cols), s)
