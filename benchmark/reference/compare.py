"""Exact pair counts of bottom-s sketches, in plain torch and numpy, from
the benchmark's own inputs.  Imports nothing of the program.

For two sketches A and B (sorted distinct values) and X the s smallest
distinct values of A ∪ B: union = |X|, shared = |X ∩ A ∩ B|, inter =
|A ∩ B|.  Pairs are counted side by side: the two rows are joined and
sorted, a value in both appears twice in a row, and a value's rank among
the distinct values says whether it lies in X.
"""

from __future__ import annotations

import numpy as np
import torch

from .nthash import INF_KEY

PAIR_BATCH = 1024


def pair_counts(table: torch.Tensor, gi, gj, s: int):
    """(shared, union, inter) int64 numpy arrays of the pairs (gi[p], gj[p])
    of rows of an [N, s] INF-padded key table."""
    gi = torch.as_tensor(np.asarray(gi, dtype=np.int64), device=table.device)
    gj = torch.as_tensor(np.asarray(gj, dtype=np.int64), device=table.device)
    out = []
    for a in range(0, gi.shape[0], PAIR_BATCH):
        v = torch.sort(torch.cat([table[gi[a:a + PAIR_BATCH]], table[gj[a:a + PAIR_BATCH]]],
                                 dim=1), dim=1).values
        fin = v != INF_KEY
        same = v[:, 1:] == v[:, :-1]
        both = torch.zeros_like(fin)
        both[:, :-1] = same & fin[:, :-1]
        first = fin.clone()
        first[:, 1:] &= ~same
        rank = torch.cumsum(first, dim=1)
        union = torch.clamp(first.sum(1), max=s)
        shared = (both & (rank <= s)).sum(1)
        out.append(torch.stack([shared, union, both.sum(1)]).cpu())
    if not out:
        return tuple(np.zeros(0, np.int64) for _ in range(3))
    res = torch.cat(out, dim=1).numpy()
    return res[0], res[1], res[2]
