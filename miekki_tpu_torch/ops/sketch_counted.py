"""Bottom-s MinHash with a minimum-copies abundance filter (the `mash
sketch -m` analog, counterpart of the JAX package's ops/sketch_counted.py):
only hashes occurring at least m times enter the sketch, which drops the
error k-mers of a read set.

The buffer holds the ``cap`` smallest distinct canonical hashes seen so
far with their exact occurrence counts: an int64 order-key tensor [cap]
(INF_KEY pads) and an int32 count tensor [cap], sorted ascending.  Each
step hashes a [g, W] block of code rows through kernel K1
(ops.sketch._hash_rows), keeps the hashes <= the buffer's cap-th value
(<=, not <: an occurrence of a value already in the buffer must still
increment its count), and merges them with one sort, a sum of counts per
run of equal values, and a second sort that truncates to cap.  The
reference merges either at most CAND_BUDGET compacted survivors or, past
the budget, the whole masked chunk; both merge the same values, so a
boolean mask compacts them here.

Exactness: the cap-th value T only decreases, and a value is dropped (by
the prefilter or the truncation) only when it is >= the T of that moment
>= the final T, so every value strictly below the final T has an exact
count.  A try is accepted when nothing was dropped, or when the sketch is
full and its last value lies below the buffer's last value; otherwise the
cap doubles and the input is sketched again.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import device as _device
from . import sketch as _sketch
from . import u64
from .hash import INVALID_CODE


def empty_counted(cap: int, device=None):
    """An empty buffer: (INF keys [cap], zero counts [cap])."""
    return (u64.inf_like((cap,), device=device),
            torch.zeros(cap, dtype=torch.int32, device=device))


def _merge_counted(buf, vals: torch.Tensor, cnts: torch.Tensor, cap: int):
    """Merge candidate keys `vals` [L] with their counts `cnts` [L] into the
    buffer.  Returns (buffer, dropped): dropped is a device bool, True if a
    finite value was truncated."""
    x, order = torch.sort(torch.cat([buf[0], vals]))
    ct = torch.cat([buf[1], cnts])[order].to(torch.int64)
    last = torch.ones_like(x, dtype=torch.bool)  # last position of its run
    last[:-1] = x[1:] != x[:-1]
    cs = torch.cumsum(ct, 0)
    # the cumulative count at the end of the previous run: run ends' sums
    # never decrease, so a running maximum over them carries it forward
    ends = torch.cummax(torch.where(last, cs, 0), 0).values
    run_tot = cs - torch.cat([ends.new_zeros(1), ends[:-1]])
    keep = last & (x != u64.INF_KEY)
    ov, order = torch.sort(torch.where(keep, x, u64.INF_KEY))
    oc = torch.where(keep, run_tot, 0).to(torch.int32)[order]
    dropped = (ov[cap:] != u64.INF_KEY).any()
    return (ov[:cap], oc[:cap]), dropped


def merge_chunk_counted(buf, h: torch.Tensor, cap: int):
    """One chunk of hash keys h [c] into the counted buffer.  Returns
    (buffer, dropped)."""
    finite = h != u64.INF_KEY
    keep = finite & (h <= buf[0][cap - 1])
    pref_dropped = (finite & ~keep).any()
    vals = h[keep]
    out, trunc_dropped = _merge_counted(
        buf, vals, torch.ones(vals.shape, dtype=torch.int32, device=vals.device), cap)
    return out, pref_dropped | trunc_dropped


def _sketch_chunked_counted(chunks: torch.Tensor, k: int, cap: int):
    """Counted buffer of one input given as uint8 code rows [n, W] (rows
    overlap by k - 1, as for ops.sketch.sketch_chunked), ~STEP_TARGET
    window starts per step.  Returns (buffer, dropped)."""
    n, w = chunks.shape
    g = max(1, min(n, _sketch.STEP_TARGET // max(1, w - k + 1)))
    if n % g:
        chunks = torch.cat([chunks, chunks.new_full((-n % g, w), INVALID_CODE)])
    buf = empty_counted(cap, chunks.device)
    dropped = torch.zeros((), dtype=torch.bool, device=chunks.device)
    for block in chunks.reshape(-1, g, w):
        h = _sketch._hash_rows(block[None], k).reshape(-1)
        buf, d = merge_chunk_counted(buf, h, cap)
        dropped |= d
    return buf, dropped


def sketch_codes_device_counted(
    codes: np.ndarray, k: int, s: int, min_copies: int,
    chunk: int = 1 << 13, cap: int = 0, max_cap: int = 1 << 22, device="cuda",
) -> np.ndarray:
    """Counted sketch of one packed input (a read set) → sorted
    uint64[<=s] of the hashes occurring >= min_copies times.  Exact: the
    cap (default next_pow2(4 s)) doubles until the certificate of the
    module docstring holds; raises ValueError past max_cap."""
    if min_copies <= 1:
        return _sketch.sketch_codes_device(codes, k, s, chunk=chunk, device=device)
    dev = _device.resolve(device)
    rows = torch.from_numpy(_sketch.bucketed_chunk_codes(codes, k, chunk)).to(dev)
    cap = cap or _sketch._next_pow2(4 * s)
    while True:
        (keys, cnt), dropped = _sketch_chunked_counted(rows, k, cap)
        vals = u64.u64_from_keys(keys)
        cnt = cnt.cpu().numpy()
        qual = vals[(vals != u64.UINT64_MAX) & (cnt >= min_copies)][:s]
        if not bool(dropped):
            return qual
        # counts are exact only strictly below the buffer's last value
        # (the buffer is full once anything was dropped)
        if len(qual) == s and qual[-1] < vals[-1]:
            return qual
        if cap >= max_cap:
            raise ValueError(
                f"min-copies sketch needs cap > {max_cap}; input too "
                f"error-dominated for device counting at s={s}, m={min_copies}")
        cap *= 2
