"""Peaks of the card and the work the kernels' jobs need, counted from the
inputs (whatever implements them), for the roofline shares.

A bound is the least time the card could take: the larger of the bytes
over the memory bandwidth and the int32 operations over the int32 peak.
The int32 peak is the published lane count: every SM of an H100 issues 64
int32 operations a clock (16 INT32 lanes in each of its 4 partitions), at
its largest SM clock.  A roofline share is a bound over the time the
kernels took.

- K1 (hash of every window): each code byte read once and 8 B written a
  window; ~24 int32 operations a window (the rolling update's ~12 64-bit
  operations, two int32 operations each).
- K3 (pair counts of 64-bit sketches): a linear merge of each pair's two
  sketches, one compare a key, two int32 operations a 64-bit key; each
  sketch's keys read once, and three int32 counts written a pair.  K4,
  the same on 32-bit keys, counts one int32 operation and 4 B a key
  (`key_bytes=4, ops_per_key=1`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# published figures of the cards the benchmark knows: SMs, largest SM
# clock, HBM bytes a second (NVIDIA H100 SXM5 data sheet)
PEAKS = {
    "H100": {"sms": 132, "max_sm_hz": 1.980e9, "hbm_bytes_per_s": 3.35e12},
}
INT32_LANES_PER_SM = 64
K1_OPS_PER_WINDOW = 24
K3_OPS_PER_KEY = 2
K3_OUT_BYTES_PER_PAIR = 12


def peaks(device_name: str) -> Optional[dict]:
    """{"int32_ops_per_s", "hbm_bytes_per_s"} of a card by its name, or
    None for a card the table does not hold."""
    for key, p in PEAKS.items():
        if key in device_name:
            return {"int32_ops_per_s": p["sms"] * INT32_LANES_PER_SM * p["max_sm_hz"],
                    "hbm_bytes_per_s": p["hbm_bytes_per_s"]}
    return None


def bound_s(ops: float, nbytes: float, peak: dict) -> float:
    return max(ops / peak["int32_ops_per_s"], nbytes / peak["hbm_bytes_per_s"])


def k1_work(lengths: Sequence[int], k: int):
    """(int32 operations, bytes) of hashing every window of sequences of
    the given lengths."""
    lengths = np.asarray(lengths, dtype=np.float64)
    windows = np.maximum(lengths - k + 1, 0)
    return float(K1_OPS_PER_WINDOW * windows.sum()), float(lengths.sum() + 8 * windows.sum())


def k3_work_self(sizes: Sequence[int], key_bytes: int = 8,
                 ops_per_key: int = K3_OPS_PER_KEY):
    """(int32 operations, bytes) of the counts of every pair i < j of one
    set of sketches of the given sizes, of keys of `key_bytes` bytes that
    take `ops_per_key` int32 operations each."""
    sizes = np.asarray(sizes, dtype=np.float64)
    n = sizes.shape[0]
    pairs = n * (n - 1) / 2
    ops = ops_per_key * (n - 1) * sizes.sum()
    return float(ops), float(key_bytes * sizes.sum() + K3_OUT_BYTES_PER_PAIR * pairs)


def k3_work_rect(sizes_a: Sequence[int], sizes_b: Sequence[int], key_bytes: int = 8,
                 ops_per_key: int = K3_OPS_PER_KEY):
    """(int32 operations, bytes) of the counts of every pair of one row
    sketch and one column sketch, keys counted as in k3_work_self."""
    a = np.asarray(sizes_a, dtype=np.float64)
    b = np.asarray(sizes_b, dtype=np.float64)
    ops = ops_per_key * (b.shape[0] * a.sum() + a.shape[0] * b.sum())
    return float(ops), float(key_bytes * (a.sum() + b.sum())
                             + K3_OUT_BYTES_PER_PAIR * a.shape[0] * b.shape[0])
