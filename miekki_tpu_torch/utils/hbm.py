"""Device-memory budgets (counterpart of the JAX package's utils/hbm.py).

One limit probe and the arithmetic that sizes every device-memory consumer
against it, with the JAX package's constants.  Budget map (fractions of
`bytes_limit`):

- ``PLANES_FRAC`` = 0.25: builder-retained [N, s] sketch planes.
- ``DIST_TOTAL_FRAC`` = 0.55: ceiling for everything the dist sweep holds
  at once (resident planes, block cache, in-flight tile passes); the cache
  gets what remains under it after the other two (``dist_cache_bytes``,
  which sizes engine.dist_tiles' key-block cache unless
  ``MIEKKI_COL_CACHE_MB`` is set).
- Screen: the one-pass merge join's DB budget is 10 % of the device's
  memory at 8 B per value; the grouped screen holds 8 B of key plus 1 B of
  hit bitmap per value resident, within 60 % of it.

Those constants are the reference's (its join and its host-built DB).  The
port adds one of its own: it builds each DB group's flat, value-sorted
keys on the device, and that one stable sort peaks at
``SCREEN_FLATTEN_BYTES_PER_VALUE``; ``screen_flatten_value_budget`` caps
both screen budgets so that the peak stays within 60 % of the memory.
The merge join (MIEKKI_SCREEN_JOIN=merge) sorts the DB's keys with each
batch's, and its peak per joined value (DB value or batch hash),
``SCREEN_MERGE_JOIN_BYTES_PER_VALUE``, caps the one-pass budget the same
way, less the batch (``screen_merge_join_value_budget``).

``MIEKKI_HBM_LIMIT`` (bytes) overrides the probed limit.  Every function
takes the device whose memory it budgets; there is no module-wide device.
"""

from __future__ import annotations

import os

import torch

DEFAULT_LIMIT = 16 << 30  # what the JAX package assumes when its device reports no limit

PLANES_FRAC = 0.25
DIST_TOTAL_FRAC = 0.55
SCREEN_MERGE_FRAC = 0.10
SCREEN_RESIDENT_FRAC = 0.60
SCREEN_RESIDENT_BYTES_PER_VALUE = 9  # 8 B key + 1 B hit bitmap
CACHE_MIN_BYTES = 64 << 20  # cache floor: ~2 blocks even on tiny parts
# the port's flat-DB build: the [N, s] key table, the sort's index input,
# its sorted keys and ids and its two scratch buffers, 8 B each per value,
# and the radix sort's per-tile counters (48.2 B per value measured at
# 10.24 M values by chip_smoke.py's screen_trace, which checks this bound)
SCREEN_FLATTEN_BYTES_PER_VALUE = 50
# the merge join's peak per joined value (DB keys and a batch's hashes):
# the resident DB keys and bitmap, the concatenated keys, the stable sort's
# sorted keys, indices and scratch, then its int32 run ids and int64
# scatter targets (chip_smoke.py's reference_routes phase checks it)
SCREEN_MERGE_JOIN_BYTES_PER_VALUE = 64


def bytes_limit(device) -> int:
    """Device memory capacity in bytes: the MIEKKI_HBM_LIMIT override, else
    a CUDA device's total memory, else DEFAULT_LIMIT (the CPU, where the
    JAX package's probe also falls back to it)."""
    env = os.environ.get("MIEKKI_HBM_LIMIT")
    if env:
        return max(1, int(env))
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return DEFAULT_LIMIT


def keep_planes_ok(table_bytes: int, device) -> bool:
    """May the index builder retain its [N, s] planes on `device`?"""
    return table_bytes <= bytes_limit(device) * PLANES_FRAC


def dist_cache_bytes(resident_plane_bytes: int, depth: int,
                     bytes_per_block: int, device) -> int:
    """Block-cache byte budget for the dist tile sweep: what remains of the
    DIST_TOTAL_FRAC ceiling after the resident planes and `depth` in-flight
    tile passes of one block each, floored at CACHE_MIN_BYTES."""
    total = int(bytes_limit(device) * DIST_TOTAL_FRAC)
    spend = int(resident_plane_bytes) + int(depth) * int(bytes_per_block)
    return max(CACHE_MIN_BYTES, total - spend)


def screen_merge_value_budget(device) -> int:
    """Max flat-DB VALUES for the one-pass merge-join screen."""
    return int(bytes_limit(device) * SCREEN_MERGE_FRAC) // 8


def screen_resident_value_budget(device) -> int:
    """Max flat-DB VALUES resident per group in the grouped screen (keys
    and hit bitmap live across the whole read stream)."""
    return int(bytes_limit(device) * SCREEN_RESIDENT_FRAC) \
        // SCREEN_RESIDENT_BYTES_PER_VALUE


def screen_flatten_value_budget(device) -> int:
    """Max flat-DB VALUES whose on-device build (one stable sort) peaks
    within SCREEN_RESIDENT_FRAC of the memory; the port's cap on both
    screen budgets above."""
    return int(bytes_limit(device) * SCREEN_RESIDENT_FRAC) \
        // SCREEN_FLATTEN_BYTES_PER_VALUE


def screen_merge_join_value_budget(device, batch: int) -> int:
    """Max flat-DB VALUES whose merge join with a batch of `batch` hashes
    peaks within SCREEN_RESIDENT_FRAC of the memory (the peak counts the DB
    values and the batch's alike); the port's cap on the one-pass budget
    under MIEKKI_SCREEN_JOIN=merge."""
    return max(0, int(bytes_limit(device) * SCREEN_RESIDENT_FRAC)
               // SCREEN_MERGE_JOIN_BYTES_PER_VALUE - batch)
