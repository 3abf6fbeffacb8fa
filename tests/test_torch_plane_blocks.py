"""Key blocks taken from a compact index's device planes on the CPU: a row
stripe of a compact DB against the whole DB, both with device planes, as
the benchmark's stripe jobs sweep it.  The count matrices equal the plain
compact reference's counts (benchmark/reference), and the block counters
and the `dist.block_load` span count each block taken from the planes and
the bytes copied into lane-padded blocks: rows * s * 4 a block at s = 200
(lanes of 256), none at s = 256, where every block is a view."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import compact as ref_compact
from benchmark.reference import compare
from miekki_tpu_torch import engine
from miekki_tpu_torch.index.store import SketchIndex
from miekki_tpu_torch.ops import compact
from miekki_tpu_torch.params import SketchParams
from miekki_tpu_torch.utils import profiling

N, ROWS, TILE = 48, 16, 8
SIGN = -(1 << 63)


def _raw_keys(seed: int, s: int) -> torch.Tensor:
    """[N, s] int64 order keys of sorted distinct sketches, INF-padded, in
    families of 4 that share most values; some rows short."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(N):
        if i % 4 == 0:
            pool = rng.integers(0, 1 << 44, 3 * s, dtype=np.uint64)
        mine = np.where(rng.random(3 * s) < 0.1,
                        rng.integers(0, 1 << 44, 3 * s, dtype=np.uint64), pool)
        vals = np.unique(mine)[:s if i % 5 else s // 2]
        row = np.full(s, np.uint64(0xFFFFFFFFFFFFFFFF))
        row[:vals.size] = vals
        rows.append(row)
    return torch.from_numpy(np.stack(rows).view(np.int64) ^ np.int64(SIGN))


def _db(s: int, planes: bool):
    keys = _raw_keys(s, s)
    table = compact.compact_rows(keys)
    codes = compact.codes_from_keys32(table)
    db = SketchIndex(SketchParams(k=31, s=s, compact=True), [f"g{i}" for i in range(N)],
                     codes, compact.lo_plane_np(codes))
    if planes:
        db.device_planes = table
    return db, keys


def _stripe(db: SketchIndex, r0: int) -> SketchIndex:
    part = slice(r0, r0 + ROWS)
    stripe = SketchIndex(db.params, db.names[part], db.hi[part], db.lo[part])
    if db.device_planes is not None:
        stripe.device_planes = db.device_planes[part]
    return stripe


@pytest.mark.parametrize("s,padded", [(200, True), (256, False)], ids=["lane256", "views"])
def test_stripe_on_plane_blocks_equals_the_reference(s, padded):
    db, keys = _db(s, planes=True)
    r0 = ROWS
    engine.reset_block_counts()
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        got = engine.dist_counts_matrix(_stripe(db, r0), db, tile=TILE, device="cpu")
    span = dict(profiling.SPANS["dist.block_load"])
    profiling.reset_spans()

    gi, gj = np.meshgrid(np.arange(r0, r0 + ROWS), np.arange(N), indexing="ij")
    want = compare.pair_counts(ref_compact.compact_table(keys), gi.ravel(), gj.ravel(), s)
    for name, w in zip(("shared", "union", "inter"), want):
        assert np.array_equal(got[name].ravel(), w), name

    blocks = ROWS // TILE + N // TILE  # the stripe's and the DB's, each loaded once
    copied = blocks * TILE * s * 4 if padded else 0
    counts = engine.BLOCK_COUNTS
    assert (counts["loads"], counts["plane_loads"]) == (blocks, blocks)
    assert counts["plane_bytes"] == copied
    assert counts["bytes_uploaded"] == 0
    assert span["calls"] == blocks and span["plane_bytes"] == copied
    assert "bytes" not in span


def test_host_plane_blocks_count_no_plane_block():
    """Without device planes every block comes from the host planes: the
    plane counters stay 0 and the span counts the uploaded bytes alone."""
    s = 200
    db, keys = _db(s, planes=False)
    engine.reset_block_counts()
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        got = engine.dist_counts_matrix(_stripe(db, 0), db, tile=TILE, device="cpu")
    span = dict(profiling.SPANS["dist.block_load"])
    profiling.reset_spans()
    blocks = ROWS // TILE + N // TILE
    counts = engine.BLOCK_COUNTS
    assert (counts["loads"], counts["plane_loads"], counts["plane_bytes"]) == (blocks, 0, 0)
    assert counts["bytes_uploaded"] == span["bytes"] == (ROWS + N) * s * 4
    assert "plane_bytes" not in span
    want = compare.pair_counts(ref_compact.compact_table(keys), np.zeros(N, np.int64),
                               np.arange(N), s)
    assert np.array_equal(got["inter"][0], want[2])
