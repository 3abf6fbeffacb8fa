"""Data-parallel read screening with a merge of partial hit state
(counterpart of the JAX package's parallel/screen.py).

Read batches are grouped D at a time along the ``data`` axis of a mesh;
position d hashes batch d of each group with kernel K1 and joins it into
its replica of the value-sorted flat DB (engine._screen_batch, the
one-device screen's step, with the join and chunk of MIEKKI_SCREEN_JOIN and
MIEKKI_SCREEN_CHUNK, as the reference passes them to every position; its
shard_map steps screen_step_sharded and screen_step_db_sharded are
_Position.step here).  The hit
bitmaps are OR-merged (hit slots, not counts, merge: a DB value seen by
two positions is one hit) and the window counters summed: in one process
on the first position's device, in a process group by all_reduce (MAX on
uint8 bitmaps, SUM on the counters).  With `db_axis`, the flat DB is also
cut into value-sorted shards, one per position along that axis.

Reads are packed into batches on the host, which takes longer than a
card's hash and join of the batch.  From one read file every rank of a
process group packs every batch to pick out its own, so W ranks do W
times the packing of one and run no faster; read files are dealt to
ranks instead when there are at least as many files as ranks.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import engine as _engine
from ..index.store import SketchIndex
from ..ops import u64
from ..ops.hash import INVALID_CODE
from .mesh import DATA_AXIS, Mesh


def _batch_groups(path, k: int, flat: int, group: int) -> Iterator[List[np.ndarray]]:
    """Packed read batches [flat + k - 1] in lists of `group`, the tail
    padded with all-invalid batches (they hash to no valid window).
    `path` may be one file or a list of files; each file is packed on a
    reader thread."""
    buf: List[np.ndarray] = []
    for p in _engine._as_path_list(path):
        for b in _engine._prefetch(_engine._packed_read_batches(p, k, flat)):
            buf.append(b)
            if len(buf) == group:
                yield buf
                buf = []
    if buf:
        buf += [np.full_like(buf[0], INVALID_CODE)] * (group - len(buf))
        yield buf


class _Position:
    """One position's screen state: its device, its replica of the flat DB
    (or of one DB shard), the hit bitmap over it, and its counters and KMV
    state."""

    def __init__(self, device, db: torch.Tensor, thr: torch.Tensor, p_values: bool):
        self.device = device
        self.join, self.chunk = _engine._screen_join(), _engine._screen_chunk()
        self.db = db.to(device)  # read only: positions on one device share it
        self.thr = thr.to(device)
        self.acc = torch.zeros(db.shape[0] + 1, dtype=torch.bool, device=device)
        self.counters = []
        self.kmv = _engine._kmv_init(device=device) if p_values else None

    def step(self, batch: np.ndarray, k: int, compact: bool, kmv: bool) -> None:
        dev_batch = _engine._batch_to_device(batch, self.device)
        self.acc, n_valid, n_keep, h = _engine._screen_batch(
            self.acc, self.db, self.thr, dev_batch, k, compact, self.join, self.chunk)
        self.counters.append(torch.stack([n_valid, n_keep]))
        if kmv and self.kmv is not None:
            self.kmv = _engine._kmv_update(self.kmv, h)

    def totals(self) -> torch.Tensor:
        """[n_windows, n_survivors] int64 summed over the batches."""
        if not self.counters:
            return torch.zeros(2, dtype=torch.int64, device=self.device)
        return torch.stack(self.counters).sum(0)


def _kmv_union(states: List[torch.Tensor]) -> torch.Tensor:
    """The bottom-s0 KMV state of the union of the states' hash sets."""
    out = states[0]
    if len(states) > 1:
        out = _engine._kmv_update(out, torch.cat([s.to(out.device) for s in states[1:]]))
    return out


def _fill_stats(stats, totals: torch.Tensor, n_groups: int) -> None:
    if stats is None:
        return
    tot_w, tot_s = (int(v) for v in totals.tolist())
    stats.update(n_windows=tot_w, n_survivors=tot_s, n_batches=n_groups,
                 survivor_rate=tot_s / tot_w if tot_w else 0.0)


def _pick_hits(winner: bool, flat_vals, gid, acc: np.ndarray, index: SketchIndex) -> np.ndarray:
    if winner:
        return _engine._hits_winner_takes_all(flat_vals, gid, acc, len(index),
                                              np.asarray(index.sizes()))
    return _engine._hits_from_bitmap(flat_vals, gid, acc, len(index))


def _group_sum(value: int, group, device: torch.device) -> int:
    """`value` summed over the ranks of the group."""
    where = torch.device("cpu") if dist.get_backend(group) == "gloo" else device
    t = torch.tensor([value], dtype=torch.int64, device=where)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return int(t)


def _merge_group(positions: List[_Position], group) -> tuple:
    """One rank's position merged over the process group: (bitmap, totals,
    KMV state or None) on the rank's device; the group's backend decides
    where the collectives run (gloo: host tensors)."""
    pos = positions[0]
    on_host = dist.get_backend(group) == "gloo"
    where = torch.device("cpu") if on_host else pos.device
    bitmap = pos.acc.to(torch.uint8).to(where)
    dist.all_reduce(bitmap, op=dist.ReduceOp.MAX, group=group)
    totals = pos.totals().to(where)
    dist.all_reduce(totals, op=dist.ReduceOp.SUM, group=group)
    kmv = None
    if pos.kmv is not None:
        world = dist.get_world_size(group)
        parts = [torch.empty_like(pos.kmv, device=where) for _ in range(world)]
        dist.all_gather(parts, pos.kmv.to(where), group=group)
        kmv = _kmv_union(parts)
    return bitmap.to(pos.device).bool(), totals, kmv


def screen_sharded(
    index: SketchIndex,
    reads_path,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    flat: int = _engine.DEFAULT_READ_FLAT,
    db_axis: Optional[str] = None,
    winner: bool = False,
    stats: Optional[dict] = None,
    p_values: bool = False,
) -> List[dict]:
    """Distributed engine.screen: the same rows, reads streamed
    data-parallel across the positions of `axis`.

    In a process-group mesh each rank screens batch r of every group of W
    and the merges are all_reduces, so every rank returns the rows; when
    reads_path lists at least W files, rank r screens files r, r + W, ...
    instead, so that no rank parses reads it does not hash (n_batches is
    then the groups of W that the same batches would fill).  With
    `db_axis` (a 2-D mesh in one process) the flat DB is also cut into
    value-sorted shards along that axis: position (a, b) screens batch a
    against shard b, and bitmaps merge over the data axis only.  winner,
    stats and p_values as in engine.screen (the KMV state is a set union
    over the read stream, so p-values do not depend on the grouping;
    n_batches counts groups)."""
    k = index.params.k
    compact = index.params.compact
    if db_axis is not None:
        if mesh.group is not None:
            raise ValueError("a DB-sharded screen runs in one process")
        return _screen_sharded_2d(index, reads_path, mesh, axis, db_axis, flat, winner,
                                  stats, p_values)
    group = mesh.group
    if group is not None:
        rank, d = dist.get_rank(group), dist.get_world_size(group)
        devices = [mesh.devices.flat[rank]]
    else:
        devices = mesh.axis_devices(axis)
        rank, d = 0, len(devices)
    db, flat_vals, gid = _engine._flatten_db(index, devices[0])
    if len(flat_vals) == 0:
        return _engine._screen_rows(index, np.zeros(len(index), np.int64))
    positions = [_Position(dev, db, db[-1], p_values) for dev in devices]
    del db
    n_groups = 0
    paths = _engine._as_path_list(reads_path)
    if group is not None and len(paths) >= d:
        for (batch,) in _batch_groups(paths[rank::d], k, flat, 1):
            positions[0].step(batch, k, compact, True)
        n_batches = _group_sum(len(positions[0].counters), group, devices[0])
        n_groups = -(-n_batches // d)
    else:
        for batches in _batch_groups(paths, k, flat, d):
            n_groups += 1
            if group is not None:
                positions[0].step(batches[rank], k, compact, True)
            else:
                for pos, batch in zip(positions, batches):
                    pos.step(batch, k, compact, True)
    if group is not None:
        acc, totals, kmv = _merge_group(positions, group)
    else:
        first = positions[0]
        acc = first.acc
        totals = first.totals()
        for pos in positions[1:]:
            acc = acc | pos.acc.to(first.device)
            totals = totals + pos.totals().to(first.device)
        kmv = _kmv_union([p.kmv for p in positions]) if p_values else None
    _fill_stats(stats, totals, n_groups)
    hits = _pick_hits(winner, flat_vals, gid, _engine._pull_bitmap(acc), index)
    return _engine._screen_rows(index, hits,
                                _engine._kmv_estimate(kmv) if kmv is not None else None)


def _screen_sharded_2d(index, reads_path, mesh: Mesh, data_axis: str, db_axis: str,
                       flat: int, winner=False, stats=None, p_values=False) -> List[dict]:
    k = index.params.k
    grid = np.moveaxis(mesh.devices, (mesh.axis_names.index(data_axis),
                                      mesh.axis_names.index(db_axis)), (0, 1))
    d_data, d_db = grid.shape[:2]
    grid = grid.reshape(d_data, d_db, -1)[:, :, 0]
    db, flat_vals, gid = _engine._flatten_db(index, grid[0, 0])
    m = len(flat_vals)
    if m == 0:
        return _engine._screen_rows(index, np.zeros(len(index), np.int64))
    ms = -(-m // d_db)
    padded = torch.cat([db, db.new_full((d_db * ms - m,), u64.INF_KEY)])
    thr = db[-1]  # the whole DB's largest value, as in the one-device prefilter
    positions = [[_Position(grid[a, b], padded[b * ms:(b + 1) * ms], thr, p_values)
                  for b in range(d_db)] for a in range(d_data)]
    del db, padded
    n_groups = 0
    for batches in _batch_groups(reads_path, k, flat, d_data):
        n_groups += 1
        for a, batch in enumerate(batches):
            for b, pos in enumerate(positions[a]):
                # the KMV state follows the reads alone: shard 0's column
                pos.step(batch, k, index.params.compact, b == 0)
    first = positions[0][0].device
    shards = []
    for b in range(d_db):
        acc = positions[0][b].acc.to(first)
        for a in range(1, d_data):
            acc = acc | positions[a][b].acc.to(first)
        shards.append(acc[:-1])  # drop each shard's sink slot
    totals = positions[0][0].totals().to(first)
    for a in range(1, d_data):
        totals = totals + positions[a][0].totals().to(first)
    _fill_stats(stats, totals, n_groups)
    kmv = _kmv_union([positions[a][0].kmv for a in range(d_data)]) if p_values else None
    acc = torch.cat(shards)[:m]
    acc_np = np.concatenate([_engine._pull_bitmap(acc), [False]])
    hits = _pick_hits(winner, flat_vals, gid, acc_np, index)
    return _engine._screen_rows(index, hits,
                                _engine._kmv_estimate(kmv) if kmv is not None else None)
