"""Distributed all-vs-all comparison (counterpart of the JAX package's
parallel/allvsall.py): the [N, N] count matrices tiled across mesh
positions, each owning one row block of the genome-sharded key table,
while the column blocks travel around a ring.

Two forms:

  * `dist_sharded_hostring` — one process, any number of positions: the host
    launches kernel K3 (K4 on a compact index) per sub-tile pair on each
    position's device and moves the column blocks to the next position
    with `tensor.to(device, non_blocking=True)`.
  * the collective rings (`ring_rect_counts`, `ring_rect_counts32`,
    `ring_all_vs_all_counts`, `ring_chunk_counts`) — one torch.distributed
    rank per position: each step counts the resident rows against the
    column block in hand, while the block for the next step travels with
    `batch_isend_irecv` (send to rank + 1, receive from rank − 1; through
    host buffers under gloo, device to device under NCCL).  Results are
    all-gathered and un-rotated on every rank.

Under MIEKKI_INTERSECT=bitonic or searchsorted every tile is counted by
that route of ops.intersect instead of K3/K4; under mxu, by K3/K4 as
under auto (ops.intersect.intersect_impl).

Step bookkeeping: with the ring permutation r → (r + 1) mod D applied after
every step, position d holds, at step t, the column block first owned by
position (d − t) mod D.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import engine as _engine
from ..index.store import SketchIndex, index_to_device
from ..ops import intersect as _intersect
from ..utils import device as _device
from .mesh import DB_AXIS, Mesh, local_mesh

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _counts_fn(keys: torch.Tensor):
    """K4 for int32 code keys, K3 for int64 order keys (or the route
    MIEKKI_INTERSECT names, which they read)."""
    return (_intersect.tile_counts_compact if keys.dtype == torch.int32
            else _intersect.tile_counts)


def _pad_rows(keys: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Pad a key table to n_rows rows of the dtype's sentinel (no copy when
    it already has them)."""
    n = keys.shape[0]
    if n == n_rows:
        return keys
    pad = keys.new_full((n_rows - n, keys.shape[1]), _intersect.inf_key(keys.dtype))
    return torch.cat([keys, pad])


def _union(sizes_a: np.ndarray, sizes_b: np.ndarray, inter: np.ndarray, s: int) -> np.ndarray:
    """union = min(size_a + size_b − inter, s), int32 [N_a, N_b] (the
    reference's host formula; sizes count non-sentinel slots)."""
    union = sizes_a.astype(np.int32)[:, None] + sizes_b.astype(np.int32)[None, :]
    union -= inter
    np.minimum(union, s, out=union)
    return union


# ------------------------------------------------------------- host ring


def _hostring_side_blocks(idx: SketchIndex, devices, nl: int) -> list:
    """A side's key table (int64 order keys, or int32 code keys for a
    compact index) lane-padded, padded with the sentinel to D * nl rows,
    and row block d placed on devices[d].  A raw side whose device_planes
    live on one of the positions' devices is cut from them, each block
    padded on its device and filled by a device-to-device copy (as the
    reference's); any other side is built from its host planes."""
    D = len(devices)
    planes = None
    if not idx.params.compact:
        planes = next((p for p in (_engine._planes_on(idx, d) for d in devices)
                       if p is not None), None)
    if planes is None:
        keys = _intersect._pad_lane(index_to_device(idx, "cpu"))
        keys = _pad_rows(keys, D * nl)
        return [keys[d * nl:(d + 1) * nl].to(devices[d]) for d in range(D)]
    n, s = planes.shape
    lane = _intersect.lane_width(s)
    blocks = []
    for d in range(D):
        r0, r1 = min(d * nl, n), min((d + 1) * nl, n)
        blk = torch.full((nl, lane), _intersect.inf_key(planes.dtype), dtype=planes.dtype,
                         device=devices[d])
        blk[:r1 - r0, :s].copy_(planes[r0:r1], non_blocking=True)
        blocks.append(blk)
    return blocks


def _checkpoint_path(checkpoint: str, t: int) -> str:
    return os.path.join(checkpoint, f"hostring_step{t}.npz")


def _save_checkpoint(checkpoint: str, t: int, shared: np.ndarray, inter: np.ndarray) -> None:
    """Write step t's running matrices atomically, with the reference's
    members: its deferred pairs (amb_i, amb_j) are empty, every count being
    exact."""
    path = _checkpoint_path(checkpoint, t)
    tmp = path + ".tmp.npz"
    empty = np.zeros(0, np.int64)
    np.savez(tmp, shared=shared, inter=inter, amb_i=empty, amb_j=empty)
    os.replace(tmp, path)


def dist_sharded_hostring(
    index_a: SketchIndex,
    devices=None,
    tile: int = _engine.DEFAULT_TILE,
    index_b: Optional[SketchIndex] = None,
    checkpoint: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Host-orchestrated ring over the positions `devices` (default: every
    visible card) in one process.

    Each position owns a sentinel-padded row block of nl rows (D * nl ≥ N),
    cut into `tile`-row sub-blocks.  At every step each (i, j) sub-tile
    pair of a position is counted on its device by K3 (K4 on a compact
    index); the column blocks then move one position on.  A bounded window
    of launches is in flight (MIEKKI_HOSTRING_WINDOW, the reference's knob:
    default 8 · D, minimum 2 · D); each pull writes shared and inter into
    the host matrices, and union follows from the sketch sizes at the end.

    Self-comparison when index_b is None (the full symmetric [N, N],
    diagonal from the kernel); rectangular A-vs-B otherwise ([N_a, N_b],
    B's blocks rotating through A's owners).

    checkpoint: optional directory; after each step the running matrices
    are written atomically (hostring_step{t}.npz), and a rerun resumes
    after the last complete step by replaying only the rotations.  The
    reference's host ring defers the pairs its stream pass cannot bracket
    exactly and lists them in its step files (amb_i, amb_j); a resumed
    file's pairs are counted exactly (ops.intersect.resolve_pairs) as it
    is loaded, so each package resumes the other's files."""
    if devices is None:
        devices = local_mesh().devices.flat
    devices = [_device.resolve(d) for d in devices]
    D = len(devices)
    self_compare = index_b is None
    idx_b = index_a if self_compare else index_b
    if not self_compare:
        index_a.params.validate_compatible(index_b.params)
    s = index_a.params.s
    n_a, n_b = len(index_a), len(idx_b)
    tile = min(tile, max(1, n_a, n_b))

    def side_geometry(n):
        per_dev = -(-max(n, 1) // D)
        n_sub = max(1, -(-per_dev // tile))
        return n_sub, n_sub * tile

    n_sub_a, nl_a = side_geometry(n_a)
    n_sub_b, nl_b = (n_sub_a, nl_a) if self_compare else side_geometry(n_b)
    row_blocks = _hostring_side_blocks(index_a, devices, nl_a)
    col_blocks = list(row_blocks) if self_compare else _hostring_side_blocks(idx_b, devices, nl_b)
    col_origin = list(range(D))
    counts_fn = _counts_fn(row_blocks[0])

    def sub(blocks, d, i):
        return blocks[d][i * tile:(i + 1) * tile]

    shared = np.zeros((D * nl_a, D * nl_b), np.int32)
    inter = np.zeros((D * nl_a, D * nl_b), np.int32)
    start_t = 0
    if checkpoint:
        os.makedirs(checkpoint, exist_ok=True)
        for t in range(D - 1, -1, -1):
            if os.path.exists(_checkpoint_path(checkpoint, t)):
                with np.load(_checkpoint_path(checkpoint, t)) as z:
                    shared[:] = z["shared"]
                    inter[:] = z["inter"]
                    amb_i, amb_j = z["amb_i"], z["amb_j"]
                if amb_i.size:
                    shared[amb_i, amb_j] = _intersect.resolve_pairs(
                        (index_a.hi, index_a.lo), (idx_b.hi, idx_b.lo), amb_i, amb_j, s)
                start_t = t + 1
                break

    window = max(2 * D, int(os.environ.get("MIEKKI_HOSTRING_WINDOW", str(8 * D))))
    pend: deque = deque()

    def pull_one():
        d, origin, i, j, handle = pend.popleft()
        r0, c0 = d * nl_a + i * tile, origin * nl_b + j * tile
        res = handle.cpu().numpy()
        shared[r0:r0 + tile, c0:c0 + tile] = res[0]
        inter[r0:r0 + tile, c0:c0 + tile] = res[1]

    def launch(d, i, j):
        c = counts_fn(sub(row_blocks, d, i), sub(col_blocks, d, j), s)
        return torch.stack([c["shared_in_x"], c["inter_full"]])

    def rotate():
        # the block of position d - 1 moves to position d (on one device a
        # no-op: nothing writes into a block, so positions may share it)
        nonlocal col_blocks, col_origin
        col_blocks = [col_blocks[(d - 1) % D].to(devices[d], non_blocking=True)
                      for d in range(D)]
        col_origin = [col_origin[(d - 1) % D] for d in range(D)]

    for t in range(D):
        if t < start_t:
            if t + 1 < D:
                rotate()
            continue
        # positions innermost, so every device's queue fills early
        for i in range(n_sub_a):
            for j in range(n_sub_b):
                for d in range(D):
                    pend.append((d, col_origin[d], i, j, launch(d, i, j)))
                    while len(pend) > window:
                        pull_one()
        if t + 1 < D:
            rotate()  # overlaps the drain below
        while pend:
            pull_one()
        if checkpoint:
            _save_checkpoint(checkpoint, t, shared, inter)

    shared = np.ascontiguousarray(shared[:n_a, :n_b])
    inter = np.ascontiguousarray(inter[:n_a, :n_b])
    return {"shared": shared, "union": _union(index_a.sizes(), idx_b.sizes(), inter, s),
            "inter": inter}


# ------------------------------------------------------- collective rings


def _ring_block(keys: torch.Tensor, n_blocks: int, rank: int, device) -> torch.Tensor:
    n = keys.shape[0]
    if n % n_blocks:
        raise ValueError(f"N={n} not divisible by {n_blocks} ring positions")
    nl = n // n_blocks
    return _intersect._pad_lane(keys[rank * nl:(rank + 1) * nl].to(device)).contiguous()


def _group_of(mesh: Mesh, axis: str):
    if mesh.group is None:
        raise ValueError("the collective rings need a process-group mesh "
                         "(local_mesh() after initialize_distributed)")
    world = dist.get_world_size(mesh.group)
    if mesh.shape[axis] != world:
        raise ValueError(f"mesh axis {axis}={mesh.shape[axis]} != {world} ranks")
    return mesh.group, world, dist.get_rank(mesh.group)


def _staged(group, device: torch.device) -> bool:
    """Whether blocks travel through host buffers: gloo sends CPU tensors
    only."""
    return dist.get_backend(group) == "gloo" and device.type != "cpu"


def _exchange(blocks: list, shift: int, group, world: int, rank: int, pin: bool) -> tuple:
    """Start sending each of `blocks` to rank + shift and receiving rank −
    shift's into fresh buffers (pinned host memory when `pin`), in one
    batch; returns (buffers, works)."""
    bufs = [torch.empty(b.shape, dtype=b.dtype, device=b.device, pin_memory=pin)
            for b in blocks]
    ops = []
    for b, out in zip(blocks, bufs):
        ops += [dist.P2POp(dist.isend, b, (rank + shift) % world, group),
                dist.P2POp(dist.irecv, out, (rank - shift) % world, group)]
    return bufs, dist.batch_isend_irecv(ops)


def _ring_local(rows: torch.Tensor, cols: torch.Tensor, s: int, group, world: int,
                rank: int, t0: int, n_steps: int) -> torch.Tensor:
    """Steps [t0, t0 + n_steps) of the ring on this rank: [n_steps, 3,
    nl_a, nl_b] int32 (shared_in_x, union_size, inter_full) on its
    device.  The column block is first moved t0 positions on in one
    exchange; the exchange for step t + 1 starts before step t's launch."""
    device = rows.device
    staged = _staged(group, device)
    counts_fn = _counts_fn(rows)
    travel = cols.cpu() if staged else cols  # what the group sends
    if t0 % world:
        (travel,), works = _exchange([travel], t0 % world, group, world, rank, staged)
        for w in works:
            w.wait()
        cols = travel.to(device) if staged else travel
    outs = []
    for t in range(n_steps):
        works = ()
        if t + 1 < n_steps:
            (nxt,), works = _exchange([travel], 1, group, world, rank, staged)
        c = counts_fn(rows, cols, s)
        outs.append(torch.stack([c["shared_in_x"], c["union_size"], c["inter_full"]]))
        if works:
            for w in works:
                w.wait()
            travel = nxt
            cols = travel.to(device, non_blocking=True) if staged else travel
    return torch.stack(outs)


def _all_gather(local: torch.Tensor, group, world: int) -> torch.Tensor:
    """[world, *local.shape] on the host, every rank's `local` in rank
    order (through the host under gloo)."""
    if dist.get_backend(group) == "gloo":
        local = local.cpu()
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local.contiguous(), group)
    return torch.stack([p.cpu() for p in parts])


def _ring_order(gathered: torch.Tensor) -> torch.Tensor:
    """[W(rank), steps, 3, nl_a, nl_b] → [3, steps, W * nl_a, nl_b]: the
    reference's ring-order layout of each count plane."""
    w, steps, planes, nl_a, nl_b = gathered.shape
    return gathered.permute(2, 1, 0, 3, 4).reshape(planes, steps, w * nl_a, nl_b)


def _unrotate(x: torch.Tensor, *, D: int, nl_rows: int, nl_cols: int) -> torch.Tensor:
    """[D(steps), D * nl_rows, nl_cols] ring output → the global count
    matrix: at step t, rows d * nl_rows:(d + 1) * nl_rows hold the counts
    against the column block first owned by position (d − t) mod D."""
    t_ids = torch.arange(D)[:, None]
    d_ids = torch.arange(D)[None, :].expand(D, D)
    origin = (d_ids - t_ids) % D
    x = x.reshape(D, D, nl_rows, nl_cols)  # [t, d, row in block, col in block]
    out = x.new_zeros((D, nl_rows, D, nl_cols))
    # advanced indices split by a slice put the [D, D] index dims first:
    # x[t, d] lands at out[d_ids[t, d], :, origin[t, d], :]
    out[d_ids, :, origin, :] = x
    return out.reshape(D * nl_rows, D * nl_cols)


def _ring_rect(a: torch.Tensor, b: torch.Tensor, s: int, mesh: Mesh, axis: str) -> Counts:
    group, world, rank = _group_of(mesh, axis)
    device = mesh.devices.flat[rank]
    rows = _ring_block(a, world, rank, device)
    cols = _ring_block(b, world, rank, device)
    local = _ring_local(rows, cols, s, group, world, rank, 0, world)
    planes = _ring_order(_all_gather(local, group, world))
    nl_a, nl_b = a.shape[0] // world, b.shape[0] // world
    return tuple(_unrotate(p, D=world, nl_rows=nl_a, nl_cols=nl_b) for p in planes)


def ring_rect_counts(a: torch.Tensor, b: torch.Tensor, *, s: int, mesh: Mesh,
                     axis: str = DB_AXIS) -> Counts:
    """Rectangular A-vs-B counts over the ranks of a process-group mesh.

    a, b: the global int64 order-key tables [N_a, s'] and [N_b, s'] (any
    device; rank r reads only its row blocks), N divisible by the ranks
    (pad with INF_KEY rows first).  B's blocks rotate through A's owners
    (n_a × n_b pair work).  Returns (shared, union, inter) int32 [N_a, N_b]
    on the host, in global order, on every rank."""
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise ValueError(f"expected int64 order keys, got {a.dtype} / {b.dtype}")
    return _ring_rect(a, b, s, mesh, axis)


def ring_rect_counts32(a: torch.Tensor, b: torch.Tensor, *, s: int, mesh: Mesh,
                       axis: str = DB_AXIS) -> Counts:
    """ring_rect_counts on compact int32 code-key tables (K4; half the
    bytes per rotation).  Pass a == b for self-comparison."""
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"expected int32 code keys, got {a.dtype} / {b.dtype}")
    return _ring_rect(a, b, s, mesh, axis)


def ring_all_vs_all_counts(db: torch.Tensor, *, s: int, mesh: Mesh,
                           axis: str = DB_AXIS) -> Counts:
    """Self-comparison counts (the rectangular ring with A = B): (shared,
    union, inter) int32 [N, N] in global order."""
    return ring_rect_counts(db, db, s=s, mesh=mesh, axis=axis)


def ring_chunk_counts(db: torch.Tensor, *, s: int, mesh: Mesh, t0: int, n_steps: int,
                      axis: str = DB_AXIS) -> Counts:
    """Self-comparison ring restricted to steps [t0, t0 + n_steps), which
    makes a long ring checkpointable between chunks.  Returns (shared,
    union, inter) int32 [n_steps, N, N // D] in RING order on every rank:
    [t − t0, d * nl:(d + 1) * nl, :] holds row block d against the column
    block first owned by position (d − t) mod D.  `unrotate_chunks` turns
    the concatenated chunks into the global matrices."""
    group, world, rank = _group_of(mesh, axis)
    device = mesh.devices.flat[rank]
    block = _ring_block(db, world, rank, device)
    local = _ring_local(block, block, s, group, world, rank, t0, n_steps)
    return tuple(_ring_order(_all_gather(local, group, world)))


def unrotate_chunks(x: np.ndarray, *, D: int) -> np.ndarray:
    """Host side: concatenated chunk outputs [D(steps), N, nl] → [N, N]."""
    n = x.shape[1]
    nl = n // D
    out = np.zeros((n, n), x.dtype)
    for t in range(D):
        for d in range(D):
            origin = (d - t) % D
            out[d * nl:(d + 1) * nl, origin * nl:(origin + 1) * nl] = \
                x[t, d * nl:(d + 1) * nl, :]
    return out


# ---------------------------------------------------------------- routing


def dist_sharded(
    index_a: SketchIndex,
    mesh: Mesh,
    axis: str = DB_AXIS,
    index_b: Optional[SketchIndex] = None,
    tile: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """All-vs-all exact counts for an index over `mesh`: {"shared",
    "union", "inter"} int32 [N_a, N_b] for the unpadded sizes, the full
    symmetric [N, N] for self-comparison (index_b None), equal to the
    single-device counts (inter = |S(A) ∩ S(B)|, the containment
    numerator).

    Routing: a process-group mesh runs the collective ring over its ranks
    (ring_rect_counts32 on a compact index); in one process, one position
    takes engine.dist_counts_matrix, symmetrised, and several positions
    (of a 1-D mesh, or of `axis` in a 2-D one) the host ring.  `tile` is
    the sub-tile edge of those two (default engine.DEFAULT_TILE).
    MIEKKI_INTERSECT=mxu routes as auto does."""
    idx_b = index_a if index_b is None else index_b
    if index_b is not None:
        index_a.params.validate_compatible(index_b.params)
    n_a, n_b = len(index_a), len(idx_b)
    if mesh.group is not None:
        world = mesh.shape[axis]

        def padded(idx):
            return _pad_rows(index_to_device(idx, "cpu"), -(-max(len(idx), 1) // world) * world)

        a = padded(index_a)
        b = a if index_b is None else padded(index_b)
        s = index_a.params.s
        sl = np.s_[:n_a, :n_b]
        ring = ring_rect_counts32 if index_a.params.compact else ring_rect_counts
        shared, union, inter = ring(a, b, s=s, mesh=mesh, axis=axis)
        return {key: np.ascontiguousarray(m[sl].numpy())
                for key, m in (("shared", shared), ("union", union), ("inter", inter))}
    tile = tile or _engine.DEFAULT_TILE
    devices = mesh.axis_devices(axis)
    if len(devices) > 1:
        return dist_sharded_hostring(index_a, devices, tile, index_b=index_b)
    counts = _engine.dist_counts_matrix(index_a, index_b, tile=tile, device=devices[0])
    if index_b is None:
        # dist_counts_matrix holds the upper triangle and the diagonal
        for key, m in counts.items():
            counts[key] = np.triu(m) + np.triu(m, 1).T
    return counts
