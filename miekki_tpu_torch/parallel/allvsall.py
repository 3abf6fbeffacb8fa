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
that route of ops.intersect instead of K3/K4.  Under MIEKKI_INTERSECT=mxu
both count by the stream pass (ops.mxu_intersect) instead, as the
reference's rings do: the host ring sorts each row
sub-block's stream once and rotates the column streams with their blocks,
and the collective `ring_rect_counts_mxu` rotates the streams themselves
and returns the (lb, ub, inter) brackets.  Ambiguous pairs (lb != ub) are
deferred to one resolve_pairs_host call at the end.

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
from ..ops import mxu_intersect as _mxu
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


def _save_checkpoint(checkpoint: str, t: int, shared: np.ndarray, inter: np.ndarray,
                     amb: Optional[tuple] = None) -> None:
    """Write step t's running matrices atomically, with the reference's
    members: amb = (amb_i, amb_j), the global coordinates of the pairs
    deferred so far (the stream pass's; empty under K3/K4)."""
    path = _checkpoint_path(checkpoint, t)
    tmp = path + ".tmp.npz"
    empty = np.zeros(0, np.int64)
    amb_i, amb_j = amb if amb is not None else (empty, empty)
    np.savez(tmp, shared=shared, inter=inter, amb_i=amb_i, amb_j=amb_j)
    os.replace(tmp, path)


def _resolve_deferred(index_a: SketchIndex, idx_b: SketchIndex, shared: np.ndarray,
                      amb_i: np.ndarray, amb_j: np.ndarray, device) -> None:
    """Resolve the deferred ambiguous pairs into `shared`, in one
    resolve_pairs_host call on the host planes (a compact index's codes
    and derived lo plane: values code << 32)."""
    if amb_i.size:
        shared[amb_i, amb_j] = _mxu.resolve_pairs_host(
            (index_a.hi, index_a.lo), (idx_b.hi, idx_b.lo), amb_i, amb_j,
            index_a.params.s, device=device)


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

    Under MIEKKI_INTERSECT=mxu each sub-tile pair runs the stream pass
    instead, as the reference's host ring: the row sub-blocks' streams are
    sorted once per position, the column streams (derived from the row
    ones for a self-comparison) rotate with their blocks, each pull is the
    slim one, and the ambiguous pairs of every step are deferred to one
    resolve at the end.

    Self-comparison when index_b is None (the full symmetric [N, N],
    diagonal from the kernel); rectangular A-vs-B otherwise ([N_a, N_b],
    B's blocks rotating through A's owners).

    checkpoint: optional directory; after each step the running matrices
    and the deferred pairs (amb_i, amb_j) are written atomically
    (hostring_step{t}.npz), and a rerun resumes after the last complete
    step by replaying only the rotations."""
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
    mxu = _intersect.intersect_impl() == "mxu"

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

    if mxu:
        stream_fn = (_mxu.sketch_stream32 if index_a.params.compact
                     else _mxu.sketch_stream)
        start = (_mxu.tile_counts_mxu_start32 if index_a.params.compact
                 else _mxu.tile_counts_mxu_start)
        row_streams = [[stream_fn(sub(row_blocks, d, i), False) for i in range(n_sub_a)]
                       for d in range(D)]
        if self_compare:  # a payload tag on the sorted row streams, no second sort
            col_streams = [[_mxu.stream_with_col_tag(st) for st in subs]
                           for subs in row_streams]
        else:
            col_streams = [[stream_fn(sub(col_blocks, d, j), True) for j in range(n_sub_b)]
                           for d in range(D)]

    shared = np.zeros((D * nl_a, D * nl_b), np.int32)
    inter = np.zeros((D * nl_a, D * nl_b), np.int32)
    amb_i: list = []
    amb_j: list = []
    start_t = 0
    if checkpoint:
        os.makedirs(checkpoint, exist_ok=True)
        for t in range(D - 1, -1, -1):
            if os.path.exists(_checkpoint_path(checkpoint, t)):
                with np.load(_checkpoint_path(checkpoint, t)) as z:
                    shared[:] = z["shared"]
                    inter[:] = z["inter"]
                    if z["amb_i"].size:
                        amb_i.append(z["amb_i"])
                        amb_j.append(z["amb_j"])
                start_t = t + 1
                break

    window = max(2 * D, int(os.environ.get("MIEKKI_HOSTRING_WINDOW", str(8 * D))))
    pend: deque = deque()

    def pull_one():
        d, origin, i, j, handle = pend.popleft()
        r0, c0 = d * nl_a + i * tile, origin * nl_b + j * tile
        if mxu:
            res, ai, aj = _mxu.tile_counts_mxu_finish_deferred(handle)
            res = (res["shared_in_x"], res["inter_full"])
            gi, gj = r0 + ai, c0 + aj
            keep = (gi < n_a) & (gj < n_b)
            if keep.any():
                amb_i.append(gi[keep])
                amb_j.append(gj[keep])
        else:
            res = handle.cpu().numpy()
        shared[r0:r0 + tile, c0:c0 + tile] = res[0]
        inter[r0:r0 + tile, c0:c0 + tile] = res[1]

    def launch(d, i, j):
        if mxu:
            return start(sub(row_blocks, d, i), sub(col_blocks, d, j), s,
                         row_stream=row_streams[d][i], col_stream=col_streams[d][j], slim=True)
        c = counts_fn(sub(row_blocks, d, i), sub(col_blocks, d, j), s)
        return torch.stack([c["shared_in_x"], c["inter_full"]])

    def rotate():
        # the block (and its streams) of position d - 1 moves to position d
        # (on one device a no-op: nothing writes into a block, so positions
        # may share it)
        nonlocal col_blocks, col_streams, col_origin
        col_blocks = [col_blocks[(d - 1) % D].to(devices[d], non_blocking=True)
                      for d in range(D)]
        if mxu:
            col_streams = [[tuple(x.to(devices[d], non_blocking=True) for x in st)
                            for st in col_streams[(d - 1) % D]] for d in range(D)]
        col_origin = [col_origin[(d - 1) % D] for d in range(D)]

    def deferred() -> tuple:
        # also under K3/K4: a resumed stream-pass checkpoint's pairs are
        # still unresolved, whichever route finishes the sweep
        empty = np.zeros(0, np.int64)
        return ((np.concatenate(amb_i) if amb_i else empty),
                (np.concatenate(amb_j) if amb_j else empty))

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
            _save_checkpoint(checkpoint, t, shared, inter, amb=deferred())

    shared = np.ascontiguousarray(shared[:n_a, :n_b])
    inter = np.ascontiguousarray(inter[:n_a, :n_b])
    _resolve_deferred(index_a, idx_b, shared, *deferred(), devices[0])
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
    counts_fn = _counts_fn(rows)  # under mxu K3/K4, as the reference's traced rings
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


# -------------------------------------------------- collective stream pass

_MXU_RING_TILE = 512  # the stream-pass ring's sub-tile edge (the reference's)


def _ring_local_mxu(rows: torch.Tensor, cols: torch.Tensor, s: int, group, world: int,
                    rank: int, tile: int) -> torch.Tensor:
    """Every step of the stream-pass ring on this rank: [world, 3, nl_a,
    nl_b] int32 (shared_lb, shared_ub, inter_full) on its device.

    The blocks are cut into `tile`-row sub-blocks (sentinel rows pad the
    last), whose streams are sorted once: the row streams stay, and the
    column streams travel the ring as two tensors (values and payloads,
    [n_j, tile * sp] each) in place of the block, so no arriving block is
    sorted again.  Each sub-tile pair is one full pass at chunk 2 · tile."""
    device = rows.device
    staged = _staged(group, device)
    compact = rows.dtype == torch.int32
    stream_fn = _mxu.sketch_stream32 if compact else _mxu.sketch_stream
    full = _mxu._tile_counts_mxu_full32 if compact else _mxu._tile_counts_mxu_full
    nl_a, nl_b = rows.shape[0], cols.shape[0]
    n_i, n_j = -(-nl_a // tile), -(-nl_b // tile)
    rows = _pad_rows(rows, n_i * tile)
    cols = _pad_rows(cols, n_j * tile)
    row_streams = [stream_fn(rows[i * tile:(i + 1) * tile], False) for i in range(n_i)]
    col = [stream_fn(cols[j * tile:(j + 1) * tile], True) for j in range(n_j)]
    col = [torch.stack([c[0] for c in col]), torch.stack([c[1] for c in col])]
    travel = [c.cpu() for c in col] if staged else col  # what the group sends
    outs = []
    for t in range(world):
        works = ()
        if t + 1 < world:
            nxt, works = _exchange(travel, 1, group, world, rank, staged)
        mat = torch.empty((3, n_i * tile, n_j * tile), dtype=torch.int32, device=device)
        for i in range(n_i):
            for j in range(n_j):
                out = full(row_streams[i], (col[0][j], col[1][j]), tile, tile, s, 2 * tile)
                sl = np.s_[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
                for p, key in enumerate(("shared_lb", "shared_ub", "inter_full")):
                    mat[p][sl] = out[key]
        outs.append(mat[:, :nl_a, :nl_b])
        if works:
            for w in works:
                w.wait()
            travel = nxt
            col = [c.to(device, non_blocking=True) for c in travel] if staged else travel
    return torch.stack(outs)


def ring_rect_counts_mxu(a: torch.Tensor, b: torch.Tensor, *, s: int, mesh: Mesh,
                         axis: str = DB_AXIS, tile: int = _MXU_RING_TILE) -> Counts:
    """Rectangular A-vs-B counts by the stream pass over the ranks of a
    process-group mesh (pass a == b for self-comparison): int64 order-key
    or int32 code-key tables, N divisible by the ranks.  Returns
    (shared_lb, shared_ub, inter) int32 [N_a, N_b] on the host, in global
    order, on every rank; the caller resolves the pairs with lb != ub
    (mxu_intersect.resolve_pairs_host), as dist_sharded does."""
    if a.dtype != b.dtype or a.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"expected int64 or int32 keys, got {a.dtype} / {b.dtype}")
    group, world, rank = _group_of(mesh, axis)
    device = mesh.devices.flat[rank]
    rows = _ring_block(a, world, rank, device)
    cols = _ring_block(b, world, rank, device)
    local = _ring_local_mxu(rows, cols, s, group, world, rank, tile)
    planes = _ring_order(_all_gather(local, group, world))
    nl_a, nl_b = a.shape[0] // world, b.shape[0] // world
    return tuple(_unrotate(p, D=world, nl_rows=nl_a, nl_cols=nl_b) for p in planes)


# ---------------------------------------------------------------- routing


def dist_sharded(
    index_a: SketchIndex,
    mesh: Mesh,
    axis: str = DB_AXIS,
    index_b: Optional[SketchIndex] = None,
    tile: Optional[int] = None,
    _traced_mxu: bool = False,
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

    Under MIEKKI_INTERSECT=mxu, as the reference routes it: a group of
    several ranks runs ring_rect_counts_mxu (sub-tile `tile`, default 512)
    and resolves the ambiguous pairs after un-rotation, union from the
    sizes; one position, of a group or not, takes dist_counts_matrix's
    deferred stream pass, and several positions in one process the host
    ring's.  _traced_mxu forces the collective stream-pass ring on a
    one-rank group too (the reference's hook of the same name)."""
    idx_b = index_a if index_b is None else index_b
    if index_b is not None:
        index_a.params.validate_compatible(index_b.params)
    n_a, n_b = len(index_a), len(idx_b)
    mxu = _traced_mxu or _intersect.intersect_impl() == "mxu"
    if _traced_mxu and mesh.group is None:
        raise ValueError("_traced_mxu needs a process-group mesh")
    if mesh.group is not None and (not mxu or _traced_mxu or mesh.shape[axis] > 1):
        world = mesh.shape[axis]

        def padded(idx):
            return _pad_rows(index_to_device(idx, "cpu"), -(-max(len(idx), 1) // world) * world)

        a = padded(index_a)
        b = a if index_b is None else padded(index_b)
        s = index_a.params.s
        sl = np.s_[:n_a, :n_b]
        if mxu:
            lb, ub, inter = (np.ascontiguousarray(m[sl].numpy()) for m in ring_rect_counts_mxu(
                a, b, s=s, mesh=mesh, axis=axis, tile=tile or _MXU_RING_TILE))
            shared = lb.copy()
            _resolve_deferred(index_a, idx_b, shared, *np.nonzero(lb != ub),
                              mesh.devices.flat[dist.get_rank(mesh.group)])
            return {"shared": shared, "union": _union(index_a.sizes(), idx_b.sizes(), inter, s),
                    "inter": inter}
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
