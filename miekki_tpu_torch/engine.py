"""High-level engine: sketch, dist and screen (counterpart of the JAX
package's engine.py, single-device paths).

Sketching runs kernel K1 through ops.sketch (and kernel K2 on the
MIEKKI_MERGE=fused strategy); the all-vs-all comparison runs kernel K3
tile by tile through ops.intersect, or kernel K4 on a compact index; read
screening hashes each packed read batch with kernel K1 and joins it
against the value-sorted DB with torch sorts and searches.
Float estimators are computed on the host in float64 with the oracle's
exact formulas (oracle.compare), from exact integer counts produced on the
device, so the TSV is byte-identical to the JAX package's for the same
input.

Every entry point takes `device` (default "cuda"; see utils.device).
"""

from __future__ import annotations

import json
import os
import stat
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import accumulate
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .index.store import SketchIndex, index_to_device
from .io import arena as _arena
from .io import encode as _encode
from .io import native as _native
from .io import read_pack as _read_pack
from .io import reader as _reader
from .io import tsv_join as _tsv_join
from .oracle import compare as _oracle_compare
from .ops import compact as _compact
from .ops import cuda_hash as _cuda_hash
from .ops import intersect as _intersect
from .ops import sketch as _sketch
from .ops import sketch_counted as _counted
from .ops import u64
from .ops.hash import INVALID_CODE
from .params import SketchParams
from .utils import device as _device
from .utils import hbm as _hbm
from .utils.profiling import span

DEFAULT_CHUNK = 1 << 13  # row width (bases) of the sketch pipeline; rows
# are grouped into ~512K-base steps (ops.sketch.STEP_TARGET)
DEFAULT_TILE = 512       # genomes per side of an all-vs-all tile

TSV_COLUMNS = (
    "query",
    "reference",
    "shared",
    "union",
    "jaccard",
    "mash_distance",
    "ani",
    "p_value",
)

# extra columns enabled by `dist --containment` (BinDash-style estimators:
# c_q = |S(q) ∩ S(r)| / |S(q)|, biased but standard for sketch-vs-sketch)
CONTAINMENT_COLUMNS = TSV_COLUMNS + (
    "containment_q",
    "containment_r",
    "ani_containment",
)

# extra columns enabled by `dist --bounds` (mash bounds analog: Wilson
# interval on the Jaccard, transformed to distance bounds)
BOUNDS_COLUMNS = TSV_COLUMNS + (
    "jaccard_lo",
    "jaccard_hi",
    "dist_lo",
    "dist_hi",
)


def add_bound_columns(rows: List[dict], k: int, conf: float = 0.95) -> List[dict]:
    for r in rows:
        r["jaccard_lo"], r["jaccard_hi"] = _oracle_compare.jaccard_ci(
            r["shared"], r["union"], conf
        )
        r["dist_lo"], r["dist_hi"] = _oracle_compare.distance_ci(
            r["shared"], r["union"], k, conf
        )
    return rows


# ------------------------------------------------------------ pipelining


class _HostPulls:
    """Device → host copies started as soon as the work they read is
    queued: each goes, non_blocking, into the next pinned buffer of a ring
    of `slots`, with an event recorded after it on the current stream, so
    that waiting for a pull waits for that copy alone and not for the work
    queued behind it.  A buffer is reused only after the event of its last
    copy.  A CPU tensor is its own pull."""

    def __init__(self, slots: int):
        self.ring = [[None, None] for _ in range(max(1, slots))]
        self.next = 0

    def start(self, x: torch.Tensor):
        if x.device.type != "cuda":
            return x
        slot = self.ring[self.next]
        self.next = (self.next + 1) % len(self.ring)
        if slot[1] is not None:
            slot[1].synchronize()
        if slot[0] is None or slot[0].numel() < x.numel() or slot[0].dtype != x.dtype:
            slot[0] = torch.empty(x.numel(), dtype=x.dtype, pin_memory=True)
        host = slot[0][:x.numel()].view(x.shape)
        host.copy_(x, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(x.device))
        return host, slot[1]

    @staticmethod
    def wait(pull) -> np.ndarray:
        """The pulled array (a copy: its pinned buffer is reused)."""
        if isinstance(pull, torch.Tensor):
            return pull.numpy()
        host, event = pull
        event.synchronize()
        return host.numpy().copy()


class _CodeStaging:
    """Host staging of the batched index build's code uploads: a ring of
    uint8 host buffers, pinned where the codes go to a card, that a thread
    keeps across builds (`code_staging`), so that a build allocates none
    once an earlier one has made them.  Batch t of a build writes its
    genomes' codes once, end to end, into slot t of the ring (`pack`); `upload`
    copies each genome, non_blocking, into its row of an INVALID-filled
    flat buffer on the device, records an event after the copies and
    gives the batch's overlapping chunk rows as a view of that buffer.  A
    slot is rewritten only after the event of its last copies.  On the CPU
    the buffers are not pinned and the copies are plain."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.slots: list = []  # [buffer, event after its last copies or None]
        self.allocs = 0        # buffers allocated

    def pack(self, t: int, genomes: Sequence[np.ndarray]) -> List[int]:
        """Write the genomes' codes end to end into slot t (once the copies
        that last read it are done); returns their offsets there, with the
        end of the last."""
        while len(self.slots) <= t:
            self.slots.append([None, None])
        slot = self.slots[t]
        if slot[1] is not None:
            slot[1].synchronize()
            slot[1] = None
        off = [0]
        for c in genomes:
            off.append(off[-1] + len(c))
        if slot[0] is None or slot[0].numel() < off[-1]:
            slot[0] = torch.empty(off[-1], dtype=torch.uint8, pin_memory=self.pinned)
            self.allocs += 1
        host = slot[0].numpy()
        for a, c in zip(off, genomes):
            host[a:a + len(c)] = c
        return off

    def upload(self, t: int, off: List[int], g_pad: int, shape: tuple, k: int,
               dev: torch.device) -> torch.Tensor:
        """The [g_pad, n_pad, W] chunk rows (shape = (n_pad, W)) of the
        genomes packed into slot t at `off`, laid out on `dev`: row gi of
        the flat [g_pad, n_pad * (W - k + 1) + k - 1] buffer holds genome
        gi's codes, INVALID past its end and in padding genomes."""
        n_pad, w = shape
        flat = torch.full((g_pad, n_pad * (w - k + 1) + k - 1), INVALID_CODE,
                          dtype=torch.uint8, device=dev)
        host = self.slots[t][0]
        for gi in range(len(off) - 1):
            flat[gi, :off[gi + 1] - off[gi]].copy_(host[off[gi]:off[gi + 1]],
                                                  non_blocking=True)
        if flat.is_cuda:
            self.slots[t][1] = torch.cuda.Event()
            self.slots[t][1].record(torch.cuda.current_stream(dev))
        return _sketch.overlapping_rows(flat, k, w)


_STAGING = threading.local()  # each thread's {pinned: _CodeStaging} and _ParseArena


def code_staging(pinned: bool) -> _CodeStaging:
    """The calling thread's code staging ring, pinned or not."""
    rings = getattr(_STAGING, "rings", None)
    if rings is None:
        rings = _STAGING.rings = {}
    if pinned not in rings:
        rings[pinned] = _CodeStaging(pinned)
    return rings[pinned]


class _ParseArena:
    """Host memory that build_index parses FASTA files into: one uint8
    buffer that a thread keeps across builds (`parse_arena`), so that a
    build's parse writes into pages an earlier build touched.  `slices`
    hands out one slice a file at the running sum of the file sizes before
    it, growing the buffer (`allocs`) only when a build's files exceed it.
    A build's codes are views of these slices, read until the build
    returns; the next build on the thread rewrites them."""

    def __init__(self):
        self.buf = np.zeros(0, dtype=np.uint8)
        self.allocs = 0  # buffers allocated

    def slices(self, sizes: Sequence[int]) -> List[np.ndarray]:
        total = sum(sizes)
        if self.buf.size < total:
            self.buf = np.empty(total, dtype=np.uint8)
            self.allocs += 1
        return [self.buf[e - n:e] for n, e in zip(sizes, accumulate(sizes))]


def parse_arena() -> _ParseArena:
    """The calling thread's parse arena."""
    arena = getattr(_STAGING, "arena", None)
    if arena is None:
        arena = _STAGING.arena = _ParseArena()
    return arena


def _file_size(path) -> int:
    """A regular file's size in bytes, else 0 (the file then takes the
    general reader, which raises what it raises today)."""
    try:
        st = os.stat(path)
    except OSError:
        return 0
    return st.st_size if stat.S_ISREG(st.st_mode) else 0


def _tpu_pull_knobs() -> None:
    """MIEKKI_PULL_GROUP and MIEKKI_PRESORT, the pull schedules of the
    reference's stream-pass route, are accepted and change nothing here:
    they amortise a fixed cost per device-to-host transfer of the TPU's
    host link, which the card's pinned copies (_HostPulls) do not pay, and
    both leave the outputs bit-identical.  A PULL_GROUP that is not an
    integer raises, as in the reference."""
    int(os.environ.get("MIEKKI_PULL_GROUP", "4"))


def _pipeline_depth(default: str) -> int:
    """MIEKKI_PIPELINE: work items dispatched beyond the one being
    finished (0: synchronous dispatch → finish)."""
    return max(0, int(os.environ.get("MIEKKI_PIPELINE", default)))


# ---------------------------------------------------------------- sketching


def sketch_file(path, params: SketchParams, chunk: int = DEFAULT_CHUNK,
                device="cuda") -> np.ndarray:
    """Sketch one genome file (all records pooled) → sorted uint64[<=s]."""
    dev = _device.resolve(device)
    records = _reader.read_genome_codes(path)
    packed = _encode.pack_records(records, params.k)
    if len(packed) < params.k:
        return np.zeros(0, dtype=np.uint64)
    return _sketch.sketch_codes_device(packed, params.k, params.s, chunk=chunk,
                                       device=dev)


MAX_GENOME_BATCH = 16  # genomes sketched side by side per batch (shape
# buckets, power-of-two batch sizes)


def build_index_per_record(
    paths: Sequence, params: SketchParams, chunk: int = DEFAULT_CHUNK,
    batch: int = MAX_GENOME_BATCH, min_copies: int = 1, device="cuda",
) -> SketchIndex:
    """Sketch every RECORD of the input files as its own entry (the
    `mash sketch -i` mode — one sketch per contig/sequence)."""
    names: List[str] = []
    codes_list: List[np.ndarray] = []
    with span("sketch"):
        with span("sketch.parse") as sp:
            for p in paths:
                for rec_name, codes in _reader.read_encoded(p):
                    names.append(rec_name or f"{p}:{len(names)}")
                    codes_list.append(codes)
                    sp.add(bases=len(codes))
        return _build_index_from_codes(codes_list, names, params, chunk, batch,
                                       min_copies, device)


def build_index(
    paths: Sequence, params: SketchParams, names: Optional[Sequence[str]] = None,
    chunk: int = DEFAULT_CHUNK, batch: int = MAX_GENOME_BATCH,
    min_copies: int = 1, device="cuda",
) -> SketchIndex:
    """Sketch many genome files into an index (one genome per file).

    Genomes whose bucketed chunk layout matches are sketched together in
    batches (power-of-two group sizes, INVALID-padded).  Each batch's
    genomes cross to the device as their codes alone; the overlapping
    chunk rows are laid out there (_CodeStaging).  batch=1 sketches one
    genome at a time.

    Where the native reader is on, each plain FASTA file is parsed straight
    into its slice of the thread's parse arena (io.arena, _ParseArena);
    every other file, and any the arena parser declines, takes the general
    reader.  Both give the same codes.
    """
    if names is None:
        names = [str(p) for p in paths]
    k = params.k

    def parse(i):
        if slots[i] is not None and slots[i].size:  # a non-empty regular file
            n = _arena.parse_into(paths[i], slots[i], k)
            if n is not None:
                return slots[i][:n], True
        return _encode.pack_records(_reader.read_genome_codes(paths[i]), k), False

    with span("sketch"):
        with span("sketch.parse") as sp:
            slots = (parse_arena().slices([_file_size(p) for p in paths])
                     if _native.available() and _arena.available() else [None] * len(paths))
            if len(paths) > 4:
                # the parsers (ctypes) and gzip inflate release the GIL, so
                # file parsing overlaps across threads
                with ThreadPoolExecutor(max_workers=8) as ex:
                    parsed = list(ex.map(parse, range(len(paths))))
            else:
                parsed = [parse(i) for i in range(len(paths))]
            codes_list = [c for c, _ in parsed]
            sp.add(bases=sum(len(c) for c in codes_list),
                   arena_files=sum(a for _, a in parsed))
        return _build_index_from_codes(codes_list, list(names), params, chunk,
                                       batch, min_copies, device)


def _build_index_from_codes(
    codes_list: Sequence[np.ndarray], names: List[str], params: SketchParams,
    chunk: int, batch: int, min_copies: int = 1, device="cuda",
) -> SketchIndex:
    dev = _device.resolve(device)
    k, s = params.k, params.s
    if min_copies > 1:
        # abundance-filtered (`mash sketch -m`): each input alone, no genome
        # batching (the counted buffer's retries depend on the input)
        sketches = [
            np.zeros(0, dtype=np.uint64) if len(c) < k
            else _counted.sketch_codes_device_counted(c, k, s, min_copies,
                                                      chunk=chunk, device=dev)
            for c in codes_list
        ]
        return SketchIndex.from_sketches(sketches, names, params)
    if batch <= 1:
        sketches = [
            np.zeros(0, dtype=np.uint64) if len(c) < k
            else _sketch.sketch_codes_device(c, k, s, chunk=chunk, device=dev)
            for c in codes_list
        ]
        return SketchIndex.from_sketches(sketches, names, params)
    with span("sketch.bucket"):
        by_shape: dict = {}
        for i, c in enumerate(codes_list):
            if len(c) >= k:
                by_shape.setdefault(_sketch.bucketed_shape(len(c), k, chunk), []).append(i)
    sketches = [np.zeros(0, dtype=np.uint64)] * len(codes_list)
    # Each batch's keys are the final sketch rows (sorted, INF-padded), so
    # the index may keep them on the device: copied in genome order into
    # one INF-filled [N, s] table as each batch is dispatched (genomes
    # shorter than k keep INF rows), the batch then dropped
    planes = (u64.inf_like((len(codes_list), s), device=dev)
              if by_shape and _keep_device_planes(len(codes_list), s, dev) else None)
    # MIEKKI_PIPELINE (default 1, as the reference): batch t + 1 is staged,
    # uploaded and dispatched before batch t's keys are pulled; each batch's
    # pull is started right after its sketch (_HostPulls).  Batch t stages
    # through slot t mod (depth + 1): batch t + depth + 1, the next to use
    # it, is staged after batch t is finished
    depth = _pipeline_depth("1")
    pulls = _HostPulls(depth + 1)
    staging = code_staging(dev.type == "cuda")

    def dispatches():
        # each span closes before the yield: the caller's finish() is no child
        groups = [(shape, idxs[a : a + batch]) for shape, idxs in by_shape.items()
                  for a in range(0, len(idxs), batch)]
        for t, (shape, grp) in enumerate(groups):
            g_pad = 1 << max(0, (len(grp) - 1).bit_length())
            slot = t % (depth + 1)
            with span("sketch.pack"):
                off = staging.pack(slot, [codes_list[i] for i in grp])
            # the codes cross as uint8 bases; the [G, n, W] rows (G genomes
            # side by side) are laid out on the device
            with span("sketch.upload", bytes=off[-1],
                      row_bytes=g_pad * shape[0] * shape[1]):
                rows = staging.upload(slot, off, g_pad, shape, k, dev)
            with span("sketch.merge"):
                keys = _sketch.sketch_chunked(rows, k, s)
                del rows  # freed now, not after the next batch's upload
                if planes is not None:
                    planes.index_copy_(0, torch.tensor(grp, device=dev),
                                       keys[:len(grp)])
                pull = pulls.start(keys)
            yield grp, pull

    def finish(grp, pull):
        with span("sketch.pull"):
            vals = u64.u64_from_keys(pulls.wait(pull))
            for gi, i in enumerate(grp):
                sketches[i] = vals[gi][vals[gi] != u64.UINT64_MAX]

    pending: deque = deque()
    for item in dispatches():
        pending.append(item)
        while len(pending) > depth:
            finish(*pending.popleft())
    while pending:
        finish(*pending.popleft())
    index = SketchIndex.from_sketches(sketches, names, params)
    index.device_planes = planes
    return index


def _keep_device_planes(n: int, s: int, device) -> bool:
    """May the builder keep its [n, s] key table on `device` as the index's
    device_planes?  MIEKKI_KEEP_DEV=0|1 decides; unset, never on the CPU
    (the host table is already there), else while the table's 8 B a value
    fit utils.hbm's planes budget (keep_planes_ok)."""
    env = os.environ.get("MIEKKI_KEEP_DEV")
    if env is not None:
        return env != "0"
    dev = torch.device(device)
    if dev.type == "cpu":
        return False
    return _hbm.keep_planes_ok(n * s * 8, dev)


# ---------------------------------------------------------------- distances


def _row_from_counts(shared: int, union: int, k: int,
                     n1: float = 0.0, n2: float = 0.0) -> dict:
    j = shared / union if union > 0 else 0.0
    d = _oracle_compare.mash_distance(j, k)
    return {
        "shared": shared,
        "union": union,
        "jaccard": j,
        "mash_distance": d,
        "ani": _oracle_compare.ani_from_distance(d),
        "p_value": _oracle_compare.chance_p_value(shared, union, n1, n2, k),
    }


def _planes_on(index: SketchIndex, device: torch.device) -> Optional[torch.Tensor]:
    """The index's device_planes if they live on `device`, else None."""
    planes = index.device_planes
    if planes is None:
        return None
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return planes if planes.device == device else None


# dist_tiles' block counters, summed over sweeps and set to 0 by the caller
# as the kernels' `launches` are: blocks formed ("loads"), cache hits,
# evictions, plane bytes copied from the host, host seconds spent staging
# them into pinned memory, the last sweep's cache cap in blocks, and of the
# loads those taken from device planes ("plane_loads") with the bytes they
# copied into lane-padded blocks ("plane_bytes"; 0 for a block that is a
# view of the planes).
BLOCK_COUNTS: dict = {}


def reset_block_counts() -> None:
    BLOCK_COUNTS.update(loads=0, hits=0, evictions=0, bytes_uploaded=0,
                        staging_s=0.0, cap=0, plane_loads=0, plane_bytes=0)


reset_block_counts()


class _KeyBlocks:
    """The key blocks of one dist_tiles sweep, through a bounded cache.

    Block b of a side is rows [b * tile, (b + 1) * tile) of its key table as
    one [tile, lane] tensor (lane: ops.intersect.lane_width), INF-padded on
    the lane and, at a partial edge block, on the rows.  A side whose
    device_planes live on the device slices them (no copy where nothing is
    padded).  Any other side's block is formed on the device from its uint32
    host planes, staged through one of two pinned buffers and uploaded on a
    copy stream, so its whole key table is never on the device.

    The cache is the reference's (miekki_tpu/engine.py:473-539): keys
    (side, b), side "a" for both sides of a self-comparison; a hit is
    re-inserted, the oldest block evicted while the cache is full; at most
    max(2, cache_bytes // bytes_per_block) blocks, cache_bytes from
    MIEKKI_COL_CACHE_MB (MiB) or else utils.hbm.dist_cache_bytes (which
    counts the `depth` tiles in flight, as the reference's).  The
    sweep's accesses are known in advance: a model of the cache runs ahead
    of it over them to the next block the cache will miss, which `prefetch`
    loads while the current tile runs (one block beyond the cache)."""

    def __init__(self, index_a: SketchIndex, index_b: Optional[SketchIndex],
                 tile: int, dev: torch.device, accesses: Iterable, depth: int = 1):
        self.index = {"a": index_a, "b": index_a if index_b is None else index_b}
        self.planes = {side: _planes_on(idx, dev) for side, idx in self.index.items()}
        self.tile, self.dev = tile, dev
        self.s = index_a.params.s
        self.compact = index_a.params.compact
        self.dtype = torch.int32 if self.compact else torch.int64
        self.lane = _intersect.lane_width(self.s)
        bytes_per_block = tile * self.lane * (4 if self.compact else 8)
        cache_mb = os.environ.get("MIEKKI_COL_CACHE_MB")
        if cache_mb is not None:
            cache_bytes = int(cache_mb) << 20
        else:
            resident = sum(p.numel() * p.element_size() for p in
                           {id(p): p for p in self.planes.values() if p is not None}.values())
            cache_bytes = _hbm.dist_cache_bytes(resident, depth, bytes_per_block, dev)
        self.cap = max(2, cache_bytes // bytes_per_block)
        BLOCK_COUNTS["cap"] = self.cap
        self.accesses = iter(accesses)
        self.model: dict = {}  # the cache's keys, up to the model's last miss
        self.cache: dict = {}
        self.ahead = None  # (key, entry) of the prefetched block
        self.staging = None  # made at the first host load on a card

    def get(self, key: tuple) -> torch.Tensor:
        """Block `key` for the tile about to be dispatched on the current
        stream."""
        ent = self.cache.pop(key, None)
        if ent is None:
            if self.ahead is not None:
                ent = self.ahead[1]
                self.ahead = None
            else:
                self._next_miss()
                ent = self._load(key)
        else:
            BLOCK_COUNTS["hits"] += 1
        while len(self.cache) >= self.cap:
            self.cache.pop(next(iter(self.cache)))
            BLOCK_COUNTS["evictions"] += 1
        self.cache[key] = ent
        if ent[1] is not None:  # formed on the copy stream: wait for it once
            torch.cuda.current_stream(self.dev).wait_event(ent[1])
            ent[1] = None
        return ent[0]

    def prefetch(self) -> None:
        if self.ahead is None:
            key = self._next_miss()
            if key is not None:
                self.ahead = (key, self._load(key))

    def _next_miss(self) -> Optional[tuple]:
        """Run the model over the accesses to the next miss: the block the
        cache will load next (the model and the cache see the same
        accesses, so with no block ahead the model stands at the cache's
        last miss)."""
        for key in self.accesses:
            hit = self.model.pop(key, False)
            while len(self.model) >= self.cap:
                self.model.pop(next(iter(self.model)))
            self.model[key] = True
            if not hit:
                return key
        return None

    def _load(self, key: tuple) -> list:
        """[block, event or None]: the event, where the block was formed on
        the copy stream, is recorded there after it."""
        side, b = key
        with span("dist.block_load") as sp:
            BLOCK_COUNTS["loads"] += 1
            n = len(self.index[side])
            r0, r1 = b * self.tile, min((b + 1) * self.tile, n)
            planes = self.planes[side]
            if planes is not None:
                BLOCK_COUNTS["plane_loads"] += 1
                keys = planes[r0:r1]
                if r1 - r0 == self.tile and self.lane == self.s:
                    sp.add(plane_bytes=0)
                    return [keys, None]
                blk = self._padded(r1 - r0)
                blk[:r1 - r0, :self.s] = keys
                nbytes = keys.numel() * keys.element_size()
                BLOCK_COUNTS["plane_bytes"] += nbytes
                sp.add(plane_bytes=nbytes)
                return [blk, None]
            idx = self.index[side]
            host = [idx.hi[r0:r1]] if self.compact else [idx.hi[r0:r1], idx.lo[r0:r1]]
            nbytes = sum(h.nbytes for h in host)
            BLOCK_COUNTS["bytes_uploaded"] += nbytes
            sp.add(bytes=nbytes)
            host = [torch.from_numpy(h.view(np.int32)) for h in host]
            if self.dev.type == "cpu":
                return [self._form(host, r1 - r0), None]
            return self._upload(host, r1 - r0)

    def _padded(self, rows: int) -> torch.Tensor:
        """An empty block whose padding (lane columns past s, rows past
        `rows`) holds the INF key."""
        blk = torch.empty((self.tile, self.lane), dtype=self.dtype, device=self.dev)
        inf = _intersect.inf_key(self.dtype)
        if self.lane > self.s:
            blk[:rows, self.s:].fill_(inf)
        if rows < self.tile:
            blk[rows:].fill_(inf)
        return blk

    def _form(self, planes: list, rows: int) -> torch.Tensor:
        """A block from int32 views of its uint32 planes, on their device:
        u64.keys_from_planes' int64 ((hi << 32) | lo) ^ 2^63, computed in
        place in the block as (lo & 0xFFFFFFFF) + hi * 2^32 (no shift of a
        signed value), or compact.keys32_from_codes' int32 codes ^ 2^31."""
        blk = self._padded(rows)
        keys = blk[:rows, :self.s]
        if self.compact:
            keys.copy_(planes[0])
            keys.bitwise_xor_(-(1 << 31))
        else:
            keys.copy_(planes[1])
            keys.bitwise_and_(0xFFFFFFFF)
            keys.add_(planes[0], alpha=1 << 32)
            keys.bitwise_xor_(u64.SIGN_BIT)
        return blk

    def _upload(self, host: list, rows: int) -> list:
        """Stage the planes' rows into the next pinned buffer (once the copy
        that last read it is done), copy them to the device and form the
        block there, all on the copy stream."""
        if self.staging is None:
            shape = (len(host), self.tile, self.s)
            self.copy_stream = torch.cuda.Stream(self.dev)
            with torch.cuda.stream(self.copy_stream):
                self.dev_planes = torch.empty(shape, dtype=torch.int32, device=self.dev)
            self.staging = [[torch.empty(shape, dtype=torch.int32, pin_memory=True), None]
                            for _ in range(2)]
        t0 = time.perf_counter()
        buf = self.staging[0]
        self.staging.reverse()
        if buf[1] is not None:
            buf[1].synchronize()
        for p, h in enumerate(host):
            buf[0][p, :rows].copy_(h)
        BLOCK_COUNTS["staging_s"] += time.perf_counter() - t0
        with torch.cuda.stream(self.copy_stream):
            for p in range(len(host)):
                self.dev_planes[p, :rows].copy_(buf[0][p, :rows], non_blocking=True)
            buf[1] = torch.cuda.Event()
            buf[1].record(self.copy_stream)
            blk = self._form([self.dev_planes[p, :rows] for p in range(len(host))], rows)
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        blk.record_stream(torch.cuda.current_stream(self.dev))
        return [blk, ready]


def dist_tiles(
    index_a: SketchIndex,
    index_b: Optional[SketchIndex] = None,
    tile: int = DEFAULT_TILE,
    device="cuda",
    *,
    skip_tiles: Optional[set] = None,
    raw: bool = False,
    depth: Optional[int] = None,
):
    """Tile-level comparison generator: yields
    ``(bi, bj, gi, gj, shared, union, inter)`` per tile, where gi/gj are
    int64 arrays of the valid global pair coordinates (upper triangle only
    for self-comparison) in row-major order, and shared/union/inter are the
    matching int32 count arrays.  A tile (bi, bj) in `skip_tiles` is
    neither dispatched nor yielded (manifest resume).

    raw=True yields ``(bi, bj, None, None, shared2d, union2d, inter2d)``:
    full [tile, tile] rectangles, edge tiles included (the caller clips
    with its n_a/n_b), with no pair mask; matrix builders slice-assign
    them.

    Blocks come from _KeyBlocks: sliced from a side's device_planes when it
    has them on the device, else formed on the device from its host planes
    one block at a time, through a cache bounded by MIEKKI_COL_CACHE_MB or
    utils.hbm.dist_cache_bytes; nothing writes into a block.  A compact
    index's int32 code-key blocks go through tile_counts_compact, a raw
    one's through tile_counts, on the route MIEKKI_INTERSECT names (K4/K3
    under auto, pallas, mxu or unset; bitonic, searchsorted).

    Pipelining: `depth` tiles (MIEKKI_PIPELINE, default 1; 0 is
    synchronous dispatch → finish) are dispatched, and the next block the
    cache misses is loaded, before tile t is finished.  Each tile's
    stacked counts are copied to a pinned host buffer right after its
    kernel (engine._HostPulls), so finishing tile t waits for its own copy
    and not for the tiles queued behind it.

    MIEKKI_PULL_GROUP and MIEKKI_PRESORT are accepted and change nothing
    (_tpu_pull_knobs)."""
    self_compare = index_b is None
    if index_b is not None:
        index_a.params.validate_compatible(index_b.params)
    idx_b = index_a if self_compare else index_b
    dev = _device.resolve(device)
    s = index_a.params.s
    tile = min(tile, max(len(index_a), len(idx_b), 1))
    n_a, n_b = len(index_a), len(idx_b)
    nb_a, nb_b = -(-n_a // tile), -(-n_b // tile)
    side_b = "a" if self_compare else "b"
    compact = index_a.params.compact
    if depth is None:
        depth = _pipeline_depth("1")
    _tpu_pull_knobs()

    def sweep():
        for bi in range(nb_a):
            for bj in range(bi if self_compare else 0, nb_b):
                if not (skip_tiles and (bi, bj) in skip_tiles):
                    yield bi, bj

    blocks = _KeyBlocks(index_a, index_b, tile, dev,
                        (key for bi, bj in sweep() for key in (("a", bi), (side_b, bj))),
                        depth=depth)
    ti_flat = np.repeat(np.arange(tile, dtype=np.int64), tile)
    tj_flat = np.tile(np.arange(tile, dtype=np.int64), tile)
    counts_fn = _intersect.tile_counts_compact if compact else _intersect.tile_counts

    def dispatch(bi: int, bj: int) -> torch.Tensor:
        counts = counts_fn(blocks.get(("a", bi)), blocks.get((side_b, bj)), s)
        return torch.stack([counts["shared_in_x"], counts["union_size"],
                            counts["inter_full"]])

    def finish(bi: int, bj: int, packed: np.ndarray):
        """The tile's yield from its pulled stacked counts."""
        if raw:
            return (bi, bj, None, None, packed[0], packed[1], packed[2])
        shared, union, inter = (packed[0].ravel(), packed[1].ravel(),
                                packed[2].ravel())
        gi = bi * tile + ti_flat
        gj = bj * tile + tj_flat
        mask = (gi < n_a) & (gj < n_b)
        if self_compare:
            mask &= gj > gi
        sel = np.flatnonzero(mask)
        return (bi, bj, gi[sel], gj[sel], shared[sel], union[sel], inter[sel])

    def pulled(item) -> tuple:
        """The yield of a pending tile: its pull waited for, then finished
        (both spans closed before the yield, so the caller's are no
        children of them)."""
        bi0, bj0, pull = item
        with span("dist.pull_wait"):
            packed = pulls.wait(pull)
        with span("dist.finish"):
            return finish(bi0, bj0, packed)

    pulls = _HostPulls(depth + 1)
    pending: deque = deque()  # (bi, bj, pull of the tile's stacked counts)
    for bi, bj in sweep():
        with span("dist.dispatch"):
            # the pull is started now, right after the tile's work is queued
            pending.append((bi, bj, pulls.start(dispatch(bi, bj))))
            blocks.prefetch()
        while len(pending) > depth:
            yield pulled(pending.popleft())
    while pending:
        yield pulled(pending.popleft())


def dist_counts_matrix(
    index_a: SketchIndex,
    index_b: Optional[SketchIndex] = None,
    tile: int = DEFAULT_TILE,
    device="cuda",
) -> dict:
    """Full count matrices of a comparison job: {"shared", "union",
    "inter"} int32 [n_a, n_b], slice-assigned from dist_tiles' raw
    rectangles.  For self-comparison the sweep covers the tiles on and
    above the diagonal, so the lower triangle holds values inside the
    diagonal tiles only (zeros elsewhere), and the diagonal is then filled
    with min(size, s) (shared, union) and size (inter).

    The sweep runs at MIEKKI_PIPELINE tiles in flight, default 8 here (the
    reference's default for this function)."""
    self_compare = index_b is None
    idx_b = index_a if self_compare else index_b
    n_a, n_b = len(index_a), len(idx_b)
    s = index_a.params.s
    t = min(tile, max(n_a, n_b, 1))
    with span("dist.counts"):
        shared = np.zeros((n_a, n_b), np.int32)
        union = np.zeros((n_a, n_b), np.int32)
        inter = np.zeros((n_a, n_b), np.int32)
        for bi, bj, _, _, sh, un, it in dist_tiles(index_a, index_b, tile, device=device,
                                                   raw=True, depth=_pipeline_depth("8")):
            with span("dist.assemble"):
                r0, r1 = bi * t, min((bi + 1) * t, n_a)
                c0, c1 = bj * t, min((bj + 1) * t, n_b)
                shared[r0:r1, c0:c1] = sh[: r1 - r0, : c1 - c0]
                union[r0:r1, c0:c1] = un[: r1 - r0, : c1 - c0]
                inter[r0:r1, c0:c1] = it[: r1 - r0, : c1 - c0]
        with span("dist.fill"):
            if self_compare:
                sizes = index_a.sizes().astype(np.int32)
                np.fill_diagonal(shared, np.minimum(sizes, s))
                np.fill_diagonal(union, np.minimum(sizes, s))
                np.fill_diagonal(inter, sizes)
    return {"shared": shared, "union": union, "inter": inter}


def dist_iter(
    index_a: SketchIndex,
    index_b: Optional[SketchIndex] = None,
    tile: int = DEFAULT_TILE,
    device="cuda",
) -> Iterator[dict]:
    """Pairwise comparison rows (self all-vs-all upper triangle when
    index_b is None), computed tile by tile on the device.  Row-level API —
    the TSV writer below uses the vectorized block path instead."""
    self_compare = index_b is None
    idx_b = index_a if self_compare else index_b
    k = index_a.params.k
    cards_a = index_a.cardinalities()
    cards_b = cards_a if self_compare else idx_b.cardinalities()
    sizes_a = index_a.sizes()
    sizes_b = sizes_a if self_compare else idx_b.sizes()

    for _, _, gis, gjs, shs, uns, its in dist_tiles(index_a, index_b, tile,
                                                    device):
        for gi, gj, sh, un, it in zip(gis, gjs, shs, uns, its):
            gi, gj, it = int(gi), int(gj), int(it)
            row = _row_from_counts(int(sh), int(un), k,
                                   cards_a[gi], cards_b[gj])
            sz_q = int(sizes_a[gi])
            sz_r = int(sizes_b[gj])
            row["containment_q"] = it / sz_q if sz_q else 0.0
            row["containment_r"] = it / sz_r if sz_r else 0.0
            row["ani_containment"] = _oracle_compare.ani_from_containment(
                max(row["containment_q"], row["containment_r"]), k
            )
            row["query"] = index_a.names[gi]
            row["reference"] = idx_b.names[gj]
            row["i"], row["j"] = gi, gj
            yield row


def dist(index_a: SketchIndex, index_b: Optional[SketchIndex] = None,
         tile: int = DEFAULT_TILE, device="cuda") -> List[dict]:
    """All comparison rows, sorted by (i, j) — deterministic across tilings."""
    return sorted(dist_iter(index_a, index_b, tile, device),
                  key=lambda r: (r["i"], r["j"]))


def rows_from_count_matrices(
    index_a: SketchIndex,
    shared: np.ndarray,
    union: np.ndarray,
    index_b: Optional[SketchIndex] = None,
    inter: Optional[np.ndarray] = None,
) -> List[dict]:
    """Comparison rows from full [N_a, N_b] count matrices — identical rows
    to engine.dist.  When `inter` (full |S(A) ∩ S(B)|) is given, the
    containment columns are populated exactly as dist_iter does."""
    self_compare = index_b is None
    idx_b = index_a if self_compare else index_b
    k = index_a.params.k
    rows = []
    cards_a = index_a.cardinalities()
    cards_b = cards_a if self_compare else idx_b.cardinalities()
    sizes_a = index_a.sizes()
    sizes_b = sizes_a if self_compare else idx_b.sizes()
    for i in range(len(index_a)):
        j0 = i + 1 if self_compare else 0
        for j in range(j0, len(idx_b)):
            row = _row_from_counts(int(shared[i, j]), int(union[i, j]), k,
                                   cards_a[i], cards_b[j])
            if inter is not None:
                it = int(inter[i, j])
                sz_q, sz_r = int(sizes_a[i]), int(sizes_b[j])
                row["containment_q"] = it / sz_q if sz_q else 0.0
                row["containment_r"] = it / sz_r if sz_r else 0.0
                row["ani_containment"] = _oracle_compare.ani_from_containment(
                    max(row["containment_q"], row["containment_r"]), k
                )
            row["query"] = index_a.names[i]
            row["reference"] = idx_b.names[j]
            row["i"], row["j"] = i, j
            rows.append(row)
    return rows


def select_columns(containment: bool = False, bounds: bool = False):
    """TSV column tuple for a dist output with optional extras."""
    cols = CONTAINMENT_COLUMNS if containment else TSV_COLUMNS
    if bounds:
        cols = tuple(cols) + BOUNDS_COLUMNS[len(TSV_COLUMNS):]
    return tuple(cols)


def filter_rows(rows, max_dist: Optional[float] = None,
                max_p: Optional[float] = None) -> List[dict]:
    """--max-dist / --max-p row filters (mash dist -d / -v analogs)."""
    out = list(rows)
    if max_dist is not None:
        out = [r for r in out if r["mash_distance"] <= max_dist]
    if max_p is not None:
        out = [r for r in out if r["p_value"] <= max_p]
    return out


# ------------------------------------------------- vectorized TSV emission
#
# Every float column except p_value is a function of (shared, union) or
# (inter, size), so each UNIQUE combo is formatted once and broadcast via
# np.unique's inverse index: every column is a table of distinct cells and
# a per-row index into it, and io.tsv_join joins the rows in one native
# pass.  The float columns use the oracle's vectorized primitives, bitwise
# equal to the scalar row path.


def _fmt_unique_floats(vals: np.ndarray) -> list:
    return [f"{v:.10g}" for v in vals.tolist()]


def _fmt_unique_ints(vals: np.ndarray) -> list:
    return [str(v) for v in vals.tolist()]


class _BlockFormatter:
    """Per-pair TSV block formatter over count arrays (shared state: names,
    cardinalities, sizes, params — prepared once per dist job)."""

    def __init__(self, index_a: SketchIndex, index_b: Optional[SketchIndex],
                 columns: Sequence[str] = TSV_COLUMNS,
                 max_dist: Optional[float] = None,
                 max_p: Optional[float] = None, conf: float = 0.95):
        idx_b = index_a if index_b is None else index_b
        self.k, self.s = index_a.params.k, index_a.params.s
        self.columns = tuple(columns)
        self.max_dist, self.max_p, self.conf = max_dist, max_p, conf
        # (UTF-8 bytes, offsets) of the names: the query and reference tables
        self.names_a = _tsv_join.cell_table(index_a.names)
        self.names_b = (self.names_a if index_b is None
                        else _tsv_join.cell_table(idx_b.names))
        self.cards_a = np.asarray(index_a.cardinalities(), dtype=np.float64)
        self.cards_b = (self.cards_a if index_b is None
                        else np.asarray(idx_b.cardinalities(), np.float64))
        self.sizes_a = np.asarray(index_a.sizes(), dtype=np.int64)
        self.sizes_b = (self.sizes_a if index_b is None
                        else np.asarray(idx_b.sizes(), dtype=np.int64))

    def header(self) -> str:
        return "#" + "\t".join(self.columns) + "\n"

    def format(self, gi, gj, shared, union, inter) -> tuple[str, int]:
        """One block of pairs → (TSV text without header, rows kept)."""
        n = gi.shape[0]
        if n == 0:
            return "", 0
        k, s = self.k, self.s
        shared = shared.astype(np.int64)
        union = union.astype(np.int64)
        inter = inter.astype(np.int64)
        m = np.int64(s + 1)

        code_su, inv_su = np.unique(shared * m + union, return_inverse=True)
        u_sh, u_un = code_su // m, code_su % m
        u_j = np.where(u_un > 0, u_sh / np.where(u_un > 0, u_un, 1), 0.0)
        u_d = _oracle_compare.mash_distance_vec(u_j, k)

        need_p = "p_value" in self.columns or self.max_p is not None
        if need_p:
            with span("dist.pvalue") as sp:
                tally: dict = {}
                p = _oracle_compare.chance_p_value_vec(
                    shared, union, self.cards_a[gi], self.cards_b[gj], k,
                    counts=tally)
                sp.add(pairs=tally["betainc"])

        keep = None
        if self.max_dist is not None:
            keep = u_d[inv_su] <= self.max_dist
        if self.max_p is not None:
            kp = p <= self.max_p
            keep = kp if keep is None else keep & kp
        if keep is not None and not keep.all():
            sel = np.flatnonzero(keep)
            gi, gj, shared, union, inter, inv_su = (
                x[sel] for x in (gi, gj, shared, union, inter, inv_su))
            if need_p:
                p = p[sel]
            n = gi.shape[0]
            if n == 0:
                return "", 0

        bounds: dict = {}

        def cells(strs, index) -> _tsv_join.Column:
            return (*_tsv_join.cell_table(strs), index)

        def col(c: str) -> _tsv_join.Column:
            if c == "query":
                return (*self.names_a, gi)
            if c == "reference":
                return (*self.names_b, gj)
            if c == "shared":
                return cells(_fmt_unique_ints(u_sh), inv_su)
            if c == "union":
                return cells(_fmt_unique_ints(u_un), inv_su)
            if c == "jaccard":
                return cells(_fmt_unique_floats(u_j), inv_su)
            if c == "mash_distance":
                return cells(_fmt_unique_floats(u_d), inv_su)
            if c == "ani":
                return cells(_fmt_unique_floats(
                    _oracle_compare.ani_from_distance_vec(u_d)), inv_su)
            if c == "p_value":
                with span("dist.pvalue"):
                    # cell 0 is "1" (no shared value); the rest one a sharing row
                    pos = np.flatnonzero(shared > 0)
                    idx = np.zeros(n, dtype=np.int64)
                    idx[pos] = np.arange(1, pos.size + 1)
                    return cells(["1"] + [f"{v:.10g}" for v in p[pos].tolist()], idx)
            if c in ("containment_q", "containment_r"):
                sz = (self.sizes_a[gi] if c.endswith("q")
                      else self.sizes_b[gj])
                cu, ci = np.unique(inter * m + sz, return_inverse=True)
                it_u, sz_u = cu // m, cu % m
                cv = np.where(sz_u > 0,
                              it_u / np.where(sz_u > 0, sz_u, 1), 0.0)
                return cells(_fmt_unique_floats(cv), ci)
            if c == "ani_containment":
                code3, ci = np.unique(
                    (inter * m + self.sizes_a[gi]) * m + self.sizes_b[gj],
                    return_inverse=True)
                szr_u = code3 % m
                it_u, szq_u = (code3 // m) // m, (code3 // m) % m
                cq = np.where(szq_u > 0,
                              it_u / np.where(szq_u > 0, szq_u, 1), 0.0)
                cr = np.where(szr_u > 0,
                              it_u / np.where(szr_u > 0, szr_u, 1), 0.0)
                av = _oracle_compare.ani_from_containment_vec(
                    np.maximum(cq, cr), k)
                return cells(_fmt_unique_floats(av), ci)
            if c in ("jaccard_lo", "jaccard_hi", "dist_lo", "dist_hi"):
                if not bounds:
                    jlo, jhi = _oracle_compare.jaccard_ci_vec(
                        u_sh, u_un, self.conf)
                    bounds.update(
                        jaccard_lo=jlo, jaccard_hi=jhi,
                        dist_lo=_oracle_compare.mash_distance_vec(jhi, k),
                        dist_hi=_oracle_compare.mash_distance_vec(jlo, k))
                return cells(_fmt_unique_floats(bounds[c]), inv_su)
            raise KeyError(f"unknown TSV column {c!r}")

        return _tsv_join.join([col(c) for c in self.columns], n), n


# Pairs per _BlockFormatter.format call: the call holds every column's
# per-row index (8 B a cell) and the rows' text (~100 B a pair, twice: the
# joined bytes and their str), so capping the call bounds peak host memory.
FORMAT_CHUNK = 1 << 20


def _format_write(fmt: "_BlockFormatter", out, gi, gj, sh, un, it,
                  chunk: int = FORMAT_CHUNK) -> tuple[int, int]:
    """Format (already ordered) pair arrays in bounded chunks; returns the
    rows and characters written.  Chunks are sequential slices, so output
    order is unchanged."""
    n_rows = n_chars = 0
    for a in range(0, gi.shape[0], chunk):
        sl = np.s_[a : a + chunk]
        text, n = fmt.format(gi[sl], gj[sl], sh[sl], un[sl], it[sl])
        with span("dist.write", bytes=len(text)):
            out.write(text)
        n_rows += n
        n_chars += len(text)
    return n_rows, n_chars


def _tsv_formatter(index_a, index_b, columns, max_dist, max_p,
                   bounds) -> "_BlockFormatter":
    """The block formatter of a dist TSV; --bounds appends its columns to
    the default set."""
    if bounds and len(columns) == len(TSV_COLUMNS):
        columns = tuple(columns) + BOUNDS_COLUMNS[len(TSV_COLUMNS):]
    return _BlockFormatter(index_a, index_b, columns, max_dist, max_p)


def dist_tsv_write(
    out,
    index_a: SketchIndex,
    index_b: Optional[SketchIndex] = None,
    tile: int = DEFAULT_TILE,
    columns: Sequence[str] = TSV_COLUMNS,
    max_dist: Optional[float] = None,
    max_p: Optional[float] = None,
    bounds: bool = False,
    device="cuda",
) -> int:
    """Stream the dist TSV to a file object via the vectorized block path,
    in global (i, j) order (each row-block stripe is buffered and sorted):
    row order and content identical to rows_to_tsv(dist(...)).  Returns
    rows written."""
    device = _device.resolve(device)
    fmt = _tsv_formatter(index_a, index_b, columns, max_dist, max_p, bounds)
    out.write(fmt.header())
    n_rows = 0
    stripe_bi = None
    stripe: List[tuple] = []

    def flush():
        nonlocal n_rows
        if not stripe:
            return
        with span("dist.format") as sp:
            native = _tsv_join.TSV_JOIN_COUNTS["native_rows"]
            gi, gj, sh, un, it = (np.concatenate(x) for x in zip(*stripe))
            order = np.lexsort((gj, gi))
            n, chars = _format_write(fmt, out, gi[order], gj[order],
                                     sh[order], un[order], it[order])
            sp.add(rows=n, bytes=chars,
                   native_rows=_tsv_join.TSV_JOIN_COUNTS["native_rows"] - native)
        n_rows += n
        stripe.clear()

    with span("dist.tsv"):
        for bi, bj, gi, gj, sh, un, it in dist_tiles(index_a, index_b, tile, device):
            if bi != stripe_bi:
                flush()
                stripe_bi = bi
            stripe.append((gi, gj, sh, un, it))
        flush()
    return n_rows


def counts_tsv_write(
    out,
    index_a: SketchIndex,
    shared: np.ndarray,
    union: np.ndarray,
    index_b: Optional[SketchIndex] = None,
    inter: Optional[np.ndarray] = None,
    columns: Sequence[str] = TSV_COLUMNS,
    max_dist: Optional[float] = None,
    max_p: Optional[float] = None,
    row_chunk: int = 256,
) -> int:
    """TSV from full [N_a, N_b] count matrices (dist_counts_matrix's
    output) via the block path — the rows of
    rows_to_tsv(rows_from_count_matrices(...)), in (i, j) order; processed
    in chunks of `row_chunk` query rows to bound peak host memory."""
    self_compare = index_b is None
    idx_b = index_a if self_compare else index_b
    n_a, n_b = len(index_a), len(idx_b)
    shared, union = np.asarray(shared), np.asarray(union)
    inter = np.zeros_like(shared) if inter is None else np.asarray(inter)
    fmt = _BlockFormatter(index_a, index_b, columns, max_dist, max_p)
    out.write(fmt.header())
    n_rows = 0
    for r0 in range(0, n_a, row_chunk):
        r1 = min(r0 + row_chunk, n_a)
        gi = np.repeat(np.arange(r0, r1, dtype=np.int64), n_b)
        gj = np.tile(np.arange(n_b, dtype=np.int64), r1 - r0)
        if self_compare:
            sel = np.flatnonzero(gj > gi)
            gi, gj = gi[sel], gj[sel]
        n_rows += _format_write(fmt, out, gi, gj, shared[gi, gj],
                                union[gi, gj], inter[gi, gj])[0]
    return n_rows


def dist_resumable(
    index_a: SketchIndex,
    out_path,
    manifest_path,
    index_b: Optional[SketchIndex] = None,
    tile: int = DEFAULT_TILE,
    columns: Sequence[str] = TSV_COLUMNS,
    max_dist: Optional[float] = None,
    max_p: Optional[float] = None,
    bounds: bool = False,
    device="cuda",
) -> int:
    """Checkpointed comparison: TSV rows go out tile by tile and each
    completed tile is recorded as a JSON line {"bi", "bj"} in the
    manifest.  On restart (both files present) the recorded tiles are
    skipped and rows are appended.  A tile's rows are flushed before its
    manifest line, so a crash can at worst duplicate the rows of one
    unrecorded tile.  Returns the rows written by this call."""
    done: set = set()
    if os.path.exists(manifest_path) and os.path.exists(out_path):
        with open(manifest_path) as mf:
            for line in mf:
                line = line.strip()
                if line:
                    rec = json.loads(line)
                    done.add((rec["bi"], rec["bj"]))
    fresh = not done
    mode = "w" if fresh else "a"
    fmt = _tsv_formatter(index_a, index_b, columns, max_dist, max_p, bounds)
    n_rows = 0
    with open(out_path, mode) as out, open(manifest_path, mode) as mf:
        if fresh:
            out.write(fmt.header())
        # rows go out per tile, in tile order, unsorted within the file
        for bi, bj, gi, gj, sh, un, it in dist_tiles(
                index_a, index_b, tile, device=device, skip_tiles=done):
            n_rows += _format_write(fmt, out, gi, gj, sh, un, it)[0]
            out.flush()
            mf.write(json.dumps({"bi": bi, "bj": bj}) + "\n")
            mf.flush()
    return n_rows


def _dist_matrix(index: SketchIndex, tile: int = DEFAULT_TILE,
                 device="cuda") -> np.ndarray:
    """Full symmetric [n, n] Mash-distance matrix (upper tiles computed,
    mirrored; the diagonal stays 0).  Distances are evaluated once per
    unique (shared, union) combination per tile."""
    n = len(index)
    # [n, n] float64 is 800 MB at n = 10k; the matrix texts are only sane
    # well below that
    if n > 46_000:  # ~16 GB of float64
        raise ValueError(
            f"dist matrix for {n} genomes would need "
            f"{n * n * 8 / 1e9:.0f} GB; use dist --counts / "
            "dist_counts_matrix (int32 counts) or the row TSV instead")
    k, s = index.params.k, index.params.s
    mat = np.zeros((n, n), dtype=np.float64)
    m = np.int64(s + 1)
    for _, _, gi, gj, sh, un, _ in dist_tiles(index, tile=tile, device=device):
        code, inv = np.unique(sh.astype(np.int64) * m + un, return_inverse=True)
        u_j = np.where(code % m > 0,
                       (code // m) / np.where(code % m > 0, code % m, 1), 0.0)
        d = _oracle_compare.mash_distance_vec(u_j, k)[inv]
        mat[gi, gj] = d
        mat[gj, gi] = d
    return mat


def _matrix_cells(index: SketchIndex, tile: int, device):
    """(formatted unique distances, [n, n] index of each cell into them):
    each unique value is formatted once."""
    n = len(index)
    u_vals, inv = np.unique(_dist_matrix(index, tile, device), return_inverse=True)
    return np.asarray(_fmt_unique_floats(u_vals), dtype=np.str_), inv.reshape(n, n)


def dist_matrix_text(index: SketchIndex, tile: int = DEFAULT_TILE,
                     device="cuda") -> str:
    """Phylip-style square Mash-distance matrix (the `mash dist -t`
    analog)."""
    n = len(index)
    u_strs, inv = _matrix_cells(index, tile, device)
    lines = [f"\t{n}"]
    for i in range(n):
        lines.append(index.names[i] + "\t" + "\t".join(u_strs[inv[i]].tolist()))
    return "\n".join(lines) + "\n"


def dist_triangle_text(index: SketchIndex, tile: int = DEFAULT_TILE,
                       device="cuda") -> str:
    """Lower-triangular Phylip matrix (the `mash triangle` analog): the
    genome count, then row i with the name and the distances to genomes
    0..i-1 only."""
    n = len(index)
    u_strs, inv = _matrix_cells(index, tile, device)
    lines = [f"\t{n}"]
    for i in range(n):
        lines.append("\t".join([index.names[i]] + u_strs[inv[i, :i]].tolist()))
    return "\n".join(lines) + "\n"


def rows_to_tsv(rows: Sequence[dict], columns: Sequence[str] = TSV_COLUMNS) -> str:
    """Deterministic TSV (floats as %.10g)."""
    lines = ["#" + "\t".join(columns)]
    for r in rows:
        cells = []
        for c in columns:
            v = r[c]
            cells.append(f"{v:.10g}" if isinstance(v, float) else str(v))
        lines.append("\t".join(cells))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- screening
#
# A read hash can only hit a sketch if it is <= the LARGEST value in any
# bottom-s sketch.  The DB's sketches are flattened into one value-sorted
# key array on the device (genome id = position // s of the [N, s] table);
# each packed read batch is hashed by kernel K1 and joined into a bitmap
# over the flat DB whose slot m (one past the end) is a sink for
# non-matches, by one of the reference's joins (MIEKKI_SCREEN_JOIN):
#
#   * searchsorted (the port's default): the batch is value-sorted and
#     searched in the DB (in chunks of MIEKKI_SCREEN_CHUNK where it is
#     set), each match marking the first slot of its value's run; hashes
#     above the DB's largest value match nothing, so no host sync is needed;
#   * merge (the reference's default; one pass only, as in the reference):
#     one stable sort of the DB keys and the batch's, a segmented OR over
#     equal-value runs, and every DB copy of a matched value marked.
#
# Per-genome distinct-hit counts come from the bitmap on the host, which
# reads each run's first slot, so both joins give the same rows.  Keys
# live in one domain on both sides of the join: int64 order keys
# (ops.u64), a compact DB's codes as the order keys of (code << 32), the
# value SketchIndex.sketch_u64 gives them; INF_KEY (no valid value equals
# it) sorts last.  A DB beyond the memory budgets (utils.hbm) is screened
# in genome groups, the read stream once per group, by the searchsorted
# join; one pass is the case of a single group.

DEFAULT_READ_FLAT = 1 << 22  # packed read bases per screening batch
SCREEN_JOINS = ("searchsorted", "merge")  # MIEKKI_SCREEN_JOIN values
_KMV_S0 = 4096  # bottom-s0 KMV state for the optional screen p-value
# column: relative error of the read-set cardinality ~1/sqrt(s0) ≈ 1.6%


def _screen_join() -> str:
    """MIEKKI_SCREEN_JOIN, read at call time: searchsorted (unset; the join
    the port's screen budgets and measurements were made with) or merge
    (the reference's default).  Any other value raises, where the
    reference takes its searchsorted family."""
    join = os.environ.get("MIEKKI_SCREEN_JOIN", "searchsorted").lower()
    if join not in SCREEN_JOINS:
        raise ValueError(f"unknown MIEKKI_SCREEN_JOIN {join!r}; expected one of "
                         f"{', '.join(SCREEN_JOINS)}")
    return join


def _screen_chunk() -> Optional[int]:
    """MIEKKI_SCREEN_CHUNK, read at call time: hashes probed per step of the
    searchsorted join.  Unset is None, the whole batch in one call: the
    port's default, where the reference's is 32768 (the card holds a
    batch's probes, tens of MiB, and each chunk costs launches)."""
    env = os.environ.get("MIEKKI_SCREEN_CHUNK")
    return max(1, int(env)) if env else None


def _screen_db_value_budgets(device, join: str = "searchsorted", batch: int = 0):
    """(max flat-DB values screened in one pass, max values resident per
    genome group) on `device`: the reference's merge and resident budgets
    (utils.hbm), each capped by the port's on-device flat-DB build, and
    under the merge join the one-pass budget also by that join's peak with
    a batch of up to `batch` hashes (utils.hbm.screen_merge_join_value_budget).
    MIEKKI_SCREEN_DB_VALS overrides both, as in the reference (tests force
    small groups with it)."""
    env = os.environ.get("MIEKKI_SCREEN_DB_VALS")
    if env:
        return max(1, int(env)), max(1, int(env))
    cap = _hbm.screen_flatten_value_budget(device)
    one_pass = min(_hbm.screen_merge_value_budget(device), cap)
    if join == "merge":
        one_pass = min(one_pass, _hbm.screen_merge_join_value_budget(device, batch))
    return one_pass, min(_hbm.screen_resident_value_budget(device), cap)


def _stable_argsort_u64(flat: np.ndarray) -> np.ndarray:
    """Stable argsort of a host u64 array: torch's multi-threaded stable
    sort on the order keys from 2^20 values up (u64 order is the order
    keys' int64 order, so the permutation is identical), np.argsort below."""
    if len(flat) >= (1 << 20):
        return torch.argsort(torch.from_numpy(u64.keys_from_u64(flat)),
                             stable=True).numpy()
    return np.argsort(flat, kind="stable")


def _compact_keys_from_codes(keys32: torch.Tensor) -> torch.Tensor:
    """int32 code keys (ops.compact) → int64 order keys of (code << 32);
    the sentinel → INF_KEY."""
    keys = keys32.to(torch.int64)
    keys <<= 32
    return keys.masked_fill_(keys32 == _compact.INF_KEY32, u64.INF_KEY)


def _compact_keys_from_hashes(keys: torch.Tensor) -> torch.Tensor:
    """int64 order keys of read hashes → the compact domain: the order key
    of (encode_pair(hash) << 32), INF_KEY for INF (encode_pair keeps valid
    codes below the sentinel)."""
    raw = keys ^ u64.SIGN_BIT
    code = _compact.encode_pair((raw >> 32) & _compact.U32, raw & _compact.U32)
    out = (code - (1 << 31)) << 32
    return out.masked_fill(code == _compact.U32, u64.INF_KEY)


def _flatten_db(index: SketchIndex, device):
    """Value-sorted flat DB: its int64 keys [M] on the device, and its
    values (uint64) and genome ids (int32) on the host, as the reference's
    host _flatten_db gives them.  One stable sort of the [N, s] key table
    with the INF padding dropped; ties keep genome order, as the
    reference's host sort of the concatenated sketches does.  The sort's
    peak is utils.hbm.SCREEN_FLATTEN_BYTES_PER_VALUE; after it only the
    keys stay on the device."""
    table = index_to_device(index, device)
    if index.params.compact:
        table = _compact_keys_from_codes(table)
    vals, pos = torch.sort(table.reshape(-1), stable=True)
    del table
    m = int((vals != u64.INF_KEY).sum())
    gid = _to_host((pos[:m] // index.params.s).to(torch.int32))
    del pos
    db = vals[:m]
    # order keys → u64 values on the device: one host array, no host pass
    return db, _to_host(db ^ u64.SIGN_BIT).view(np.uint64), gid


PULL_CHUNK_BYTES = 1 << 28  # pinned staging buffer of a device → host copy


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array (a view of a CPU tensor).  From a card the copy
    goes through one pinned staging buffer of at most PULL_CHUNK_BYTES
    (pageable copies run at a fraction of the link's rate, and pinning a
    whole multi-GB result would round up to a power of two and stay
    cached in the host allocator)."""
    if x.device.type == "cpu":
        return x.numpy()
    flat = x.reshape(-1)
    out = torch.empty(flat.shape, dtype=x.dtype)
    step = max(1, PULL_CHUNK_BYTES // x.element_size())
    stage = torch.empty(min(step, flat.numel()), dtype=x.dtype, pin_memory=True)
    for a in range(0, flat.numel(), step):
        b = min(a + step, flat.numel())
        stage[:b - a].copy_(flat[a:b])
        out[a:b].copy_(stage[:b - a])
    return out.reshape(x.shape).numpy()


def _hash_batch(flat_codes: torch.Tensor, k: int) -> torch.Tensor:
    """Order keys of every k-window of one packed read batch ([F + k - 1]
    codes → [F]): kernel K1 on a CUDA tensor, its plain version on a CPU
    tensor."""
    return _cuda_hash.hash_windows_cuda(flat_codes.view(1, -1), k)[0]


def _screen_join_sorted(acc: torch.Tensor, db: torch.Tensor, thr: torch.Tensor,
                        hh: torch.Tensor, chunk: Optional[int] = None):
    """Join a value-sorted hash batch against the sorted DB, `chunk` hashes
    a step (None: the whole batch in one step): each match marks the lower
    bound of its value, the first slot of the value's run.  The survivors
    (h <= thr, the DB's largest value) are the prefix of `hh`; the rest
    match nothing (no DB value exceeds thr), so the steps need no mask and
    nothing waits for the card.  Returns (acc, n_keep as a device
    scalar)."""
    m, n = db.shape[0], hh.shape[0]
    step = chunk or max(n, 1)
    for a in range(0, n, step):
        ch = hh[a:a + step]
        probe = torch.searchsorted(db, ch).clamp_(max=m - 1)
        matched = db[probe] == ch  # a probe past the end lands on db[m - 1] < ch
        acc.index_put_((torch.where(matched, probe, m),), matched)
    return acc, (hh <= thr).sum()


def _screen_join_merge(acc: torch.Tensor, db: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Which DB values appear in the hash batch `h` (any order)?  One stable
    sort of the DB keys followed by the batch's (so within an equal-value
    run the DB copies come first, as the reference's sort by (value,
    is_read) puts them) with each element's index riding along; a DB copy
    is hit iff the last element of its run is a read (the segmented OR of
    the reference's log-doubling rolls, exactly); the hits are scattered
    back by the DB index that rode along (the reference restores them by a
    second sort on (is_read, index): the same bitmap).  Every DB copy of a
    matched value is marked."""
    m = db.shape[0]
    vals, idx = torch.sort(torch.cat([db, h]), stable=True)
    n = vals.shape[0]
    is_read = idx >= m
    last = torch.ones(n, dtype=torch.bool, device=vals.device)
    last[:-1] = vals[1:] != vals[:-1]
    del vals
    run = torch.cumsum(last, 0, dtype=torch.int32)
    run -= last.to(torch.int32)  # run id: the runs ended before this element
    run_read = torch.zeros(n + 1, dtype=torch.bool, device=acc.device)
    run_read.index_put_((torch.where(last, run, n),), is_read)  # slot n: a sink
    hit = run_read[run] & ~is_read
    acc.index_put_((torch.where(hit, idx, m),), hit)
    return acc


def _screen_batch(acc: torch.Tensor, db: torch.Tensor, thr: torch.Tensor,
                  flat_codes: torch.Tensor, k: int, compact: bool, join: str,
                  chunk: Optional[int]):
    """One packed read batch hashed (K1) and joined into `acc` by `join`.
    Returns (acc, n_valid — valid k-mer windows, n_keep — windows at or
    below thr, both device scalars, and the batch's unsorted hash keys,
    which the KMV state reuses)."""
    h = _hash_batch(flat_codes, k)
    n_valid = (h != u64.INF_KEY).sum()  # counted before the compact map
    hc = _compact_keys_from_hashes(h) if compact else h
    if join == "merge":
        return _screen_join_merge(acc, db, hc), n_valid, (hc <= thr).sum(), h
    acc, n_keep = _screen_join_sorted(acc, db, thr, torch.sort(hc).values, chunk)
    return acc, n_valid, n_keep, h


def _kmv_init(s0: int = _KMV_S0, device="cpu") -> torch.Tensor:
    return u64.inf_like((s0,), device=device)


def _kmv_update(state: torch.Tensor, h: torch.Tensor,
                s0: int = _KMV_S0) -> torch.Tensor:
    """Bottom-s0 distinct-hash (KMV) state after one batch's hash keys:
    sort, dedup (duplicates become INF), sort, truncate.  Set-union
    semantics, so the state depends only on the hashes seen; the keys of
    the JAX package's (hi, lo) state, bit for bit."""
    keys = torch.sort(torch.cat([state, h.reshape(-1)])).values
    dup = torch.zeros_like(keys, dtype=torch.bool)
    dup[1:] = keys[1:] == keys[:-1]
    return torch.sort(keys.masked_fill(dup, u64.INF_KEY)).values[:s0]


def _kmv_estimate(state: torch.Tensor) -> float:
    """Read-set distinct canonical-k-mer estimate from the KMV state;
    exact when fewer than s0 distinct hashes were seen."""
    vals = u64.u64_from_keys(state)
    return _oracle_compare.kmv_cardinality(vals, len(vals))


def _prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` on a reader thread with a bounded queue: host-side file
    IO and packing overlap the device's work on the previous batch.
    Exceptions propagate to the consumer."""
    import queue as _queue
    import threading as _threading

    q: _queue.Queue = _queue.Queue(maxsize=depth)
    _END = object()
    stop = _threading.Event()

    def put_checked(item) -> bool:
        # bounded put with a stop check: if the consumer abandons iteration
        # (device error, KeyboardInterrupt), a plain q.put would block
        # forever and leak the thread + the open stream handle it holds
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not put_checked(item):
                    return
            put_checked(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            put_checked(e)

    t = _threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()
    finally:
        stop.set()
        if hasattr(it, "close"):
            # release the underlying stream promptly (generators holding
            # native handles); the thread exits on its next stop check
            try:
                t.join(timeout=5.0)
                it.close()
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass


def _packed_read_batches(path, k: int, flat: int) -> Iterator[torch.Tensor]:
    """Pack read records into uint8[F + k - 1] rows, separator-delimited."""
    for row, *_ in _packed_read_rows(path, k, flat):
        yield row


def _packed_read_rows(path, k: int, flat: int, pin: bool = False) -> Iterator[tuple]:
    """_packed_read_batches' rows, each with the number of reads whose
    first base lies in it, the number of read bases it adds (a base in two
    overlapping rows counts in the first) and whether the native pass
    (io.read_pack) packed it; its rows are views of one tensor a chunk,
    pinned with `pin`.

    Where the pass is not built, records are packed here, in file order,
    into rows of whole records; a record longer than a row is split into
    pieces with k - 1 bases of overlap."""
    if _native.available() and _read_pack.available():
        for row, n_reads, n_bases in _read_pack.rows(path, k, flat, pin):
            yield row, n_reads, n_bases, True
        return
    _native.warn_python_fallback("_packed_read_batches")
    buf = np.full(flat + k - 1, _encode.INVALID_CODE, dtype=np.uint8)
    pos = reads = bases = 0
    step = flat - k + 1  # long records are split with k-1 overlap so every
    # window is hashed exactly once (piece i covers starts [i*step, ...))

    def pieces(codes):
        n = len(codes)
        if n <= flat:
            yield codes
        else:
            for a in range(0, n - k + 1, step):
                yield codes[a : a + flat]

    def row():
        _read_pack.count(fallback_batches=1)
        return torch.from_numpy(buf), reads, bases, False

    for _, codes in _reader.read_encoded(path):
        for p, piece in enumerate(pieces(codes)):
            n = len(piece)
            if pos + n + (k - 1 if pos else 0) > flat:
                yield row()
                buf = np.full(flat + k - 1, _encode.INVALID_CODE, dtype=np.uint8)
                pos = reads = bases = 0
            if pos:
                pos += k - 1  # separator gap: windows can't span records
            buf[pos : pos + n] = piece
            pos += n
            reads += p == 0
            bases += n - (k - 1 if p else 0)  # a later piece repeats k - 1
    if pos:
        yield row()


def _as_path_list(reads_path) -> List:
    if isinstance(reads_path, (str, bytes, os.PathLike)):
        return [reads_path]
    return list(reads_path)


def _batch_to_device(batch: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One packed read batch on `device`: copied asynchronously to a card
    from pinned memory (a row the packer staged there is copied as it is,
    any other is pinned first)."""
    if device.type == "cuda":
        if not batch.is_pinned():
            batch = batch.pin_memory()
        batch = batch.to(device, non_blocking=True)
    return batch


def _device_batches(reads_path, k: int, flat: int, device: torch.device):
    """Every packed read batch of every file, on `device` (packed on a
    reader thread, into pinned memory for a card; a `screen.pack` span
    holds this thread's wait for a batch and its upload, counts its reads,
    read bases, the batch and whether the native pass packed it, and
    closes before the yield; one more holds the wait for each file's
    end)."""
    for path in _as_path_list(reads_path):
        rows = _prefetch(_packed_read_rows(path, k, flat, pin=device.type == "cuda"))
        while True:
            with span("screen.pack") as sp:
                item = next(rows, None)
                if item is None:
                    break
                batch, n_reads, n_bases, native = item
                sp.add(reads=n_reads, bases=n_bases, batches=1, native_batches=int(native))
                dev_batch = _batch_to_device(batch, device)
            yield dev_batch


HITS_CHUNK = 1 << 26  # flat-DB slots per step of _hits_from_bitmap


def _hits_from_bitmap(flat_vals: np.ndarray, gid: np.ndarray,
                      acc: np.ndarray, n_genomes: int) -> np.ndarray:
    """Bitmap → per-genome distinct-hit counts.

    The join marks only the FIRST slot of an equal-value run (a hash shared
    by several genomes); propagate marks across runs before counting.  The
    flat DB is walked in steps of about HITS_CHUNK slots that start on run
    boundaries, which bounds the host's int64 temporaries."""
    hits = np.zeros(n_genomes, np.int64)
    m, a = len(flat_vals), 0
    while a < m:
        b = min(a + HITS_CHUNK, m)
        while b < m and flat_vals[b] == flat_vals[b - 1]:
            b += 1  # a step ends where a run does
        hit_all = acc[a:b][_first_occ_idx(flat_vals[a:b])]
        hits += np.bincount(gid[a:b][hit_all], minlength=n_genomes)
        a = b
    return hits


def _first_occ_idx(flat_vals: np.ndarray) -> np.ndarray:
    """Index of the first slot of each equal-value run, per slot: equal to
    np.searchsorted(flat_vals, flat_vals, "left") on sorted input, by
    linear run-boundary passes."""
    if len(flat_vals) == 0:
        return np.zeros(0, np.int64)
    newrun = np.concatenate([[True], flat_vals[1:] != flat_vals[:-1]])
    starts = np.flatnonzero(newrun)
    run_id = np.cumsum(newrun) - 1
    return starts[run_id]


def _hits_winner_takes_all(flat_vals: np.ndarray, gid: np.ndarray,
                           acc: np.ndarray, n_genomes: int,
                           sizes: Optional[np.ndarray] = None) -> np.ndarray:
    """Winner-takes-all hit attribution (the `mash screen -w` analog):
    each DISTINCT hit hash value is credited to exactly one genome — the
    genome with the highest plain containment among those whose sketch
    contains the value (ties → lower genome index).

    sizes: per-genome sketch sizes — ranking is by containment hits/size
    (falls back to raw hit counts when omitted; identical when all sketches
    are full at s)."""
    if len(flat_vals) == 0:
        return np.zeros(n_genomes, np.int64)
    plain = _hits_from_bitmap(flat_vals, gid, acc, n_genomes)
    score = (plain / np.maximum(sizes, 1) if sizes is not None
             else plain.astype(np.float64))
    # rank genomes: better containment → smaller rank (ties → lower index)
    order = np.lexsort((np.arange(n_genomes), -score))
    rank = np.empty(n_genomes, np.int64)
    rank[order] = np.arange(n_genomes)
    # equal-value runs in the sorted flat DB; run is hit iff its first slot is
    starts = np.flatnonzero(
        np.concatenate([[True], flat_vals[1:] != flat_vals[:-1]]))
    run_min_rank = np.minimum.reduceat(rank[gid], starts)
    winners = order[run_min_rank[acc[:-1][starts]]]
    return np.bincount(winners, minlength=n_genomes).astype(np.int64)


def _winner_from_hitall(vals: np.ndarray, gid: np.ndarray,
                        hit_all: np.ndarray, n_genomes: int,
                        sizes: np.ndarray) -> np.ndarray:
    """Winner-takes-all arbitration from per-slot hit marks (the grouped
    analog of _hits_winner_takes_all, which derives the marks from a
    first-of-run bitmap; semantics and tie-breaks identical)."""
    order_v = np.argsort(vals, kind="stable")
    vals = vals[order_v]
    gid = gid[order_v]
    hit = hit_all[order_v]
    plain = np.bincount(gid[hit], minlength=n_genomes).astype(np.int64)
    score = plain / np.maximum(sizes, 1)
    order = np.lexsort((np.arange(n_genomes), -score))
    rank = np.empty(n_genomes, np.int64)
    rank[order] = np.arange(n_genomes)
    starts = np.flatnonzero(
        np.concatenate([[True], vals[1:] != vals[:-1]]))
    run_hit = hit[starts]  # marks are propagated across each run already
    run_min_rank = np.minimum.reduceat(rank[gid], starts)
    winners = order[run_min_rank[run_hit]]
    return np.bincount(winners, minlength=n_genomes).astype(np.int64)


def _screen_rows(index: SketchIndex, hits: np.ndarray,
                 read_card: Optional[float] = None) -> List[dict]:
    sizes = index.sizes()
    k = index.params.k
    pvals = None
    if read_card is not None:
        pvals = _oracle_compare.screen_p_value_vec(hits, sizes, read_card, k)
    out = []
    for g in range(len(index)):
        c = float(hits[g]) / float(sizes[g]) if sizes[g] > 0 else 0.0
        c_lo, c_hi = _oracle_compare.jaccard_ci(int(hits[g]), int(sizes[g]))
        row = {
            "reference": index.names[g],
            "hits": int(hits[g]),
            "sketch_size": int(sizes[g]),
            "containment": c,
            "containment_lo": c_lo,
            "containment_hi": c_hi,
            "ani": _oracle_compare.ani_from_containment(c, k),
        }
        if pvals is not None:
            row["p_value"] = float(pvals[g])
        out.append(row)
    return out


def _packbits_device(acc: torch.Tensor) -> torch.Tensor:
    """Bool bitmap → uint8 bytes on the device, 8 strided slices, bit order
    "big" as np.unpackbits reads it."""
    n = acc.shape[0]
    a = torch.zeros(-(-n // 8) * 8, dtype=torch.uint8, device=acc.device)
    a[:n] = acc
    word = torch.zeros(a.shape[0] // 8, dtype=torch.uint8, device=acc.device)
    for j in range(8):
        word |= a[j::8] << (7 - j)
    return word


def _pull_bitmap(acc: torch.Tensor) -> np.ndarray:
    """Device bool bitmap → host, moved as packed bits (8× fewer bytes)."""
    n = acc.shape[0]
    packed = _to_host(_packbits_device(acc))
    return np.unpackbits(packed)[:n].astype(np.bool_)


def screen(
    index: SketchIndex, reads_path, flat: int = DEFAULT_READ_FLAT,
    winner: bool = False, stats: Optional[dict] = None,
    p_values: bool = False, device="cuda",
) -> List[dict]:
    """Containment of each DB genome's sketch in the read stream:
    c_g = |S(g) ∩ H(reads)| / |S(g)|.

    reads_path may be one file or a list of files (hits union across all).
    winner=True switches to winner-takes-all hit attribution (`mash screen
    -w` analog).  When `stats` is a dict, prefilter observability is
    written into it: n_windows, n_survivors, survivor_rate, n_batches.
    p_values=True adds a "p_value" column: the chance probability of >=
    hits under a binomial null with the read set's distinct-k-mer count
    estimated by a bottom-s0 KMV state carried across batches.

    A DB beyond the one-pass budget (utils.hbm, MIEKKI_SCREEN_DB_VALS) is
    screened in contiguous genome groups within the residency budget, with
    identical rows; its stats add n_slabs and phase_seconds."""
    with span("screen"):
        dev = _device.resolve(device)
        sizes = index.sizes()
        join = _screen_join()
        one_pass, per_group = _screen_db_value_budgets(dev, join, flat)
        groups = [(0, len(index))]
        grouped = int(sizes.sum()) > one_pass and len(index) > 1
        if grouped:
            groups, start, acc_v = [], 0, 0
            for i, v in enumerate(sizes):
                if acc_v + int(v) > per_group and i > start:
                    groups.append((start, i))
                    start, acc_v = i, 0
                acc_v += int(v)
            groups.append((start, len(index)))
        run: dict = {}
        # beyond the one-pass budget the searchsorted join, as in the reference
        hits, kmv = _screen_groups(index, reads_path, flat, groups, winner, run,
                                   _kmv_init(device=dev) if p_values else None, dev,
                                   "searchsorted" if grouped else join)
        if stats is not None and run:
            if not grouped:
                del run["n_slabs"], run["phase_seconds"]
            stats.update(run)
        read_card = _kmv_estimate(kmv) if kmv is not None else None
    with span("screen.rows", rows=len(index)):
        return _screen_rows(index, hits, read_card)


def _screen_groups(index: SketchIndex, reads_path, flat: int, groups,
                   winner: bool, stats: dict, kmv: Optional[torch.Tensor],
                   device: torch.device, join: str = "searchsorted"):
    """Hash-once screen of contiguous genome groups [(i0, i1), ...] (the
    reference's _screen_bitmap for one group, _screen_slabbed for several).

    Each group's flat keys and hit bitmap stay on the device for a whole
    pass over the read stream; each batch is hashed and joined into the
    group (_screen_batch) by `join` (screen() passes MIEKKI_SCREEN_JOIN's
    in one pass, the searchsorted join beyond it, as in the reference).
    Containment decomposes by genome subsets; winner mode with several
    groups merges their per-slot hit marks and arbitrates globally.  Stats: n_windows
    and n_batches cover one group's pass, n_survivors sums over groups,
    n_slabs is the group count, phase_seconds times the phases; per-batch
    counters stay device scalars, read once per group.  The KMV state
    depends on the reads alone and is updated during the first streamed
    group.  Returns (hits per genome, the KMV state)."""
    k = index.params.k
    compact = index.params.compact
    sizes = index.sizes()
    chunk = _screen_chunk()
    hits = np.zeros(len(index), np.int64)
    win_parts = []
    kmv_done = False
    timings: dict = {"flatten_s": 0.0, "stream_s": 0.0, "acc_pull_s": 0.0,
                     "hits_s": 0.0}
    for i0, i1 in groups:
        t_ph = time.perf_counter()
        sub = SketchIndex(index.params, index.names[i0:i1],
                          index.hi[i0:i1], index.lo[i0:i1])
        with span("screen.flatten") as sp:
            db, flat_vals, gid = _flatten_db(sub, device)
            sp.add(values=len(flat_vals), bytes=flat_vals.nbytes + gid.nbytes)
        timings["flatten_s"] += time.perf_counter() - t_ph
        if db.shape[0] == 0:
            continue
        t_ph = time.perf_counter()
        thr = db[-1]  # the group's largest sketch value
        acc = torch.zeros(db.shape[0] + 1, dtype=torch.bool, device=device)
        counters = []
        for dev_batch in _device_batches(reads_path, k, flat, device):
            with span("screen.join"):
                acc, n_valid, n_keep, h = _screen_batch(acc, db, thr, dev_batch, k,
                                                        compact, join, chunk)
                if kmv is not None and not kmv_done:
                    kmv = _kmv_update(kmv, h)
                counters.append(torch.stack([n_valid, n_keep]))
        kmv_done = True
        timings["stream_s"] += time.perf_counter() - t_ph
        windows, surv = (torch.stack(counters).sum(0).tolist()
                         if counters else (0, 0))
        if not stats:
            stats.update(n_windows=windows, n_survivors=surv,
                         n_batches=len(counters))
        else:
            stats["n_survivors"] += surv
        t_ph = time.perf_counter()
        with span("screen.pull", bytes=-(-acc.shape[0] // 8)):
            acc_np = _pull_bitmap(acc)
        del db, thr, acc  # free the group before the next one is built
        timings["acc_pull_s"] += time.perf_counter() - t_ph
        t_ph = time.perf_counter()
        with span("screen.hits"):
            if not winner:
                hits[i0:i1] = _hits_from_bitmap(flat_vals, gid, acc_np, i1 - i0)
            elif len(groups) == 1:  # the bitmap's runs are the whole DB's
                hits = _hits_winner_takes_all(flat_vals, gid, acc_np, len(index),
                                              np.asarray(sizes))
            else:
                # per-group hit marks propagated across equal-value runs;
                # global arbitration happens after the loop
                hit_first = acc_np[:-1]
                win_parts.append((flat_vals, gid + i0,
                                  hit_first[_first_occ_idx(flat_vals)]))
        timings["hits_s"] += time.perf_counter() - t_ph
    if stats:
        stats["phase_seconds"] = {p: round(v, 1) for p, v in timings.items()}
        stats["n_slabs"] = len(groups)
        stats["survivor_rate"] = (stats["n_survivors"]
                                  / (stats["n_windows"] * len(groups))
                                  if stats["n_windows"] else 0.0)
    if winner and win_parts:
        with span("screen.hits"):
            vals = np.concatenate([v for v, _, _ in win_parts])
            gids = np.concatenate([g for _, g, _ in win_parts])
            hit_all = np.concatenate([h for _, _, h in win_parts])
            hits = _winner_from_hitall(vals, gids, hit_all, len(index),
                                       np.asarray(sizes))
    return hits, kmv
