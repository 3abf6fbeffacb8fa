"""High-level engine: sketch and dist (counterpart of the JAX package's
engine.py, single-device paths).

Sketching runs kernel K1 through ops.sketch (and kernel K2 on the
MIEKKI_MERGE=fused strategy); the all-vs-all comparison runs kernel K3
tile by tile through ops.intersect, or kernel K4 on a compact index.
Float estimators are computed on the host in float64 with the oracle's
exact formulas (oracle.compare), from exact integer counts produced on the
device, so the TSV is byte-identical to the JAX package's for the same
input.

Every entry point takes `device` (default "cuda"; see utils.device).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from .index.store import SketchIndex, index_to_device
from .io import encode as _encode
from .io import reader as _reader
from .oracle import compare as _oracle_compare
from .ops import intersect as _intersect
from .ops import sketch as _sketch
from .ops import u64
from .ops.hash import INVALID_CODE
from .params import SketchParams
from .utils import device as _device

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
    for p in paths:
        for rec_name, codes in _reader.read_encoded(p):
            names.append(rec_name or f"{p}:{len(names)}")
            codes_list.append(codes)
    return _build_index_from_codes(codes_list, names, params, chunk, batch,
                                   min_copies, device)


def build_index(
    paths: Sequence, params: SketchParams, names: Optional[Sequence[str]] = None,
    chunk: int = DEFAULT_CHUNK, batch: int = MAX_GENOME_BATCH,
    min_copies: int = 1, device="cuda",
) -> SketchIndex:
    """Sketch many genome files into an index (one genome per file).

    Genomes whose bucketed chunk layout matches are sketched together in
    batches (power-of-two group sizes, INVALID-padded).  batch=1 sketches
    one genome at a time.
    """
    if names is None:
        names = [str(p) for p in paths]

    def parse(p):
        return _encode.pack_records(_reader.read_genome_codes(p), params.k)

    if len(paths) > 4:
        # the native parser (ctypes) and gzip inflate release the GIL, so
        # file parsing overlaps across threads
        with ThreadPoolExecutor(max_workers=8) as ex:
            codes_list = list(ex.map(parse, paths))
    else:
        codes_list = [parse(p) for p in paths]
    return _build_index_from_codes(codes_list, list(names), params, chunk,
                                   batch, min_copies, device)


def _build_index_from_codes(
    codes_list: Sequence[np.ndarray], names: List[str], params: SketchParams,
    chunk: int, batch: int, min_copies: int = 1, device="cuda",
) -> SketchIndex:
    if min_copies > 1:
        raise NotImplementedError(
            "abundance-filtered sketches (min_copies > 1) are not ported yet "
            "(ROADMAP M10)")
    dev = _device.resolve(device)
    k, s = params.k, params.s
    if batch <= 1:
        sketches = [
            np.zeros(0, dtype=np.uint64) if len(c) < k
            else _sketch.sketch_codes_device(c, k, s, chunk=chunk, device=dev)
            for c in codes_list
        ]
        return SketchIndex.from_sketches(sketches, names, params)
    rows_per_genome = [None if len(c) < k
                       else _sketch.bucketed_chunk_codes(c, k, chunk)
                       for c in codes_list]
    sketches = [np.zeros(0, dtype=np.uint64)] * len(codes_list)
    by_shape: dict = {}
    for i, rows in enumerate(rows_per_genome):
        if rows is not None:
            by_shape.setdefault(rows.shape, []).append(i)
    for shape, idxs in by_shape.items():
        for a in range(0, len(idxs), batch):
            grp = idxs[a : a + batch]
            g_pad = 1 << max(0, (len(grp) - 1).bit_length())
            stack = np.full((g_pad,) + shape, INVALID_CODE, np.uint8)
            for gi, i in enumerate(grp):
                stack[gi] = rows_per_genome[i]
            # uploaded as uint8 codes: one [G, n, W] batch, G genomes side by side
            keys = _sketch.sketch_chunked(torch.from_numpy(stack).to(dev), k, s)
            vals = u64.u64_from_keys(keys)
            for gi, i in enumerate(grp):
                sketches[i] = vals[gi][vals[gi] != u64.UINT64_MAX]
    return SketchIndex.from_sketches(sketches, names, params)


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


def _pad_rows(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """INF-pad an [N, s'] key table to a multiple of `tile` rows (no copy
    when already aligned)."""
    n = keys.shape[0]
    if n and n % tile == 0:
        return keys
    pad = keys.new_full((-(-n // tile) * tile - n, keys.shape[1]),
                        _intersect.inf_key(keys.dtype))
    return torch.cat([keys, pad])


def dist_tiles(
    index_a: SketchIndex,
    index_b: Optional[SketchIndex] = None,
    tile: int = DEFAULT_TILE,
    device="cuda",
):
    """Tile-level comparison generator: yields
    ``(bi, bj, gi, gj, shared, union, inter)`` per tile, where gi/gj are
    int64 arrays of the valid global pair coordinates (upper triangle only
    for self-comparison) in row-major order, and shared/union/inter are the
    matching int32 count arrays.

    The whole key table lives on the device (index_to_device, lane-padded
    once); tiles are its row slices.  A compact index's int32 code-key
    table goes through tile_counts_compact (K4), a raw one's through
    tile_counts (K3).  Depth-1 pipelining: tile t+1's counts are enqueued
    before tile t's are pulled with one `.cpu()`."""
    self_compare = index_b is None
    if index_b is not None:
        index_a.params.validate_compatible(index_b.params)
    idx_b = index_a if self_compare else index_b
    s = index_a.params.s
    tile = min(tile, max(len(index_a), len(idx_b), 1))
    n_a, n_b = len(index_a), len(idx_b)

    keys_a = _pad_rows(_intersect._pad_lane(index_to_device(index_a, device)), tile)
    keys_b = keys_a if self_compare else _pad_rows(
        _intersect._pad_lane(index_to_device(idx_b, device)), tile)
    nb_a, nb_b = keys_a.shape[0] // tile, keys_b.shape[0] // tile
    ti_flat = np.repeat(np.arange(tile, dtype=np.int64), tile)
    tj_flat = np.tile(np.arange(tile, dtype=np.int64), tile)
    counts_fn = (_intersect.tile_counts_compact if index_a.params.compact
                 else _intersect.tile_counts)

    def dispatch(bi: int, bj: int):
        counts = counts_fn(keys_a[bi * tile:(bi + 1) * tile],
                           keys_b[bj * tile:(bj + 1) * tile], s)
        return torch.stack([counts["shared_in_x"], counts["union_size"],
                            counts["inter_full"]])

    def finish(bi: int, bj: int, handle):
        packed = handle.cpu().numpy()
        shared, union, inter = (packed[0].ravel(), packed[1].ravel(),
                                packed[2].ravel())
        gi = bi * tile + ti_flat
        gj = bj * tile + tj_flat
        mask = (gi < n_a) & (gj < n_b)
        if self_compare:
            mask &= gj > gi
        sel = np.flatnonzero(mask)
        return (bi, bj, gi[sel], gj[sel], shared[sel], union[sel], inter[sel])

    pending: deque = deque()
    for bi in range(nb_a):
        for bj in range(nb_b):
            if self_compare and bj < bi:
                continue
            pending.append((bi, bj, dispatch(bi, bj)))
            if len(pending) > 1:
                yield finish(*pending.popleft())
    while pending:
        yield finish(*pending.popleft())


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
# np.unique's inverse index; assembly is C-level np.char.add over U arrays.
# The float columns use the oracle's vectorized primitives, bitwise equal
# to the scalar row path.


def _fmt_unique_floats(vals: np.ndarray) -> np.ndarray:
    return np.asarray([f"{v:.10g}" for v in vals.tolist()], dtype=np.str_)


def _fmt_unique_ints(vals: np.ndarray) -> np.ndarray:
    return np.asarray([str(v) for v in vals.tolist()], dtype=np.str_)


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
        self.names_a = np.asarray(index_a.names, dtype=np.str_)
        self.names_b = (self.names_a if index_b is None
                        else np.asarray(idx_b.names, dtype=np.str_))
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
            p = _oracle_compare.chance_p_value_vec(
                shared, union, self.cards_a[gi], self.cards_b[gj], k
            )

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

        cols_cache: dict = {}

        def col(c: str) -> np.ndarray:
            if c == "query":
                return self.names_a[gi]
            if c == "reference":
                return self.names_b[gj]
            if c == "shared":
                return _fmt_unique_ints(u_sh)[inv_su]
            if c == "union":
                return _fmt_unique_ints(u_un)[inv_su]
            if c == "jaccard":
                return _fmt_unique_floats(u_j)[inv_su]
            if c == "mash_distance":
                return _fmt_unique_floats(u_d)[inv_su]
            if c == "ani":
                return _fmt_unique_floats(
                    _oracle_compare.ani_from_distance_vec(u_d))[inv_su]
            if c == "p_value":
                out = np.full(n, "1", dtype="U26")
                pos = np.flatnonzero(shared > 0)
                if pos.size:
                    out[pos] = [f"{v:.10g}" for v in p[pos].tolist()]
                return out
            if c in ("containment_q", "containment_r"):
                sz = (self.sizes_a[gi] if c.endswith("q")
                      else self.sizes_b[gj])
                cu, ci = np.unique(inter * m + sz, return_inverse=True)
                it_u, sz_u = cu // m, cu % m
                cv = np.where(sz_u > 0,
                              it_u / np.where(sz_u > 0, sz_u, 1), 0.0)
                return _fmt_unique_floats(cv)[ci]
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
                return _fmt_unique_floats(av)[ci]
            if c in ("jaccard_lo", "jaccard_hi", "dist_lo", "dist_hi"):
                if "bounds" not in cols_cache:
                    jlo, jhi = _oracle_compare.jaccard_ci_vec(
                        u_sh, u_un, self.conf)
                    cols_cache["bounds"] = {
                        "jaccard_lo": _fmt_unique_floats(jlo),
                        "jaccard_hi": _fmt_unique_floats(jhi),
                        "dist_lo": _fmt_unique_floats(
                            _oracle_compare.mash_distance_vec(jhi, k)),
                        "dist_hi": _fmt_unique_floats(
                            _oracle_compare.mash_distance_vec(jlo, k)),
                    }
                return cols_cache["bounds"][c][inv_su]
            raise KeyError(f"unknown TSV column {c!r}")

        parts = col(self.columns[0])
        for c in self.columns[1:]:
            parts = np.char.add(np.char.add(parts, "\t"), col(c))
        return "\n".join(parts.tolist()) + "\n", n


# Pairs per _BlockFormatter.format call: the format pass builds UCS4
# row-string intermediates (~100 chars x 4 B per pair, doubled per
# np.char.add step), so capping the call bounds peak host memory.
FORMAT_CHUNK = 1 << 20


def _format_write(fmt: "_BlockFormatter", out, gi, gj, sh, un, it,
                  chunk: int = FORMAT_CHUNK) -> int:
    """Format (already ordered) pair arrays in bounded chunks; returns rows
    written.  Chunks are sequential slices, so output order is unchanged."""
    n_rows = 0
    for a in range(0, gi.shape[0], chunk):
        sl = np.s_[a : a + chunk]
        text, n = fmt.format(gi[sl], gj[sl], sh[sl], un[sl], it[sl])
        out.write(text)
        n_rows += n
    return n_rows


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
    if bounds and len(columns) == len(TSV_COLUMNS):
        columns = tuple(columns) + BOUNDS_COLUMNS[len(TSV_COLUMNS):]
    fmt = _BlockFormatter(index_a, index_b, columns, max_dist, max_p)
    out.write(fmt.header())
    n_rows = 0
    stripe_bi = None
    stripe: List[tuple] = []

    def flush():
        nonlocal n_rows
        if not stripe:
            return
        gi, gj, sh, un, it = (np.concatenate(x) for x in zip(*stripe))
        order = np.lexsort((gj, gi))
        n_rows += _format_write(fmt, out, gi[order], gj[order],
                                sh[order], un[order], it[order])
        stripe.clear()

    for bi, bj, gi, gj, sh, un, it in dist_tiles(index_a, index_b, tile, device):
        if bi != stripe_bi:
            flush()
            stripe_bi = bi
        stripe.append((gi, gj, sh, un, it))
    flush()
    return n_rows


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
