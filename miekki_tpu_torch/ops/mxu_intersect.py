"""Tile intersection counts by the stream pass (counterpart of the JAX
package's ops/mxu_intersect.py, the route MIEKKI_INTERSECT=mxu selects).

Instead of merging every pair of a tile, the pass sorts the tile's values
once and counts all pairs from that one stream:

  stream = stable sort(concat(all row-sketch values, all column values))
           with a payload per value: its row id, or its column id | COL_TAG
           (PAY_SENTINEL for the padding sentinel);
  rid    = run ids: equal values are adjacent, one run per distinct value.

The stream is cut into chunks of ti + tj values, so a run (at most one
element per sketch) spans at most two chunks.  Per chunk,

  m_in[i, j] = runs of the chunk holding both row i and column j,
  corr[i, j] = the pair's match on the run crossing into the chunk,

and the exact Mash `shared_in_x` (matches of union rank <= s) is
bracketed from the pair's distinct count at the chunk's edges (start,
end = cum_a + cum_b - cumulative matches): a chunk ending at <= s adds
its matches to the lower bound, one starting at >= s adds none to the
upper.  lb == ub for every pair without a match inside its s-crossing
chunk; the others ("ambiguous") are resolved exactly by
`resolve_pairs_host`.  inter_full, shared_lb, shared_ub and the ambiguous
set equal the reference's bit for bit.

The reference carries the state chunk by chunk in a `lax.scan` and builds
m_in as two one-hot products, ohRᵀ·E·ohC, with E the chunk's equality
matrix.  Here a batch of chunks runs at once: each chunk's run-membership
matrices R [ti, runs] and C [runs, tj] are scattered from the payloads
(the runs of a chunk are contiguous, so a value's run is its rid minus
the chunk's first rid), m_in = R·C is one `torch.bmm` for the batch, and
the running counts are cumulative sums along the chunk axis, the last
carried into the next batch (BATCH_BYTES bounds one [chunks, ti, tj] int32
plane).  The count state is int32.

Matmul precision: R and C hold 0/1 and m_in is an integer at most
chunk / 2 (a run with both sides has two elements), every partial sum a
smaller non-negative integer.  float16 holds every integer up to 2,048
exactly, so the products run in float16 (tensor cores at their dense
float16 rate) up to chunk = 4,096 — tiles up to 2,048 a side — and in
float32 beyond, on the CPU and on the card alike.  bfloat16 would not do:
a bfloat16 product is returned in bfloat16, exact only to 256, and a
512 x 512 tile reaches 512.

Streams are (values, payload): int64 order keys (ops.u64) and int32
payloads, or int32 code keys (ops.compact) for a compact index; the
payload's bits are the reference's uint32 ones (PAY_SENTINEL is
0xFFFFFFFF).  Every sort is stable on the concatenation in the
reference's order (rows before columns), so ties land where `lax.sort`
puts them.  The legacy banded pass (`mode="band"`) counts matches at
stream distance 1..band and flags longer runs (`overflow`); a tile that
overflows is recounted by K3 (K4 for codes) in `tile_counts_mxu_finish`.
The route launches no kernel of its own; `PASS_COUNTS` counts its passes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import compact as _compact
from . import intersect as _intersect
from . import u64

DEFAULT_CHUNK = 2048
DEFAULT_BAND = 8
COL_TAG = 1 << 16  # payload bit marking column-side elements
PAY_SENTINEL = -1  # payload of INF and chunk padding: no row or column id
BATCH_BYTES = 128 << 20  # one [chunks, ti, tj] int32 plane of a batch
FP16_EXACT = 2048  # largest integer below which float16 holds them all
RESOLVE_CHUNK = 8192  # pairs per batch of the torch resolve (2 s keys each)

# passes of the stream pass by mode, tiles recounted after a band overflow,
# and pairs resolved, summed over calls; set to 0 by reset_counts()
PASS_COUNTS: dict = {}


def reset_counts() -> None:
    PASS_COUNTS.update(full=0, band=0, fallbacks=0, resolved=0)


reset_counts()


# ------------------------------------------------------------------ streams


def _stream(keys: torch.Tensor, is_col: bool) -> tuple:
    """[N, sp] keys → (values [N * sp] sorted, payloads int32): one stable
    sort, so equal values keep row order and the payload is the row id."""
    n, sp = keys.shape
    vals, order = torch.sort(keys.reshape(-1), stable=True)
    pay = torch.div(order, max(sp, 1), rounding_mode="floor").to(torch.int32)
    if is_col:
        pay |= COL_TAG
    return vals, pay


def sketch_stream(keys: torch.Tensor, is_col: bool) -> tuple:
    """A block's sorted value stream: [N, sp] int64 order keys → (keys,
    payload) [N * sp], payload = sketch id | COL_TAG for the column role.
    Sorted once per block and reused by every tile the block is in."""
    if keys.dtype != torch.int64:
        raise ValueError(f"expected int64 order keys, got {keys.dtype}")
    return _stream(keys, is_col)


def sketch_stream32(codes: torch.Tensor, is_col: bool) -> tuple:
    """sketch_stream for compact int32 code keys."""
    if codes.dtype != torch.int32:
        raise ValueError(f"expected int32 code keys, got {codes.dtype}")
    return _stream(codes, is_col)


def stream_with_col_tag(stream: tuple) -> tuple:
    """The column-role stream from a row-role one: the payload is not a
    sort key, so the permutation is the same and only COL_TAG is set (the
    value tensor is shared, not copied)."""
    vals, pay = stream
    return vals, pay | COL_TAG


stream_with_col_tag32 = stream_with_col_tag


# ------------------------------------------------------------- the pass


def _matmul_dtype(chunk: int) -> torch.dtype:
    """float16 while every m_in (at most chunk / 2) is exact in it."""
    return torch.float16 if chunk // 2 <= FP16_EXACT else torch.float32


def _batch_chunks(ti: int, tj: int) -> int:
    return max(1, BATCH_BYTES // max(1, 4 * ti * tj))


def _merge(row_stream: tuple, col_stream: tuple) -> tuple:
    """Merge two presorted streams: stable sort of their concatenation."""
    vals, order = torch.sort(torch.cat([row_stream[0], col_stream[0]]), stable=True)
    return vals, torch.cat([row_stream[1], col_stream[1]])[order]


def _pad_stream(vals: torch.Tensor, pay: torch.Tensor, length: int,
                pay_fill: int) -> tuple:
    inf = _intersect.inf_key(vals.dtype)
    extra = length - vals.shape[0]
    if extra:
        vals = torch.cat([vals, vals.new_full((extra,), inf)])
        pay = torch.cat([pay, pay.new_full((extra,), pay_fill)])
    return vals, pay


def _run_ids(vals: torch.Tensor) -> torch.Tensor:
    """int32 run ids, one per distinct value, from 1 (one cumsum)."""
    newrun = torch.ones(vals.shape, dtype=torch.int32, device=vals.device)
    newrun[1:] = vals[1:] != vals[:-1]
    return torch.cumsum(newrun, 0, dtype=torch.int32)


class _CountState:
    """The running counts of a pass over [ti, tj] pairs, advanced a batch
    of chunks at a time: cumulative matches and per-side counts at the
    chunk edge, the lb/ub brackets, and the previous chunk's end tests.
    `strict` selects the band pass's lb test (end < s) over the full
    pass's (end <= s)."""

    def __init__(self, ti: int, tj: int, s: int, strict: bool, device):
        i32 = torch.int32
        self.s, self.strict = s, strict
        self.c = torch.zeros((ti, tj), dtype=i32, device=device)
        self.ca = torch.zeros(ti, dtype=i32, device=device)
        self.cb = torch.zeros(tj, dtype=i32, device=device)
        self.lb = torch.zeros((ti, tj), dtype=i32, device=device)
        self.ub = torch.zeros((ti, tj), dtype=i32, device=device)
        self.end_le = torch.zeros((ti, tj), dtype=torch.bool, device=device)
        self.end_lt = torch.ones((ti, tj), dtype=torch.bool, device=device)  # 0 < s

    def add(self, m_in: torch.Tensor, corr, cnt_a: torch.Tensor, cnt_b: torch.Tensor) -> None:
        """One batch: m_in and corr [B, ti, tj] int32 (corr None in the band
        pass), cnt_a [B, ti] and cnt_b [B, tj] elements per chunk."""
        inc = m_in if corr is None else m_in + corr
        c_end = torch.cumsum(inc, 0, dtype=torch.int32).add_(self.c)
        ca_end = torch.cumsum(cnt_a, 0, dtype=torch.int32).add_(self.ca)
        cb_end = torch.cumsum(cnt_b, 0, dtype=torch.int32).add_(self.cb)
        end = ca_end[:, :, None] + cb_end[:, None, :] - c_end  # distinct at the end
        del inc
        end_lt = end < self.s
        end_le = end_lt if self.strict else end <= self.s
        del end
        # the start of chunk b is the end of chunk b - 1
        start_lt = torch.cat([self.end_lt[None], end_lt[:-1]])
        self.lb += (m_in * end_le).sum(0, dtype=torch.int32)
        self.ub += (m_in * start_lt).sum(0, dtype=torch.int32)
        if corr is not None:
            # the crossing value's rank is the previous chunk's end count
            prev_le = torch.cat([self.end_le[None], end_le[:-1]])
            c = (corr * prev_le).sum(0, dtype=torch.int32)
            self.lb += c
            self.ub += c
        self.c, self.ca, self.cb = c_end[-1], ca_end[-1], cb_end[-1]
        self.end_le, self.end_lt = end_le[-1], end_lt[-1]

    def result(self, overflow) -> dict:
        return {"inter_full": self.c, "shared_lb": self.lb, "shared_ub": self.ub,
                "overflow": overflow}


def _counts_per_chunk(side: torch.Tensor, width: int) -> torch.Tensor:
    """[B, C] ids of one side (in [0, width), or -1 for none) → [B, width]
    int32 elements per chunk of each id."""
    nb = side.shape[0]
    b = torch.arange(nb, device=side.device)[:, None]
    idx = torch.where(side >= 0, b * width + side, nb * width)
    cnt = torch.bincount(idx.reshape(-1), minlength=nb * width + 1)
    return cnt[:-1].view(nb, width).to(torch.int32)


def _side_ids(pay: torch.Tensor, ti: int, tj: int) -> tuple:
    """Row ids and column ids of payloads (-1 where the element is not of
    that side); a payload matches the reference's one-hot iota only if it
    is < ti (rows) or in [COL_TAG, COL_TAG + tj) (columns)."""
    p = pay.long()
    row = torch.where((p >= 0) & (p < ti), p, -1)
    col = p - COL_TAG
    col = torch.where((col >= 0) & (col < tj), col, -1)
    return row, col


def _mxu_pass_from_rid(rid: torch.Tensor, pay: torch.Tensor, ti: int, tj: int, s: int,
                       chunk: int, n_chunks: int) -> dict:
    """The value-free core of the full pass: everything after the run ids
    depends only on (rid, pay), shared by the int64 and int32 fronts."""
    dev = rid.device
    state = _CountState(ti, tj, s, strict=False, device=dev)
    dt = _matmul_dtype(chunk)
    first = rid[0::chunk][:n_chunks]
    last = rid[chunk - 1::chunk][:n_chunks]
    # chunk c's first run continues chunk c - 1's last one
    head = torch.zeros(n_chunks, dtype=torch.bool, device=dev)
    head[1:] = first[1:] == last[:-1]
    last_run = (last - first).long()  # local index of each chunk's last run
    a_carry = torch.zeros((1, ti), dtype=dt, device=dev)
    b_carry = torch.zeros((1, tj), dtype=dt, device=dev)
    step = _batch_chunks(ti, tj)
    for c0 in range(0, n_chunks, step):
        c1 = min(c0 + step, n_chunks)
        nb = c1 - c0
        wpay = pay[c0 * chunk:c1 * chunk].view(nb, chunk)
        wrid = rid[c0 * chunk:c1 * chunk].view(nb, chunk)
        local = (wrid - wrid[:, :1]).long()  # run index inside the chunk
        row, col = _side_ids(wpay, ti, tj)
        b = torch.arange(nb, device=dev)[:, None]
        r_idx = torch.where(row >= 0, (b * ti + row) * chunk + local, nb * ti * chunk)
        c_idx = torch.where(col >= 0, (b * chunk + local) * tj + col, nb * chunk * tj)
        R = torch.zeros(nb * ti * chunk + 1, dtype=dt, device=dev)
        R[r_idx.reshape(-1)] = 1
        R = R[:-1].view(nb, ti, chunk)  # R[b, i, r]: row i holds run r
        C = torch.zeros(nb * chunk * tj + 1, dtype=dt, device=dev)
        C[c_idx.reshape(-1)] = 1
        C = C[:-1].view(nb, chunk, tj)  # C[b, r, j]: column j holds run r
        m_in = torch.bmm(R, C).to(torch.int32)

        # membership in the run crossing into each chunk (its head) and in
        # each chunk's last run (its tail, the next chunk's carry)
        hd = head[c0:c1].to(dt)[:, None]
        a_head = R[:, :, 0] * hd
        b_head = C[:, 0, :] * hd
        lr = last_run[c0:c1]
        a_tail = R.gather(2, lr.view(nb, 1, 1).expand(nb, ti, 1))[:, :, 0]
        b_tail = C.gather(1, lr.view(nb, 1, 1).expand(nb, 1, tj))[:, 0, :]
        a_prev = torch.cat([a_carry, a_tail[:-1]])
        b_prev = torch.cat([b_carry, b_tail[:-1]])
        a_carry, b_carry = a_tail[-1:], b_tail[-1:]
        corr = torch.bmm(torch.stack([a_prev, a_head], 2),
                         torch.stack([b_head, b_prev], 1)).to(torch.int32)
        del R, C
        state.add(m_in, corr, _counts_per_chunk(row, ti), _counts_per_chunk(col, tj))
    PASS_COUNTS["full"] += 1
    return state.result(torch.zeros((), dtype=torch.bool, device=dev))


def _full_pass(row_stream: tuple, col_stream: tuple, ti: int, tj: int, s: int,
               chunk: int) -> dict:
    if ti + tj > chunk:
        raise ValueError(f"chunk {chunk} < ti + tj = {ti + tj}")
    vals, pay = _merge(row_stream, col_stream)
    n = vals.shape[0]
    if not (ti and tj and n):
        return _CountState(ti, tj, s, False, vals.device).result(
            torch.zeros((), dtype=torch.bool, device=vals.device))
    n_chunks = -(-n // chunk)
    vals, pay = _pad_stream(vals, pay, n_chunks * chunk, PAY_SENTINEL)
    # INF elements (sketch padding and chunk padding) take the sentinel
    # payload, so no one-hot ever holds them
    pay = torch.where(vals == _intersect.inf_key(vals.dtype), PAY_SENTINEL, pay)
    return _mxu_pass_from_rid(_run_ids(vals), pay, ti, tj, s, chunk, n_chunks)


def _tile_counts_mxu_full(row_stream: tuple, col_stream: tuple, ti: int, tj: int, s: int,
                          chunk: int) -> dict:
    """The full stream pass on int64 streams: exact for any run length.
    Returns {"inter_full", "shared_lb", "shared_ub"} int32 [ti, tj] and
    "overflow" (a bool scalar, always False here)."""
    if row_stream[0].dtype != torch.int64:
        raise ValueError(f"expected int64 streams, got {row_stream[0].dtype}")
    return _full_pass(row_stream, col_stream, ti, tj, s, chunk)


def _tile_counts_mxu_full32(row_stream: tuple, col_stream: tuple, ti: int, tj: int, s: int,
                            chunk: int) -> dict:
    """_tile_counts_mxu_full on compact int32 streams (codes are distinct
    per sketch, so the same exactness argument holds)."""
    if row_stream[0].dtype != torch.int32:
        raise ValueError(f"expected int32 streams, got {row_stream[0].dtype}")
    return _full_pass(row_stream, col_stream, ti, tj, s, chunk)


def _tile_counts_mxu(row_stream: tuple, col_stream: tuple, ti: int, tj: int, s: int,
                     chunk: int, band: int) -> dict:
    """The legacy banded pass: matches at stream distance 1..band, per
    chunk of `chunk` positions (a chunk's window reaches band positions
    into the next); lb counts a chunk whose end count is < s.  `overflow`
    flags a run longer than band + 1, whose matches are then incomplete."""
    vals, pay = _merge(row_stream, col_stream)
    dev = vals.device
    n = vals.shape[0]
    n_chunks = -(-n // chunk)
    vals, pay = _pad_stream(vals, pay, n_chunks * chunk + band + 1, 0)
    valid = vals != _intersect.inf_key(vals.dtype)
    row, col = _side_ids(torch.where(valid, pay, PAY_SENTINEL), ti, tj)
    state = _CountState(ti, tj, s, strict=True, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    step = _batch_chunks(ti, tj)
    for c0 in range(0, n_chunks, step):
        c1 = min(c0 + step, n_chunks)
        nb, p0, p1 = c1 - c0, c0 * chunk, c1 * chunk
        b = (torch.arange(p0, p1, device=dev) - p0) // chunk
        trash = nb * ti * tj
        idx = []
        for w in range(1, band + 1):
            eq = (vals[p0:p1] == vals[p0 + w:p1 + w]) & valid[p0:p1] & valid[p0 + w:p1 + w]
            for r, c in ((row[p0:p1], col[p0 + w:p1 + w]), (row[p0 + w:p1 + w], col[p0:p1])):
                ok = eq & (r >= 0) & (c >= 0)
                idx.append(torch.where(ok, (b * ti + r) * tj + c, trash))
        m_c = torch.bincount(torch.cat(idx), minlength=trash + 1)[:-1]
        m_c = m_c.view(nb, ti, tj).to(torch.int32)
        far = p0 + band + 1
        overflow |= ((vals[p0:p1] == vals[far:p1 + band + 1]) & valid[p0:p1]
                     & valid[far:p1 + band + 1]).any()
        state.add(m_c, None, _counts_per_chunk(row[p0:p1].view(nb, chunk), ti),
                  _counts_per_chunk(col[p0:p1].view(nb, chunk), tj))
    PASS_COUNTS["band"] += 1
    return state.result(overflow)


def _sizes(keys: torch.Tensor) -> torch.Tensor:
    return (keys != _intersect.inf_key(keys.dtype)).sum(-1, dtype=torch.int32)


def _streams(rows, cols, row_stream, col_stream) -> tuple:
    fn = sketch_stream32 if rows.dtype == torch.int32 else sketch_stream
    return (fn(rows, False) if row_stream is None else row_stream,
            fn(cols, True) if col_stream is None else col_stream)


def _pass(rows, cols, s, chunk, band, row_stream, col_stream, mode) -> dict:
    row_stream, col_stream = _streams(rows, cols, row_stream, col_stream)
    ti, tj = rows.shape[0], cols.shape[0]
    if mode == "full":
        # chunk = ti + tj: the least that keeps every run within two chunks
        full = _tile_counts_mxu_full32 if rows.dtype == torch.int32 else _tile_counts_mxu_full
        return full(row_stream, col_stream, ti, tj, s, ti + tj)
    if mode != "band":
        raise ValueError(f"unknown stream-pass mode {mode!r} (full or band)")
    if rows.dtype == torch.int32:
        raise ValueError("the band pass has no 32-bit form")
    return _tile_counts_mxu(row_stream, col_stream, ti, tj, s, chunk, band)


def tile_counts_mxu(rows: torch.Tensor, cols: torch.Tensor, s: int, *,
                    chunk: int = DEFAULT_CHUNK, band: int = DEFAULT_BAND,
                    row_stream=None, col_stream=None, mode: str = None) -> dict:
    """All-pairs counts of a tile by the stream pass: rows [Ti, sp], cols
    [Tj, sp] keys (int64, or int32 codes, full mode only) → inter_full,
    union_size, n_a, n_b (exact int32 [Ti, Tj]), shared_lb / shared_ub
    (int32 brackets on shared_in_x) and overflow (bool scalar; False in
    the default full mode).  Pass precomputed streams to skip the sorts;
    `chunk` and `band` apply to mode="band" only."""
    out = _pass(rows, cols, s, chunk, band, row_stream, col_stream, mode or "full")
    ti, tj = rows.shape[0], cols.shape[0]
    n_a, n_b = _sizes(rows), _sizes(cols)
    out["union_size"] = torch.clamp(n_a[:, None] + n_b[None, :] - out["inter_full"], max=s)
    out["n_a"] = n_a[:, None].expand(ti, tj)
    out["n_b"] = n_b[None, :].expand(ti, tj)
    return out


def _mxu_exact_packed(rows, cols, s, slim, row_stream, col_stream):
    """The pass and its epilogue as one flat int32 tensor on the tiles'
    device: (lb | ub | inter | union | n_a | n_b | overflow), or with slim
    (lb | ub | inter | overflow) — union and the sizes then follow from
    the index on the host."""
    out = _pass(rows, cols, s, 0, 0, row_stream, col_stream, "full")
    parts = [out["shared_lb"].reshape(-1), out["shared_ub"].reshape(-1),
             out["inter_full"].reshape(-1)]
    if not slim:
        n_a, n_b = _sizes(rows), _sizes(cols)
        union = torch.clamp(n_a[:, None] + n_b[None, :] - out["inter_full"], max=s)
        parts += [union.reshape(-1), n_a, n_b]
    parts.append(out["overflow"].to(torch.int32)[None])
    return torch.cat(parts)


def tile_counts_mxu_start(rows: torch.Tensor, cols: torch.Tensor, s: int, *,
                          chunk: int = DEFAULT_CHUNK, band: int = DEFAULT_BAND,
                          row_stream=None, col_stream=None, slim: bool = False):
    """Enqueue the full pass for a tile of int64 keys without waiting for
    it; returns a pending handle for tile_counts_mxu_finish(_deferred).
    On a card the work is queued on the current stream, so the caller can
    queue the next tile while this one runs.  `chunk` and `band` are the
    reference's signature; the full pass ignores them."""
    flat = _mxu_exact_packed(rows, cols, s, slim, row_stream, col_stream)
    return (flat, rows, cols, s, slim)


def tile_counts_mxu_start32(codes_rows: torch.Tensor, codes_cols: torch.Tensor, s: int, *,
                            row_stream=None, col_stream=None, slim: bool = False):
    """tile_counts_mxu_start for compact int32 code keys (full mode)."""
    flat = _mxu_exact_packed(codes_rows, codes_cols, s, slim, row_stream, col_stream)
    return (flat, codes_rows, codes_cols, s, slim, "32")


def _pair_view(planes) -> tuple:
    """(hi, lo) uint32 host planes of a handle's rows or columns: a plane
    pair passes through; int64 keys are split; int32 code keys give the
    codes and their derived lo plane (ops.compact.lo_plane_np)."""
    if isinstance(planes, tuple):
        return planes
    if planes.dtype == torch.int32:
        codes = _compact.codes_from_keys32(planes)
        return codes, _compact.lo_plane_np(codes)
    return u64.planes_from_keys(planes)


def tile_counts_mxu_exact(rows: torch.Tensor, cols: torch.Tensor, s: int, *,
                          chunk: int = DEFAULT_CHUNK, band: int = DEFAULT_BAND,
                          row_stream=None, col_stream=None) -> dict:
    """tile_counts-compatible exact counts (host numpy, int32 [Ti, Tj]):
    the pass for the bulk, resolve_pairs_host for the ambiguous pairs."""
    return tile_counts_mxu_finish(tile_counts_mxu_start(
        rows, cols, s, chunk=chunk, band=band, row_stream=row_stream, col_stream=col_stream))


def tile_counts_mxu_exact32(codes_rows: torch.Tensor, codes_cols: torch.Tensor, s: int, *,
                            row_stream=None, col_stream=None) -> dict:
    """tile_counts_mxu_exact for compact int32 code keys."""
    return tile_counts_mxu_finish(tile_counts_mxu_start32(
        codes_rows, codes_cols, s, row_stream=row_stream, col_stream=col_stream))


def tile_counts_mxu_finish(pending) -> dict:
    """Wait for a start handle and resolve its ambiguous pairs: the dict
    of tile_counts_mxu_exact."""
    res, amb_i, amb_j = tile_counts_mxu_finish_deferred(pending)
    if amb_i.size:
        _, rows, cols, s = pending[:4]
        res["shared_in_x"][amb_i, amb_j] = resolve_pairs_host(
            _pair_view(rows), _pair_view(cols), amb_i, amb_j, s, device=rows.device)
    return res


def tile_counts_mxu_finish_deferred(pending) -> tuple:
    """Wait for a start handle (one pull) without resolving: returns (res,
    amb_i, amb_j), res["shared_in_x"] holding the lb bracket and (amb_i,
    amb_j) the tile coordinates of the pairs with lb != ub.  A slim
    handle's res has union_size, n_a and n_b None.  After a band overflow
    the tile is recounted by K3 (K4 for codes), with nothing ambiguous."""
    flat_dev, rows, cols, s = pending[:4]
    slim = pending[4] if len(pending) > 4 else False
    ti, tj = rows.shape[0], cols.shape[0]
    empty = np.zeros(0, np.int64)
    # dist_tiles pulls the flat itself (engine._HostPulls) and passes numpy
    flat = flat_dev.cpu().numpy() if isinstance(flat_dev, torch.Tensor) else flat_dev
    if flat[-1]:
        PASS_COUNTS["fallbacks"] += 1
        fn = (_intersect.tile_counts_compact if rows.dtype == torch.int32
              else _intersect.tile_counts)
        res = {k: v.cpu().numpy() for k, v in fn(rows, cols, s).items()}
        res["n_a"] = np.broadcast_to(res["n_a"][:, None], (ti, tj))
        res["n_b"] = np.broadcast_to(res["n_b"][None, :], (ti, tj))
        return res, empty, empty
    m = ti * tj
    lb = flat[:m].reshape(ti, tj)
    ub = flat[m:2 * m].reshape(ti, tj)
    res = {"inter_full": flat[2 * m:3 * m].reshape(ti, tj), "shared_in_x": lb.copy()}
    if slim:
        res["union_size"] = res["n_a"] = res["n_b"] = None
    else:
        res["union_size"] = flat[3 * m:4 * m].reshape(ti, tj)
        res["n_a"] = np.broadcast_to(flat[4 * m:4 * m + ti][:, None], (ti, tj))
        res["n_b"] = np.broadcast_to(flat[4 * m + ti:4 * m + ti + tj][None, :], (ti, tj))
    amb_i, amb_j = np.nonzero(lb != ub)
    return res, amb_i, amb_j


# -------------------------------------------------------------- resolution


def resolve_pairs_host(rows: tuple, cols: tuple, amb_i: np.ndarray, amb_j: np.ndarray,
                       s: int, device="cpu") -> np.ndarray:
    """Exact shared_in_x of the pairs (row amb_i[k], column amb_j[k]) of
    two (hi, lo) uint32 host plane tables [N, sp] (sorted, UINT64_MAX
    padded; a compact index's codes and derived lo plane): int32 [K].

    The native library's threaded two-pointer pass first (io.native,
    bit-identical to the merge counts).  With MIEKKI_NATIVE_RESOLVE=0 or
    without the library, torch on `device`: first at a prefix width w < s
    (_resolve_prefix_width, MIEKKI_RESOLVE_W), whose certificate proves a
    count exact, then at full width for the pairs it leaves."""
    from ..io import native as _native

    PASS_COUNTS["resolved"] += int(np.size(amb_i))
    if os.environ.get("MIEKKI_NATIVE_RESOLVE", "1") != "0" and _native.has_resolve():
        return _native.resolve_pairs_native(
            np.asarray(rows[0]), np.asarray(rows[1]), np.asarray(cols[0]),
            np.asarray(cols[1]), np.asarray(amb_i, np.int64), np.asarray(amb_j, np.int64), s)
    amb_i = np.asarray(amb_i, np.int64)
    amb_j = np.asarray(amb_j, np.int64)
    sp = rows[0].shape[-1]
    w = min(sp, min(s, _resolve_prefix_width(s)))
    k = amb_i.size
    fixed = np.empty(k, np.int32)
    ok = np.empty(k, bool)

    def keys(planes, idx, width=None):
        sl = np.s_[idx] if width is None else np.s_[idx, :width]
        return torch.from_numpy(u64.keys_from_planes(planes[0][sl], planes[1][sl])).to(device)

    for o in range(0, k, RESOLVE_CHUNK):
        ci, cj = amb_i[o:o + RESOLVE_CHUNK], amb_j[o:o + RESOLVE_CHUNK]
        packed = _resolve_pairs_prefix(keys(rows, ci, w), keys(cols, cj, w), s).cpu().numpy()
        fixed[o:o + ci.size] = packed[0]
        ok[o:o + ci.size] = packed[1].astype(bool)
    bad = np.flatnonzero(~ok)
    for o in range(0, bad.size, RESOLVE_CHUNK):
        sel = bad[o:o + RESOLVE_CHUNK]
        fixed[sel] = _resolve_pairs_sorted(keys(rows, amb_i[sel]), keys(cols, amb_j[sel]),
                                           s).cpu().numpy()
    return fixed


def _resolve_prefix_width(s: int) -> int:
    """Prefix width of the first resolve try: MIEKKI_RESOLVE_W clamped to
    [1, s], else ~5/8 s rounded up to a multiple of 2,048 (a pair needs
    ~(s + shared) / 2 elements a side below its s-th distinct value)."""
    env = os.environ.get("MIEKKI_RESOLVE_W")
    if env:
        return max(1, min(s, int(env)))
    return -(-(5 * s // 8) // 2048) * 2048


def _resolve_pairs_prefix(a: torch.Tensor, b: torch.Tensor, s: int) -> torch.Tensor:
    """shared_in_x of sketch pairs from their w-element prefixes (a, b [P,
    w] keys) and a certificate: [2, P] int32 (count | ok).  ok = 1 when the
    merged prefixes hold >= s distinct values <= min(last(a), last(b))
    (every element below that cap is inside both prefixes), or when both
    prefixes end in padding (they are the whole sketches)."""
    inf = _intersect.inf_key(a.dtype)
    x = torch.sort(torch.cat([a, b], -1), -1).values
    valid = x != inf
    dup = torch.zeros_like(valid)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
    dup &= valid
    distinct = valid & ~dup
    rank = torch.cumsum(distinct, -1, dtype=torch.int32)
    cnt = (dup & (rank <= s)).sum(-1, dtype=torch.int32)
    cap = torch.minimum(a[..., -1], b[..., -1])
    cnt_le = (distinct & (x <= cap[..., None])).sum(-1, dtype=torch.int32)
    both_inf = (a[..., -1] == inf) & (b[..., -1] == inf)
    return torch.stack([cnt, ((cnt_le >= s) | both_inf).to(torch.int32)])


def _resolve_pairs_sorted(a: torch.Tensor, b: torch.Tensor, s: int) -> torch.Tensor:
    """Exact shared_in_x of sketch pairs by one batched sort-merge."""
    return _intersect.pair_counts_merge(a, b, s)["shared_in_x"]
