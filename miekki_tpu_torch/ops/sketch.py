"""Bottom-s MinHash sketch construction in torch (counterpart of the JAX
package's ops/sketch.py, strategies ``tree``, ``threshold``, ``sort`` and
``fused``).

The running sketch is a fixed-shape [G, s] int64 key tensor (G genomes
side by side, the JAX package's vmap written out as a batch dimension),
sorted ascending and INF-padded.  Each step hashes a [G, g, W] block of
code rows through kernel K1 (ops.cuda_hash) and merges the hashes into the
sketch by the strategy MIEKKI_MERGE names (every strategy gives the same
bits):

  * ``tree`` (default): keep hashes below the current s-th minimum,
    pre-reduce them by levels of row-local width-128 sorts keeping the 32
    smallest per row, merge the survivors with one sort-dedup-truncate;
    after WARMUP_STEPS per-step merges, one merge per MERGE_EVERY steps.
    A genome whose tree level overflowed (a row held more finite
    candidates than the cap, so a needed value may have been dropped) is
    redone exactly from its raw hashes.
  * ``threshold``: the same mask, the survivors compacted into a budget of
    CAND_BUDGET by a top-k over int32 position keys, one (s + budget)
    merge; a genome with more survivors than the budget is redone exactly.
  * ``sort``: a full sort-dedup-truncate of every step's hashes.
  * ``fused``: each step's hash, threshold and first tree levels by kernel
    K2 (ops.cuda_sketch), with MIEKKI_FUSED_LEVELS reduction levels
    (default 2), then a merge per step; no warmup and no group merging,
    as in the JAX package.

`lax.scan` becomes a Python loop and `lax.while_loop` an
``if overflow.any():``; the sorts are plain `torch.sort`, as the JAX
package leaves them to XLA.  Unlike the JAX package, which sends any
MIEKKI_MERGE value it does not know to ``sort``, the port raises for it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import device as _device
from . import u64
from .cuda_hash import hash_windows_cuda
from .cuda_sketch import hash_reduce_cuda
from .fused_sketch import GROUP_CAP
from .hash import INVALID_CODE

STRATEGIES = ("tree", "threshold", "sort", "fused")  # MIEKKI_MERGE values
HASH_IMPLS = ("auto", "pallas", "xla")  # MIEKKI_HASH values
FUSED_WIDTH = 2048  # the fused path needs W - k + 1 divisible by this

# Survivor budget: candidate rows longer than 2x this are tree-reduced
# before the merge; merges of at most budget + s values sort directly.
CAND_BUDGET = 16384

TREE_WIDTH = 128  # lanes per row-local sort
TREE_CAP = 32     # candidates kept per row per level
TREE_CAP0 = 16    # kept per row on the widest (first) group-path level

# Target number of window starts hashed per step (per genome).
STEP_TARGET = 1 << 19
# Steps per bottom-s merge in the group-merged path.
MERGE_EVERY = 4
# Per-step-merged warmup steps before group merging starts: they pin the
# threshold so that later groups essentially never overflow the tree.
WARMUP_STEPS = 2


def empty_sketch(s: int, batch=(), device=None) -> torch.Tensor:
    return u64.inf_like(tuple(batch) + (s,), device=device)


def _merge_sorted_trunc(sketch: torch.Tensor, cand: torch.Tensor,
                        s: int) -> torch.Tensor:
    """sort(concat) → dedup → resort → first s, along the last dim."""
    x = torch.sort(torch.cat([sketch, cand], dim=-1), dim=-1).values
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
    x = torch.sort(x.masked_fill_(dup, u64.INF_KEY), dim=-1).values
    return x[..., :s].contiguous()


def _tree_level(h: torch.Tensor, cap: int = TREE_CAP, width: int = TREE_WIDTH):
    """One reduction level over the last dim of [G, c]: row-sort
    [G, c/width, width], keep the `cap` smallest per row.  Returns
    ([G, c/width*cap], overflowed bool [G]) — a genome overflowed if any of
    its rows had more than `cap` finite candidates (counting duplicates)."""
    g, c = h.shape
    rows = -(-c // width)
    if rows * width != c:
        h = torch.cat([h, h.new_full((g, rows * width - c), u64.INF_KEY)], -1)
    x = torch.sort(h.reshape(g, rows, width), dim=-1).values
    finite = (x != u64.INF_KEY).sum(-1)
    return x[..., :cap].reshape(g, rows * cap), finite.amax(-1) > cap


def _with_fallback(out: torch.Tensor, overflow: torch.Tensor, exact) -> torch.Tensor:
    """Replace the rows of `out` whose genome overflowed by exact(idx)."""
    if not bool(overflow.any()):
        return out
    idx = overflow.nonzero().squeeze(1)
    out = out.clone()
    out[idx] = exact(idx)
    return out


def _merge_tree(sketch: torch.Tensor, hashes: torch.Tensor, s: int,
                budget: int) -> torch.Tensor:
    c = hashes.shape[-1]
    if c <= budget + s:
        return _merge_sorted_trunc(sketch, hashes, s)
    thr = sketch[:, s - 1:s]
    cand = torch.where(hashes < thr, hashes, u64.INF_KEY)
    overflow = torch.zeros(sketch.shape[0], dtype=torch.bool, device=sketch.device)
    while cand.shape[-1] > 2 * budget:
        cand, of = _tree_level(cand)
        overflow |= of
    out = _merge_sorted_trunc(sketch, cand, s)
    return _with_fallback(
        out, overflow, lambda idx: _merge_sorted_trunc(sketch[idx], hashes[idx], s))


def _merge_threshold(sketch: torch.Tensor, hashes: torch.Tensor, s: int,
                     budget: int) -> torch.Tensor:
    """Keep hashes below the s-th minimum, compact them into `budget` slots
    by a top-k over int32 position keys (kept positions carry their index,
    the others -1, so with at most `budget` survivors every one is picked;
    the other picks are >= the threshold and fall behind the kept values),
    and merge once; a genome with more survivors is redone exactly."""
    c = hashes.shape[-1]
    if c <= budget + s:
        return _merge_sorted_trunc(sketch, hashes, s)
    keep = hashes < sketch[:, s - 1:s]
    pos = torch.arange(c, dtype=torch.int32, device=hashes.device)
    idx = torch.topk(torch.where(keep, pos, -1), budget, dim=-1, sorted=False).indices
    out = _merge_sorted_trunc(sketch, torch.gather(hashes, -1, idx), s)
    return _with_fallback(
        out, keep.sum(-1) > budget,
        lambda idx: _merge_sorted_trunc(sketch[idx], hashes[idx], s))


def _merge(sketch: torch.Tensor, hashes: torch.Tensor, s: int, budget: int,
           strategy: str) -> torch.Tensor:
    """[G, s] sketch ∪ [G, c] hashes by `strategy`; a chunk of at most
    budget + s values, or any strategy but tree and threshold, takes one
    sort-dedup-truncate, as in the JAX package."""
    if strategy == "tree":
        return _merge_tree(sketch, hashes, s, budget)
    if strategy == "threshold":
        return _merge_threshold(sketch, hashes, s, budget)
    return _merge_sorted_trunc(sketch, hashes, s)


def merge_into_sketch(sketch: torch.Tensor, hashes: torch.Tensor, s: int,
                      budget: int = CAND_BUDGET, strategy: str = None) -> torch.Tensor:
    """Merge candidate hash keys (INF = masked) into bottom-s sketch keys:
    sketch [s] with hashes [c], or sketch [G, s] with hashes [G, c].
    Exact bottom-s-distinct semantics under every strategy (default
    MIEKKI_MERGE, read at call time)."""
    strategy = _strategy(strategy)
    if sketch.dim() == 1:
        return _merge(sketch[None], hashes[None], s, budget, strategy)[0]
    return _merge(sketch, hashes, s, budget, strategy)


def _strategy(strategy: str = None) -> str:
    if strategy is None:
        strategy = os.environ.get("MIEKKI_MERGE", "tree").lower()
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown merge strategy {strategy!r}: the port has "
                         f"{', '.join(STRATEGIES)}")
    return strategy


def _hash_impl(hash_impl: str = None) -> str:
    if hash_impl is None:
        hash_impl = os.environ.get("MIEKKI_HASH", "auto").lower()
    if hash_impl not in HASH_IMPLS:
        raise ValueError(f"unknown MIEKKI_HASH {hash_impl!r}; expected one of "
                         f"{', '.join(HASH_IMPLS)}")
    return hash_impl


def _hash_rows(block: torch.Tensor, k: int) -> torch.Tensor:
    """Hash a [G, g, W] row block through K1 → [G, g * n] keys."""
    g_, g, w = block.shape
    return hash_windows_cuda(block.reshape(g_ * g, w).contiguous(), k).reshape(g_, -1)


def sketch_chunked(chunks: torch.Tensor, k: int, s: int, group: int = 0,
                   strategy: str = None, hash_impl: str = None,
                   fused_levels: int = None) -> torch.Tensor:
    """Sketch genomes given as uint8 code rows: [n_chunks, C + k - 1] for one
    genome → [s] keys, or [G, n_chunks, C + k - 1] for G genomes → [G, s].

    Chunk rows must overlap by k-1 bases (row i covers window starts
    [i*C, (i+1)*C) of the packed genome); padding bases are INVALID_CODE.
    They may be a strided view (overlapping_rows): each step's block is
    made contiguous on its device before K1 reads it.
    Rows are processed `group` at a time (0 = auto: ~STEP_TARGET window
    starts per step).  Output rows are ascending and INF-padded.

    strategy, hash_impl and fused_levels default to the MIEKKI_MERGE,
    MIEKKI_HASH and MIEKKI_FUSED_LEVELS variables, and the tree path's
    first-level cap to MIEKKI_TREE_CAP0 (0 or unset: TREE_CAP0), all read
    at call time.  ``fused`` runs K2 on every step when C is a multiple of
    FUSED_WIDTH, else (as the JAX package does) a plain sort-merge of each
    step's hashes; ``tree`` takes the group-merged path past the warmup,
    ``threshold`` and ``sort`` merge every step.

    MIEKKI_HASH takes the JAX package's values, auto, pallas and xla.
    There its Pallas kernel and its XLA hash compute one function, bit for
    bit; here every value selects that one function, K1's wrapper: the
    kernel on a card, its plain version on the CPU (never on the card)."""
    strategy = _strategy(strategy)
    _hash_impl(hash_impl)
    if fused_levels is None:
        fused_levels = int(os.environ.get("MIEKKI_FUSED_LEVELS", "2"))
    cap0 = int(os.environ.get("MIEKKI_TREE_CAP0", "0")) or TREE_CAP0
    single = chunks.dim() == 2
    if single:
        chunks = chunks[None]
    gn, n, w = chunks.shape
    g = group or max(1, min(n, STEP_TARGET // max(1, w - k + 1)))
    if n % g:
        pad = chunks.new_full((gn, -n % g, w), INVALID_CODE)
        chunks = torch.cat([chunks, pad], dim=1)
    blocks = chunks.reshape(gn, -1, g, w)
    if strategy == "fused":
        out = empty_sketch(s, (gn,), chunks.device)
        fused = (w - k + 1) % FUSED_WIDTH == 0
        for t in range(blocks.shape[1]):
            out = (_fused_step(out, blocks[:, t], k, s, fused_levels) if fused
                   else _merge_sorted_trunc(out, _hash_rows(blocks[:, t], k), s))
    elif strategy == "tree" and blocks.shape[1] > WARMUP_STEPS + 1:
        out = _sketch_group_merged(blocks, k, s, cap0)
    else:
        out = empty_sketch(s, (gn,), chunks.device)
        for t in range(blocks.shape[1]):
            out = _merge(out, _hash_rows(blocks[:, t], k), s, CAND_BUDGET, strategy)
    return out[0] if single else out


def _fused_step(sketch: torch.Tensor, block: torch.Tensor, k: int, s: int,
                levels: int) -> torch.Tensor:
    """One fused step: K2 on the [G, g, W] block with each genome's s-th
    minimum as its rows' threshold, tree levels down to the candidate
    budget, one merge; a genome whose group overflowed is redone exactly
    from its raw hashes (K1)."""
    gn, g, w = block.shape
    cand, cmax = hash_reduce_cuda(block.reshape(gn * g, w).contiguous(), k,
                                  sketch[:, s - 1], levels)
    overflow = cmax.reshape(gn, g).amax(-1) > GROUP_CAP
    flat = cand.reshape(gn, -1)
    while flat.shape[-1] > 2 * CAND_BUDGET:
        flat, of = _tree_level(flat)
        overflow |= of
    out = _merge_sorted_trunc(sketch, flat, s)
    return _with_fallback(
        out, overflow, lambda idx: _merge_sorted_trunc(sketch[idx], _hash_rows(block[idx], k), s))


def _step_cand(block: torch.Tensor, thr: torch.Tensor, k: int,
               overflow: torch.Tensor, cap0: int = TREE_CAP0):
    """Hash one [G, g, W] block, keep hashes below thr [G, 1], compact to the
    per-step candidate budget (first level keeps cap0 per row)."""
    h = _hash_rows(block, k)
    cand = torch.where(h < thr, h, u64.INF_KEY)
    cap = cap0
    while cand.shape[-1] > 2 * CAND_BUDGET:
        cand, of = _tree_level(cand, cap=cap)
        overflow = overflow | of
        cap = TREE_CAP
    return cand, overflow


def _group_merge(carry: torch.Tensor, group: torch.Tensor, k: int,
                 s: int, cap0: int = TREE_CAP0) -> torch.Tensor:
    """One bottom-s merge for the m = group.shape[1] steps of a group.  The
    threshold is the carry's s-th min for every step (stale but
    conservative: the s-th min only decreases).  An overflowing genome is
    redone exactly: every raw hash of the group, merged step by step."""
    m = group.shape[1]
    thr = carry[:, s - 1:s]
    overflow = torch.zeros(carry.shape[0], dtype=torch.bool, device=carry.device)
    cands = []
    for i in range(m):
        cand, overflow = _step_cand(group[:, i], thr, k, overflow, cap0)
        cands.append(cand)
    cat = torch.cat(cands, dim=-1)
    while cat.shape[-1] > 2 * CAND_BUDGET:
        cat, of = _tree_level(cat)
        overflow |= of
    out = _merge_sorted_trunc(carry, cat, s)

    def exact(idx):
        res = carry[idx]
        for i in range(m):
            res = _merge_sorted_trunc(res, _hash_rows(group[idx, i], k), s)
        return res

    return _with_fallback(out, overflow, exact)


def _sketch_group_merged(blocks: torch.Tensor, k: int, s: int,
                         cap0: int = TREE_CAP0) -> torch.Tensor:
    """Tree-strategy steps with ONE bottom-s merge per MERGE_EVERY steps,
    after WARMUP_STEPS per-step merges; the remainder group runs at its
    exact size.  Bitwise equal to per-step merging (bottom-s of a set is
    associative)."""
    out = empty_sketch(s, (blocks.shape[0],), blocks.device)
    for t in range(WARMUP_STEPS):
        out = _merge_tree(out, _hash_rows(blocks[:, t], k), s, CAND_BUDGET)
    tail = blocks[:, WARMUP_STEPS:]
    for a in range(0, tail.shape[1], MERGE_EVERY):
        out = _group_merge(out, tail[:, a:a + MERGE_EVERY], k, s, cap0)
    return out


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def chunk_codes(codes: np.ndarray, k: int, chunk: int) -> np.ndarray:
    """Host-side: pack a 1-D code array into overlapping [n, chunk+k-1] rows."""
    codes = np.asarray(codes, dtype=np.uint8)
    n_chunks = max(1, -(-len(codes) // chunk))
    padded = np.full(n_chunks * chunk + k - 1, INVALID_CODE, dtype=np.uint8)
    padded[: len(codes)] = codes
    rows = np.stack(
        [padded[i * chunk : i * chunk + chunk + k - 1] for i in range(n_chunks)]
    )
    return rows


def bucketed_shape(length: int, k: int, chunk: int) -> tuple:
    """(n_pad, c + k - 1): the shape of bucketed_chunk_codes' rows for a
    genome of `length` codes, from the length alone.  The chunk c is
    `chunk` or, for a shorter genome, the power of two at or above its
    length (at least 4,096); n_pad is the power of two at or above its
    ceil(length / c) rows (at least one)."""
    c = min(chunk, max(4096, _next_pow2(max(1, length))))
    return _next_pow2(max(1, -(-length // c))), c + k - 1


def overlapping_rows(flat: torch.Tensor, k: int, width: int) -> torch.Tensor:
    """The [..., n, width] chunk rows of [..., n * c + k - 1] flat codes as
    a view (c = width - k + 1): row i is flat[..., i * c : i * c + width].
    Flat codes INVALID past a genome's end give bucketed_chunk_codes' rows,
    its padding rows included."""
    return flat.unfold(-1, width, width - k + 1)


def bucketed_chunk_codes(codes: np.ndarray, k: int, chunk: int) -> np.ndarray:
    """chunk_codes with power-of-two shape bucketing (bucketed_shape): the
    chunk width and the row count are rounded up to powers of two, so
    genomes of similar length share a shape and are sketched together in
    one batch.  Padding rows are all-INVALID → hash to INF → merge no-ops."""
    n_pad, w = bucketed_shape(len(codes), k, chunk)
    rows = chunk_codes(codes, k, w - k + 1)
    if n_pad != rows.shape[0]:
        pad = np.full(
            (n_pad - rows.shape[0], rows.shape[1]), INVALID_CODE, np.uint8
        )
        rows = np.concatenate([rows, pad])
    return rows


def sketch_codes_device(codes: np.ndarray, k: int, s: int, chunk: int = 1 << 13,
                        device="cuda") -> np.ndarray:
    """End-to-end single-genome sketch → sorted uint64[<=s] (host).

    `codes` is a packed uint8 array (io.encode.pack_records for
    multi-record genomes — separators invalidate boundary-spanning windows).
    """
    dev = _device.resolve(device)
    rows = bucketed_chunk_codes(codes, k, chunk)
    keys = sketch_chunked(torch.from_numpy(rows).to(dev), k, s)
    out = u64.u64_from_keys(keys)
    return out[out != u64.UINT64_MAX]
