"""Port parity of dist_tiles' bounded block cache (engine._KeyBlocks): key
blocks formed one at a time from the host planes, cached under
MIEKKI_COL_CACHE_MB or utils.hbm.dist_cache_bytes with the reference's
keys, hits and oldest-first eviction.  Every output is held bitwise
against the JAX package's under the same environment and against the
port with the cache unset (`device="cpu"`: the kernels' plain versions
count).  Tile 8 over 37 and 29 genomes at s = 100: the lane is padded to
128 and both sides end in a partial block.  Tolerance: none."""

from collections import OrderedDict

import numpy as np
import pytest
import torch

from miekki_tpu import cli as jcli
from miekki_tpu import engine as J
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu.utils import hbm as JH
from miekki_tpu_torch import cli as tcli
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.index.store import index_to_device
from miekki_tpu_torch.ops import intersect as TI
from miekki_tpu_torch.params import SketchParams

from fixtures import make_genome_family, write_fasta

S, TILE, N_A, N_B = 100, 8, 37, 29
SKIP = {(0, 1), (1, 3), (2, 2), (4, 0)}


def _pair(idx: TIndex) -> JIndex:
    """The same host table as a JAX-package SketchIndex."""
    return JIndex(JParams.from_dict(idx.params.to_dict()), idx.names, idx.hi, idx.lo)


def _host_only(idx: TIndex) -> TIndex:
    return TIndex(idx.params, idx.names, idx.hi, idx.lo)


def _indexes(s: int = S):
    """Sides A (N_A sketches) and B (N_B) drawn from one pool, so pairs
    share values: sizes 0..s, every fifth row full, one empty row."""
    rng = np.random.default_rng(13)
    pool = np.unique(rng.integers(0, 2 ** 64 - 1, size=4 * s, dtype=np.uint64))
    sketches = []
    for i in range(N_A + N_B):
        size = s if i % 5 == 0 else int(rng.integers(0, s + 1))
        sketches.append(np.sort(rng.choice(pool, size=size, replace=False)))
    sketches[7] = np.zeros(0, np.uint64)
    idx = TIndex.from_sketches(sketches, [f"g{i}" for i in range(len(sketches))],
                               SketchParams(k=31, s=s))
    return (TIndex(idx.params, idx.names[:N_A], idx.hi[:N_A], idx.lo[:N_A]),
            TIndex(idx.params, idx.names[N_A:], idx.hi[N_A:], idx.lo[N_A:]))


@pytest.fixture(scope="module")
def sides():
    raw = _indexes()
    return {"raw": raw, "compact": tuple(t.to_compact() for t in raw)}


def _job(sides, kind, rect):
    a, b = sides[kind]
    return (a, b) if rect else (a, None)


def _tiles(gen) -> list:
    return [(t[0], t[1]) + tuple(None if x is None else np.asarray(x) for x in t[2:])
            for t in gen]


def _assert_tiles_equal(got: list, want: list):
    assert [t[:2] for t in got] == [t[:2] for t in want]
    for g, w in zip(got, want):
        for x, y in zip(g[2:], w[2:]):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.shape == y.shape and np.array_equal(x, y)


def _assert_counts_equal(a: dict, b: dict):
    for key in ("shared", "union", "inter"):
        assert np.array_equal(a[key], b[key]), key


def _set_cache(monkeypatch, cache_mb):
    if cache_mb is None:
        monkeypatch.delenv("MIEKKI_COL_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("MIEKKI_COL_CACHE_MB", cache_mb)


@pytest.mark.parametrize("cache_mb", [None, "0"], ids=["unset", "cap2"])
@pytest.mark.parametrize("rect", [False, True], ids=["self", "rect"])
@pytest.mark.parametrize("kind", ["raw", "compact"])
@pytest.mark.parametrize("form", ["masked", "raw_tiles"])
@pytest.mark.parametrize("skip", [None, SKIP], ids=["all", "skip"])
def test_dist_tiles_equal_reference_and_uncapped(sides, monkeypatch, kind, rect, cache_mb,
                                                 form, skip):
    a, b = _job(sides, kind, rect)
    raw = form == "raw_tiles"
    uncapped = _tiles(T.dist_tiles(a, b, TILE, device="cpu", skip_tiles=skip, raw=raw))
    _set_cache(monkeypatch, cache_mb)
    got = _tiles(T.dist_tiles(a, b, TILE, device="cpu", skip_tiles=skip, raw=raw))
    want = _tiles(J.dist_tiles(_pair(a), None if b is None else _pair(b), TILE,
                               skip_tiles=skip, raw=raw))
    _assert_tiles_equal(got, want)
    _assert_tiles_equal(got, uncapped)


@pytest.mark.parametrize("cache_mb", [None, "0"], ids=["unset", "cap2"])
@pytest.mark.parametrize("rect", [False, True], ids=["self", "rect"])
@pytest.mark.parametrize("kind", ["raw", "compact"])
def test_dist_counts_matrix_equals_reference_and_uncapped(sides, monkeypatch, kind, rect,
                                                          cache_mb):
    a, b = _job(sides, kind, rect)
    uncapped = T.dist_counts_matrix(a, b, TILE, device="cpu")
    _set_cache(monkeypatch, cache_mb)
    got = T.dist_counts_matrix(a, b, TILE, device="cpu")
    _assert_counts_equal(got, J.dist_counts_matrix(_pair(a), None if b is None else _pair(b),
                                                   TILE))
    _assert_counts_equal(got, uncapped)


@pytest.mark.parametrize("kind", ["raw", "compact"])
def test_blocks_equal_the_padded_table(sides, kind):
    """Every block formed from the host planes, the partial edge block
    included, equals the matching rows of index_to_device after padding
    to the lane and to whole tiles."""
    a, _ = sides[kind]
    table = TI._pad_lane(index_to_device(a, "cpu"))
    n_blocks = -(-N_A // TILE)
    pad = torch.full((n_blocks * TILE - N_A, table.shape[1]), TI.inf_key(table.dtype),
                     dtype=table.dtype)
    table = torch.cat([table, pad])
    blocks = T._KeyBlocks(a, None, TILE, torch.device("cpu"), ())
    for b in range(n_blocks):
        blk = blocks._load(("a", b))[0]
        assert blk.dtype == table.dtype
        assert torch.equal(blk, table[b * TILE:(b + 1) * TILE]), b


@pytest.mark.parametrize("kind", ["raw", "compact"])
def test_mixed_job_planes_on_one_side(sides, monkeypatch, kind):
    """Side A with CPU device_planes, side B from its host planes, under a
    cap of 2 and unset: equal to both sides from host planes and to the
    reference."""
    a, b = sides[kind]
    with_planes = _host_only(a)
    with_planes.device_planes = index_to_device(a, "cpu").clone()
    want = J.dist_counts_matrix(_pair(a), _pair(b), TILE)
    for cache_mb in (None, "0"):
        _set_cache(monkeypatch, cache_mb)
        _assert_counts_equal(T.dist_counts_matrix(with_planes, b, TILE, device="cpu"), want)
        _assert_counts_equal(T.dist_counts_matrix(a, b, TILE, device="cpu"), want)


def _lru(accesses, cap: int):
    """The keys a least-recently-used cache of `cap` blocks loads over the
    accesses, in order, and its evictions."""
    cache, loads, evictions = OrderedDict(), [], 0
    for key in accesses:
        if key in cache:
            cache.move_to_end(key)
            continue
        loads.append(key)
        cache[key] = True
        if len(cache) > cap:
            cache.popitem(last=False)
            evictions += 1
    return loads, evictions


@pytest.fixture(scope="module")
def wide_sides():
    """The sides at s = 4,096: a raw block is 256 KiB, so 1 MiB caps the
    cache at 4 blocks (a compact one at 8)."""
    raw = _indexes(4096)
    return {"raw": raw, "compact": tuple(t.to_compact() for t in raw)}


def _zero_counts(rows: torch.Tensor, cols: torch.Tensor, s: int) -> dict:
    """A stand-in for the tile counts where only the blocks' traffic is
    checked."""
    zeros = torch.zeros((rows.shape[0], cols.shape[0]), dtype=torch.int32)
    return {"shared_in_x": zeros, "union_size": zeros, "inter_full": zeros}


@pytest.mark.parametrize("cache_mb", [None, "0", "1"], ids=["unset", "cap2", "1MiB"])
@pytest.mark.parametrize("rect", [False, True], ids=["self", "rect"])
@pytest.mark.parametrize("kind", ["raw", "compact"])
@pytest.mark.parametrize("skip", [None, SKIP], ids=["all", "skip"])
def test_counts_follow_an_lru_model(wide_sides, monkeypatch, kind, rect, cache_mb, skip):
    """Loads, hits, evictions and bytes copied from the host planes of a
    sweep equal an LRU model's over the reference's accesses (each tile's
    row block, then its column block), and so does the cap (the tile
    counts are stood in for: the outputs are held above)."""
    s = 4096
    a, b = _job(wide_sides, kind, rect)
    monkeypatch.setattr(TI, "tile_counts", _zero_counts)
    monkeypatch.setattr(TI, "tile_counts_compact", _zero_counts)
    _set_cache(monkeypatch, cache_mb)
    T.reset_block_counts()
    list(T.dist_tiles(a, b, TILE, device="cpu", skip_tiles=skip, raw=True))
    got = dict(T.BLOCK_COUNTS)
    bytes_per_block = TILE * s * (4 if kind == "compact" else 8)
    if cache_mb is None:
        cap = JH.dist_cache_bytes(0, 1, bytes_per_block) // bytes_per_block
    else:
        cap = max(2, (int(cache_mb) << 20) // bytes_per_block)
    n = {"a": N_A, "b": N_B if rect else N_A}
    accesses = [key for bi in range(-(-n["a"] // TILE)) for bj in range(-(-n["b"] // TILE))
                if (rect or bj >= bi) and not (skip and (bi, bj) in skip)
                for key in (("a", bi), ("b" if rect else "a", bj))]
    loads, evictions = _lru(accesses, cap)
    assert got["cap"] == cap
    assert (got["loads"], got["hits"], got["evictions"]) == (
        len(loads), len(accesses) - len(loads), evictions)
    if cache_mb is None:
        assert evictions == 0
    elif cache_mb == "0" or kind == "raw":
        assert evictions > 0
    plane_row_bytes = s * (4 if kind == "compact" else 8)
    assert got["bytes_uploaded"] == plane_row_bytes * sum(
        min(TILE, n[side] - blk * TILE) for side, blk in loads)
    assert got["staging_s"] == 0.0  # no pinned staging on the CPU


@pytest.mark.parametrize("limit", [10 ** 9, 3 * 10 ** 9, 100 << 20])
@pytest.mark.parametrize("planes", ["none", "a", "self"])
def test_cap_under_hbm_limit(sides, monkeypatch, limit, planes):
    """Unset, the cap is max(2, dist_cache_bytes(resident, 1, block) //
    block) with the reference's arithmetic under the same
    MIEKKI_HBM_LIMIT; resident counts the device planes in use once (a
    self-comparison's one table)."""
    monkeypatch.delenv("MIEKKI_COL_CACHE_MB", raising=False)
    monkeypatch.setenv("MIEKKI_HBM_LIMIT", str(limit))
    a, b = sides["raw"]
    resident = 0
    if planes != "none":
        a = _host_only(a)
        a.device_planes = index_to_device(a, "cpu").clone()
        resident = a.device_planes.numel() * 8
    if planes == "self":
        b = None
    bytes_per_block = TILE * 128 * 8
    T.reset_block_counts()
    list(T.dist_tiles(a, b, TILE, device="cpu", raw=True))
    want = max(2, JH.dist_cache_bytes(resident, 1, bytes_per_block) // bytes_per_block)
    assert T.BLOCK_COUNTS["cap"] == want
    assert want > 2


@pytest.fixture(scope="module")
def genome_dbs(tmp_path_factory):
    """A raw and a compact index file of 13 related genomes (s = 100),
    written by the port's CLI."""
    tmp = tmp_path_factory.mktemp("dist_cache")
    rng = np.random.default_rng(29)
    seqs = make_genome_family(rng, 13, 3_000, sub_rate=0.04)
    paths = [str(write_fasta(tmp / f"g{i}.fa", [(f"g{i}", g)])) for i, g in enumerate(seqs)]
    out = {"tmp": tmp}
    for tag, extra in (("raw", []), ("compact", ["--compress"])):
        out[tag] = str(tmp / f"{tag}.npz")
        assert tcli.main(["sketch", *paths, "-o", out[tag], "-k", "21", "-s", str(S),
                          *extra, "--device", "cpu"]) == 0
    return out


@pytest.mark.parametrize("kind", ["raw", "compact"])
def test_cli_dist_with_a_cap_of_two_writes_the_reference_bytes(genome_dbs, monkeypatch, kind):
    monkeypatch.setenv("MIEKKI_COL_CACHE_MB", "0")
    tmp, db = genome_dbs["tmp"], genome_dbs[kind]
    jtsv, ttsv = tmp / f"j_{kind}.tsv", tmp / f"t_{kind}.tsv"
    assert jcli.main(["dist", db, "-o", str(jtsv), "--tile", "4"]) == 0
    T.reset_block_counts()
    assert tcli.main(["dist", db, "-o", str(ttsv), "--tile", "4", "--device", "cpu"]) == 0
    assert T.BLOCK_COUNTS["cap"] == 2 and T.BLOCK_COUNTS["evictions"] > 0
    assert ttsv.read_bytes() == jtsv.read_bytes()
