"""Port parity of the reference's result-identical knobs
(tests/test_env_matrix.py for miekki_tpu_torch): every value of
MIEKKI_MERGE × MIEKKI_HASH, MIEKKI_SCREEN_JOIN × MIEKKI_SCREEN_CHUNK,
MIEKKI_INTERSECT (raw and compact indexes), MIEKKI_PIPELINE, and under the
stream pass MIEKKI_PULL_GROUP and MIEKKI_PRESORT (accepted, acting on
nothing) gives the JAX package's outputs on the CPU: index members, dist TSV bytes, count matrices, the host
ring's matrices over three CPU positions and screen rows.  The reference
outputs are computed once with the variables unset (its own env-matrix test
holds them invariant).  Sizes: 4 genomes of 6 kb (k = 21, s = 256), and
for the tile routes 11 synthetic family sketches at tile 4.  Tolerance:
none — integers and TSV bytes exactly, float columns as the same float64
values."""

import numpy as np
import pytest

from miekki_tpu import engine as J
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.io import reader as j_reader
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.ops import intersect as TI
from miekki_tpu_torch.ops import mxu_intersect as TM
from miekki_tpu_torch.params import SketchParams as TParams
from miekki_tpu_torch.parallel import dist_sharded_hostring

from fixtures import make_genome_family, reads_from_genome, write_fasta, write_fastq

K, S, TILE = 21, 256, 4
KNOBS = ("MIEKKI_MERGE", "MIEKKI_HASH", "MIEKKI_SCREEN_JOIN", "MIEKKI_SCREEN_CHUNK",
         "MIEKKI_INTERSECT", "MIEKKI_PIPELINE", "MIEKKI_PULL_GROUP", "MIEKKI_PRESORT",
         "MIEKKI_TREE_CAP0")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """The reference test's genomes (4 of 6 kb at 4 % substitution), its
    JAX index and dist TSV, and reads of genome 1 (60 of 80 bases)."""
    tmp = tmp_path_factory.mktemp("torch_envmat")
    rng = np.random.default_rng(311)
    paths = [str(write_fasta(tmp / f"g{i}.fa", [(f"g{i}", g)]))
             for i, g in enumerate(make_genome_family(rng, 4, 6000, sub_rate=0.04))]
    jidx = J.build_index(paths, JParams(k=K, s=S))
    g1 = b"".join(s for _, s in j_reader.read_records(paths[1]))
    reads = reads_from_genome(np.random.default_rng(17), g1, 60, 80)
    fq = str(write_fastq(tmp / "reads.fq", [(f"r{i}", r) for i, r in enumerate(reads)]))
    return {"paths": paths, "jidx": jidx, "tsv": J.rows_to_tsv(J.dist(jidx)), "fq": fq}


def _same_members(tidx: TIndex, jidx: JIndex) -> bool:
    return (tidx.names == jidx.names and np.array_equal(tidx.hi, jidx.hi)
            and np.array_equal(tidx.lo, jidx.lo))


@pytest.mark.parametrize("merge", ["sort", "threshold", "tree", "fused"])
@pytest.mark.parametrize("hash_impl", ["auto", "pallas", "xla"])
def test_merge_hash_matrix_equals_reference(monkeypatch, genomes, merge, hash_impl):
    monkeypatch.setenv("MIEKKI_MERGE", merge)
    monkeypatch.setenv("MIEKKI_HASH", hash_impl)
    tidx = T.build_index(genomes["paths"], TParams(k=K, s=S), device="cpu")
    assert _same_members(tidx, genomes["jidx"])
    assert T.rows_to_tsv(T.dist(tidx, device="cpu")) == genomes["tsv"], (merge, hash_impl)


@pytest.fixture(scope="module")
def screen_refs(genomes):
    """The reference's screen rows (plain and -w), raw and compact DB."""
    out = {}
    for kind in ("raw", "compact"):
        jidx = genomes["jidx"].to_compact() if kind == "compact" else genomes["jidx"]
        for winner in (False, True):
            out[kind, winner] = J.screen(jidx, genomes["fq"], flat=2048, winner=winner)
    return out


@pytest.mark.parametrize("join", ["merge", "searchsorted"])
@pytest.mark.parametrize("chunk", ["4096", "999"])
def test_screen_join_matrix_equals_reference(monkeypatch, genomes, screen_refs, join, chunk):
    """Both joins at awkward chunk sizes give the reference's rows, plain
    and winner-takes-all, on a DB whose genomes share values (a family at
    4 %): the merge join marks every DB copy of a matched value, the probe
    join the first of its run, and the hits read the first."""
    jidx = genomes["jidx"]
    base = TIndex(TParams.from_dict(jidx.params.to_dict()), jidx.names, jidx.hi, jidx.lo)
    flat_vals, _ = J._flatten_db(jidx)
    assert len(np.unique(flat_vals)) < len(flat_vals)  # values shared by genomes
    monkeypatch.setenv("MIEKKI_SCREEN_JOIN", join)
    monkeypatch.setenv("MIEKKI_SCREEN_CHUNK", chunk)
    for kind in ("raw", "compact"):
        tidx = base.to_compact() if kind == "compact" else base
        for winner in (False, True):
            stats = {}
            got = T.screen(tidx, genomes["fq"], flat=2048, winner=winner, stats=stats,
                           device="cpu")
            assert got == screen_refs[kind, winner], (join, chunk, kind, winner)
            assert stats["n_survivors"] > 0


def test_merge_join_budget_counts_the_batch(monkeypatch, genomes, screen_refs):
    """Under MIEKKI_SCREEN_JOIN=merge the one-pass budget is the memory's
    merge-join share less the batch.  With a limit whose share holds the DB
    but not the DB and a batch beside it, the merge screen takes the grouped
    path with the searchsorted join; with a share that holds both, one pass
    by the merge join.  The searchsorted screen runs in one pass under
    both limits, and every run gives the reference's rows."""
    from miekki_tpu_torch.utils import hbm

    jidx = genomes["jidx"]
    tidx = TIndex(TParams.from_dict(jidx.params.to_dict()), jidx.names, jidx.hi, jidx.lo)
    n_vals, flat = int(tidx.sizes().sum()), 2048
    per = hbm.SCREEN_MERGE_JOIN_BYTES_PER_VALUE
    merges = []
    real = T._screen_join_merge
    monkeypatch.setattr(T, "_screen_join_merge", lambda *a: merges.append(1) or real(*a))
    for extra, grouped in ((flat // 2, True), (2 * flat, False)):
        limit = int((n_vals + extra) * per / hbm.SCREEN_RESIDENT_FRAC) + per
        monkeypatch.setenv("MIEKKI_HBM_LIMIT", str(limit))
        share = int(limit * hbm.SCREEN_RESIDENT_FRAC) // per
        assert hbm.screen_merge_join_value_budget("cpu", flat) == share - flat
        assert (T._screen_db_value_budgets("cpu", "merge", flat)[0] < n_vals) == grouped
        assert T._screen_db_value_budgets("cpu", "searchsorted", flat)[0] >= n_vals
        for join in ("merge", "searchsorted"):
            monkeypatch.setenv("MIEKKI_SCREEN_JOIN", join)
            stats, merges[:] = {}, []
            got = T.screen(tidx, genomes["fq"], flat=flat, stats=stats, device="cpu")
            assert got == screen_refs["raw", False], (join, grouped)
            one_pass = join == "searchsorted" or not grouped
            assert ("n_slabs" in stats) == (not one_pass), (join, grouped)
            assert bool(merges) == (join == "merge" and one_pass), (join, grouped)


def test_screen_join_values(monkeypatch):
    assert T._screen_join() == "searchsorted" and T._screen_chunk() is None
    monkeypatch.setenv("MIEKKI_SCREEN_JOIN", "MERGE")
    monkeypatch.setenv("MIEKKI_SCREEN_CHUNK", "999")
    assert T._screen_join() == "merge" and T._screen_chunk() == 999
    monkeypatch.setenv("MIEKKI_SCREEN_JOIN", "partition")
    with pytest.raises(ValueError, match="MIEKKI_SCREEN_JOIN"):
        T._screen_join()


def _family_sketches(n, s, seed):
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2 ** 63, size=8 * s, dtype=np.uint64))[: 3 * s]
    out = []
    for i in range(n):
        sk = np.unique(pool[rng.choice(3 * s, size=s + 20, replace=False)])[:s]
        out.append(sk[: s // 3] if i % 4 == 3 else sk)
    return out


@pytest.fixture(scope="module")
def tiles():
    """11 family sketches (s = 256, every fourth short), raw and compact:
    (JAX index, port index, JAX TSV at tile 4, JAX count matrices)."""
    sketches = _family_sketches(11, S, 5)
    names = [f"f{i}" for i in range(len(sketches))]
    out = {}
    for kind in ("raw", "compact"):
        j = JIndex.from_sketches(sketches, names, JParams(k=K, s=S))
        t = TIndex.from_sketches(sketches, names, TParams(k=K, s=S))
        if kind == "compact":
            j, t = j.to_compact(), t.to_compact()
        out[kind] = (j, t, J.rows_to_tsv(J.dist(j, tile=TILE)),
                     J.dist_counts_matrix(j, tile=TILE))
    return out


def _assert_counts_equal(got: dict, want: dict, what):
    for key in ("shared", "union", "inter"):
        assert np.array_equal(got[key], want[key]), (what, key)


@pytest.mark.parametrize("impl", ["auto", "pallas", "bitonic", "searchsorted", "mxu"])
@pytest.mark.parametrize("kind", ["raw", "compact"])
def test_tile_route_matrix_equals_reference(monkeypatch, tiles, impl, kind):
    """Every MIEKKI_INTERSECT route gives the reference's dist TSV, count
    matrices and (upper triangle of) host-ring matrices over three CPU
    positions; only auto/pallas call K3/K4's wrapper."""
    from miekki_tpu_torch.ops import cuda_intersect, cuda_intersect32

    jidx, tidx, tsv, counts = tiles[kind]
    monkeypatch.setenv("MIEKKI_INTERSECT", impl)
    calls = []
    for mod, name in ((cuda_intersect, "tile_counts_cuda"),
                      (cuda_intersect32, "tile_counts32_cuda")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real: calls.append(1) or real(*a))
    assert T.rows_to_tsv(T.dist(tidx, tile=TILE, device="cpu")) == tsv
    _assert_counts_equal(T.dist_counts_matrix(tidx, tile=TILE, device="cpu"), counts, impl)
    ring = dist_sharded_hostring(tidx, ["cpu"] * 3, tile=2)
    for key in ("shared", "union", "inter"):
        assert np.array_equal(np.triu(ring[key]), np.triu(counts[key])), key
        assert np.array_equal(ring[key], ring[key].T), key
    assert bool(calls) == (impl in ("auto", "pallas")), impl


@pytest.mark.parametrize("depth", ["0", "1", "3", "8"])
def test_pipeline_depth_matrix_equals_reference(monkeypatch, genomes, tiles, depth):
    """MIEKKI_PIPELINE: dist_tiles' yields (order, coordinates, counts),
    the count matrices and build_index's members do not depend on it."""
    jidx, tidx, _, counts = tiles["raw"]
    want = list(T.dist_tiles(tidx, tile=TILE, device="cpu"))
    monkeypatch.setenv("MIEKKI_PIPELINE", depth)
    got = list(T.dist_tiles(tidx, tile=TILE, device="cpu"))
    assert [t[:2] for t in got] == [t[:2] for t in want]
    for a, b in zip(got, want):
        for x, y in zip(a[2:], b[2:]):
            assert np.array_equal(x, y)
    _assert_counts_equal(T.dist_counts_matrix(tidx, tile=TILE, device="cpu"), counts, depth)
    _assert_counts_equal(T.dist_counts_matrix(tiles["compact"][1], tile=TILE, device="cpu"),
                         tiles["compact"][3], depth)
    built = T.build_index(genomes["paths"], TParams(k=K, s=S), batch=2, device="cpu")
    assert _same_members(built, genomes["jidx"])


@pytest.mark.parametrize("knobs", [
    {"MIEKKI_PIPELINE": "0"},
    {"MIEKKI_PULL_GROUP": "1"},
    {"MIEKKI_PULL_GROUP": "3", "MIEKKI_PIPELINE": "8"},
    {"MIEKKI_PRESORT": "1"},
    {"MIEKKI_PRESORT": "1", "MIEKKI_COL_CACHE_MB": "0"},
])
@pytest.mark.parametrize("kind", ["raw", "compact"])
def test_stream_pass_knobs_equal_reference(monkeypatch, tiles, knobs, kind):
    """Under MIEKKI_INTERSECT=mxu, the pull knobs leave the TSV and count
    matrices the reference's; MIEKKI_PULL_GROUP and MIEKKI_PRESORT are
    accepted and act on nothing: the block cache's loads and hits and the
    passes are those of the run without them."""
    jidx, tidx, tsv, counts = tiles[kind]
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    if "MIEKKI_COL_CACHE_MB" in knobs:
        monkeypatch.setenv("MIEKKI_COL_CACHE_MB", knobs["MIEKKI_COL_CACHE_MB"])
    runs = []
    for extra in ({}, knobs):
        for name, value in extra.items():
            monkeypatch.setenv(name, value)
        T.reset_block_counts()
        TM.reset_counts()
        assert T.rows_to_tsv(T.dist(tidx, tile=TILE, device="cpu")) == tsv
        runs.append((dict(T.BLOCK_COUNTS), dict(TM.PASS_COUNTS)))
    n_blocks = -(-len(tidx) // TILE)
    assert runs[0][1]["full"] == n_blocks * (n_blocks + 1) // 2
    for key in ("loads", "hits", "evictions"):
        assert runs[1][0][key] == runs[0][0][key], key
    assert runs[1][1] == runs[0][1]
    _assert_counts_equal(T.dist_counts_matrix(tidx, tile=TILE, device="cpu"), counts, knobs)
    assert TI.intersect_impl() == "mxu"


@pytest.mark.parametrize("value", ["four", "2.5"])
def test_pull_group_that_is_not_an_integer_raises(monkeypatch, tiles, value):
    """As in the reference, MIEKKI_PULL_GROUP must be an integer."""
    monkeypatch.setenv("MIEKKI_PULL_GROUP", value)
    with pytest.raises(ValueError):
        list(T.dist_tiles(tiles["raw"][1], tile=TILE, device="cpu"))
