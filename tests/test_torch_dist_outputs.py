"""Port parity of the comparison outputs beyond the row TSV: manifest
resume (dist_resumable, `dist --manifest`), count matrices
(dist_counts_matrix, counts_tsv_write, `dist --counts`), the Phylip
matrices (`dist --matrix`, `triangle`), `merge`, sharded index files
(`sketch --shards`) and `--profile`.  The same seeded inputs go through the
JAX package and the port (`device="cpu"` / `--device cpu`); texts must be
byte-identical (a resumed TSV as a row multiset), count matrices bitwise
equal, and npz files equal member for member."""

import json

import numpy as np
import pytest

from miekki_tpu import cli as jcli
from miekki_tpu import engine as J
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu_torch import cli as tcli
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.params import SketchParams

from fixtures import make_genome_family, random_genome_fasta, write_fasta

K, S = 21, 64


def _pair(idx: TIndex):
    """The same index as a JAX-package SketchIndex."""
    from miekki_tpu.params import SketchParams as JParams

    return JIndex(JParams.from_dict(idx.params.to_dict()), idx.names, idx.hi, idx.lo)


def _split(idx, at):
    cls = type(idx)
    return (cls(idx.params, idx.names[:at], idx.hi[:at], idx.lo[:at]),
            cls(idx.params, idx.names[at:], idx.hi[at:], idx.lo[at:]))


@pytest.fixture(scope="module")
def idx(tmp_path_factory):
    """9 genomes of 600 bases (as tests/test_resume.py), sketched by the port."""
    tmp = tmp_path_factory.mktemp("torch_resume")
    rng = np.random.default_rng(5)
    paths = [random_genome_fasta(tmp / f"g{i}.fa", rng, length=600) for i in range(9)]
    return T.build_index(paths, SketchParams(k=K, s=S), device="cpu")


@pytest.fixture(scope="module")
def related(tmp_path_factory):
    """11 sketches with shared values (s = 40, some short, one empty), the
    port's and the reference's index of them."""
    rng = np.random.default_rng(3)
    s = 40
    pool = rng.integers(0, 2 ** 64 - 1, size=200, dtype=np.uint64)
    sketches = [np.unique(rng.choice(pool, size=int(rng.integers(0, s + 1)),
                                     replace=False))[:s] for _ in range(10)]
    sketches.append(np.sort(rng.choice(pool, size=s, replace=False)))
    t = TIndex.from_sketches(sketches, [f"g{i}" for i in range(11)],
                             SketchParams(k=K, s=s))
    return t, _pair(t)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Raw and compact index files of 5 related genomes (and 2 more for
    --ref jobs), written by the port's CLI."""
    tmp = tmp_path_factory.mktemp("torch_outputs")
    rng = np.random.default_rng(61)
    seqs = make_genome_family(rng, 7, 4_000, sub_rate=0.05)
    paths = [str(write_fasta(tmp / f"g{i}.fa", [(f"g{i}", g)]))
             for i, g in enumerate(seqs)]
    out = {"tmp": tmp, "paths": paths}
    for tag, inputs, extra in (("raw", paths[:5], []), ("compact", paths[:5], ["--compress"]),
                               ("ref", paths[5:], []), ("ref32", paths[5:], ["--compress"])):
        out[tag] = str(tmp / f"{tag}.npz")
        assert tcli.main(["sketch", *inputs, "-o", out[tag], "-k", str(K), "-s", "200",
                          *extra, "--device", "cpu"]) == 0
    return out


def _npz_members(path):
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


def _same_npz(a, b):
    za, zb = _npz_members(a), _npz_members(b)
    assert sorted(za) == sorted(zb)
    for name in za:
        assert za[name].dtype == zb[name].dtype, name
        assert np.array_equal(za[name], zb[name]), name
    return za


def _rows(path):
    return sorted(open(path).read().splitlines()[1:])


# ------------------------------------------------------------------ M13 resume


def test_resumable_full_run_matches_dist(idx, tmp_path):
    out, mani = tmp_path / "d.tsv", tmp_path / "d.manifest"
    n = T.dist_resumable(idx, out, mani, tile=4, device="cpu")
    rows = T.dist(idx, tile=4, device="cpu")
    assert n == len(rows) == 36
    assert _rows(out) == sorted(T.rows_to_tsv(rows).splitlines()[1:])
    # tile order, unsorted within a tile: the reference's bytes
    jout, jmani = tmp_path / "j.tsv", tmp_path / "j.manifest"
    assert J.dist_resumable(_pair(idx), jout, jmani, tile=4) == n
    assert out.read_bytes() == jout.read_bytes()
    assert mani.read_bytes() == jmani.read_bytes()


def test_resume_after_interruption(idx, tmp_path, monkeypatch):
    out, mani = tmp_path / "d.tsv", tmp_path / "d.manifest"

    class Stop(Exception):
        pass

    # interrupt after 2 completed tiles (a host dying mid-job)
    real = T.dist_tiles

    def two_tiles(*a, **kw):
        gen = real(*a, **kw)
        yield next(gen)
        yield next(gen)
        raise Stop()

    monkeypatch.setattr(T, "dist_tiles", two_tiles)
    with pytest.raises(Stop):
        T.dist_resumable(idx, out, mani, tile=4, device="cpu")
    monkeypatch.setattr(T, "dist_tiles", real)
    tiles_done = [tuple(json.loads(ln).values()) for ln in mani.read_text().splitlines()]
    assert tiles_done == [(0, 0), (0, 1)]
    assert len(out.read_text().splitlines()) == 1 + 4 * 3 // 2 + 4 * 4

    n = T.dist_resumable(idx, out, mani, tile=4, device="cpu")
    manifest = [tuple(json.loads(ln).values()) for ln in mani.read_text().splitlines()]
    assert len(manifest) == len(set(manifest)) == 6  # no tile recomputed
    assert n == 36 - 4 * 3 // 2 - 4 * 4
    want = sorted(T.rows_to_tsv(J.dist(_pair(idx), tile=4)).splitlines()[1:])
    assert _rows(out) == want


def test_resume_noop_when_complete(idx, tmp_path):
    out, mani = tmp_path / "d.tsv", tmp_path / "d.manifest"
    T.dist_resumable(idx, out, mani, tile=4, device="cpu")
    before = out.read_text()
    assert T.dist_resumable(idx, out, mani, tile=4, device="cpu") == 0
    assert out.read_text() == before


def test_resume_restarts_when_the_output_is_missing(idx, tmp_path):
    """The manifest is read only when both files exist: a manifest with no
    TSV beside it starts a fresh run."""
    out, mani = tmp_path / "d.tsv", tmp_path / "d.manifest"
    T.dist_resumable(idx, out, mani, tile=4, device="cpu")
    full = out.read_bytes()
    out.unlink()
    assert T.dist_resumable(idx, out, mani, tile=4, device="cpu") == 36
    assert out.read_bytes() == full
    assert len(mani.read_text().splitlines()) == 6


def test_resumable_rectangular(idx, tmp_path):
    a, b = _split(idx, 4)
    out, mani = tmp_path / "r.tsv", tmp_path / "r.manifest"
    n = T.dist_resumable(a, out, mani, index_b=b, tile=3, device="cpu")
    rows = J.dist(*_split(_pair(idx), 4))
    assert n == len(rows) == 4 * 5
    assert _rows(out) == sorted(J.rows_to_tsv(rows).splitlines()[1:])


def test_cli_manifest_resume(dbs, tmp_path):
    """dist --manifest through both CLIs: the same bytes; a rerun is a
    no-op; the rows are those of the plain TSV."""
    db = dbs["raw"]
    common = ["--manifest", None, "--tile", "2", "--containment"]
    outs = {}
    for name, mod, extra in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        out, mani = tmp_path / f"{name}.tsv", tmp_path / f"{name}.manifest"
        common[1] = str(mani)
        assert mod.main(["dist", db, "-o", str(out), *common, *extra]) == 0
        first = out.read_bytes()
        assert mod.main(["dist", db, "-o", str(out), *common, *extra]) == 0
        assert out.read_bytes() == first
        outs[name] = (first, mani.read_bytes())
    assert outs["t"] == outs["j"]
    assert len(outs["t"][0].splitlines()) == 1 + 10
    plain = tmp_path / "p.tsv"
    assert tcli.main(["dist", db, "-o", str(plain), "--containment", "--device", "cpu"]) == 0
    assert _rows(plain) == sorted(outs["t"][0].decode().splitlines()[1:])


def test_cli_manifest_interrupted_then_resumed(dbs, tmp_path, monkeypatch):
    """An interrupted `dist --manifest` (the tile generator dies after its
    first tile) resumes to the plain TSV's rows, each tile once."""
    db = dbs["raw"]
    out, mani = tmp_path / "i.tsv", tmp_path / "i.manifest"
    argv = ["dist", db, "-o", str(out), "--manifest", str(mani), "--tile", "2",
            "--device", "cpu"]
    real = T.dist_tiles

    def one_tile(*a, **kw):
        gen = real(*a, **kw)
        yield next(gen)
        raise KeyboardInterrupt

    monkeypatch.setattr(T, "dist_tiles", one_tile)
    with pytest.raises(KeyboardInterrupt):
        tcli.main(argv)
    assert len(mani.read_text().splitlines()) == 1
    monkeypatch.setattr(T, "dist_tiles", real)
    assert tcli.main(argv) == 0
    tiles = [tuple(json.loads(ln).values()) for ln in mani.read_text().splitlines()]
    assert len(tiles) == len(set(tiles)) == 6
    plain = tmp_path / "p.tsv"
    assert jcli.main(["dist", db, "-o", str(plain)]) == 0
    assert _rows(out) == _rows(plain)


def test_cli_manifest_requires_an_output_file(dbs, capsys):
    assert tcli.main(["dist", dbs["raw"], "--manifest", "m.jsonl", "--device", "cpu"]) == 2
    assert "dist: --manifest requires -o FILE" in capsys.readouterr().err


# ---------------------------------------------------------- M14 count matrices


@pytest.mark.parametrize("tile", [3, 4, 11, 512])
@pytest.mark.parametrize("kind", ["self", "rect", "compact", "compact_rect"])
def test_dist_counts_matrix_equals_reference(related, kind, tile):
    """Bitwise equal at each tiling (3 and 4 do not divide 11), including
    the lower-triangle values inside diagonal tiles and the zeros
    elsewhere."""
    t, j = related
    if kind.startswith("compact"):
        t, j = t.to_compact(), j.to_compact()
    args_t, args_j = ((t,), (j,)) if not kind.endswith("rect") else (_split(t, 4), _split(j, 4))
    got = T.dist_counts_matrix(*args_t, tile=tile, device="cpu")
    want = J.dist_counts_matrix(*args_j, tile=tile)
    for c in ("shared", "union", "inter"):
        assert got[c].dtype == want[c].dtype == np.int32, c
        assert np.array_equal(got[c], want[c]), c
    if kind == "self" and tile == 4:
        assert got["shared"][5, 4] != 0 or got["union"][5, 4] != 0  # inside a diagonal tile
        assert (got["union"][4:, :4] == 0).all()  # a lower off-diagonal tile


@pytest.mark.parametrize("kind", ["self", "rect"])
def test_counts_tsv_write_equals_reference_and_dist_tsv(related, kind, tmp_path):
    import io

    t, j = related
    cols = T.select_columns(containment=True, bounds=True)
    args_t = (t, None) if kind == "self" else _split(t, 4)
    args_j = (j, None) if kind == "self" else _split(j, 4)
    c = T.dist_counts_matrix(*args_t, tile=4, device="cpu")
    got, want, rows = io.StringIO(), io.StringIO(), io.StringIO()
    n = T.counts_tsv_write(got, args_t[0], c["shared"], c["union"], args_t[1],
                           inter=c["inter"], columns=cols, row_chunk=3)
    J.counts_tsv_write(want, args_j[0], c["shared"], c["union"], args_j[1],
                       inter=c["inter"], columns=cols, row_chunk=3)
    T.dist_tsv_write(rows, args_t[0], args_t[1], tile=4, columns=cols, device="cpu")
    assert got.getvalue() == want.getvalue() == rows.getvalue()
    assert n == (55 if kind == "self" else 4 * 7)


@pytest.mark.parametrize("db,ref", [("raw", None), ("compact", None), ("raw", "ref"),
                                    ("compact", "ref32")])
def test_cli_counts_equal_reference_members(dbs, db, ref, tmp_path):
    extra = ["--ref", dbs[ref]] if ref else []
    jout, tout = tmp_path / "j.npz", tmp_path / "t.npz"
    assert jcli.main(["dist", dbs[db], "--counts", str(jout), "--tile", "2", *extra]) == 0
    assert tcli.main(["dist", dbs[db], "--counts", str(tout), "--tile", "2", *extra,
                      "--device", "cpu"]) == 0
    z = _same_npz(jout, tout)
    assert sorted(z) == ["inter", "k", "query_names", "reference_names", "s", "shared",
                         "union"]
    assert z["shared"].shape == (5, 5 if ref is None else 2)


# ------------------------------------------------ M15 matrix, triangle, merge


@pytest.mark.parametrize("db", ["raw", "compact"])
def test_matrix_and_triangle_text_equal_reference(dbs, db, tmp_path):
    for argv in (["dist", dbs[db], "--matrix", "--tile", "2"],
                 ["triangle", dbs[db], "--tile", "3"]):
        jout, tout = tmp_path / "j.txt", tmp_path / "t.txt"
        assert jcli.main([*argv, "-o", str(jout)]) == 0
        assert tcli.main([*argv, "-o", str(tout), "--device", "cpu"]) == 0
        assert tout.read_bytes() == jout.read_bytes()
    lines = (tmp_path / "t.txt").read_text().splitlines()  # the triangle
    assert lines[0] == "\t5" and [len(ln.split("\t")) for ln in lines[1:]] == [1, 2, 3, 4, 5]


def test_triangle_is_the_lower_half_of_the_matrix(related):
    t, _ = related
    square = T.dist_matrix_text(t, tile=4, device="cpu").splitlines()
    tri = T.dist_triangle_text(t, tile=3, device="cpu").splitlines()
    assert square[0] == tri[0] == "\t11"
    for i, (sq, tr) in enumerate(zip(square[1:], tri[1:])):
        cells = sq.split("\t")
        assert tr.split("\t") == cells[:1 + i]
        assert cells[1 + i] == "0"


def test_dist_matrix_refuses_beyond_46000_genomes():
    params = SketchParams(k=K, s=1)
    big = TIndex(params, [str(i) for i in range(46_001)],
                 np.full((46_001, 1), 0xFFFFFFFF, np.uint32),
                 np.full((46_001, 1), 0xFFFFFFFF, np.uint32))
    with pytest.raises(ValueError, match="dist --counts"):
        T._dist_matrix(big, device="cpu")


@pytest.mark.parametrize("extra,message", [
    (["--ref", "REF"], "dist: --matrix is self-all-vs-all only"),
    (["--containment"], "dist: --matrix excludes"),
    (["--bounds"], "dist: --matrix excludes"),
    (["--max-dist", "0.1"], "dist: --matrix excludes"),
    (["--max-p", "0.1"], "dist: --matrix excludes"),
])
def test_matrix_refusals_exit_2(dbs, capsys, extra, message):
    extra = [dbs["ref"] if x == "REF" else x for x in extra]
    codes = []
    for mod, dev in ((jcli, []), (tcli, ["--device", "cpu"])):
        codes.append(mod.main(["dist", dbs["raw"], "--matrix", *extra, *dev]))
        assert message in capsys.readouterr().err
    assert codes == [2, 2]


@pytest.mark.parametrize("kind", ["raw", "compact"])
def test_merge_equals_reference(dbs, kind, tmp_path, capsys):
    ref = "ref" if kind == "raw" else "ref32"
    jout, tout = tmp_path / "j.npz", tmp_path / "t.npz"
    assert jcli.main(["merge", dbs[kind], dbs[ref], "-o", str(jout)]) == 0
    assert tcli.main(["merge", dbs[kind], dbs[ref], "-o", str(tout)]) == 0
    z = _same_npz(jout, tout)
    assert len(json.loads(bytes(z["header"]))["names"]) == 7
    merged = TIndex.load(tout)
    assert np.array_equal(merged.hi[:5], TIndex.load(dbs[kind]).hi)
    with pytest.raises(ValueError):
        tcli.main(["merge", dbs["raw"], dbs["ref32"], "-o", str(tmp_path / "x.npz")])
    capsys.readouterr()


# ------------------------------------------------------------- M16 shards


@pytest.mark.parametrize("n_shards", [2, 3, 9])
def test_sketch_shards_equal_reference(dbs, n_shards, tmp_path):
    """`sketch --shards N` writes the reference's shard files (empty ones
    when N exceeds the genomes), and they load back into the unsharded
    index."""
    paths = dbs["paths"]
    common = [*paths, "-k", str(K), "-s", "200", "--shards", str(n_shards)]
    assert jcli.main(["sketch", *common, "-o", str(tmp_path / "j.npz")]) == 0
    assert tcli.main(["sketch", *common, "-o", str(tmp_path / "t.npz"),
                      "--device", "cpu"]) == 0
    names = [f"shard{i:04d}-of-{n_shards:04d}.npz" for i in range(n_shards)]
    for name in names:
        _same_npz(tmp_path / f"j.{name}", tmp_path / f"t.{name}")
    assert not (tmp_path / "t.npz").exists()
    back = TIndex.load_sharded([str(tmp_path / f"t.{n}") for n in names])
    whole = tmp_path / "whole.npz"
    assert tcli.main(["sketch", *paths, "-k", str(K), "-s", "200", "-o", str(whole),
                      "--device", "cpu"]) == 0
    one = TIndex.load(whole)
    assert back.names == one.names
    assert np.array_equal(back.hi, one.hi) and np.array_equal(back.lo, one.lo)


def test_save_sharded_more_shards_than_genomes(related, tmp_path):
    t, j = related
    small = TIndex(t.params, t.names[:2], t.hi[:2], t.lo[:2])
    paths = small.save_sharded(str(tmp_path / "db"), 4)
    jpaths = JIndex(j.params, j.names[:2], j.hi[:2], j.lo[:2]).save_sharded(
        str(tmp_path / "jdb"), 4)
    assert [p.split("/")[-1] for p in paths] == [
        f"db.shard{i:04d}-of-0004.npz" for i in range(4)]
    assert sum(len(TIndex.load(p)) for p in paths) == 2
    for p, q in zip(paths, jpaths):
        _same_npz(p, q)
    back = TIndex.load_sharded(paths)
    assert back.names == small.names and np.array_equal(back.hi, small.hi)


# ------------------------------------------------------------ M17 --profile


@pytest.mark.parametrize("argv", [["dist", "DB", "--matrix"], ["triangle", "DB"],
                                  ["dist", "DB", "--counts", "COUNTS"]])
def test_profile_writes_a_trace_and_keeps_the_result(dbs, argv, tmp_path):
    argv = [dbs["raw"] if a == "DB" else str(tmp_path / "c.npz") if a == "COUNTS" else a
            for a in argv]
    out = ["-o", str(tmp_path / "out.txt")] if "--counts" not in argv else []
    assert tcli.main([*argv, *out, "--device", "cpu"]) == 0
    plain = (tmp_path / "out.txt").read_bytes() if out else _npz_members(tmp_path / "c.npz")
    prof = tmp_path / "prof"
    assert tcli.main([*argv, *out, "--device", "cpu", "--profile", str(prof)]) == 0
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    if out:
        assert (tmp_path / "out.txt").read_bytes() == plain
    else:
        again = _npz_members(tmp_path / "c.npz")
        assert all(np.array_equal(again[m], plain[m]) for m in plain)



def test_warm_up_window_launches_its_burst_under_its_span():
    from torch.profiler import ProfilerActivity, profile

    from miekki_tpu_torch.utils import profiling

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.warm_up_window("cpu", launches=16)
    events = prof.profiler.kineto_results.events()
    span = [e for e in events if e.name() == profiling.WARMUP_SPAN]
    assert len(span) == 1
    ops = [e for e in events if e.name() in ("aten::empty", "aten::zero_")]
    assert sum(e.name() == "aten::zero_" for e in ops) == 16
    assert all(span[0].start_ns() <= e.start_ns() <= span[0].end_ns() for e in ops)
    assert profiling.missing_device_records(events) == 0


class _Event:
    """The parts of a profiler event that missing_device_records reads."""

    def __init__(self, name, corr, start, on_card):
        from torch.autograd import DeviceType

        self._name, self._corr, self._start = name, corr, start
        self._type = DeviceType.CUDA if on_card else DeviceType.CPU

    def name(self):
        return self._name

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return self._start

    def device_type(self):
        return self._type


@pytest.mark.parametrize("dropped,skip,want", [((), 0, 0), ((1, 2), 0, 2), ((1, 2), 2, 0),
                                               ((1, 5), 2, 1), ((6,), 5, 1)])
def test_missing_device_records_counts_the_launches_without_a_kernel(dropped, skip, want):
    from miekki_tpu_torch.utils.profiling import missing_device_records

    # six launches, ids 1..6 in launch order, listed last-launched first;
    # `skip` passes over the first launched
    events = [_Event("aten::add_", 0, 0, False), _Event("cudaMemcpyAsync", 9, 50, False)]
    for corr in range(6, 0, -1):
        events.append(_Event("cudaLaunchKernel", corr, 100 + corr, False))
        if corr not in dropped:
            events.append(_Event("void add_kernel<float>()", corr, 200 + corr, True))
    assert missing_device_records(events, skip=skip) == want
