"""Port parity: the port's CLI (miekki_tpu_torch.cli) against the JAX
package's CLI on the same genome files.  TSVs must be byte-identical and
index files must hold equal headers and arrays; each package loads the
other's index.  Covers raw and compact indexes (`sketch --compress`,
`compress`), the fused sketch strategy (MIEKKI_MERGE=fused), `screen`, and
`dist`/`screen --distributed` (the reference on conftest's 8 faked CPU
devices).  Everything runs with `--device cpu`."""

import json

import numpy as np
import pytest

from miekki_tpu import cli as jcli
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu_torch import cli as tcli
from miekki_tpu_torch.index.store import SketchIndex as TIndex

from fixtures import make_genome_family, write_fasta

K, S = 21, 300


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(55)
    seqs = make_genome_family(rng, 5, 15_000, sub_rate=0.04)
    seqs[3] = seqs[3][:9_000] + b"N" * 40 + seqs[3][9_040:]
    paths = [str(write_fasta(tmp / f"g{i}.fa", [(f"g{i}", g)]))
             for i, g in enumerate(seqs)]
    multi = str(write_fasta(tmp / "multi.fa", [(f"rec{i}", g[:5_000 + 700 * i])
                                                for i, g in enumerate(seqs)]))
    return tmp, paths, multi


def _sketch_both(tmp, inputs, tag, extra=()):
    jdb, tdb = str(tmp / f"j_{tag}.npz"), str(tmp / f"t_{tag}.npz")
    common = ["-k", str(K), "-s", str(S), *extra]
    assert jcli.main(["sketch", *inputs, "-o", jdb, *common]) == 0
    assert tcli.main(["sketch", *inputs, "-o", tdb, *common, "--device", "cpu"]) == 0
    return jdb, tdb


def _npz_members(path):
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


@pytest.mark.parametrize("extra", [[], ["--containment"], ["--bounds"],
                                   ["--containment", "--max-dist", "0.05"]])
def test_sketch_then_dist_writes_identical_tsv(genomes, extra):
    tmp, paths, _ = genomes
    jdb, tdb = _sketch_both(tmp, paths, "dist")
    jtsv, ttsv = tmp / "j.tsv", tmp / "t.tsv"
    assert jcli.main(["dist", jdb, "-o", str(jtsv), "--tile", "3", *extra]) == 0
    assert tcli.main(["dist", tdb, "-o", str(ttsv), "--tile", "3", "--device", "cpu",
                      *extra]) == 0
    text = ttsv.read_bytes()
    assert text == jtsv.read_bytes()
    assert len(text.splitlines()) > 1


def test_dist_of_genome_files_against_a_reference_index(genomes):
    tmp, paths, _ = genomes
    jdb, tdb = _sketch_both(tmp, paths[:2], "ref")
    jtsv, ttsv = tmp / "jr.tsv", tmp / "tr.tsv"
    common = ["-k", str(K), "-s", str(S), "--tile", "2", "--max-p", "1e-3"]
    assert jcli.main(["dist", *paths[2:], "--ref", jdb, "-o", str(jtsv), *common]) == 0
    assert tcli.main(["dist", *paths[2:], "--ref", tdb, "-o", str(ttsv), *common,
                      "--device", "cpu"]) == 0
    assert ttsv.read_bytes() == jtsv.read_bytes()


@pytest.mark.parametrize("mode", ["default", "per_record"])
def test_saved_index_equals_reference(genomes, mode):
    tmp, paths, multi = genomes
    inputs, extra = (paths, []) if mode == "default" else ([multi], ["--per-record"])
    jdb, tdb = _sketch_both(tmp, inputs, mode, extra)
    jz, tz = _npz_members(jdb), _npz_members(tdb)
    assert sorted(jz) == sorted(tz) == ["header", "hi", "lo"]
    assert json.loads(bytes(jz["header"])) == json.loads(bytes(tz["header"]))
    for name in ("header", "hi", "lo"):
        assert jz[name].dtype == tz[name].dtype, name
        assert np.array_equal(jz[name], tz[name]), name
    assert len(json.loads(bytes(tz["header"]))["names"]) == len(paths)


def test_each_package_loads_the_others_index(genomes):
    tmp, paths, _ = genomes
    jdb, tdb = _sketch_both(tmp, paths, "cross")
    a, b = TIndex.load(jdb), JIndex.load(tdb)
    for idx, ref in ((a, JIndex.load(jdb)), (b, TIndex.load(tdb))):
        assert idx.names == ref.names
        assert idx.params.to_dict() == ref.params.to_dict()
        assert np.array_equal(idx.hi, ref.hi) and np.array_equal(idx.lo, ref.lo)
    out = tmp / "saved_by_port.npz"
    a.save(out)
    back = JIndex.load(out)
    assert np.array_equal(back.hi, a.hi) and back.names == a.names


def test_info_matches_reference(genomes, capsys):
    tmp, paths, _ = genomes
    jdb, _ = _sketch_both(tmp, paths[:3], "info")
    for extra in ([], ["--dump"]):
        assert jcli.main(["info", jdb, *extra]) == 0
        want = capsys.readouterr().out
        assert tcli.main(["info", jdb, *extra]) == 0
        assert capsys.readouterr().out == want


@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_dist_distributed_writes_identical_tsv(genomes, compact):
    """`dist --distributed`: the reference on its 8 faked CPU devices, the
    port on --device cpu (one position); the same TSV bytes as each other
    and as the one-device `dist`."""
    tmp, paths, _ = genomes
    jdb, tdb = _sketch_both(tmp, paths, "dd32" if compact else "dd",
                            ["--compress"] if compact else [])
    jtsv, ttsv, plain = tmp / "jd.tsv", tmp / "td.tsv", tmp / "plain.tsv"
    common = ["--tile", "3", "--containment"]
    assert jcli.main(["dist", jdb, "--distributed", "-o", str(jtsv), *common]) == 0
    assert tcli.main(["dist", tdb, "--distributed", "-o", str(ttsv), *common,
                      "--device", "cpu"]) == 0
    assert tcli.main(["dist", tdb, "-o", str(plain), *common, "--device", "cpu"]) == 0
    text = ttsv.read_bytes()
    assert text == jtsv.read_bytes() == plain.read_bytes()
    assert len(text.splitlines()) == 1 + len(paths) * (len(paths) - 1) // 2


@pytest.mark.parametrize("rect", [False, True], ids=["self", "rect"])
def test_dist_distributed_counts_match_reference(genomes, rect):
    """`dist --distributed --counts`: the reference's npz members (the full
    symmetric matrices of a self-comparison)."""
    tmp, paths, _ = genomes
    jdb, tdb = _sketch_both(tmp, paths, "ddc")
    jref, tref = (["--ref", jdb], ["--ref", tdb]) if rect else ([], [])
    jc, tc = tmp / "jdc.npz", tmp / "tdc.npz"
    assert jcli.main(["dist", jdb, "--distributed", "--counts", str(jc), *jref]) == 0
    assert tcli.main(["dist", tdb, "--distributed", "--counts", str(tc), *tref,
                      "--device", "cpu"]) == 0
    za, zb = _npz_members(jc), _npz_members(tc)
    assert sorted(za) == sorted(zb)
    for name in za:
        assert za[name].dtype == zb[name].dtype and np.array_equal(za[name], zb[name]), name
    if not rect:
        assert np.array_equal(zb["shared"], zb["shared"].T)


def _same_npz(a, b, members):
    za, zb = _npz_members(a), _npz_members(b)
    assert sorted(za) == sorted(zb) == sorted(members)
    assert json.loads(bytes(za["header"])) == json.loads(bytes(zb["header"]))
    for name in members:
        assert za[name].dtype == zb[name].dtype and np.array_equal(za[name], zb[name]), name


def test_compact_indexes_match_reference(genomes, capsys):
    """`sketch --compress` and `compress` write the reference's compact
    files; `dist` of a compact index writes its TSV; `info` and
    `info --dump` print the same."""
    tmp, paths, _ = genomes
    jdb, tdb = _sketch_both(tmp, paths, "compress", ["--compress"])
    _same_npz(jdb, tdb, ["header", "hi"])
    assert json.loads(bytes(_npz_members(tdb)["header"]))["format_version"] == 2
    raw_j, raw_t = _sketch_both(tmp, paths, "raw_for_compress")
    j32, t32 = tmp / "j32.npz", tmp / "t32.npz"
    assert jcli.main(["compress", raw_j, "-o", str(j32)]) == 0
    assert tcli.main(["compress", raw_t, "-o", str(t32)]) == 0
    _same_npz(j32, t32, ["header", "hi"])
    _same_npz(t32, tdb, ["header", "hi"])
    assert tcli.main(["compress", str(t32), "-o", str(tmp / "again.npz")]) == 1
    capsys.readouterr()
    jtsv, ttsv = tmp / "jc.tsv", tmp / "tc.tsv"
    assert jcli.main(["dist", jdb, "-o", str(jtsv), "--tile", "2", "--containment"]) == 0
    assert tcli.main(["dist", tdb, "-o", str(ttsv), "--tile", "2", "--containment",
                      "--device", "cpu"]) == 0
    assert ttsv.read_bytes() == jtsv.read_bytes()
    assert len(ttsv.read_bytes().splitlines()) == 1 + 10
    for extra in ([], ["--dump"]):
        assert jcli.main(["info", jdb, *extra]) == 0
        want = capsys.readouterr().out
        assert tcli.main(["info", tdb, *extra]) == 0
        assert capsys.readouterr().out == want


def test_fused_sketch_matches_reference(genomes, monkeypatch):
    """MIEKKI_MERGE=fused: both CLIs write the same index, equal to the
    tree strategy's, and the same dist TSV."""
    tmp, paths, _ = genomes
    tree_j, _ = _sketch_both(tmp, paths, "tree_for_fused")
    monkeypatch.setenv("MIEKKI_MERGE", "fused")
    jdb, tdb = _sketch_both(tmp, paths, "fused")
    _same_npz(jdb, tdb, ["header", "hi", "lo"])
    _same_npz(tree_j, tdb, ["header", "hi", "lo"])
    jtsv, ttsv = tmp / "jf.tsv", tmp / "tf.tsv"
    assert jcli.main(["dist", jdb, "-o", str(jtsv)]) == 0
    assert tcli.main(["dist", tdb, "-o", str(ttsv), "--device", "cpu"]) == 0
    assert ttsv.read_bytes() == jtsv.read_bytes()


@pytest.fixture(scope="module")
def reads(genomes):
    from fixtures import reads_from_genome, write_fastq
    from miekki_tpu_torch.io.reader import read_records

    tmp, paths, _ = genomes
    rng = np.random.default_rng(56)
    seqs = [seq for p in paths[:3] for _, seq in read_records(p)]
    files = []
    for i, seq in enumerate(seqs):
        rs = reads_from_genome(rng, seq, 60 // (i + 1), 100)
        files.append(str(write_fastq(tmp / f"reads{i}.fq",
                                     [(f"r{i}_{j}", r) for j, r in enumerate(rs)])))
    return files


@pytest.mark.parametrize("extra,n_files", [([], 1), (["-w"], 1), (["-p"], 1),
                                           (["-w", "-p"], 2), ([], 3)])
@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_screen_writes_identical_tsv(genomes, reads, extra, n_files, compact):
    tmp, paths, _ = genomes
    tag = "screen32" if compact else "screen"
    jdb, tdb = _sketch_both(tmp, paths, tag, ["--compress"] if compact else [])
    jtsv, ttsv = tmp / "js.tsv", tmp / "ts.tsv"
    common = ["--flat", "4096", *extra]
    assert jcli.main(["screen", jdb, *reads[:n_files], "-o", str(jtsv), *common]) == 0
    assert tcli.main(["screen", tdb, *reads[:n_files], "-o", str(ttsv), *common,
                      "--device", "cpu"]) == 0
    text = ttsv.read_bytes()
    assert text == jtsv.read_bytes()
    assert len(text.splitlines()) == 1 + len(paths)
    assert ("p_value" in text.splitlines()[0].decode()) == ("-p" in extra)


@pytest.mark.parametrize("extra", [[], ["-w"], ["-p"]], ids=["plain", "winner", "p_values"])
def test_screen_distributed_writes_identical_tsv(genomes, reads, extra):
    """`screen --distributed`: the reference over its 8 faked CPU devices,
    the port on --device cpu; the same bytes, and the same as `screen`."""
    tmp, paths, _ = genomes
    jdb, tdb = _sketch_both(tmp, paths, "sd")
    jtsv, ttsv, plain = tmp / "jsd.tsv", tmp / "tsd.tsv", tmp / "psd.tsv"
    common = ["--flat", "4096", *extra]
    assert jcli.main(["screen", jdb, *reads, "-o", str(jtsv), "--distributed", *common]) == 0
    assert tcli.main(["screen", tdb, *reads, "-o", str(ttsv), "--distributed", *common,
                      "--device", "cpu"]) == 0
    assert tcli.main(["screen", tdb, *reads, "-o", str(plain), *common,
                      "--device", "cpu"]) == 0
    assert ttsv.read_bytes() == jtsv.read_bytes() == plain.read_bytes()


def test_screen_metrics_carry_the_reference_keys(genomes, reads, monkeypatch):
    """--metrics: the same phase line as the reference's, one-pass and
    grouped (MIEKKI_SCREEN_DB_VALS), equal apart from times."""
    tmp, paths, _ = genomes
    jdb, tdb = _sketch_both(tmp, paths, "screen_metrics")
    for vals in (None, "700"):
        if vals:
            monkeypatch.setenv("MIEKKI_SCREEN_DB_VALS", vals)
        lines = []
        for mod, db, extra in ((jcli, jdb, []), (tcli, tdb, ["--device", "cpu"])):
            met = tmp / f"{mod.__name__}_{vals}.jsonl"
            met.unlink(missing_ok=True)
            assert mod.main(["screen", db, *reads, "-o", str(tmp / "m.tsv"), "--flat",
                             "4096", "--metrics", str(met), *extra]) == 0
            line = json.loads(met.read_text().splitlines()[-1])
            for key in ("ts", "seconds", "phase_seconds"):
                line.pop(key, None)
            lines.append(line)
        assert lines[0] == lines[1]
        assert lines[1]["phase"] == "screen" and lines[1]["genomes"] == len(paths)
        assert ("n_slabs" in lines[1]) == bool(vals)
