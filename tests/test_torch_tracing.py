"""The port's program spans (utils.profiling.span, SPANS) on the CPU at
tiny sizes: 8 FASTA files through `cli sketch` (whole files and
--per-record), 16 sketches at tile 8
through dist_counts_matrix, dist_tsv_write and `cli dist` of their saved
index, and a read set through screen and through `cli screen -p` of a saved
index.  Under torch.profiler every span of a path is in SPANS with the
calls its inputs imply, its self seconds within its seconds and a child's
within its root's; the exported chrome trace holds one `user_annotation`
event per call, each inside the span the path nests it in (a span left
open across a generator's yield would enclose the caller's spans).  With
no profiler nothing is recorded and the outputs are the same.  The card's
idle time under each span is checked exactly on a synthetic trace."""

import contextlib
import gzip
import io
import json
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from miekki_tpu_torch import cli as tcli
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex
from miekki_tpu_torch.io import encode, reader
from miekki_tpu_torch.ops import sketch as sketch_ops
from miekki_tpu_torch.params import SketchParams
from miekki_tpu_torch.utils import metrics, profiling
from miekki_tpu_torch.utils.profiling import SPANS, span

from fixtures import make_genome_family, reads_from_genome, write_fasta, write_fastq

K, S, TILE, N_SKETCHES = 21, 200, 8, 16
# genome lengths in three bucketed shapes (rows of 4,096 / 8,192 bases)
LENGTHS = [3000, 3000, 6000, 6000, 20000, 20000, 20000, 3000]

# each path's spans and the span each is nested in (None: a root)
PARENTS = {
    "sketch": {"sketch": None, "sketch.parse": "sketch", "sketch.bucket": "sketch",
               "sketch.pack": "sketch", "sketch.upload": "sketch", "sketch.merge": "sketch",
               "sketch.pull": "sketch", "index.assemble": "sketch", "index.save": None},
    "per_record": {"sketch": None, "sketch.parse": "sketch", "sketch.bucket": "sketch",
                   "sketch.pack": "sketch", "sketch.upload": "sketch",
                   "sketch.merge": "sketch", "sketch.pull": "sketch",
                   "index.assemble": "sketch", "index.save": None},
    "counts": {"dist.counts": None, "dist.dispatch": "dist.counts",
               "dist.block_load": "dist.dispatch", "dist.pull_wait": "dist.counts",
               "dist.finish": "dist.counts", "dist.assemble": "dist.counts",
               "dist.fill": "dist.counts"},
    "tsv": {"dist.tsv": None, "dist.dispatch": "dist.tsv", "dist.block_load": "dist.dispatch",
            "dist.pull_wait": "dist.tsv", "dist.finish": "dist.tsv", "dist.format": "dist.tsv",
            "dist.pvalue": "dist.format", "dist.write": "dist.format"},
    "cli_tsv": {"index.load": None, "dist.tsv": None, "dist.dispatch": "dist.tsv",
                "dist.block_load": "dist.dispatch", "dist.pull_wait": "dist.tsv",
                "dist.finish": "dist.tsv", "dist.format": "dist.tsv",
                "dist.pvalue": "dist.format", "dist.write": "dist.format"},
    "screen": {"screen": None, "screen.flatten": "screen", "screen.pack": "screen",
               "screen.join": "screen", "screen.pull": "screen", "screen.hits": "screen",
               "screen.rows": None},
    "cli_screen": {"index.load": None, "screen": None, "screen.flatten": "screen",
                   "screen.pack": "screen", "screen.join": "screen", "screen.pull": "screen",
                   "screen.hits": "screen", "screen.rows": None},
}
PARENTS["screen_python"] = PARENTS["screen"]  # the screen where the read pack pass is not built
ROUNDING = 1e-9  # seconds: self_s and s are sums of differently rounded terms


def _root(parents, name):
    while parents[name] is not None:
        name = parents[name]
    return name


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracing")
    rng = np.random.default_rng(17)
    fasta = []
    for i, n in enumerate(LENGTHS):
        (seq,) = make_genome_family(rng, 1, n)
        fasta.append(str(write_fasta(tmp / f"g{i}.fa", [(f"g{i}", seq)])))
    pool = np.unique(rng.integers(0, 2 ** 64 - 1, size=4 * S, dtype=np.uint64))
    sketches = [np.sort(rng.choice(pool, size=int(rng.integers(S // 2, S + 1)),
                                   replace=False)) for _ in range(N_SKETCHES)]
    index = SketchIndex.from_sketches(sketches, [f"s{i}" for i in range(N_SKETCHES)],
                                      SketchParams(k=K, s=S))
    genome = make_genome_family(rng, 1, 20000)[0]
    reads = reads_from_genome(rng, genome, 300, 150)
    fastq = str(write_fastq(tmp / "reads.fq", [(f"r{i}", r) for i, r in enumerate(reads)]))
    db = T.build_index(fasta, SketchParams(k=K, s=S), device="cpu")
    index_file = tmp / "sketches.npz"
    index.save(index_file)
    db_file = tmp / "db.npz"
    db.save(db_file)
    return {"tmp": tmp, "fasta": fasta, "index": index, "fastq": fastq, "n_reads": len(reads),
            "read_bases": sum(len(r) for r in reads), "db": db, "index_file": index_file,
            "db_file": db_file}


@contextlib.contextmanager
def _packer(path):
    """The read packer of `path`: the Python one on "screen_python" (the
    native pass reads as not built), the native pass elsewhere."""
    with pytest.MonkeyPatch.context() as m:
        if path == "screen_python":
            m.setattr(T._read_pack, "available", lambda: False)
        yield


def _read_index(path):
    """(names, hi, lo) of an index file, read without the program's
    SketchIndex.load (whose `index.load` span is no part of a sketch path)."""
    with np.load(path) as z:
        return json.loads(bytes(z["header"]).decode())["names"], z["hi"], z["lo"]


def _run(path, inp, tag):
    """The path's output (bytes, arrays or rows) and, for the screen, its stats."""
    if path in ("sketch", "per_record"):
        out = inp["tmp"] / f"index-{path}-{tag}.npz"
        extra = ["--per-record"] if path == "per_record" else []
        assert tcli.main(["sketch", *inp["fasta"], "-o", str(out), "-k", str(K),
                          "-s", str(S), "--device", "cpu", *extra]) == 0
        return _read_index(out), None
    if path == "counts":
        m = T.dist_counts_matrix(inp["index"], tile=TILE, device="cpu")
        return (m["shared"], m["union"], m["inter"]), None
    if path == "tsv":
        buf = io.StringIO()
        T.dist_tsv_write(buf, inp["index"], tile=TILE, device="cpu")
        return buf.getvalue(), None
    if path == "cli_tsv":
        out = inp["tmp"] / f"dist-{tag}.tsv"
        assert tcli.main(["dist", str(inp["index_file"]), "-o", str(out), "--tile", str(TILE),
                          "--device", "cpu"]) == 0
        return out.read_text(), None
    if path == "cli_screen":
        out = inp["tmp"] / f"screen-{tag}.tsv"
        assert tcli.main(["screen", str(inp["db_file"]), inp["fastq"], "-p", "-o", str(out),
                          "--flat", "1024", "--device", "cpu"]) == 0
        return out.read_text(), None
    stats: dict = {}
    with _packer(path):
        rows = T.screen(inp["db"], inp["fastq"], flat=1024, stats=stats, device="cpu")
    return rows, stats


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module", params=list(PARENTS))
def traced(request, inputs):
    path = request.param
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, stats = _run(path, inputs, "traced")
    trace = inputs["tmp"] / f"{path}.trace.json"
    prof.export_chrome_trace(str(trace))
    spans = {name: dict(rec) for name, rec in SPANS.items()}
    profiling.reset_spans()
    return {"path": path, "spans": spans, "trace": trace, "out": out, "stats": stats}


def _n_tiles(n, tile):
    nb = -(-n // tile)
    return nb * (nb + 1) // 2


def test_every_span_is_recorded_with_its_calls(traced, inputs):
    path, spans = traced["path"], traced["spans"]
    assert set(spans) == set(PARENTS[path])
    assert all(rec["calls"] >= 1 for rec in spans.values())
    if path in ("sketch", "per_record"):
        shapes = {}
        for p in inputs["fasta"]:
            codes = encode.pack_records(reader.read_genome_codes(p), K)
            shape = sketch_ops.bucketed_chunk_codes(codes, K, T.DEFAULT_CHUNK).shape
            shapes[shape] = shapes.get(shape, 0) + 1
        batches = sum(-(-n // T.MAX_GENOME_BATCH) for n in shapes.values())
        assert batches == 3
        assert spans["sketch.merge"]["calls"] == batches
        assert spans["sketch.pack"]["calls"] == spans["sketch.upload"]["calls"] == batches
        assert spans["sketch.pull"]["calls"] == batches
        assert spans["sketch.parse"]["bases"] == sum(LENGTHS)
        if path == "sketch":  # build_index parses each plain FASTA file into its arena
            assert spans["sketch.parse"]["arena_files"] == len(inputs["fasta"])
        saved = inputs["tmp"] / f"index-{path}-traced.npz"
        assert spans["index.save"]["bytes"] == saved.stat().st_size
        assert spans["sketch"]["calls"] == spans["index.save"]["calls"] == 1
    elif path in ("counts", "tsv", "cli_tsv"):
        tiles = _n_tiles(N_SKETCHES, TILE)
        assert tiles == 3
        for name in ("dist.dispatch", "dist.pull_wait", "dist.finish"):
            assert spans[name]["calls"] == tiles, name
        # a self-comparison over two blocks loads each once, 8 rows of the
        # hi and lo planes at s uint32 values
        assert spans["dist.block_load"]["calls"] == 2
        assert spans["dist.block_load"]["bytes"] == N_SKETCHES * S * 2 * 4
        if path == "counts":
            assert spans["dist.assemble"]["calls"] == tiles
            assert spans["dist.fill"]["calls"] == 1
        else:
            assert spans["dist.format"]["calls"] == 2  # one a row-block stripe
            assert spans["dist.format"]["rows"] == N_SKETCHES * (N_SKETCHES - 1) // 2
            _assert_tsv_counts(traced, inputs)
    else:
        _assert_screen_counts(traced, inputs)


def _assert_screen_counts(traced, inputs):
    """The screen's counts: `screen.pack` the file's reads, read bases and
    batches (one call more: the file's end), and of those the batches
    the native pass packed (all, or none where it is not built);
    `screen.flatten` the DB's
    values and the bytes of their values and genome ids pulled;
    `screen.pull` the bitmap's packed bytes (one bit a value and the
    sink); `screen.rows` the rows once, opened once more by `cli screen`
    around the TSV text; `index.load` the file's bytes."""
    spans, db = traced["spans"], inputs["db"]
    with _packer(traced["path"]):
        native = T._native.available() and T._read_pack.available()
        batches = len(list(T._packed_read_rows(inputs["fastq"], K, 1024)))
    assert native == (traced["path"] != "screen_python")
    if traced["stats"] is not None:
        assert batches == traced["stats"]["n_batches"]
    assert spans["screen.pack"]["reads"] == inputs["n_reads"]
    assert spans["screen.pack"]["bases"] == inputs["read_bases"]
    assert spans["screen.pack"]["batches"] == spans["screen.join"]["calls"] == batches
    assert spans["screen.pack"]["calls"] == batches + 1  # and the file's end
    assert spans["screen.pack"]["native_batches"] == (batches if native else 0)
    values = int(db.sizes().sum())
    assert spans["screen.flatten"]["calls"] == spans["screen.pull"]["calls"] == 1
    assert spans["screen.flatten"]["values"] == values
    assert spans["screen.flatten"]["bytes"] == values * (8 + 4)
    assert spans["screen.pull"]["bytes"] == -(-(values + 1) // 8)
    assert spans["screen.hits"]["calls"] == 1
    assert spans["screen.rows"]["rows"] == len(db)
    if traced["path"] == "cli_screen":
        assert spans["screen.rows"]["calls"] == 2
        assert spans["index.load"]["calls"] == 1
        assert spans["index.load"]["bytes"] == inputs["db_file"].stat().st_size
    else:
        assert spans["screen.rows"]["calls"] == 1


def _assert_tsv_counts(traced, inputs):
    """The TSV's p-value, write and load counts: `dist.pvalue` counts the
    pairs whose p-value went through the incomplete beta (here every pair
    sharing a value: 0 < q < 1 at these cardinalities) and opens twice a
    format call (the p-values, then their text); `dist.write` counts the
    characters of the rows, as `dist.format` does; `index.load` the file's
    bytes and its genomes."""
    spans, text = traced["spans"], traced["out"]
    header, *rows = text.splitlines(keepends=True)
    sharing = sum(int(r.split("\t")[2]) > 0 for r in rows)
    assert 0 < sharing <= len(rows)
    assert spans["dist.pvalue"]["pairs"] == sharing
    assert spans["dist.pvalue"]["calls"] == 2 * spans["dist.format"]["calls"]
    assert spans["dist.write"]["calls"] == spans["dist.format"]["calls"]
    assert spans["dist.write"]["bytes"] == spans["dist.format"]["bytes"] == len(text) - len(header)
    if traced["path"] == "cli_tsv":
        assert spans["index.load"]["calls"] == 1
        assert spans["index.load"]["bytes"] == inputs["index_file"].stat().st_size
        assert spans["index.load"]["genomes"] == N_SKETCHES


@pytest.mark.parametrize("path", ["sketch", "per_record"])
def test_sketch_upload_counts_bases_and_laid_out_rows(inputs, path):
    """`sketch.upload` counts the bytes that crossed (the staged bases of
    every batch) and `row_bytes`, the rows laid out on the device: g_pad *
    n_pad * (c + k - 1) summed over the batches."""
    shapes = {}
    for p in inputs["fasta"]:
        codes = encode.pack_records(reader.read_genome_codes(p), K)
        shape = sketch_ops.bucketed_shape(len(codes), K, T.DEFAULT_CHUNK)
        shapes[shape] = shapes.get(shape, 0) + 1
    row_bytes = 0
    for (n_pad, w), n in shapes.items():
        for a in range(0, n, T.MAX_GENOME_BATCH):
            g = min(T.MAX_GENOME_BATCH, n - a)
            row_bytes += (1 << (g - 1).bit_length()) * n_pad * w
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _run(path, inputs, "upload-counts")
    upload = dict(SPANS["sketch.upload"])
    profiling.reset_spans()
    assert upload["bytes"] == sum(LENGTHS)
    assert upload["row_bytes"] == row_bytes
    assert row_bytes == 4 * (4096 + K - 1) + 2 * (8192 + K - 1) + 4 * 4 * (8192 + K - 1)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_parse_counts_the_files_parsed_into_the_arena(inputs, gz):
    """`sketch.parse`'s `arena_files`: every plain FASTA file of a build,
    none of gzipped ones (they take the general reader); `bases` the same."""
    paths = inputs["fasta"]
    if gz:
        paths = []
        for p in inputs["fasta"]:
            out = inputs["tmp"] / (Path(p).name + ".gz")
            out.write_bytes(gzip.compress(Path(p).read_bytes()))
            paths.append(str(out))
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        T.build_index(paths, SketchParams(k=K, s=S), device="cpu")
    parse = dict(SPANS["sketch.parse"])
    profiling.reset_spans()
    assert parse["arena_files"] == (0 if gz else len(paths))
    assert parse["bases"] == sum(LENGTHS)


def test_self_and_child_seconds_lie_within(traced):
    parents, spans = PARENTS[traced["path"]], traced["spans"]
    for name, rec in spans.items():
        assert 0.0 <= rec["self_s"] <= rec["s"] + ROUNDING, name
        assert rec["s"] <= spans[_root(parents, name)]["s"] + ROUNDING, name
        children = [c for c, p in parents.items() if p == name]
        assert sum(spans[c]["s"] for c in children) <= rec["s"] + ROUNDING, name


def test_chrome_trace_nests_each_span_in_its_parent(traced):
    """One user_annotation event per call, and the innermost span event
    enclosing each is its parent's (none for a root)."""
    parents, spans = PARENTS[traced["path"]], traced["spans"]
    events = [e for e in json.loads(traced["trace"].read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"] in parents]
    counts = {}
    for e in events:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    assert counts == {name: rec["calls"] for name, rec in spans.items()}
    for e in events:
        a, b = e["ts"], e["ts"] + e["dur"]
        around = [o for o in events if o is not e and o["ts"] <= a
                  and b <= o["ts"] + o["dur"] and o["dur"] >= e["dur"]]
        inner = max(around, key=lambda o: (o["ts"], -o["dur"]), default=None)
        assert (inner["name"] if inner else None) == parents[e["name"]], e["name"]


def test_untraced_run_records_nothing_and_gives_the_same_output(traced, inputs):
    profiling.reset_spans()
    out, _ = _run(traced["path"], inputs, "untraced")
    assert SPANS == {}
    assert span("a") is span("b", rows=3)
    with span("a") as sp:
        sp.add(bytes=1)
    assert SPANS == {}
    _same(out, traced["out"])


def test_span_records_on_a_raise_and_unwinds():
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with span("outer", rows=2) as outer:
                outer.add(rows=1)
                with span("inner"):
                    raise ValueError("x")
        with span("after"):
            pass
    assert SPANS["outer"]["calls"] == SPANS["inner"]["calls"] == 1
    assert SPANS["outer"]["rows"] == 3
    assert SPANS["outer"]["self_s"] <= SPANS["outer"]["s"] - SPANS["inner"]["s"] + ROUNDING
    # the stack unwound: "after" is a root, its self time all of it
    assert SPANS["after"]["self_s"] == SPANS["after"]["s"]
    assert list(SPANS) == ["outer", "inner", "after"]
    profiling.reset_spans()


def _event(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_under_spans_on_a_synthetic_trace(tmp_path):
    """root [0, 100] holds a [10, 40] and b [50, 90], b holds c [60, 70];
    the card runs [0, 5], [20, 30], [65, 80] and [95, 120].  Idle: root
    [5, 10) [40, 50) [90, 95); a [10, 20) [30, 40); b [50, 60) [80, 90);
    c [60, 65).  d starts with e at 200 and ends later: e is innermost.
    Spans not named and time outside every span count nowhere."""
    events = [_event("root", 0, 100), _event("a", 10, 30), _event("b", 50, 40),
              _event("c", 60, 10), _event("other", 0, 300), _event("d", 200, 50),
              _event("e", 200, 20),
              _event("k", 0, 5, "kernel"), _event("m", 20, 10, "gpu_memcpy"),
              _event("k", 65, 15, "kernel"), _event("z", 95, 25, "gpu_memset"),
              _event("host op", 40, 20, "cpu_op"), {"ph": "i", "name": "marker", "ts": 3}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = profiling.idle_under_spans(path, ["root", "a", "b", "c", "d", "e"])
    assert got == {"root": 20.0, "a": 20.0, "b": 20.0, "c": 5.0, "d": 30.0, "e": 20.0}


def test_cli_profile_prints_spans_and_appends_a_trace_row(inputs, tmp_path, capsys):
    met = tmp_path / "m.jsonl"
    out = tmp_path / "idx.npz"
    assert tcli.main(["sketch", *inputs["fasta"], "-o", str(out), "-k", str(K), "-s", str(S),
                      "--device", "cpu", "--profile", str(tmp_path / "prof"),
                      "--metrics", str(met)]) == 0
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("sketch: span ")]
    names = [ln.split(": ")[1].removeprefix("span ") for ln in lines]
    assert names[0] == "sketch" and set(names) == set(PARENTS["sketch"])
    assert len(names) == len(set(names))
    assert all("calls " in ln and ", s " in ln and "self_s " in ln and "idle_s None" in ln
               for ln in lines)
    rows = metrics.read(str(met))
    assert [r["phase"] for r in rows] == ["sketch", "trace"]
    trace = rows[1]["spans"]
    assert list(trace) == names
    assert trace["sketch.merge"]["calls"] == 3 and trace["sketch.merge"]["idle_s"] is None
    assert trace["sketch.upload"]["bytes"] > 0
    assert all(r["self_s"] <= r["s"] + ROUNDING for r in trace.values())
    assert len(list((tmp_path / "prof").glob("*.json"))) == 1


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_packed_rows_count_each_read_once(tmp_path, monkeypatch, native):
    """screen.pack's `reads` and `bases`: each row's count of reads whose
    first base lies in it sums to the file's reads, and its count of the
    bases it adds to the file's bases, on the native pass and the Python
    packer (which splits reads longer than a row); each row says which
    packed it; the rows are _packed_read_batches' own."""
    if not native:
        monkeypatch.setattr(T._native, "available", lambda: False)
    assert (T._native.available() and T._read_pack.available()) == native
    rng = np.random.default_rng(5)
    reads = [make_genome_family(rng, 1, n)[0] for n in (150, 0, 30, 2500, 150, 700)] * 20
    fq = write_fastq(tmp_path / "r.fq", [(f"r{i}", r) for i, r in enumerate(reads)])
    rows = list(T._packed_read_rows(str(fq), K, 1024))
    assert sum(n for _, n, _, _ in rows) == len(reads)
    assert sum(b for _, _, b, _ in rows) == sum(len(r) for r in reads)
    assert all(n >= 0 and b >= 0 and by_pass == native for _, n, b, by_pass in rows)
    want = list(T._packed_read_batches(str(fq), K, 1024))
    assert len(rows) == len(want)
    for (row, *_), w in zip(rows, want):
        np.testing.assert_array_equal(row.numpy(), w.numpy())
