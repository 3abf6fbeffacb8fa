"""The `screen` cell's pieces: the reference's rows worked by hand (hits,
the Wilson interval, ANI from containment, the KMV cardinality and the
binomial p-value against a direct tail sum), its isolation from the port,
the read simulator's shares, strands, errors and FASTQ file, the judge's
comparison and the span readers' arithmetic."""

import math
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness
from benchmark.jobs import dist_tsv, screen
from benchmark.reference import nthash
from benchmark.reference import screen as ref
from benchmark.yardstick import data, reads

CELL = "bacteria-1k.screen"
K = 4


def _keys(values):
    vals = np.array(values, np.uint64)
    return torch.from_numpy(vals.view(np.int64) ^ np.int64(-(1 << 63)))


def _tail(n, hits, q):
    """P(X >= hits), X ~ Binomial(n, q), summed exactly."""
    q = Fraction(q)
    return float(sum(math.comb(n, i) * q ** i * (1 - q) ** (n - i) for i in range(hits, n + 1)))


def _parse(text):
    header, *rows = text.split("\n")[:-1]
    assert header == "#" + "\t".join(ref.COLUMNS)
    return {r[0]: r[1:] for r in (line.split("\t") for line in rows)}


def test_rows_by_hand():
    """Sketches of 4 values against H: a holds 3 of them, b all, c none,
    d is empty; H below KMV_S0, so its cardinality is its size."""
    h = torch.sort(_keys([5, 9, 17, 40, 41, 300])).values
    inf = (1 << 64) - 1
    table = _keys([[5, 9, 17, 18], [5, 9, 17, 40], [1, 2, 3, 4], [inf] * 4])
    rows = _parse(ref.tsv(table, ["a", "b", "c", "d"], h, K))
    q = 6 / 4 ** K
    z = 1.959963986120195

    def wilson(x, n):
        p = x / n
        mid = (p + z * z / (2 * n)) / (1 + z * z / n)
        half = z / (1 + z * z / n) * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
        return max(0.0, mid - half), min(1.0, mid + half)

    hits, size, c, lo, hi, ani, p = rows["a"]
    assert (hits, size, c) == ("3", "4", "0.75")
    assert (float(lo), float(hi)) == pytest.approx(wilson(3, 4), rel=1e-9)
    assert float(ani) == pytest.approx(1 + math.log(0.75) / K, rel=1e-9)
    assert 0 < float(p) < 1 and float(p) == pytest.approx(_tail(4, 3, q), rel=1e-9)
    hits, size, c, lo, hi, ani, p = rows["b"]
    assert (hits, size, c, hi, ani) == ("4", "4", "1", "1", "1")
    assert float(p) == pytest.approx(q ** 4, rel=1e-9)
    assert rows["c"] == ["0", "4", "0", "0", f"{wilson(0, 4)[1]:.10g}", "0", "1"]
    assert rows["d"] == ["0", "0", "0", "0", "1", "0", "1"]
    # without -p the same rows, one column fewer
    plain = ref.tsv(table, ["a", "b", "c", "d"], h, K, p_value=False).split("\n")
    assert plain[0] == "#" + "\t".join(ref.COLUMNS[:-1])
    assert plain[1].split("\t") == ["a"] + rows["a"][:-1]


def test_acklam_z_and_the_p_value_column():
    z = ref.acklam_z(0.975)
    assert z == 1.959963986120195
    assert abs(z - 1.959963984540054) < 1.2e-9 * z
    with pytest.raises(ValueError):
        ref.acklam_z(0.99)
    # the judge's p-value column is the one dist_tsv.rows_wrong reads
    assert ref.COLUMNS.index("p_value") == dist_tsv.P_COLUMN


def test_cardinality_kmv():
    short = torch.sort(_keys(range(1, 101))).values
    assert ref.cardinality(short) == 100.0
    g = torch.Generator().manual_seed(3)
    many = torch.unique(torch.randint(-(1 << 62), 1 << 62, (50_000,), generator=g))
    q = float((int(many[ref.KMV_S0 - 1]) ^ (-(1 << 63))) & ((1 << 64) - 1)) / 2.0 ** 64
    assert ref.cardinality(many) == pytest.approx(ref.KMV_S0 / (2 * q - q * q) - 1,
                                                  rel=1e-12)


def test_p_value_clamps():
    hits = torch.tensor([0, 2, 2])
    sizes = torch.tensor([5, 5, 5])
    assert ref.p_values(hits, sizes, 0.0, 31).tolist() == [1.0, 0.0, 0.0]
    assert ref.p_values(hits, sizes, 5.0, 1).tolist() == [1.0, 1.0, 1.0]


def test_distinct_hashes_drop_invalid_windows_and_cut():
    codes = torch.tensor([[0, 1, 2, 3, 0, 1], [3, 3, 4, 3, 3, 3]], dtype=torch.uint8)
    h = ref.distinct_hashes([codes, codes[0], torch.zeros(0, dtype=torch.uint8)], K)
    want = nthash.canonical_keys(codes, K)
    assert torch.equal(h, torch.unique(want[want != nthash.INF_KEY]))
    assert h.shape[0] == 3  # the second read's windows all hold the N
    cut = ref.distinct_hashes([codes], K, cut=True)
    assert torch.equal(cut, torch.unique(nthash.to_codes32(h)))


def test_reference_alone_loads_nothing_of_the_port():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(tiny.ROOT)!r})\n"
        "import benchmark.reference.screen, benchmark.yardstick.reads\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'miekki_tpu', 'miekki_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-3000:]


# members far apart (30-60 % substitution), so a read's 20-mers name its source
CFG = {"genome_bases": 20_000, "family_size": 4, "family_substitution": [0.3, 0.6]}
WL = {"reads": 20_000, "read_length": 100, "source_families": 2, "source_members": 2,
      "source_share": 0.8, "abundance_ratio": 0.5, "substitution": 0.01, "n_rate": 0.002,
      "reverse_share": 0.5, "quality": [30, 40]}
SEED = 2 ** 31 + 77


def test_source_counts():
    counts = reads.source_counts(1000, 4, 0.5)
    assert counts.tolist() == [533, 267, 133, 67] and counts.sum() == 1000
    assert reads.source_counts(7, 3, 1.0).tolist() == [3, 2, 2]


@pytest.fixture(scope="module")
def simulated():
    return reads.read_set(SEED, CFG, WL, "cpu")


def test_read_set_shares_strands_and_errors(simulated):
    """Each of 4,000 reads placed by majority vote of its 20-mers over the
    sources' two strands: a fifth unrelated, the sources in proportion to
    0.5^i, half on each strand, and ~1 % of each placed read's bases
    substituted."""
    r = simulated
    assert r.shape == (WL["reads"], WL["read_length"]) and r.dtype == torch.uint8
    assert torch.equal(r, reads.read_set(SEED, CFG, WL, "cpu"))
    assert not torch.equal(r, reads.read_set(SEED + 1, CFG, WL, "cpu"))
    n_share = float((r == reads.N_CODE).float().mean())
    assert 0.5 * WL["n_rate"] < n_share < 1.5 * WL["n_rate"]
    rates = data.member_rates(CFG)
    genomes = [g for f in range(WL["source_families"])
               for g in data.family_genomes(SEED, f, CFG["genome_bases"], rates,
                                            "cpu")[:WL["source_members"]]]
    where = {}
    for i, g in enumerate(genomes):
        for strand, seq in enumerate((g, 3 - g.flip(0))):
            for w in seq.unfold(0, 20, 1).tolist():
                where[tuple(w)] = (i, strand)
    placed = []
    for read in r[:4000].tolist():
        votes = {}
        for a in range(0, len(read) - 19):
            hit = where.get(tuple(read[a:a + 20]))
            if hit:
                votes[hit] = votes.get(hit, 0) + 1
        placed.append(max(votes, key=votes.get) if votes else None)
    src = np.array([-1 if p is None else p[0] for p in placed])
    assert 0.18 < (src < 0).mean() < 0.22
    share = np.bincount(src[src >= 0], minlength=4) / (src >= 0).sum()
    assert np.allclose(share, reads.source_counts(16_000, 4, 0.5) / 16_000, atol=0.03)
    strands = [p[1] for p in placed if p is not None]
    assert 0.45 < np.mean(strands) < 0.55
    # substitutions: placed forward reads against their best-matching start
    subs = total = 0
    for read, p in zip(r[:4000], placed):
        if p is None or p[1]:
            continue
        g = genomes[p[0]]
        windows = g.unfold(0, WL["read_length"], 1)
        diff = (windows != read).sum(1)
        best = int(diff.min())
        subs += best - int((read == reads.N_CODE).sum())
        total += WL["read_length"]
    assert 0.007 < subs / total < 0.013


def test_fastq_file(simulated, tmp_path):
    r = simulated[:1000]
    path = reads.write_fastq(tmp_path / "r.fq", r, 5, [30, 40])
    lines = path.read_text().split("\n")
    assert len(lines) == 4 * 1000 + 1 and lines[-1] == ""
    names, seqs, plus, quals = lines[0:-1:4], lines[1::4], lines[2::4], lines[3::4]
    assert names[0] == "@r000" and names[-1] == "@r999"
    assert set(plus) == {"+"}
    lut = "ACGTN"
    assert seqs == ["".join(lut[c] for c in row) for row in r.tolist()]
    for s, q in zip(seqs, quals):
        assert len(q) == len(s)
        assert all((c == "#") == (b == "N") for b, c in zip(s, q))
        assert all(c == "#" or 63 <= ord(c) <= 73 for c in q)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    run = harness.Run(tiny.cell(CELL), 2 ** 31 + 29, "cpu", tmp_path_factory.mktemp("screen"),
                      trace=False)
    screen.setup(run)
    return run


def _replace_column(text: str, col: int, fn) -> bytes:
    lines = text.split("\n")
    out = [lines[0]]
    for line in lines[1:-1]:
        c = line.split("\t")
        c[col] = fn(c[col])
        out.append("\t".join(c))
    return ("\n".join(out) + "\n").encode()


def test_setup_counts_the_reads(tiny_run):
    wl = tiny_run.workload
    assert len(tiny_run.state["hashed_lengths"]) == wl["reads"]
    assert set(tiny_run.state["hashed_lengths"].tolist()) == {wl["read_length"]}
    assert tiny_run.state["gbase"] == wl["reads"] * wl["read_length"] / 1e9
    assert tiny_run.state["reads"].stat().st_size > wl["reads"] * 2 * wl["read_length"]


def test_judge_holds_text_and_p_value_tolerance(tiny_run):
    want = screen.reference(tiny_run)
    wb = want.encode()
    p_col = ref.COLUMNS.index("p_value")
    inside = [float(line.split("\t")[p_col]) for line in want.split("\n")[1:-1]]
    assert sum(0 < p < 1 for p in inside) >= 1  # the tiny cell's unrelated family
    assert screen.rows_wrong(wb, wb) == 0
    near = _replace_column(want, p_col, lambda p: repr(float(p) * (1 + 1e-12)))
    assert near != wb and screen.rows_wrong(near, wb) == 0
    off = _replace_column(want, p_col, lambda p: repr(float(p) * (1 + 1e-8)))
    moved = sum(a != b for a, b in zip(off.split(b"\n"), wb.split(b"\n")))
    assert moved > 0 and screen.rows_wrong(off, wb) == moved
    hits = _replace_column(want, 1, lambda h: str(int(h) + 1))
    assert screen.rows_wrong(hits, wb) == len(want.split("\n")) - 2


def test_judge_counts_a_job_whose_file_differs(tiny_run, tmp_path):
    path = tmp_path / "kept.tsv"
    path.write_text(screen.reference(tiny_run))
    tiny_run.state.update(kept=path, digests=["x", "y", "y"])
    (wrong, limit), = screen.judge(tiny_run).values()
    assert (wrong, limit) == (tiny_run.config["genomes"], 0)


def test_judge_finds_the_reads_less_their_last_batch_wrong(tiny_run, tmp_path):
    """The reference of the read set less its last quarter (the share of
    the last of several batches) is not the screen of the whole set."""
    table = tiny_run.state["table"]
    k = tiny_run.config["k"]
    r = reads.read_set(tiny_run.seed, tiny_run.config, tiny_run.workload, "cpu")
    less = ref.tsv(table, dist_tsv.names(tiny_run),
                   ref.distinct_hashes([r[: 3 * r.shape[0] // 4]], k), k)
    assert screen.rows_wrong(less.encode(), screen.reference(tiny_run).encode()) > 0


READERS = ("read_pack_ms_per_batch", "screen_join_ms_per_batch", "screen_db_ms_per_job",
           "screen_hits_ms_per_job")


def _rec(s, calls=2, **counts):
    return {"calls": calls, "s": s, "self_s": s, **counts}


# two jobs of 90 batches each
REGISTRY = {
    "index.load": _rec(1.2, bytes=80_000_000), "screen": _rec(11.0),
    "screen.flatten": _rec(0.1, values=20_480_000, bytes=245_760_000),
    "screen.pack": _rec(9.0, 182, reads=4_194_304, bases=629_145_600, batches=180),
    "screen.join": _rec(0.36, 180), "screen.pull": _rec(0.004, bytes=2_560_002),
    "screen.hits": _rec(0.3), "screen.rows": _rec(0.096, 4, rows=2048),
}
WANT = {"read_pack_ms_per_batch": 1e3 * 9.0 / 180, "screen_join_ms_per_batch": 2.0,
        "screen_db_ms_per_job": 50.0, "screen_hits_ms_per_job": 1e3 * 0.4 / 2}
# the spans each metric reads; the count it divides by where a span gives it
READS = {"read_pack_ms_per_batch": ("screen.pack",), "screen_join_ms_per_batch": ("screen.join",),
         "screen_db_ms_per_job": ("screen.flatten",),
         "screen_hits_ms_per_job": ("screen.pull", "screen.hits", "screen.rows")}


def _stub():
    from types import SimpleNamespace

    return SimpleNamespace(walls=[5.0, 6.0], state={})


@pytest.mark.parametrize("name", READERS)
def test_reader_arithmetic(monkeypatch, name):
    from miekki_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "SPANS", dict(REGISTRY))
    assert harness.metric_reader(name).read(_stub()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_its_span(monkeypatch, name):
    """A span gone, a `screen.pack` that counts no batches (the program
    before them), no registry at all."""
    from miekki_tpu_torch.utils import profiling

    for gone in READS[name]:
        monkeypatch.setattr(profiling, "SPANS", {k: v for k, v in REGISTRY.items() if k != gone})
        assert harness.metric_reader(name).read(_stub()) is None, gone
    if name == "read_pack_ms_per_batch":
        before = {**REGISTRY, "screen.pack": _rec(9.0, 182, reads=4_194_304)}
        monkeypatch.setattr(profiling, "SPANS", before)
        assert harness.metric_reader(name).read(_stub()) is None
    monkeypatch.delattr(profiling, "SPANS")
    assert harness.metric_reader(name).read(_stub()) is None


def test_new_metrics_are_listed_for_the_screen_cell():
    listed = {m["name"]: m for m in harness.load_cell(CELL).per_layer}
    for name in READERS + ("device_idle_share.screen", "k1_roofline.screen"):
        assert listed[name]["workloads"] == [CELL] and listed[name]["moves"] == "sketch_gbase_s"
        source = "program_span" if name in READERS else "device_trace"
        assert listed[name]["source"] == source
    assert [m["name"] for m in harness.load_cell(CELL).end_to_end] == ["sketch_gbase_s",
                                                                       "setup_s"]


def test_readers_find_the_jobs_spans(tmp_path):
    """Two jobs of the tiny cell under a CPU profiler, as in a traced
    window: each span reader reads a positive number."""
    from torch.profiler import ProfilerActivity, profile

    from miekki_tpu_torch.utils import profiling

    run = harness.Run(tiny.cell(CELL), 2 ** 31 + 5, "cpu", tmp_path, True)
    screen.setup(run)
    profiling.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for j in range(2):
                screen.job(run, j)
                run.walls.append(1.0)
                screen.keep(run, j)
        for m in READERS:
            value = harness.metric_reader(m).read(run)
            assert value is not None and value > 0, m
    finally:
        profiling.reset_spans()
