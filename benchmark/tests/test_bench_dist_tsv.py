"""The `dist_tsv` cell's pieces: the reference's formulas worked by hand at
j = 0, j = 1 and a mid value, its incomplete beta against a direct
binomial tail sum, its isolation from the port, and the judge's
comparison: text columns equal, p-values within P_TOLERANCE, which a
p-value or a distance in float32 does not meet."""

import math
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness
from benchmark.jobs import dist_tsv
from benchmark.reference import mash

CELL = "bacteria-1k.dist-tsv"
K, S = 4, 4
# values as fractions of 2**64: B shares A's two smallest, C is A, D lies
# above them all
A = [0.01, 0.02, 0.03, 0.04]
TABLE = [A, [0.01, 0.02, 0.05, 0.06], A, [0.5, 0.6, 0.7, 0.8]]


def _keys(rows):
    vals = np.array([[round(f * 2 ** 64) for f in r] for r in rows], np.uint64)
    return torch.from_numpy(vals.view(np.int64) ^ np.int64(-(1 << 63)))


def _card(last):
    q = round(last * 2 ** 64) / 2.0 ** 64
    return S / (2 * q - q * q) - 1


def _tail(n, shared, q):
    """P(X >= shared), X ~ Binomial(n, q), summed exactly."""
    q = Fraction(q)
    return float(sum(math.comb(n, i) * q ** i * (1 - q) ** (n - i)
                     for i in range(shared, n + 1)))


def _rows():
    text = mash.tsv(_keys(TABLE), ["a", "b", "c", "d"], K, S)
    lines = text.split("\n")
    assert lines[0] == mash.HEADER.rstrip("\n") and lines[-1] == ""
    return {(r[0], r[1]): r[2:] for r in (line.split("\t") for line in lines[1:-1])}


def test_rows_by_hand():
    rows = _rows()
    assert list(rows) == [("a", "b"), ("a", "c"), ("a", "d"), ("b", "c"), ("b", "d"),
                          ("c", "d")]
    na, nb = _card(0.04), _card(0.06)

    # a mid value: the bottom 4 of A ∪ B are A's, two of them in B
    shared, union, jac, dist, ani, p = rows[("a", "b")]
    d = -math.log(2 * 0.5 / 1.5) / K
    assert (shared, union, jac, dist, ani) == ("2", "4", "0.5", f"{d:.10g}", f"{1 - d:.10g}")
    m = na * nb / 4 ** K
    want = _tail(4, 2, m / (na + nb - m))
    assert 0 < want < 1 and float(p) == pytest.approx(want, rel=1e-9)

    # j = 1: distance 0, ANI 1, p-value q^4
    shared, union, jac, dist, ani, p = rows[("a", "c")]
    assert (shared, union, jac, dist, ani) == ("4", "4", "1", "0", "1")
    m = na * na / 4 ** K
    assert float(p) == pytest.approx((m / (2 * na - m)) ** 4, rel=1e-9)

    # j = 0: distance 1, ANI 0, p-value 1
    assert rows[("a", "d")] == ["0", "4", "0", "1", "0", "1"]


def test_cardinality_is_the_count_below_s():
    table = _keys([[0.1, 0.2, 0.3, 0.4]])
    short = torch.cat([table[:, :2], torch.full((1, 2), mash.INF_KEY)], dim=1)
    assert mash.cardinalities(short, S) == [2.0]
    assert mash.cardinalities(table, S) == [pytest.approx(_card(0.4), rel=1e-12)]


@pytest.mark.parametrize("n", [1, 2, 7, 30, 120])
def test_betainc_is_the_binomial_tail(n):
    shared = torch.arange(1, n + 1, dtype=torch.float64)
    for q in (1e-6, 0.013, 0.25, 0.5, 0.93):
        got = mash.betainc(shared, n - shared + 1.0, torch.full_like(shared, q))
        want = [_tail(n, int(sh), q) for sh in shared.tolist()]
        for g, w in zip(got.tolist(), want):
            assert g == pytest.approx(w, rel=1e-11, abs=1e-300), (n, q)


def test_p_value_clamps():
    one = torch.ones(3, dtype=torch.float64)
    shared = torch.tensor([0.0, 3.0, 3.0], dtype=torch.float64)
    union = torch.full((3,), 5.0, dtype=torch.float64)
    assert mash.p_values(shared, union, one * 100, one * 100, 4).tolist()[0] == 1.0
    # q = 0 (a sketch of no k-mers shares none by chance); q >= 1 (m = 6.25
    # of 5 k-mers each over 4^1)
    assert mash.p_values(shared, union, one * 0, one * 2, 31).tolist() == [1.0, 0.0, 0.0]
    assert mash.p_values(shared, union, one * 5, one * 5, 1).tolist() == [1.0, 1.0, 1.0]


def test_reference_alone_loads_nothing_of_the_port():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(tiny.ROOT)!r})\n"
        "import benchmark.reference.mash\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'miekki_tpu', 'miekki_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-3000:]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    run = harness.Run(tiny.cell(CELL), 2 ** 31 + 29, "cpu", tmp_path_factory.mktemp("tsv"),
                      trace=False)
    dist_tsv.setup(run)
    return run


def _replace_column(text: str, col: int, fn) -> bytes:
    lines = text.split("\n")
    out = [lines[0]]
    for line in lines[1:-1]:
        c = line.split("\t")
        c[col] = fn(c[col])
        out.append("\t".join(c))
    return ("\n".join(out) + "\n").encode()


def test_judge_holds_text_and_p_value_tolerance(tiny_run):
    want = dist_tsv.reference(tiny_run)
    wb = want.encode()
    p_col, d_col = mash.COLUMNS.index("p_value"), mash.COLUMNS.index("mash_distance")
    mid = [float(line.split("\t")[p_col]) for line in want.split("\n")[1:-1]]
    mid = [p for p in mid if 0 < p < 1]
    assert len(mid) > 10  # the tiny cell's k puts related pairs' p-values inside (0, 1)
    assert dist_tsv.rows_wrong(wb, wb) == 0

    # p-values moved well inside the tolerance are equal
    near = _replace_column(want, p_col, lambda p: repr(float(p) * (1 + 1e-12)))
    assert near != wb and dist_tsv.rows_wrong(near, wb) == 0

    def f32(v):
        return f"{float(np.float32(float(v))):.10g}"

    # a distance in float32 is wrong wherever its text moved; a p-value in
    # float32 (a relative error up to 6e-8) nearly everywhere
    for col, share in ((d_col, 1.0), (p_col, 0.9)):
        got = _replace_column(want, col, f32)
        moved = sum(a != b for a, b in zip(got.split(b"\n"), wb.split(b"\n")))
        assert moved > 10 and moved >= dist_tsv.rows_wrong(got, wb) >= share * moved, col

    # the header; a row left out; one more row
    lines = wb.split(b"\n")
    assert dist_tsv.rows_wrong(b"\n".join([b"#x" + lines[0]] + lines[1:]), wb) == 1
    assert dist_tsv.rows_wrong(b"\n".join(lines[:-2] + lines[-1:]), wb) >= 1
    assert dist_tsv.rows_wrong(b"\n".join(lines[:-1] + lines[-2:]), wb) >= 1


def test_judge_counts_a_job_whose_file_differs(tiny_run, tmp_path):
    path = tmp_path / "kept.tsv"
    path.write_text(dist_tsv.reference(tiny_run))
    rows = tiny_run.state["rows"]
    tiny_run.state.update(kept=path, digests=["x", "y", "y"])
    (wrong, limit), = dist_tsv.judge(tiny_run).values()
    assert (wrong, limit) == (rows, 0)


READERS = ("tsv_format_ms_per_mrow", "tsv_pvalue_ms_per_mrow", "tsv_write_gb_s",
           "index_load_gb_s")


def _rec(s, self_s=None, **counts):
    return {"calls": 2, "s": s, "self_s": s if self_s is None else self_s, **counts}


# two jobs: 1,047,552 rows, 90 MB written, 160 MB loaded
REGISTRY = {
    "index.load": _rec(0.4, bytes=160_000_000, genomes=2048),
    "dist.tsv": _rec(3.0), "dist.format": _rec(2.2, 1.2, rows=1_047_552, bytes=90_000_000),
    "dist.pvalue": _rec(0.6), "dist.write": _rec(0.4, bytes=90_000_000),
}
WANT = {"tsv_format_ms_per_mrow": 1e3 * 1.2 / 1.047552,
        "tsv_pvalue_ms_per_mrow": 1e3 * 0.6 / 1.047552,
        "tsv_write_gb_s": 0.09 / 0.4, "index_load_gb_s": 0.16 / 0.4}


@pytest.mark.parametrize("name", READERS)
def test_reader_arithmetic(monkeypatch, name):
    from miekki_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "SPANS", dict(REGISTRY))
    got = harness.metric_reader(name).read(None)
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_on_a_program_without_the_spans(monkeypatch, name):
    """A program from before these spans: `dist.format` alone, holding the
    p-values and the write, and no `index.load`; or no registry at all."""
    from miekki_tpu_torch.utils import profiling

    before = {"dist.tsv": _rec(3.0), "dist.format": _rec(2.2, rows=1_047_552)}
    monkeypatch.setattr(profiling, "SPANS", before)
    assert harness.metric_reader(name).read(None) is None
    monkeypatch.delattr(profiling, "SPANS")
    assert harness.metric_reader(name).read(None) is None


def test_readers_find_the_jobs_spans(tmp_path):
    """Two jobs of the tiny cell under a CPU profiler, as in a traced
    window: each reader reads a positive number."""
    from torch.profiler import ProfilerActivity, profile

    from miekki_tpu_torch.utils import profiling

    cell = tiny.cell(CELL)
    run = harness.Run(cell, 2 ** 31 + 5, "cpu", tmp_path, True)
    dist_tsv.setup(run)
    profiling.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for j in range(2):
                dist_tsv.job(run, j)
                run.walls.append(1.0)
                dist_tsv.keep(run, j)
        for m in READERS:
            value = harness.metric_reader(m).read(run)
            assert value is not None and value > 0, m
    finally:
        profiling.reset_spans()
