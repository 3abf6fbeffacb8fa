"""The TSV row join (io.tsv_join, csrc/tsv_join.cpp) under the port's TSV
writers, on the CPU.  The native pass and the numpy fallback (taken where
`available()` is False) give byte-identical texts, each equal to the row
path's `rows_to_tsv(dist(...))`, for every column set, the row filters, a
rectangular comparison, names that are not ASCII, an empty block, chunked
writes and the count-matrix writer.  TSV_JOIN_COUNTS and the `dist.format`
span count the rows each joined."""

import io

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex
from miekki_tpu_torch.io import tsv_join
from miekki_tpu_torch.params import SketchParams
from miekki_tpu_torch.utils import profiling

K, S, TILE = 9, 40, 4
# no tab, of differing lengths, some far from ASCII
NAMES = ["g0", "génome_1", "株_2_a_longer_name", "x", "Ωμέγα-4", "g5", "名前6",
         "seven_7", "ü8", "g9_" + "z" * 30, "😀10"]


def _index(seed: int, n: int, names) -> SketchIndex:
    """n sketches drawn from one pool (the same for every seed), so pairs
    share values: some full (an estimated cardinality), some short of s
    (exact), one empty."""
    pool = np.random.default_rng(0).integers(0, 2 ** 64 - 1, size=160, dtype=np.uint64)
    rng = np.random.default_rng(seed)
    sketches = [np.unique(rng.choice(pool, size=int(rng.integers(0, S + 1)),
                                     replace=False))[:S] for _ in range(n - 2)]
    sketches += [np.sort(rng.choice(pool, size=S, replace=False)), np.zeros(0, np.uint64)]
    return SketchIndex.from_sketches(sketches, list(names), SketchParams(k=K, s=S))


@pytest.fixture(scope="module")
def idx():
    return _index(3, len(NAMES), NAMES)


@pytest.fixture(scope="module")
def ref_idx():
    return _index(4, 5, [f"r{i}_ß" * (i + 1) for i in range(5)])


def _both(monkeypatch, write):
    """(native text, its rows, fallback text, its rows), each joined alone
    from fresh counts, which must have counted every row on its own path."""
    out = []
    for native in (True, False):
        with monkeypatch.context() as m:
            if not native:
                m.setattr(tsv_join, "available", lambda: False)
            tsv_join.reset_join_counts()
            buf = io.StringIO()
            rows = write(buf)
            key = "native_rows" if native else "fallback_rows"
            assert tsv_join.TSV_JOIN_COUNTS == {
                "native_rows": 0, "fallback_rows": 0, key: rows}
            out += [buf.getvalue(), rows]
    return out


def _expected(idx_a, idx_b, columns, max_dist=None, max_p=None) -> str:
    rows = T.add_bound_columns(T.dist(idx_a, idx_b, tile=TILE, device="cpu"), K)
    return T.rows_to_tsv(T.filter_rows(rows, max_dist, max_p), columns=columns)


def _quantile(idx_a, idx_b, key, q):
    rows = T.dist(idx_a, idx_b, tile=TILE, device="cpu")
    return float(np.quantile([r[key] for r in rows], q))


def test_the_native_join_is_built():
    assert tsv_join.available()


@pytest.mark.parametrize("containment,bounds,rect,filt", [
    (False, False, False, None),
    (True, False, False, None),
    (False, True, False, None),
    (False, False, False, ("max_dist", 0.5)),
    (False, False, False, ("max_p", 0.5)),
    (False, False, False, ("max_dist", None)),  # keeps no row
    (False, False, True, None),
    (True, True, True, ("max_p", 0.4)),
])
def test_native_and_fallback_equal_the_row_path(monkeypatch, idx, ref_idx, containment,
                                                bounds, rect, filt):
    idx_b = ref_idx if rect else None
    columns = T.select_columns(containment, bounds)
    kw = {}
    if filt is not None:
        key, q = filt
        col = "mash_distance" if key == "max_dist" else "p_value"
        kw[key] = -1.0 if q is None else _quantile(idx, idx_b, col, q)
    want = _expected(idx, idx_b, columns, **kw)
    n_want = want.count("\n") - 1
    pairs = len(idx) * len(ref_idx) if rect else len(idx) * (len(idx) - 1) // 2
    if filt is None:
        assert n_want == pairs
    elif filt[1] is None:
        assert n_want == 0
    else:
        assert 0 < n_want < pairs

    text, rows, text_np, rows_np = _both(monkeypatch, lambda buf: T.dist_tsv_write(
        buf, idx, idx_b, tile=TILE, columns=columns, device="cpu", **kw))
    assert text == want
    assert text_np == want
    assert rows == rows_np == n_want


def test_names_keep_their_characters(monkeypatch, idx):
    text, _, text_np, _ = _both(monkeypatch, lambda buf: T.dist_tsv_write(
        buf, idx, tile=TILE, device="cpu"))
    lines = text.splitlines()[1:]
    assert text == text_np
    assert {line.split("\t")[0] for line in lines} == set(NAMES[:-1])
    assert {line.split("\t")[1] for line in lines} == set(NAMES[1:])
    assert all(line.count("\t") == len(T.TSV_COLUMNS) - 1 for line in lines)


def test_empty_block(monkeypatch, idx):
    fmt = T._BlockFormatter(idx, None)
    empty = np.zeros(0, dtype=np.int64)
    for native in (True, False):
        with monkeypatch.context() as m:
            if not native:
                m.setattr(tsv_join, "available", lambda: False)
            assert fmt.format(empty, empty, empty, empty, empty) == ("", 0)
            assert tsv_join.join([(*tsv_join.cell_table(["a"]), empty)], 0) == ""
    one = SketchIndex.from_sketches([np.arange(1, S + 1, dtype=np.uint64)], ["only"],
                                    SketchParams(k=K, s=S))
    text, rows, text_np, rows_np = _both(monkeypatch, lambda buf: T.dist_tsv_write(
        buf, one, tile=TILE, device="cpu"))
    assert text == text_np == T.rows_to_tsv([])
    assert rows == rows_np == 0


def _pairs(idx):
    tiles = list(T.dist_tiles(idx, tile=TILE, device="cpu"))
    gi, gj, sh, un, it = (np.concatenate(x) for x in zip(*[t[2:] for t in tiles]))
    order = np.lexsort((gj, gi))
    return [x[order] for x in (gi, gj, sh, un, it)]


def test_format_write_in_chunks_of_three(monkeypatch, idx):
    fmt = T._BlockFormatter(idx, None, T.select_columns(True, True))
    pairs = _pairs(idx)
    whole, n_whole = fmt.format(*pairs)
    text, rows, text_np, rows_np = _both(
        monkeypatch, lambda buf: T._format_write(fmt, buf, *pairs, chunk=3)[0])
    assert text == text_np == whole
    assert rows == rows_np == n_whole == len(idx) * (len(idx) - 1) // 2


@pytest.mark.parametrize("rect", [False, True])
def test_counts_tsv_write(monkeypatch, idx, ref_idx, rect):
    idx_b = ref_idx if rect else None
    counts = T.dist_counts_matrix(idx, idx_b, tile=TILE, device="cpu")
    columns = T.CONTAINMENT_COLUMNS
    text, rows, text_np, rows_np = _both(monkeypatch, lambda buf: T.counts_tsv_write(
        buf, idx, counts["shared"], counts["union"], idx_b, counts["inter"],
        columns=columns, row_chunk=4))
    want = T.rows_to_tsv(T.rows_from_count_matrices(
        idx, counts["shared"], counts["union"], idx_b, counts["inter"]), columns=columns)
    assert text == text_np == want
    assert rows == rows_np == want.count("\n") - 1


def test_dist_format_span_counts_the_native_rows(idx):
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        rows = T.dist_tsv_write(io.StringIO(), idx, tile=TILE, device="cpu")
    fmt = dict(profiling.SPANS["dist.format"])
    profiling.reset_spans()
    assert fmt["calls"] == -(-len(idx) // TILE)  # one a row-block stripe with rows
    assert fmt["native_rows"] == fmt["rows"] == rows == len(idx) * (len(idx) - 1) // 2


def test_join_checks_its_columns():
    data, offsets = tsv_join.cell_table(["a", "bb"])
    assert tsv_join.join([(data, offsets, np.array([1, 0])),
                          (data, offsets, np.array([1, 1]))], 2) == "bb\tbb\na\tbb\n"
    with pytest.raises(IndexError):
        tsv_join.join([(data, offsets, np.array([0, -1]))], 2)
    with pytest.raises(ValueError):
        tsv_join.join([(data, offsets, np.array([0, 1]))], 3)
    with pytest.raises(ValueError):
        tsv_join.join([], 1)
