"""`cli dist` of saved sketch indexes into a TSV, on the CPU, against the
benchmark's plain reference (benchmark/reference/mash.py): every column
equal as text, and each p-value equal as text or within the benchmark
judge's relative tolerance.  Seeded family sketches (related members
within a family, unrelated across), some rows cut short of s so their
cardinality is exact, and k small enough that the chance p-values of
related pairs fall strictly between 0 and 1."""

import numpy as np
import pytest
import torch

from benchmark.jobs import dist_tsv
from benchmark.reference import mash, nthash
from benchmark.yardstick import data
from miekki_tpu_torch import cli
from miekki_tpu_torch.index.store import SketchIndex
from miekki_tpu_torch.params import SketchParams

S, FAMILY, RATES = 200, 4, [0.01, 0.03, 0.06, 0.1]


def _table(seed: int, n: int, part: int) -> torch.Tensor:
    """[n, S] order keys of family sketches; every third row keeps only
    its first 150 values."""
    keys = data.family_sketch_keys(seed, n, S, FAMILY, RATES, "cpu", part=part)
    keys[::3, 150:] = nthash.INF_KEY
    return keys


def _save(keys: torch.Tensor, names, k: int, path) -> str:
    values = data.u64_table(keys)
    SketchIndex(SketchParams(k=k, s=S), names, (values >> np.uint64(32)).astype(np.uint32),
                (values & np.uint64(0xFFFFFFFF)).astype(np.uint32)).save(path)
    return str(path)


def _p_inside(text: str) -> int:
    """p-values strictly between 0 and 1."""
    col = mash.COLUMNS.index("p_value")
    return sum(0 < float(line.split("\t")[col]) < 1 for line in text.split("\n")[1:-1])


@pytest.mark.parametrize("seed,n,k,tile", [(2 ** 31 + 3, 24, 9, 8), (977, 20, 10, 16),
                                           (41, 12, 8, 64)])
def test_self_all_vs_all_equals_the_reference(tmp_path, seed, n, k, tile):
    keys = _table(seed, n, 0)
    names = [f"g{i}" for i in range(n)]
    out = tmp_path / "dist.tsv"
    assert cli.main(["dist", _save(keys, names, k, tmp_path / "db.npz"), "-o", str(out),
                     "--tile", str(tile), "--device", "cpu"]) == 0
    want = mash.tsv(keys, names, k, S)
    got = out.read_bytes()
    assert want.count("\n") == 1 + n * (n - 1) // 2
    assert _p_inside(want) > 0
    assert dist_tsv.rows_wrong(got, want.encode()) == 0


@pytest.mark.parametrize("seed,na,nb,k", [(2 ** 33 + 7, 12, 16, 9), (5, 8, 4, 10)])
def test_query_against_reference_equals_the_reference(tmp_path, seed, na, nb, k):
    # the two tables share families: drawn as one, split between the files
    keys = _table(seed, na + nb, 1)
    qa, rb = keys[:na], keys[na:]
    names_a = [f"q{i}" for i in range(na)]
    names_b = [f"r{i}" for i in range(nb)]
    out = tmp_path / "dist.tsv"
    assert cli.main(["dist", _save(qa, names_a, k, tmp_path / "q.npz"),
                     "--ref", _save(rb, names_b, k, tmp_path / "r.npz"),
                     "-o", str(out), "--tile", "8", "--device", "cpu"]) == 0
    want = mash.tsv(qa, names_a, k, S, rb, names_b)
    assert want.count("\n") == 1 + na * nb
    assert dist_tsv.rows_wrong(out.read_bytes(), want.encode()) == 0


def test_related_pairs_inside_a_family_give_p_values_inside(tmp_path):
    """The p-values compared include ones strictly between 0 and 1, and a
    p-value in float32 in their place reads wrong."""
    n, k = 16, 9
    keys = _table(2 ** 31 + 3, n, 0)
    want = mash.tsv(keys, [f"g{i}" for i in range(n)], k, S)
    col = mash.COLUMNS.index("p_value")
    lines = want.split("\n")
    inside = [i for i, line in enumerate(lines[1:-1], 1)
              if 0 < float(line.split("\t")[col]) < 1]
    assert len(inside) >= n // 2
    cols = lines[inside[0]].split("\t")
    cols[col] = f"{float(np.float32(float(cols[col]))):.10g}"
    assert cols[col] != lines[inside[0]].split("\t")[col]
    lines[inside[0]] = "\t".join(cols)
    assert dist_tsv.rows_wrong("\n".join(lines).encode(), want.encode()) == 1
