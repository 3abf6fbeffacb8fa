"""Port parity: the engine (miekki_tpu_torch.engine) and the index store
against the JAX package's engine and store on the CPU.  Rows, counts and
sketches must be equal: every count is an integer, and the float columns
come from the same float64 oracle formulas."""

import io

import numpy as np
import pytest
import torch

from miekki_tpu import engine as jengine
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu_torch import engine as tengine
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.index.store import index_to_device
from miekki_tpu_torch.ops import u64
from miekki_tpu_torch.params import SketchParams as TParams

from fixtures import make_genome_family, write_fasta

K, S = 21, 200


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_engine")
    rng = np.random.default_rng(9)
    seqs = make_genome_family(rng, 4, 8_000, sub_rate=0.03) + [b"ACGT" * 3]
    paths = [str(write_fasta(tmp / f"e{i}.fa", [(f"e{i}", g)]))
             for i, g in enumerate(seqs)]
    tidx = tengine.build_index(paths, TParams(k=K, s=S), device="cpu")
    jidx = jengine.build_index(paths, JParams(k=K, s=S))
    return paths, tidx, jidx


def _split(idx, cls, params, n):
    return (cls(params, idx.names[:n], idx.hi[:n], idx.lo[:n]),
            cls(params, idx.names[n:], idx.hi[n:], idx.lo[n:]))


def test_build_index_and_sketch_file_match_reference(indexes):
    paths, tidx, jidx = indexes
    assert tidx.names == jidx.names
    assert np.array_equal(tidx.hi, jidx.hi) and np.array_equal(tidx.lo, jidx.lo)
    assert tidx.sizes()[-1] == 0  # shorter than k: empty sketch
    one = tengine.sketch_file(paths[0], TParams(k=K, s=S), device="cpu")
    assert np.array_equal(one, jengine.sketch_file(paths[0], JParams(k=K, s=S)))
    assert np.array_equal(one, tidx.sketch_u64(0))


def test_batch_one_equals_batched(indexes):
    paths, tidx, _ = indexes
    single = tengine.build_index(paths, TParams(k=K, s=S), batch=1, device="cpu")
    assert np.array_equal(single.hi, tidx.hi) and np.array_equal(single.lo, tidx.lo)


@pytest.mark.parametrize("split", [None, 2])
def test_dist_rows_match_reference(indexes, split):
    _, tidx, jidx = indexes
    if split is None:
        targs, jargs = (tidx,), (jidx,)
    else:
        targs = _split(tidx, TIndex, tidx.params, split)
        jargs = _split(jidx, JIndex, jidx.params, split)
    got = tengine.dist(*targs, tile=2, device="cpu")
    want = jengine.dist(*jargs, tile=2)
    assert [(r["i"], r["j"]) for r in got] == [(r["i"], r["j"]) for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert all(g[c] == w[c] for c in w), (g, w)


def test_rows_from_count_matrices_and_tsv_writers_agree(indexes):
    _, tidx, _ = indexes
    rows = tengine.dist(tidx, tile=3, device="cpu")
    n = len(tidx)
    mats = [np.zeros((n, n), np.int64) for _ in range(3)]
    for _, _, gi, gj, *counts in tengine.dist_tiles(tidx, tile=2, device="cpu"):
        for m, c in zip(mats, counts):
            m[gi, gj] = c
    again = tengine.rows_from_count_matrices(tidx, mats[0], mats[1], inter=mats[2])
    assert again == rows
    cols = tengine.select_columns(containment=True, bounds=True)
    buf = io.StringIO()
    n_rows = tengine.dist_tsv_write(buf, tidx, tile=3, columns=cols, device="cpu")
    assert n_rows == len(rows)
    assert buf.getvalue() == tengine.rows_to_tsv(
        tengine.add_bound_columns(rows, K), columns=cols)
    near = tengine.filter_rows(rows, max_dist=0.05, max_p=1e-5)
    buf = io.StringIO()
    tengine.dist_tsv_write(buf, tidx, tile=3, max_dist=0.05, max_p=1e-5, device="cpu")
    assert buf.getvalue() == tengine.rows_to_tsv(near)
    assert 0 < len(near) < len(rows)


def test_dist_tiles_mask_and_order(indexes):
    _, tidx, _ = indexes
    tiles = list(tengine.dist_tiles(tidx, tile=2, device="cpu"))
    assert [(t[0], t[1]) for t in tiles] == [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    pairs = [(int(i), int(j)) for t in tiles for i, j in zip(t[2], t[3])]
    n = len(tidx)
    assert sorted(pairs) == [(i, j) for i in range(n) for j in range(i + 1, n)]


def test_index_to_device_keys(indexes):
    _, tidx, _ = indexes
    keys = index_to_device(tidx, "cpu")
    assert keys.dtype == torch.int64 and keys.shape == (len(tidx), S)
    assert np.array_equal(keys.numpy(), u64.keys_from_planes(tidx.hi, tidx.lo))
    assert np.array_equal(u64.planes_from_keys(keys)[0], tidx.hi)
    assert bool((keys[-1] == u64.INF_KEY).all())


def test_compact_indexes_and_counted_sketches_are_not_ported_yet(indexes, tmp_path):
    """Compact indexes (M8) and counted sketches (M10) are both ported now:
    the port's to_compact and the reference's compact file agree, and
    build_index with min_copies=2 gives the reference's index."""
    paths, tidx, jidx = indexes
    compact = tmp_path / "compact.npz"
    jidx.to_compact().save(compact)
    loaded, mine = TIndex.load(compact), tidx.to_compact()
    assert loaded.params == mine.params and loaded.params.compact
    assert np.array_equal(loaded.hi, mine.hi) and np.array_equal(loaded.lo, mine.lo)
    counted = tengine.build_index(paths[:2], TParams(k=K, s=S), min_copies=2, device="cpu")
    ref = jengine.build_index(paths[:2], JParams(k=K, s=S), min_copies=2)
    assert np.array_equal(counted.hi, ref.hi) and np.array_equal(counted.lo, ref.lo)
