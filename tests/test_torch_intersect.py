"""Port parity: tile intersection counts (miekki_tpu_torch.ops.intersect and
the K3 wrapper ops.cuda_intersect) against the JAX package's Pallas tile
kernel (interpret mode), its pair_counts_merge and the numpy oracle.
Tolerance: none — every output is an integer count."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miekki_tpu.ops import intersect as JI
from miekki_tpu.ops import pallas_intersect as JPI
from miekki_tpu.ops import u64 as ju64
from miekki_tpu.oracle import compare as OC
from miekki_tpu_torch.ops import cuda_intersect as TCI
from miekki_tpu_torch.ops import intersect as TI
from miekki_tpu_torch.ops import u64 as tu64

KEYS = ("shared_in_x", "union_size", "inter_full")
O_INF = np.uint64(0xFFFFFFFFFFFFFFFF)


def _table(rng, n_rows, s, pool_hi, full_every=4):
    """[n_rows, s] u64 table of sorted distinct sketches, INF-padded; every
    `full_every`-th row is full (s values), so bottom-s cuts happen."""
    pool = np.unique(np.concatenate(
        [[0], rng.integers(0, pool_hi, size=6 * s, dtype=np.uint64)]))
    tab = np.full((n_rows, s), O_INF, np.uint64)
    for i in range(n_rows):
        n = s if i % full_every == 0 else int(rng.integers(0, s + 1))
        tab[i, :n] = np.sort(rng.choice(pool, size=n, replace=False))
    return tab


@pytest.mark.parametrize("s,ti,tj", [(17, 3, 5), (50, 6, 4), (300, 3, 4), (1000, 2, 3)])
def test_plain_tile_counts_match_pallas_and_merge(s, ti, tj):
    rng = np.random.default_rng(s)
    tab = _table(rng, ti + tj, s, 4 * s)
    keys = torch.from_numpy(tu64.keys_from_u64(tab))
    got = TI.tile_counts(keys[:ti], keys[ti:], s)

    hi, lo = (jnp.asarray(x) for x in ju64.split(tab))
    rows, cols = (hi[:ti], lo[:ti]), (hi[ti:], lo[ti:])
    want = JPI.tile_counts_pallas(JI._pad_lane(rows), JI._pad_lane(cols), s,
                                  interpret=True)
    for key in KEYS + ("n_a", "n_b"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    for i in range(ti):
        for j in range(tj):
            m = JI.pair_counts_merge((rows[0][i], rows[1][i]),
                                     (cols[0][j], cols[1][j]), s)
            for key in KEYS:
                assert int(got[key][i, j]) == int(m[key]), (i, j, key)
            a, b = tab[i][tab[i] != O_INF], tab[ti + j][tab[ti + j] != O_INF]
            sh, un, _ = OC.mash_jaccard(a, b, s)
            assert (int(got["shared_in_x"][i, j]), int(got["union_size"][i, j])) == (sh, un)


def test_zero_head_ties():
    """Hash value 0 present in both sketches (tests/test_pallas_kernels.py
    zero-head case): counts must equal pair_counts_merge."""
    s = 300
    rng = np.random.default_rng(5)
    a = np.unique(np.concatenate([[0], rng.integers(0, 1000, 280, dtype=np.uint64)]))[:s]
    b = np.unique(np.concatenate([[0, 1], rng.integers(0, 1000, 280, dtype=np.uint64)]))[:s]
    ta = np.full(s, O_INF, np.uint64)
    ta[:len(a)] = a
    tb = np.full(s, O_INF, np.uint64)
    tb[:len(b)] = b
    got = TI.tile_counts(torch.from_numpy(tu64.keys_from_u64(ta[None])),
                         torch.from_numpy(tu64.keys_from_u64(tb[None])), s)
    ap = tuple(jnp.asarray(x) for x in ju64.split(ta))
    bp = tuple(jnp.asarray(x) for x in ju64.split(tb))
    want = JI.pair_counts_merge(ap, bp, s)
    for key in KEYS:
        assert int(got[key][0, 0]) == int(want[key]), key


def test_pair_counts_merge_matches_reference():
    rng = np.random.default_rng(8)
    s = 64
    tab = _table(rng, 6, s, 200, full_every=2)
    keys = torch.from_numpy(tu64.keys_from_u64(tab))
    got = TI.pair_counts_merge(keys[:3], keys[3:], s)
    for i in range(3):
        pa = tuple(jnp.asarray(x) for x in ju64.split(tab[i]))
        pb = tuple(jnp.asarray(x) for x in ju64.split(tab[3 + i]))
        want = JI.pair_counts_merge(pa, pb, s)
        for key in KEYS + ("n_a", "n_b"):
            assert int(got[key][i]) == int(want[key]), (i, key)


def test_pad_lane_matches_reference_width():
    for sp in (1, 17, 128, 129, 300, 10_000):
        keys = torch.zeros((2, sp), dtype=torch.int64)
        padded = TI._pad_lane(keys)
        jw = JI._pad_lane((jnp.zeros((2, sp), jnp.uint32),) * 2)[0].shape[1]
        assert padded.shape == (2, jw)
        assert bool((padded[:, sp:] == tu64.INF_KEY).all())


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    rng = np.random.default_rng(2)
    keys = torch.from_numpy(tu64.keys_from_u64(_table(rng, 5, 100, 400)))
    keys = TI._pad_lane(keys)
    before = TCI.tile_counts_cuda.launches
    got = TCI.tile_counts_cuda(keys[:2], keys[2:], 100)
    assert TCI.tile_counts_cuda.launches == before
    want = TI.tile_counts_plain(keys[:2], keys[2:], 100)
    for key in KEYS + ("n_a", "n_b"):
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(ValueError):
        TCI.tile_counts_cuda(keys[:2].to(torch.int32), keys[2:], 100)
    with pytest.raises(ValueError):
        TCI.tile_counts_cuda(keys[:2, :64], keys[2:], 100)

