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


def _frontier_merge_step(a, b, ca, cb, s, acc):
    """One pair's merge of a step, as merge_step in csrc/tile_counts_merge.cu:
    a[:ca] and b[:cb] are followed by an INF sentinel; acc = [uni, inter,
    shared] carried from the earlier steps."""
    uni = acc[0]
    end = ca + cb
    p = q = common = 0
    va, vb = a[0], b[0]
    exact_rank = not (uni >= s or uni + end <= s)
    rank = uni
    while p + q < end:
        le, ge = va <= vb, vb <= va
        if le and ge:
            common += 1
            acc[2] += exact_rank and rank < s
        rank += 1
        p += le
        q += ge
        if le:
            va = a[p]
        if ge:
            vb = b[q]
    if not exact_rank and uni < s:
        acc[2] += common
    acc[0] += end - common
    acc[1] += common


def _frontier_counts(rows, cols, s, cap, block=(2, 3)):
    """numpy model of the kernel's block and step loop (tile_counts_merge.cu)
    at a tiny CAP and block: each block stages the next `cap` keys of its
    rows and columns (edge rows repeat the last one, positions past sp read
    INF), takes the frontier F as the least last staged key, counts each
    row's keys <= F with the kernel's binary search, puts an INF sentinel
    after them, merges every pair's segments with carried counts, and stops
    after the step whose F is INF."""
    inf = np.iinfo(rows.dtype).max
    (ti, sp), tj = rows.shape, cols.shape[0]
    n_r, n_c = block
    out = np.zeros((3, ti, tj), np.int64)
    for r0 in range(0, ti, n_r):
        for c0 in range(0, tj, n_c):
            staged = ([rows[min(r0 + r, ti - 1)] for r in range(n_r)]
                      + [cols[min(c0 + c, tj - 1)] for c in range(n_c)])
            cursor = [0] * len(staged)
            acc = [[[0, 0, 0] for _ in range(n_c)] for _ in range(n_r)]
            while True:
                buf = []
                for r, row in enumerate(staged):
                    seg = np.full(cap + 1, inf, rows.dtype)
                    window = row[cursor[r]:cursor[r] + cap]
                    seg[:len(window)] = window
                    buf.append(seg)
                f = min(seg[cap - 1] for seg in buf)
                fc = f if f < inf else inf - 1
                count = []
                for r, seg in enumerate(buf):
                    n, step = 0, cap
                    while step:
                        if n + step <= cap and seg[n + step - 1] <= fc:
                            n += step
                        step >>= 1
                    seg[n] = inf
                    count.append(n)
                    cursor[r] += n
                for i in range(n_r):
                    for j in range(n_c):
                        _frontier_merge_step(buf[i], buf[n_r + j], count[i],
                                             count[n_r + j], s, acc[i][j])
                if f == inf:
                    break
            for i in range(min(n_r, ti - r0)):
                for j in range(min(n_c, tj - c0)):
                    uni, inter, shared = acc[i][j]
                    out[:, r0 + i, c0 + j] = shared, min(uni, s), inter
    return dict(zip(KEYS, out))


def _key_table(rng, n_rows, sp, pool, full_every=3):
    """[n_rows, sp] sorted distinct keys drawn from `pool`, INF-padded;
    row 1 is empty (all INF) and every `full_every`-th row is full."""
    inf = np.iinfo(pool.dtype).max
    tab = np.full((n_rows, sp), inf, pool.dtype)
    for i in range(n_rows):
        n = sp if i % full_every == 0 else 0 if i == 1 else int(rng.integers(0, sp + 1))
        tab[i, :n] = np.sort(rng.choice(pool, size=n, replace=False))
    return tab


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("cap", [4, 8])
@pytest.mark.parametrize("case", ["random", "ties", "edges", "diagonal", "zero_head"])
def test_frontier_decomposition_matches_plain(dtype, cap, case):
    """The kernel's step loop (frontier, sentinels, carried counts, the
    exact-rank step) equals tile_counts_plain: wide pools, tie-heavy pools,
    the smallest and largest finite keys next to INF, a diagonal tile, the
    zero-head ties of test_zero_head_ties; s below, inside and above the
    row widths; tiles ragged against the 2 x 3 model block."""
    rng = np.random.default_rng(cap * 7 + len(case))
    info = np.iinfo(dtype)
    ti, tj, sp = 5, 7, 19
    if case == "zero_head":
        s, sp = 300, 301
        lo = info.min  # order key of value 0
        a = np.unique(np.concatenate([[0], rng.integers(0, 1000, 280)]))[:s] + lo
        b = np.unique(np.concatenate([[0, 1], rng.integers(0, 1000, 280)]))[:s] + lo
        tab = np.full((2, sp), info.max, dtype)
        tab[0, :len(a)], tab[1, :len(b)] = a, b
        rows, cols, s_values = tab[:1], tab[1:], [s, 100]
    else:
        if case == "random":
            pool = rng.integers(info.min, info.max, size=8 * sp, dtype=dtype)
        elif case == "ties":
            pool = rng.integers(info.min, info.min + 2 * sp, size=4 * sp, dtype=dtype)
        else:
            pool = np.concatenate([[info.min, info.min + 1, info.max - 2, info.max - 1],
                                   rng.integers(info.min, info.max, 2 * sp, dtype=dtype)])
        pool = np.unique(pool).astype(dtype)
        tab = _key_table(rng, ti + tj, sp, pool)
        if case == "edges":  # a full row ending in the largest finite key
            inner = pool[pool != info.max - 1]
            tab[0] = np.sort(np.append(rng.choice(inner, sp - 1, replace=False),
                                       dtype(info.max - 1)))
        rows, cols = tab[:ti], (tab[:ti] if case == "diagonal" else tab[ti:])
        s_values = [3, 11, 19, 40]
    for s in s_values:
        got = _frontier_counts(rows, cols, s, cap)
        want = TI.tile_counts_plain(torch.from_numpy(rows), torch.from_numpy(cols), s)
        for key in KEYS:
            assert np.array_equal(got[key], want[key].numpy()), (s, key)


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

