"""Port parity of ops/intersect.py's per-pair and membership forms and of
its bitonic and searchsorted tile routes: miekki_tpu_torch.ops.intersect
against miekki_tpu.ops.intersect on the CPU, on seeded sketches that are
empty (all INF), identical, disjoint, overlapping and cut at s.  The port
takes int64 order keys (int32 code keys for the 32-bit forms) where the
reference takes (hi, lo) planes (uint32 codes).  Tolerance: none — every
output is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miekki_tpu.ops import intersect as JI
from miekki_tpu.ops import u64 as ju64
from miekki_tpu_torch.ops import compact as TC
from miekki_tpu_torch.ops import intersect as TI
from miekki_tpu_torch.ops import u64 as tu64

COUNT_KEYS = ("shared_in_x", "union_size", "inter_full", "n_a", "n_b")
INF = np.uint64(0xFFFFFFFFFFFFFFFF)
INF32 = np.uint32(0xFFFFFFFF)


def _pairs(rng, sp, s, dtype=np.uint64):
    """[(a, b)] row pairs of width sp (sorted distinct, INF-padded): empty,
    one empty, identical, disjoint, overlapping, and full rows cut at s."""
    top = 2 ** 63 if dtype == np.uint64 else 0xFFFFFFFE
    inf = INF if dtype == np.uint64 else INF32
    pool = np.unique(rng.integers(0, top, size=4 * sp, dtype=dtype))

    def row(vals):
        out = np.full(sp, inf, dtype)
        vals = np.unique(vals)[:sp]
        out[:len(vals)] = vals
        return out

    x = rng.choice(pool, size=sp, replace=False)
    y = rng.choice(pool, size=sp, replace=False)
    evens, odds = np.sort(pool)[0::2], np.sort(pool)[1::2]
    return [
        (row([]), row([])),
        (row(x[:s // 2]), row([])),
        (row(x[:s]), row(x[:s])),
        (row(evens[:s]), row(odds[:s])),
        (row(x[: s // 2 + 3]), row(np.concatenate([x[: s // 4], y[: s // 2]]))),
        (row(x), row(y)),
        (row(np.concatenate([[0], x[:s - 1]])), row(np.concatenate([[0], y[:s - 1]]))),
    ]


def _keys(tab):
    return torch.from_numpy(tu64.keys_from_u64(tab))


def _planes(tab):
    return tuple(jnp.asarray(p) for p in ju64.split(tab))


def _assert_counts(got, want, what):
    for key in COUNT_KEYS:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), (what, key)
        assert got[key].dtype == torch.int32, (what, key)


@pytest.mark.parametrize("sp,s", [(64, 64), (100, 60), (128, 100)])
def test_pair_counts_equals_reference(sp, s):
    rng = np.random.default_rng(sp + s)
    for n, (a, b) in enumerate(_pairs(rng, sp, s)):
        got = TI.pair_counts(_keys(a), _keys(b), s)
        _assert_counts(got, JI.pair_counts(_planes(a), _planes(b), s), n)
        _assert_counts(got, TI.pair_counts_merge(_keys(a), _keys(b), s), n)
        codes = (TC.encode_u64(a), TC.encode_u64(b))
        got32 = TI.pair_counts32(*(torch.from_numpy(TC.keys32_from_codes(c)) for c in codes), s)
        _assert_counts(got32, JI.pair_counts32(*(jnp.asarray(c) for c in codes), s), n)


@pytest.mark.parametrize("sp,s", [(64, 64), (128, 100), (256, 17)])
def test_pair_counts_bitonic_equals_reference(sp, s):
    """Batched [pairs, sp] rows through the bitonic network, both forms."""
    rng = np.random.default_rng(sp * 3 + s)
    pairs = _pairs(rng, sp, s)
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    got = TI.pair_counts_bitonic(_keys(a), _keys(b), s)
    _assert_counts(got, JI.pair_counts_bitonic(_planes(a), _planes(b), s), "u64")
    _assert_counts(got, TI.pair_counts_merge(_keys(a), _keys(b), s), "merge")
    merged = TI._bitonic_merge_u64(torch.cat([_keys(a), _keys(b).flip(-1)], -1), sp)
    jh, jl = JI._bitonic_merge_u64(
        *(jnp.concatenate([x, y[..., ::-1]], axis=-1) for x, y in zip(_planes(a), _planes(b))),
        sp)
    assert np.array_equal(tu64.u64_from_keys(merged), ju64.join(np.asarray(jh), np.asarray(jl)))

    pairs32 = _pairs(rng, sp, s, np.uint32)
    a32 = np.stack([p[0] for p in pairs32])
    b32 = np.stack([p[1] for p in pairs32])
    got32 = TI.pair_counts_bitonic32(torch.from_numpy(TC.keys32_from_codes(a32)),
                                     torch.from_numpy(TC.keys32_from_codes(b32)), s)
    _assert_counts(got32, JI.pair_counts_bitonic32(jnp.asarray(a32), jnp.asarray(b32), s),
                   "u32")


def test_bitonic_needs_equal_power_of_two_widths():
    k96 = torch.full((2, 96), tu64.INF_KEY, dtype=torch.int64)
    k128 = torch.full((2, 128), tu64.INF_KEY, dtype=torch.int64)
    for a, b in ((k96, k96), (k128, k128[:, :64])):
        with pytest.raises(ValueError, match="power-of-two"):
            TI.pair_counts_bitonic(a, b, 10)
        with pytest.raises(ValueError, match="power-of-two"):
            TI.pair_counts_bitonic32(a.to(torch.int32), b.to(torch.int32), 10)
        with pytest.raises(ValueError, match="power-of-two"):
            JI.pair_counts_bitonic((jnp.zeros(a.shape, jnp.uint32),) * 2,
                                   (jnp.zeros(b.shape, jnp.uint32),) * 2, 10)
    with pytest.raises(ValueError, match="int64"):
        TI.pair_counts_bitonic(k128.to(torch.int32), k128.to(torch.int32), 10)


@pytest.mark.parametrize("m", [0, 1, 37, 300])
def test_searchsorted_and_member_equal_reference(m):
    """Lower bounds of a [3, 40] needle block (hay values, their
    neighbours, INF) and membership; INF never matches, even against INF
    padding in the haystack."""
    rng = np.random.default_rng(m)
    vals = np.unique(rng.integers(1, 2 ** 63, size=m, dtype=np.uint64))
    hay = np.concatenate([vals, np.full(2, INF)]) if m else vals
    picks = rng.choice(vals, size=39) if m else np.zeros(39, np.uint64)
    extra = np.array([INF, 0, 2 ** 63 + 5], np.uint64)
    needles = np.concatenate([picks, picks + np.uint64(1), picks - np.uint64(1),
                              extra]).reshape(3, 40)
    got = TI.searchsorted_u64(_keys(hay), _keys(needles))
    assert got.dtype == torch.int32 and tuple(got.shape) == needles.shape
    member = TI.member_u64(_keys(hay), _keys(needles))
    if m:  # the reference's gather needs a non-empty haystack
        assert np.array_equal(got.numpy(), np.asarray(JI.searchsorted_u64(_planes(hay),
                                                                          _planes(needles))))
        assert np.array_equal(member.numpy(), np.asarray(JI.member_u64(_planes(hay),
                                                                       _planes(needles))))
    assert np.array_equal(got.numpy(), np.searchsorted(hay, needles, side="left"))
    want_member = np.isin(needles, vals) & (needles != INF)
    assert np.array_equal(member.numpy(), want_member)


def test_containment_counts_equal_reference():
    rng = np.random.default_rng(9)
    sp, s = 96, 80
    pool = np.unique(rng.integers(0, 2 ** 63, size=600, dtype=np.uint64))
    db = np.full((6, sp), INF, np.uint64)
    for i, n in enumerate((0, 10, 80, 80, 45, 1)):
        db[i, :n] = np.sort(rng.choice(pool, size=n, replace=False))
    reads = np.concatenate([np.sort(rng.choice(pool, size=200, replace=False)), [INF] * 8])
    hits, sizes = TI.containment_counts(_keys(db), _keys(reads))
    j_hits, j_sizes = JI.containment_counts(_planes(db), _planes(reads))
    assert hits.dtype == sizes.dtype == torch.int32
    assert np.array_equal(hits.numpy(), np.asarray(j_hits))
    assert np.array_equal(sizes.numpy(), np.asarray(j_sizes))
    assert int(hits[0]) == 0 and int(sizes[2]) == s


@pytest.mark.parametrize("impl", ["bitonic", "searchsorted"])
@pytest.mark.parametrize("s,ti,tj", [(60, 9, 5), (200, 3, 11)])
def test_tile_routes_equal_reference(impl, s, ti, tj):
    """tile_counts / tile_counts_compact on the bitonic and searchsorted
    routes equal the reference's jitted routes and K3/K4's plain version;
    a route name the reference does not know raises."""
    rng = np.random.default_rng(s + ti)
    pool = np.unique(rng.integers(0, 2 ** 63, size=4 * s, dtype=np.uint64))
    tab = np.full((ti + tj, s), INF, np.uint64)
    for i in range(ti + tj):
        n = s if i % 3 == 0 else int(rng.integers(0, s + 1))
        tab[i, :n] = np.sort(rng.choice(pool, size=n, replace=False))
    keys = _keys(tab)
    got = TI.tile_counts(keys[:ti], keys[ti:], s, impl)
    hi, lo = _planes(tab)
    want = JI.tile_counts((hi[:ti], lo[:ti]), (hi[ti:], lo[ti:]), s, impl=impl)
    plain = TI.tile_counts(keys[:ti], keys[ti:], s)
    for key in ("shared_in_x", "union_size", "inter_full"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
        assert torch.equal(got[key], plain[key]), key
    assert torch.equal(got["n_a"], plain["n_a"]) and torch.equal(got["n_b"], plain["n_b"])

    codes = TC.encode_u64(tab)
    k32 = torch.from_numpy(TC.keys32_from_codes(codes))
    got32 = TI.tile_counts_compact(k32[:ti], k32[ti:], s, impl)
    want32 = JI.tile_counts_compact(jnp.asarray(codes[:ti]), jnp.asarray(codes[ti:]), s,
                                    impl=impl)
    for key in ("shared_in_x", "union_size", "inter_full"):
        assert np.array_equal(got32[key].numpy(), np.asarray(want32[key])), key
    with pytest.raises(ValueError, match="tile route"):
        TI.tile_counts(keys[:ti], keys[ti:], s, "mxu")
