"""Port parity under MIEKKI_INTERSECT=mxu on the CPU, against the JAX
package's stream pass (miekki_tpu.ops.mxu_intersect), case for case with
tests/test_mxu_intersect.py: the same seeded sketches go through the port's
tile functions, which the variable sends to K3/K4's plain versions, and
through the reference's tile functions under the same variable, raw and
compact (the values' ranks as codes).  shared_in_x, union_size, inter_full
and the sizes must be bitwise equal (every output is an integer).  The
exact resolve of named pairs (ops.intersect.resolve_pairs, which resumes
the reference's host-ring step files) is held to the reference's
resolve_pairs_host, with and without the native library.  Shapes: s <= 200
and tiles of 2-16 rows, but for the resolve cases at s = 8,192 and the
long-shared-tail case (2 x 600 at s = 600)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miekki_tpu.ops import intersect as jintersect
from miekki_tpu.ops import mxu_intersect as JM
from miekki_tpu.ops import u64 as ju64
from miekki_tpu.oracle import sketch as oracle_sketch
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.io import native as tnative
from miekki_tpu_torch.ops import compact as tcompact
from miekki_tpu_torch.ops import intersect as TI
from miekki_tpu_torch.ops import u64 as tu64
from miekki_tpu_torch.params import SketchParams

EXACT_KEYS = ("shared_in_x", "union_size", "inter_full")
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def stack_both(sketches, s):
    """The same padded [n, s] table as JAX (hi, lo) planes and port keys."""
    arr = np.stack([oracle_sketch.pad_sketch(x, s) for x in sketches])
    hi, lo = ju64.split(arr)
    return (jnp.asarray(hi), jnp.asarray(lo)), torch.from_numpy(tu64.keys_from_u64(arr))


def random_sketch(rng, n_values, value_range, s):
    return np.unique(rng.integers(0, value_range, size=n_values, dtype=np.uint64))[:s]


def _rank_codes(rows, cols):
    """uint32 code tables of both sides: each finite value's rank among the
    values of the two sides (order and equality kept), the sentinel kept."""
    u_rows, u_cols = tu64.u64_from_keys(rows[1]), tu64.u64_from_keys(cols[1])
    values = np.unique(np.concatenate([u_rows.ravel(), u_cols.ravel()]))
    values = values[values != SENTINEL]

    def codes(u):
        out = np.searchsorted(values, u).astype(np.uint32)
        out[u == SENTINEL] = np.uint32(0xFFFFFFFF)
        return out

    return codes(u_rows), codes(u_cols)


def _assert_counts_equal(got: dict, want: dict, what: str):
    for key in EXACT_KEYS:
        assert got[key].dtype == torch.int32, (what, key)
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), (what, key)
    shape = got["shared_in_x"].shape
    for key, axis in (("n_a", 1), ("n_b", 0)):
        g = np.broadcast_to(np.expand_dims(got[key].numpy(), axis), shape)
        assert np.array_equal(g, np.broadcast_to(np.asarray(want[key]), shape)), (what, key)


def check_tile(rows, cols, s, monkeypatch):
    """The port's tile_counts and tile_counts_compact under
    MIEKKI_INTERSECT=mxu equal the reference's under the same variable
    (its stream pass and exact resolve); returns the port's raw counts."""
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    got = TI.tile_counts(rows[1], cols[1], s)
    _assert_counts_equal(got, jintersect.tile_counts(rows[0], cols[0], s), "raw")
    code_rows, code_cols = _rank_codes(rows, cols)
    got32 = TI.tile_counts_compact(torch.from_numpy(tcompact.keys32_from_codes(code_rows)),
                                   torch.from_numpy(tcompact.keys32_from_codes(code_cols)), s)
    want32 = jintersect.tile_counts_compact(jnp.asarray(code_rows), jnp.asarray(code_cols), s)
    _assert_counts_equal(got32, want32, "compact")
    for key in EXACT_KEYS:
        assert torch.equal(got32[key], got[key]), key
    return {key: got[key].numpy() for key in EXACT_KEYS}


@pytest.mark.parametrize("seed", range(4))
def test_random_overlapping_tiles(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    s = 64
    rows = stack_both([random_sketch(rng, 120, 1000, s) for _ in range(5)], s)
    cols = stack_both([random_sketch(rng, 120, 1000, s) for _ in range(7)], s)
    check_tile(rows, cols, s, monkeypatch)


def test_identical_and_disjoint(monkeypatch):
    s = 64
    a = np.arange(1, s + 1, dtype=np.uint64) * 7
    b = a + 1000
    rows = stack_both([a, b], s)
    cols = stack_both([a, b], s)
    exact = check_tile(rows, cols, s, monkeypatch)
    assert np.array_equal(exact["inter_full"], [[s, 0], [0, s]])
    assert np.array_equal(exact["shared_in_x"], [[s, 0], [0, s]])
    assert np.array_equal(exact["union_size"], [[s, s], [s, s]])


def test_short_sketches_inf_padding(monkeypatch):
    rng = np.random.default_rng(5)
    s = 64
    rows = stack_both([random_sketch(rng, 10, 100, s) for _ in range(3)], s)
    cols = stack_both([random_sketch(rng, 8, 100, s) for _ in range(3)], s)
    check_tile(rows, cols, s, monkeypatch)


def test_value_zero_ties(monkeypatch):
    s = 64
    sk = [np.array([0, 5, 9], np.uint64), np.array([0, 5, 11], np.uint64),
          np.array([0, 9, 11], np.uint64)]
    check_tile(stack_both(sk, s), stack_both(sk, s), s, monkeypatch)


def test_full_mode_long_runs_exact(monkeypatch):
    """Ten values shared by all 20 sketches: runs of 20 equal values."""
    rng = np.random.default_rng(7)
    s = 64
    core = rng.choice(1000, size=10, replace=False).astype(np.uint64)

    def member():
        mine = rng.choice(5000, size=80, replace=False).astype(np.uint64) + 2000
        return np.unique(np.concatenate([core, mine]))[:s]

    rows = stack_both([member() for _ in range(9)], s)
    cols = stack_both([member() for _ in range(11)], s)
    check_tile(rows, cols, s, monkeypatch)


@pytest.mark.parametrize("s_cut", [4, 5, 6, 8])
def test_full_mode_run_straddles_chunk_edge(s_cut, monkeypatch):
    """Runs of 7 that straddle the reference's chunk edges (chunk = ti + tj
    = 7); the s-cut lands on and around the crossing value's rank."""
    s = 64
    vals = np.arange(1, 40, dtype=np.uint64)
    sk = [np.unique(np.concatenate([vals[:3], np.uint64(10 + 5 * i) + vals[:3]]))[:s_cut]
          for i in range(7)]
    check_tile(stack_both(sk[:3], s), stack_both(sk[3:], s), s_cut, monkeypatch)


def _clone_family(s, seed):
    rng = np.random.default_rng(seed)
    root = np.unique(rng.integers(0, 2 ** 62, size=3 * s, dtype=np.uint64))
    out = []
    for share in (0.95, 0.9, 0.2, 0.15, 0.0):
        keep = rng.random(root.size) < share
        vals = np.concatenate([root[keep], rng.integers(0, 2 ** 62, size=2 * s, dtype=np.uint64)])
        out.append(np.unique(vals)[:s])
    return out


def _planes(keys: torch.Tensor) -> tuple:
    return ju64.split(tu64.u64_from_keys(keys))


@pytest.mark.parametrize("native", ["1", "0"])
def test_prefix_resolution_and_clone_fallback(native, monkeypatch):
    """At s = 8,192, every pair of a clone family (shares 95 % to 0 %):
    resolve_pairs with the native library ("1") or without it ("0": the
    batched merge) equals the reference's resolve_pairs_host under
    MIEKKI_NATIVE_RESOLVE of the same value, and the tile counts."""
    monkeypatch.setenv("MIEKKI_NATIVE_RESOLVE", native)
    if native == "0":
        monkeypatch.setattr(tnative, "has_resolve", lambda: False)
    s = 8192
    sk = _clone_family(s, 99)
    rows, cols = stack_both(sk[:3], s), stack_both(sk[2:], s)
    ai, aj = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    ai, aj = ai.ravel(), aj.ravel()
    planes = (_planes(rows[1]), _planes(cols[1]))
    got = TI.resolve_pairs(*planes, ai, aj, s)
    want = JM.resolve_pairs_host(*planes, ai, aj, s)
    ref = TI.tile_counts_plain(rows[1], cols[1], s)["shared_in_x"].numpy().ravel()
    assert got.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(got, ref)


def test_prefix_certificate_rejects_clones(monkeypatch):
    """A clone pair (all s shared) and an unrelated pair at s = 8,192,
    without the native library and one pair a batch (RESOLVE_BATCH = 1):
    s and the exact count, as the reference's resolve gives them."""
    rng = np.random.default_rng(7)
    s = 8192
    base = np.unique(rng.integers(0, 2 ** 62, size=2 * s, dtype=np.uint64))[:s]
    other = np.unique(rng.integers(0, 2 ** 62, size=2 * s, dtype=np.uint64))[:s]
    rows, cols = stack_both([base, base], s), stack_both([base, other], s)
    monkeypatch.setattr(tnative, "has_resolve", lambda: False)
    monkeypatch.setattr(TI, "RESOLVE_BATCH", 1)
    planes = (_planes(rows[1]), _planes(cols[1]))
    ai, aj = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    got = TI.resolve_pairs(*planes, ai, aj, s)
    ref = TI.tile_counts_plain(rows[1], cols[1], s)["shared_in_x"].numpy().ravel()
    assert np.array_equal(got, ref) and got[0] == s and got[2] == s
    assert np.array_equal(got, JM.resolve_pairs_host(*planes, ai, aj, s))


def _family_index(rng, n, s, compact):
    pool = np.unique(rng.integers(1, 2 ** 63, size=8 * s, dtype=np.uint64))[:3 * s]
    sketches = []
    for i in range(n):
        sk = np.unique(pool[rng.choice(3 * s, size=s + 16, replace=False)])[:s]
        sketches.append(sk[:s // 3] if i % 5 == 4 else sk)
    idx = TIndex.from_sketches(sketches, [f"g{i}" for i in range(n)], SketchParams(k=21, s=s))
    return idx.to_compact() if compact else idx


@pytest.mark.parametrize("pairs", ["random", "identical_rows", "empty"])
@pytest.mark.parametrize("kind", ["raw", "compact"])
def test_resolve_pairs_equals_reference(kind, pairs, monkeypatch):
    """resolve_pairs over an index's host planes (a compact index's codes
    and derived lo plane) equals the reference's resolve_pairs_host, with
    and without the native library: random pairs of a family at s = 64,
    every pair of a 4 x 4 tile whose rows are one sketch, and no pair."""
    rng = np.random.default_rng(31)
    s = 64
    idx = _family_index(rng, 12, s, kind == "compact")
    if pairs == "identical_rows":
        rows = np.repeat(idx.hi[:1], 4, axis=0), np.repeat(idx.lo[:1], 4, axis=0)
        cols = idx.hi[[0, 5, 6, 9]], idx.lo[[0, 5, 6, 9]]  # a clone and a short one
        ai, aj = (x.ravel() for x in np.meshgrid(np.arange(4), np.arange(4), indexing="ij"))
    else:
        rows = cols = (idx.hi, idx.lo)
        k = 40 if pairs == "random" else 0
        ai, aj = rng.integers(0, len(idx), size=k), rng.integers(0, len(idx), size=k)
    want = JM.resolve_pairs_host(rows, cols, ai, aj, s)
    got = TI.resolve_pairs(rows, cols, ai, aj, s)
    monkeypatch.setattr(tnative, "has_resolve", lambda: False)
    plain = TI.resolve_pairs(rows, cols, ai, aj, s)
    assert got.dtype == plain.dtype == np.int32 and got.shape == (ai.size,)
    assert np.array_equal(got, want) and np.array_equal(plain, want)
    if pairs == "identical_rows":
        tile = got.reshape(4, 4)
        assert (tile == tile[:1]).all() and (tile[:, 0] == s).all()


def test_long_shared_tail_beyond_bfloat16(monkeypatch):
    """Row 0 and column 0 hold near-identical long sketches of large
    values, every other sketch 3 small ones: in the reference's stream pass
    a chunk of the tail holds more than 256 matches of that pair (beyond
    bfloat16).  Two rows against 600 columns at s = 600."""
    rng = np.random.default_rng(17)
    ti, tj = 2, 600
    s = 600
    big = np.unique(rng.integers(1 << 62, 1 << 63, size=2 * s, dtype=np.uint64))[:s]
    near = big.copy()
    near[rng.choice(s, size=7, replace=False)] += np.uint64(1)
    near = np.unique(near)

    def table(first, n):
        return [first] + [np.sort(rng.choice(1 << 20, size=3, replace=False).astype(np.uint64))
                          for _ in range(n - 1)]

    rows, cols = stack_both(table(big, ti), s), stack_both(table(near, tj), s)
    exact = check_tile(rows, cols, s, monkeypatch)
    assert exact["inter_full"][0, 0] > 256


def test_unknown_intersect_impl_raises(monkeypatch):
    from miekki_tpu_torch import engine as T

    for value, want in (("mxu", "pallas"), ("MXU", "pallas"), ("pallas", "pallas"),
                        ("auto", "pallas"), ("bitonic", "bitonic"),
                        ("SearchSorted", "searchsorted")):
        monkeypatch.setenv("MIEKKI_INTERSECT", value)
        assert TI.intersect_impl() == want
    monkeypatch.delenv("MIEKKI_INTERSECT")
    assert TI.intersect_impl() == "pallas"
    idx = TIndex.from_sketches([np.arange(1, 9, dtype=np.uint64)] * 2, ["a", "b"],
                               SketchParams(k=21, s=8))
    for value in ("nope", "xla"):
        monkeypatch.setenv("MIEKKI_INTERSECT", value)
        with pytest.raises(ValueError, match="MIEKKI_INTERSECT"):
            T.dist_counts_matrix(idx, device="cpu")
