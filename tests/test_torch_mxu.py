"""Port parity of the stream pass (miekki_tpu_torch.ops.mxu_intersect)
against miekki_tpu.ops.mxu_intersect on the CPU, case for case with
tests/test_mxu_intersect.py: the same seeded sketches go through both;
inter_full, shared_lb, shared_ub, union_size, overflow, the ambiguous set
and the resolved shared_in_x must be bitwise equal (every output is an
integer), streams equal value for value and payload bit for bit.  Shapes:
s <= 200 and tiles of 2-16 rows, but for the resolve cases (s = 8,192,
3 x 3) and the long-shared-tail case (2 x 600 at s = 600)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miekki_tpu.ops import intersect as jintersect
from miekki_tpu.ops import mxu_intersect as JM
from miekki_tpu.ops import u64 as ju64
from miekki_tpu.oracle import sketch as oracle_sketch
from miekki_tpu_torch.ops import compact as tcompact
from miekki_tpu_torch.ops import intersect as TI
from miekki_tpu_torch.ops import mxu_intersect as TM
from miekki_tpu_torch.ops import u64 as tu64

RAW_KEYS = ("inter_full", "shared_lb", "shared_ub", "union_size", "n_a", "n_b", "overflow")
EXACT_KEYS = ("shared_in_x", "union_size", "inter_full", "n_a", "n_b")


def stack_both(sketches, s):
    """The same padded [n, s] table as JAX (hi, lo) planes and port keys."""
    arr = np.stack([oracle_sketch.pad_sketch(x, s) for x in sketches])
    hi, lo = ju64.split(arr)
    return (jnp.asarray(hi), jnp.asarray(lo)), torch.from_numpy(tu64.keys_from_u64(arr))


def random_sketch(rng, n_values, value_range, s):
    return np.unique(rng.integers(0, value_range, size=n_values, dtype=np.uint64))[:s]


def assert_raw_equal(rows, cols, s, **kw):
    """tile_counts_mxu of both packages, bitwise; returns the port's lb, ub."""
    want = JM.tile_counts_mxu(rows[0], cols[0], s, **kw)
    got = TM.tile_counts_mxu(rows[1], cols[1], s, **kw)
    for key in RAW_KEYS:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.dtype == (np.bool_ if key == "overflow" else np.int32), key
        assert np.array_equal(g, w), key
    return got["shared_lb"].numpy(), got["shared_ub"].numpy()


def assert_exact_equal(rows, cols, s, **kw):
    want = JM.tile_counts_mxu_exact(rows[0], cols[0], s, **kw)
    got = TM.tile_counts_mxu_exact(rows[1], cols[1], s, **kw)
    for key in EXACT_KEYS:
        assert np.array_equal(got[key], np.asarray(want[key])), key
    return got


def check_tile(rows, cols, s, **kw):
    lb, ub = assert_raw_equal(rows, cols, s, **kw)
    exact = assert_exact_equal(rows, cols, s, **kw)
    plain = TI.tile_counts_plain(rows[1], cols[1], s)
    for key in ("shared_in_x", "union_size", "inter_full"):
        assert np.array_equal(exact[key], plain[key].numpy()), key
    return lb, ub


@pytest.mark.parametrize("seed", range(4))
def test_random_overlapping_tiles(seed):
    rng = np.random.default_rng(seed)
    s = 64
    rows = stack_both([random_sketch(rng, 120, 1000, s) for _ in range(5)], s)
    cols = stack_both([random_sketch(rng, 120, 1000, s) for _ in range(7)], s)
    check_tile(rows, cols, s)
    assert_raw_equal(rows, cols, s, chunk=64, band=8, mode="band")


def test_crossing_chunk_ambiguity_resolved():
    rng = np.random.default_rng(99)
    s = 64
    base = np.unique(rng.integers(0, 300, size=200, dtype=np.uint64))
    sketches = [np.sort(base[rng.random(base.size) < 0.7])[:s] for _ in range(6)]
    rows, cols = stack_both(sketches[:3], s), stack_both(sketches[3:], s)
    lb, ub = check_tile(rows, cols, s)
    assert (lb != ub).any(), "the case must hold ambiguous pairs"
    _, ai, aj = TM.tile_counts_mxu_finish_deferred(TM.tile_counts_mxu_start(rows[1], cols[1], s))
    _, jai, jaj = JM.tile_counts_mxu_finish_deferred(
        JM.tile_counts_mxu_start(rows[0], cols[0], s))
    assert np.array_equal(ai, jai) and np.array_equal(aj, jaj)


def test_identical_and_disjoint():
    s = 64
    a = np.arange(1, s + 1, dtype=np.uint64) * 7
    b = a + 1000
    rows = stack_both([a, b], s)
    cols = stack_both([a, b], s)
    exact = assert_exact_equal(rows, cols, s)
    assert np.array_equal(exact["inter_full"], [[s, 0], [0, s]])
    assert np.array_equal(exact["shared_in_x"], [[s, 0], [0, s]])
    assert np.array_equal(exact["union_size"], [[s, s], [s, s]])


def test_short_sketches_inf_padding():
    rng = np.random.default_rng(5)
    s = 64
    rows = stack_both([random_sketch(rng, 10, 100, s) for _ in range(3)], s)
    cols = stack_both([random_sketch(rng, 8, 100, s) for _ in range(3)], s)
    check_tile(rows, cols, s)


def test_value_zero_ties():
    s = 64
    sk = [np.array([0, 5, 9], np.uint64), np.array([0, 5, 11], np.uint64),
          np.array([0, 9, 11], np.uint64)]
    check_tile(stack_both(sk, s), stack_both(sk, s), s)


def test_band_overflow_detected_and_recounted_by_k3():
    """The band pass flags a run longer than band + 1 as the reference
    does; a handle whose overflow flag is set is recounted by the tile
    kernel's plain version (K3 on a card) in finish; the full pass has no
    overflow and exact counts."""
    s = 64
    shared = np.uint64(42)
    sk = [np.sort(np.array([shared, 100 + 13 * i, 200 + 7 * i], np.uint64)) for i in range(6)]
    rows, cols = stack_both(sk[:3], s), stack_both(sk, s)
    assert_raw_equal(rows, cols, s, chunk=16, band=2, mode="band")
    raw = TM.tile_counts_mxu(rows[1], cols[1], s, chunk=16, band=2, mode="band")
    assert bool(raw["overflow"])
    TM.reset_counts()
    flat, *rest = TM.tile_counts_mxu_start(rows[1], cols[1], s)
    flat = flat.clone()
    flat[-1] = 1  # the overflow slot, which the full pass never sets
    res = TM.tile_counts_mxu_finish((flat, *rest))
    assert TM.PASS_COUNTS["fallbacks"] == 1 and TM.PASS_COUNTS["full"] == 1
    exact = assert_exact_equal(rows, cols, s, chunk=16, band=2)
    for key in EXACT_KEYS:
        assert np.array_equal(res[key], exact[key]), key
    assert_raw_equal(rows, cols, s)
    assert not bool(TM.tile_counts_mxu(rows[1], cols[1], s)["overflow"])


def test_full_mode_long_runs_exact():
    rng = np.random.default_rng(7)
    s = 64
    core = rng.choice(1000, size=10, replace=False).astype(np.uint64)

    def member():
        mine = rng.choice(5000, size=80, replace=False).astype(np.uint64) + 2000
        return np.unique(np.concatenate([core, mine]))[:s]

    rows = stack_both([member() for _ in range(9)], s)
    cols = stack_both([member() for _ in range(11)], s)  # core runs of 20
    check_tile(rows, cols, s)


@pytest.mark.parametrize("s_cut", [4, 5, 6, 8])
def test_full_mode_run_straddles_chunk_edge(s_cut):
    """Runs of 7 straddle chunk edges (chunk = ti + tj = 7); the s-cut
    lands on and around the crossing value's rank."""
    s = 64
    vals = np.arange(1, 40, dtype=np.uint64)
    sk = [np.unique(np.concatenate([vals[:3], np.uint64(10 + 5 * i) + vals[:3]]))[:s_cut]
          for i in range(7)]
    check_tile(stack_both(sk[:3], s), stack_both(sk[3:], s), s_cut)


def test_matches_tile_counts_production():
    rng = np.random.default_rng(21)
    s = 128
    rows = stack_both([random_sketch(rng, 300, 5000, s) for _ in range(9)], s)
    cols = stack_both([random_sketch(rng, 300, 5000, s) for _ in range(11)], s)
    got = assert_exact_equal(rows, cols, s)
    want = jintersect.tile_counts(rows[0], cols[0], s)
    for key in want:
        assert np.array_equal(got[key], np.asarray(want[key])), key


def test_stream_reuse_matches_fresh():
    rng = np.random.default_rng(3)
    s = 64
    rows = stack_both([random_sketch(rng, 100, 600, s) for _ in range(4)], s)
    cols = stack_both([random_sketch(rng, 100, 600, s) for _ in range(4)], s)
    rs, cs = TM.sketch_stream(rows[1], False), TM.sketch_stream(cols[1], True)
    fresh = TM.tile_counts_mxu(rows[1], cols[1], s)
    reused = TM.tile_counts_mxu(rows[1], cols[1], s, row_stream=rs, col_stream=cs)
    for key in ("inter_full", "shared_lb", "shared_ub"):
        assert torch.equal(fresh[key], reused[key]), key
    assert_raw_equal(rows, cols, s)


def _assert_stream_equal(got, want):
    vals, pay = got
    assert np.array_equal(tu64.u64_from_keys(vals), ju64.join(np.asarray(want[0]),
                                                               np.asarray(want[1])))
    assert np.array_equal(pay.numpy().view(np.uint32), np.asarray(want[2]))


def test_stream_with_col_tag_matches_col_sort():
    """Heavy ties across 9 sketches: the derived column stream equals a
    direct column-role sort, and both equal the reference's streams."""
    rng = np.random.default_rng(11)
    s = 64
    pool = np.unique(rng.integers(0, 200, size=400, dtype=np.uint64))
    rows = stack_both([np.sort(rng.choice(pool, size=s, replace=False)) for _ in range(9)], s)
    base = TM.sketch_stream(rows[1], False)
    derived = TM.stream_with_col_tag(base)
    direct = TM.sketch_stream(rows[1], True)
    assert all(torch.equal(d, x) for d, x in zip(derived, direct))
    _assert_stream_equal(base, JM.sketch_stream(rows[0], False))
    _assert_stream_equal(direct, JM.sketch_stream(rows[0], True))


def _clone_family(s, seed):
    rng = np.random.default_rng(seed)
    root = np.unique(rng.integers(0, 2 ** 62, size=3 * s, dtype=np.uint64))
    out = []
    for share in (0.95, 0.9, 0.2, 0.15, 0.0):
        keep = rng.random(root.size) < share
        vals = np.concatenate([root[keep], rng.integers(0, 2 ** 62, size=2 * s, dtype=np.uint64)])
        out.append(np.unique(vals)[:s])
    return out


@pytest.mark.parametrize("native", ["1", "0"])
def test_prefix_resolution_and_clone_fallback(native, monkeypatch):
    """At s = 8,192 the prefix width is < s; near-clone pairs fail the
    certificate and go to the full-width pass.  MIEKKI_NATIVE_RESOLVE=0
    runs the torch resolve, 1 the native one; both equal the reference's
    exact counts (and its own resolve under the same variable)."""
    monkeypatch.setenv("MIEKKI_NATIVE_RESOLVE", native)
    s = 8192
    assert TM._resolve_prefix_width(s) == JM._resolve_prefix_width(s) < s
    sk = _clone_family(s, 99)
    rows, cols = stack_both(sk[:3], s), stack_both(sk[2:], s)
    assert_exact_equal(rows, cols, s)
    ai, aj = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    ai, aj = ai.ravel(), aj.ravel()
    planes = (ju64.split(tu64.u64_from_keys(rows[1])), ju64.split(tu64.u64_from_keys(cols[1])))
    got = TM.resolve_pairs_host(*planes, ai, aj, s)
    want = JM.resolve_pairs_host(*planes, ai, aj, s)
    ref = TI.tile_counts_plain(rows[1], cols[1], s)["shared_in_x"].numpy().ravel()
    assert np.array_equal(got, want) and np.array_equal(got, ref)


def test_prefix_certificate_rejects_clones(monkeypatch):
    """_resolve_pairs_prefix: count and certificate bitwise with the
    reference's, a clone pair refused, an unrelated one accepted with its
    exact count; a small MIEKKI_RESOLVE_W sends pairs to the full pass."""
    rng = np.random.default_rng(7)
    s = 8192
    w = TM._resolve_prefix_width(s)
    base = np.unique(rng.integers(0, 2 ** 62, size=2 * s, dtype=np.uint64))[:s]
    other = np.unique(rng.integers(0, 2 ** 62, size=2 * s, dtype=np.uint64))[:s]
    rows, cols = stack_both([base, base], s), stack_both([base, other], s)
    got = TM._resolve_pairs_prefix(rows[1][:, :w], cols[1][:, :w], s).numpy()
    want = np.asarray(JM._resolve_pairs_prefix(
        (rows[0][0][:, :w], rows[0][1][:, :w]), (cols[0][0][:, :w], cols[0][1][:, :w]), s))
    assert np.array_equal(got, want)
    assert got[1][0] == 0 and got[1][1] == 1
    monkeypatch.setenv("MIEKKI_NATIVE_RESOLVE", "0")
    monkeypatch.setenv("MIEKKI_RESOLVE_W", "64")
    assert TM._resolve_prefix_width(s) == 64
    planes = (ju64.split(tu64.u64_from_keys(rows[1])), ju64.split(tu64.u64_from_keys(cols[1])))
    ai, aj = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    ref = TI.tile_counts_plain(rows[1], cols[1], s)["shared_in_x"].numpy().ravel()
    assert np.array_equal(TM.resolve_pairs_host(*planes, ai, aj, s), ref)


def test_single_plane_full_pass_matches_pair_path():
    """The 32-bit (compact) pass equals the reference's, and equals the
    64-bit pass on (code, lo plane) values, short sketches and long runs
    included; stream_with_col_tag32 equals a direct column sort."""
    rng = np.random.default_rng(9)
    s, ti, tj = 200, 12, 16
    root = np.sort(rng.choice(2 ** 31 - 1, size=s, replace=False).astype(np.uint32) + 1)

    def table(n):
        tbl = np.full((n, s), np.uint32(0xFFFFFFFF))
        for i in range(n):
            m = int(rng.integers(5, s + 1))
            vals = np.where(rng.random(s) < 0.3, root,
                            rng.integers(1, 2 ** 31, size=s, dtype=np.uint32).astype(np.uint32))
            tbl[i, :m] = np.sort(np.unique(vals))[:m]
        return tbl

    rows, cols = table(ti), table(tj)
    trows = torch.from_numpy(tcompact.keys32_from_codes(rows))
    tcols = torch.from_numpy(tcompact.keys32_from_codes(cols))
    got = TM.tile_counts_mxu_exact32(trows, tcols, s)
    want = JM.tile_counts_mxu_exact32(jnp.asarray(rows), jnp.asarray(cols), s)
    for key in EXACT_KEYS:
        assert np.array_equal(got[key], np.asarray(want[key])), key
    raw32 = TM.tile_counts_mxu(trows, tcols, s)
    lo_r, lo_c = tcompact.lo_plane_np(rows), tcompact.lo_plane_np(cols)
    raw64 = TM.tile_counts_mxu(torch.from_numpy(tu64.keys_from_planes(rows, lo_r)),
                               torch.from_numpy(tu64.keys_from_planes(cols, lo_c)), s)
    for key in ("inter_full", "shared_lb", "shared_ub", "union_size"):
        assert torch.equal(raw32[key], raw64[key]), key
    jraw = JM._tile_counts_mxu_full32(JM.sketch_stream32(jnp.asarray(rows), False),
                                      JM.sketch_stream32(jnp.asarray(cols), True),
                                      ti, tj, s, ti + tj)
    for key in ("inter_full", "shared_lb", "shared_ub"):
        assert np.array_equal(raw32[key].numpy(), np.asarray(jraw[key])), key
    st = TM.sketch_stream32(tcols, False)
    tagged, direct = TM.stream_with_col_tag32(st), TM.sketch_stream32(tcols, True)
    assert all(torch.equal(a, b) for a, b in zip(tagged, direct))
    jd = JM.sketch_stream32(jnp.asarray(cols), True)
    assert np.array_equal(tcompact.codes_from_keys32(direct[0]), np.asarray(jd[0]))
    assert np.array_equal(direct[1].numpy().view(np.uint32), np.asarray(jd[1]))


def test_long_shared_tail_beyond_bfloat16():
    """Row 0 and column 0 hold near-identical long sketches of large
    values, every other sketch 3 small ones, so a chunk of the stream's
    tail holds only that pair's runs: m_in[0, 0] exceeds 256 in one chunk
    (a bfloat16 product would round it), and the counts stay exact.  Two
    rows against 600 columns: a chunk of 602 holds up to 301 runs."""
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
    vals, pay = TM._merge(TM.sketch_stream(rows[1], False), TM.sketch_stream(cols[1], True))
    chunk = ti + tj
    both = ((pay[:-1] == 0) & (pay[1:] == TM.COL_TAG) & (vals[:-1] == vals[1:])).nonzero()
    p = both.flatten()
    p = p[p // chunk == (p + 1) // chunk]
    assert int(torch.bincount(p // chunk).max()) > 256
    assert TM._matmul_dtype(chunk) == torch.float16
    check_tile(rows, cols, s)


def test_unknown_intersect_impl_raises(monkeypatch):
    from miekki_tpu_torch import engine as T
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.params import SketchParams

    for value, want in (("mxu", "mxu"), ("MXU", "mxu"), ("pallas", "pallas"), ("auto", "pallas"),
                        ("bitonic", "bitonic"), ("SearchSorted", "searchsorted")):
        monkeypatch.setenv("MIEKKI_INTERSECT", value)
        assert TI.intersect_impl() == want
    monkeypatch.delenv("MIEKKI_INTERSECT")
    assert TI.intersect_impl() == "pallas"
    idx = SketchIndex.from_sketches([np.arange(1, 9, dtype=np.uint64)] * 2, ["a", "b"],
                                    SketchParams(k=21, s=8))
    for value in ("nope", "xla"):
        monkeypatch.setenv("MIEKKI_INTERSECT", value)
        with pytest.raises(ValueError, match="MIEKKI_INTERSECT"):
            T.dist_counts_matrix(idx, device="cpu")


def test_batches_of_chunks_equal_one_batch(monkeypatch):
    """The pass over batches of one, two and all chunks (BATCH_BYTES) gives
    the same counts: the carried state crosses batch edges exactly."""
    rng = np.random.default_rng(23)
    s = 64
    base = np.unique(rng.integers(0, 300, size=200, dtype=np.uint64))
    sk = [np.sort(base[rng.random(base.size) < 0.7])[:s] for _ in range(8)]
    rows, cols = stack_both(sk[:3], s), stack_both(sk[3:], s)
    want = TM.tile_counts_mxu(rows[1], cols[1], s)
    for nbytes in (1, 2 * 4 * 3 * 5, 7 * 4 * 3 * 5):
        monkeypatch.setattr(TM, "BATCH_BYTES", nbytes)
        got = TM.tile_counts_mxu(rows[1], cols[1], s)
        for key in ("inter_full", "shared_lb", "shared_ub"):
            assert torch.equal(got[key], want[key]), (nbytes, key)
        band = TM.tile_counts_mxu(rows[1], cols[1], s, chunk=16, band=4, mode="band")
        monkeypatch.setattr(TM, "BATCH_BYTES", 128 << 20)
        band1 = TM.tile_counts_mxu(rows[1], cols[1], s, chunk=16, band=4, mode="band")
        for key in ("inter_full", "shared_lb", "shared_ub", "overflow"):
            assert torch.equal(band[key], band1[key]), (nbytes, key)


def test_float32_products_past_the_float16_range(monkeypatch):
    """Where chunk / 2 passes FP16_EXACT the products run in float32 (on
    the CPU and the card alike), with the same counts."""
    rng = np.random.default_rng(29)
    s = 64
    rows = stack_both([random_sketch(rng, 100, 400, s) for _ in range(6)], s)
    cols = stack_both([random_sketch(rng, 100, 400, s) for _ in range(5)], s)
    want = TM.tile_counts_mxu(rows[1], cols[1], s)
    monkeypatch.setattr(TM, "FP16_EXACT", 4)
    assert TM._matmul_dtype(6 + 5) == torch.float32
    got = TM.tile_counts_mxu(rows[1], cols[1], s)
    for key in ("inter_full", "shared_lb", "shared_ub"):
        assert torch.equal(got[key], want[key]), key
    assert_raw_equal(rows, cols, s)
