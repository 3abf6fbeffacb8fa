"""Port parity: compact (32-bit fingerprint) indexes — miekki_tpu_torch's
ops.compact, the compact SketchIndex, the K4 plain version
(ops.intersect.tile_counts_compact_plain) and the compact dist path —
against the JAX package's ops/compact.py, index/store.py, its Pallas
compact tile kernel (interpret mode) and pair_counts32.  Tolerance: none —
codes and counts are integers, TSVs are compared as bytes."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miekki_tpu import engine as JE
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.ops import compact as JC
from miekki_tpu.ops import intersect as JI
from miekki_tpu.ops import pallas_intersect as JPI
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu_torch import engine as TE
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.index.store import index_to_device
from miekki_tpu_torch.ops import compact as TC
from miekki_tpu_torch.ops import cuda_intersect32 as TCI32
from miekki_tpu_torch.ops import intersect as TI
from miekki_tpu_torch.ops import u64 as tu64
from miekki_tpu_torch.params import SketchParams as TParams

KEYS = ("shared_in_x", "union_size", "inter_full")
INF32 = np.uint32(0xFFFFFFFF)
O_INF = np.uint64(0xFFFFFFFFFFFFFFFF)


def _edge_values(rng, n):
    """uint64 values across every exponent, the encoder's edges included."""
    edges = np.array([0, 1, 2, 3, 1 << 25, (1 << 26) + 5, (1 << 27) - 1, 1 << 32,
                      (1 << 32) + 1, 1 << 63, 0xFFFFFFFFFFFFFFFE,
                      0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFF00], dtype=np.uint64)
    shifts = rng.integers(0, 64, size=n).astype(np.uint64)
    rand = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) >> shifts
    return np.concatenate([edges, rand * np.uint64(2) + np.uint64(1), rand])


def _colliding_table(rng, n, s):
    """[n, s] sorted u64 sketches holding near-adjacent values (code
    collisions), some rows short."""
    base = rng.integers(0, 2**40, size=(n, s // 2), dtype=np.uint64)
    vals = np.sort(np.concatenate(
        [base, base + rng.integers(1, 3, base.shape, dtype=np.uint64)], axis=1), axis=1)
    vals[1, s - 30:] = O_INF
    vals[2, 5:] = O_INF
    return vals


def test_encode_pair_matches_reference():
    vals = _edge_values(np.random.default_rng(1), 4000)
    hi, lo = (vals >> np.uint64(32)).astype(np.uint32), (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = np.asarray(JC.encode_pair(jnp.asarray(hi), jnp.asarray(lo)))
    assert np.array_equal(want, JC.encode_u64(vals))
    for h, l in ((hi.astype(np.int64), lo.astype(np.int64)),
                 (hi.view(np.int32), lo.view(np.int32))):  # int32: raw uint32 bits
        got = TC.encode_pair(torch.from_numpy(h), torch.from_numpy(l))
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy().astype(np.uint32), want)
    x = torch.from_numpy(np.array([0, 1, 2, 3, 255, 1 << 16, 0xFFFFFFFF], np.int64))
    assert TC._clz32(x).tolist() == [32, 31, 30, 30, 24, 15, 0]


def test_compact_rows_matches_reference_and_to_compact():
    rng = np.random.default_rng(33)
    vals = _colliding_table(rng, 12, 128)
    hi, lo = (vals >> np.uint64(32)).astype(np.uint32), (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = np.asarray(JC.compact_rows(jnp.asarray(hi), jnp.asarray(lo)))
    keys32 = TC.compact_rows(torch.from_numpy(tu64.keys_from_u64(vals)))
    assert keys32.dtype == torch.int32
    assert np.array_equal(TC.codes_from_keys32(keys32), want)
    names = [f"g{i}" for i in range(len(vals))]
    t_idx = TIndex(TParams(k=31, s=128), names, hi, lo).to_compact()
    assert np.array_equal(t_idx.hi, want)
    assert np.array_equal(TC.lo_plane(keys32).numpy().astype(np.uint32),
                          np.asarray(JC.lo_plane(jnp.asarray(want))))
    assert np.array_equal(TC.lo_plane(keys32).numpy().astype(np.uint32), t_idx.lo)


def test_to_compact_and_cardinalities_match_reference():
    rng = np.random.default_rng(7)
    vals = _colliding_table(rng, 9, 200)
    vals[4] = np.sort(rng.integers(0, 2**64 - 2, size=200, dtype=np.uint64))
    vals[5, 1:] = O_INF  # one value: j < 2 branch
    sketches = [row[row != O_INF] for row in vals]
    names = [f"g{i}" for i in range(len(vals))]
    t_raw = TIndex.from_sketches(sketches, names, TParams(k=21, s=200))
    j_raw = JIndex.from_sketches(sketches, names, JParams(k=21, s=200))
    t_c, j_c = t_raw.to_compact(), j_raw.to_compact()
    assert t_c.params.compact and t_c.to_compact() is t_c
    assert t_c.params.to_dict() == j_c.params.to_dict()
    for a, b in ((t_c.hi, j_c.hi), (t_c.lo, j_c.lo), (t_c.sizes(), j_c.sizes())):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tc, jc = t_c.cardinalities(), j_c.cardinalities()
    assert tc.dtype == jc.dtype == np.float64 and np.array_equal(tc, jc)
    for i in range(len(vals)):
        assert np.array_equal(t_c.sketch_u64(i), j_c.sketch_u64(i))
    assert (t_c.sizes() < t_raw.sizes()).any()  # collisions were deduplicated
    keys = index_to_device(t_c, "cpu")
    assert keys.dtype == torch.int32
    assert np.array_equal(TC.codes_from_keys32(keys), t_c.hi)


def test_save_load_across_packages(tmp_path):
    rng = np.random.default_rng(9)
    vals = _colliding_table(rng, 6, 64)
    sketches = [row[row != O_INF] for row in vals]
    names = [f"g{i}" for i in range(6)]
    t_c = TIndex.from_sketches(sketches, names, TParams(k=21, s=64)).to_compact()
    j_c = JIndex.from_sketches(sketches, names, JParams(k=21, s=64)).to_compact()
    t_path, j_path = tmp_path / "t.npz", tmp_path / "j.npz"
    t_c.save(t_path)
    j_c.save(j_path)
    with np.load(t_path) as z, np.load(j_path) as y:
        assert sorted(z.files) == sorted(y.files) == ["header", "hi"]
        assert bytes(z["header"]) == bytes(y["header"])
        assert np.array_equal(z["hi"], y["hi"])
    for idx in (TIndex.load(j_path), JIndex.load(t_path), TIndex.load(t_path)):
        assert idx.params.compact and idx.names == names
        assert np.array_equal(idx.hi, t_c.hi) and np.array_equal(idx.lo, t_c.lo)


def _code_table(rng, n_rows, sp, pool_size, full_every=3):
    """[n_rows, sp] uint32 code table: sorted distinct codes from a shared
    pool (so rows overlap), code 0 present, sentinel-padded, some rows full."""
    pool = np.unique(np.concatenate(
        [[0], rng.choice(0xFFFFFFFE, size=pool_size, replace=False)])).astype(np.uint32)
    tab = np.full((n_rows, sp), INF32, np.uint32)
    for i in range(n_rows):
        m = sp if i % full_every == 0 else int(rng.integers(0, sp + 1))
        tab[i, :m] = np.sort(rng.choice(pool, size=m, replace=False))
    return tab


@pytest.mark.parametrize("sp,s,ti,tj", [(128, 100, 5, 7), (256, 256, 9, 4),
                                        (512, 400, 3, 16)])
def test_plain_tile_counts32_match_pallas32_and_pair_counts32(sp, s, ti, tj):
    rng = np.random.default_rng(sp + ti)
    tab = _code_table(rng, ti + tj, sp, 3 * sp)
    keys = torch.from_numpy(TC.keys32_from_codes(tab))
    got = TI.tile_counts_compact(keys[:ti], keys[ti:], s)
    want = JPI.tile_counts_pallas32(jnp.asarray(tab[:ti]), jnp.asarray(tab[ti:]), s,
                                    interpret=True)
    for key in KEYS + ("n_a", "n_b"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    for i in range(ti):
        for j in range(min(tj, 4)):
            pc = TI.pair_counts32(keys[i], keys[ti + j], s)
            ref = JI.pair_counts32(jnp.asarray(tab[i]), jnp.asarray(tab[ti + j]), s)
            for key in KEYS:
                assert int(pc[key]) == int(ref[key]) == int(got[key][i, j]), (i, j, key)
            assert ((int(pc["n_a"]), int(pc["n_b"])) == (int(ref["n_a"]), int(ref["n_b"]))
                    == (int(got["n_a"][i]), int(got["n_b"][j])))


def test_compact_zero_head_ties():
    """Code 0 present in both sketches (the zero-head case of
    tests/test_pallas_kernels.py:108, on codes)."""
    s = 300
    rng = np.random.default_rng(5)
    a = np.unique(np.concatenate([[0], rng.integers(0, 1000, 280)])).astype(np.uint32)[:s]
    b = np.unique(np.concatenate([[0, 1], rng.integers(0, 1000, 280)])).astype(np.uint32)[:s]
    tab = np.full((2, 384), INF32, np.uint32)
    tab[0, :len(a)] = a
    tab[1, :len(b)] = b
    keys = torch.from_numpy(TC.keys32_from_codes(tab))
    got = TI.tile_counts_compact(keys[:1], keys[1:], s)
    want = JPI.tile_counts_pallas32(jnp.asarray(tab[:1]), jnp.asarray(tab[1:]), s,
                                    interpret=True)
    for key in KEYS:
        assert int(got[key][0, 0]) == int(np.asarray(want[key])[0, 0]), key
        assert int(got[key][0, 0]) == int(TI.pair_counts32(keys[0], keys[1], s)[key]), key


def test_wrapper32_on_cpu_runs_plain_version_without_launching():
    rng = np.random.default_rng(2)
    keys = TI._pad_lane(torch.from_numpy(TC.keys32_from_codes(_code_table(rng, 5, 100, 300))))
    assert keys.shape[1] == 128 and bool((keys[:, 100:] == TC.INF_KEY32).all())
    before = TCI32.tile_counts32_cuda.launches
    got = TCI32.tile_counts32_cuda(keys[:2], keys[2:], 100)
    assert TCI32.tile_counts32_cuda.launches == before
    want = TI.tile_counts_compact_plain(keys[:2], keys[2:], 100)
    for key in KEYS + ("n_a", "n_b"):
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(ValueError):
        TCI32.tile_counts32_cuda(keys[:2].to(torch.int64), keys[2:], 100)
    with pytest.raises(ValueError):
        TCI32.tile_counts32_cuda(keys[:2, :64], keys[2:], 100)
    with pytest.raises(ValueError):
        TI.tile_counts_compact_plain(keys[:2].to(torch.int64), keys[2:].to(torch.int64), 100)


@pytest.fixture(scope="module")
def raw_sketches():
    rng = np.random.default_rng(21)
    pool = np.unique(rng.integers(0, 2**64 - 1, size=900, dtype=np.uint64))
    sketches = [np.unique(rng.choice(pool, size=int(rng.integers(50, 260)), replace=False))[:250]
                for _ in range(7)]
    sketches.append(np.unique(np.concatenate([sketches[0][:200], pool[:5]]))[:250])
    return sketches, [f"g{i}" for i in range(len(sketches))]


@pytest.mark.parametrize("tile", [3, 512])
def test_compact_dist_tsv_matches_reference(raw_sketches, tile):
    sketches, names = raw_sketches
    t_c = TIndex.from_sketches(sketches, names, TParams(k=21, s=250)).to_compact()
    j_c = JIndex.from_sketches(sketches, names, JParams(k=21, s=250)).to_compact()
    cols = TE.select_columns(True, True)
    buf = io.StringIO()
    n = TE.dist_tsv_write(buf, t_c, tile=tile, columns=cols, device="cpu")
    jbuf = io.StringIO()
    JE.dist_tsv_write(jbuf, j_c, tile=tile, columns=cols)
    assert n == len(names) * (len(names) - 1) // 2
    assert buf.getvalue() == jbuf.getvalue()
    rows = TE.dist(t_c, tile=tile, device="cpu")
    assert TE.rows_to_tsv(rows) == JE.rows_to_tsv(JE.dist(j_c, tile=tile))


def test_compact_against_raw_is_refused(raw_sketches):
    sketches, names = raw_sketches
    raw = TIndex.from_sketches(sketches, names, TParams(k=21, s=250))
    with pytest.raises(ValueError, match="incompatible"):
        list(TE.dist_tiles(raw, raw.to_compact(), device="cpu"))
    rect = TE.dist(raw.to_compact(), raw.to_compact(), tile=4, device="cpu")
    assert len(rect) == len(names) ** 2
