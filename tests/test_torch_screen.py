"""Port parity of read screening: miekki_tpu_torch.engine.screen against
miekki_tpu.engine.screen on the CPU, at small sizes (5 genomes of 5 kb at
3 % substitution, k = 17, s = 128, 240 reads of 90 bases, batches of
2,048-6,000 bases).  Rows must be equal in every column (integers exactly,
floats as the same float64 values), and so must the --metrics stats (apart
from the grouped path's phase_seconds), the KMV state behind the p-value
column (bitwise), and the host helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miekki_tpu import engine as J
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.io import native as j_native
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.io import native as t_native
from miekki_tpu_torch.ops import u64

from fixtures import make_genome_family, reads_from_genome, write_fasta, write_fastq

K, S, FLAT = 17, 128, 2048
MODES = {"plain": {}, "winner": {"winner": True}, "p_values": {"p_values": True}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_screen")
    rng = np.random.default_rng(42)
    genomes = make_genome_family(rng, 5, 5000, sub_rate=0.03)
    paths = [str(write_fasta(tmp / f"g{i}.fa", [(f"g{i}", g)]))
             for i, g in enumerate(genomes)]
    jidx = J.build_index(paths, JParams(k=K, s=S))
    db = tmp / "db.npz"
    jidx.save(db)
    # reads drawn from genomes 0 and 2 only
    reads = (reads_from_genome(rng, genomes[0], 120, 90)
             + reads_from_genome(rng, genomes[2], 120, 90))
    fq = str(write_fastq(tmp / "reads.fq", [(f"r{i}", r) for i, r in enumerate(reads)]))
    halves = [str(write_fastq(tmp / f"half{h}.fq",
                              [(f"r{i}", r) for i, r in enumerate(reads)
                               if (i < 120) == (h == 0)])) for h in (0, 1)]
    return {"tmp": tmp, "paths": paths, "db": db, "fq": fq, "halves": halves,
            "genome0": paths[0]}


def _indexes(setup, compact):
    j, t = JIndex.load(setup["db"]), TIndex.load(setup["db"])
    return (j.to_compact(), t.to_compact()) if compact else (j, t)


def _both(jidx, tidx, reads, **kw):
    sj, st = {}, {}
    a = J.screen(jidx, reads, stats=sj, **kw)
    b = T.screen(tidx, reads, stats=st, device="cpu", **kw)
    return a, b, sj, st


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_screen_rows_equal_reference(setup, compact, mode):
    jidx, tidx = _indexes(setup, compact)
    want, got, sj, st = _both(jidx, tidx, setup["fq"], flat=FLAT, **MODES[mode])
    assert got == want
    assert st == sj
    assert st["n_batches"] > 1 and 0 < st["n_survivors"] <= st["n_windows"]
    assert max(r["hits"] for r in got) > 0
    assert ("p_value" in got[0]) == (mode == "p_values")


@pytest.mark.parametrize("winner", [False, True], ids=["plain", "winner"])
@pytest.mark.parametrize("vals", ["200", "500"])
def test_forced_groups_equal_one_pass_and_reference(setup, monkeypatch, vals, winner):
    jidx, tidx = _indexes(setup, False)
    one = T.screen(tidx, setup["fq"], flat=FLAT, winner=winner, p_values=True,
                   device="cpu")
    monkeypatch.setenv("MIEKKI_SCREEN_DB_VALS", vals)
    want, got, sj, st = _both(jidx, tidx, setup["fq"], flat=FLAT, winner=winner,
                              p_values=True)
    assert got == one == want
    assert st.pop("phase_seconds").keys() == sj.pop("phase_seconds").keys()
    assert st == sj
    assert st["n_slabs"] >= 2


def test_forced_groups_compact(setup, monkeypatch):
    jidx, tidx = _indexes(setup, True)
    one = T.screen(tidx, setup["fq"], flat=FLAT, device="cpu")
    monkeypatch.setenv("MIEKKI_SCREEN_DB_VALS", "300")
    want, got, sj, st = _both(jidx, tidx, setup["fq"], flat=FLAT)
    assert got == one == want
    st.pop("phase_seconds"), sj.pop("phase_seconds")
    assert st == sj and st["n_slabs"] >= 2


@pytest.mark.parametrize("join", ["merge", "searchsorted"])
@pytest.mark.parametrize("chunk", ["4096", "999"])
def test_join_and_chunk_knobs_leave_rows_and_stats_unchanged(setup, monkeypatch,
                                                             join, chunk):
    """The reference's join knobs change neither its rows nor its stats;
    the port has one join and ignores them, and equals it under each."""
    jidx, tidx = _indexes(setup, False)
    default, _, s_default, _ = _both(jidx, tidx, setup["fq"], flat=FLAT, winner=True)
    monkeypatch.setenv("MIEKKI_SCREEN_JOIN", join)
    monkeypatch.setenv("MIEKKI_SCREEN_CHUNK", chunk)
    want, got, sj, st = _both(jidx, tidx, setup["fq"], flat=FLAT, winner=True)
    assert got == want == default
    assert st == sj == s_default


def test_kmv_state_equals_reference_bitwise(setup):
    """After a multi-batch stream (more distinct hashes than s0, so the
    state truncates) the port's state holds the reference's values."""
    j_state = J._kmv_init()
    t_state = T._kmv_init()
    n = 0
    for batch in T._packed_read_batches(setup["fq"], K, FLAT):
        j_state = J._kmv_update(*j_state, jnp.asarray(batch), K, J._KMV_S0)
        t_state = T._kmv_update(t_state, T._hash_batch(torch.from_numpy(batch), K))
        n += 1
    assert n > 1
    want = u64.join(np.asarray(j_state[0]), np.asarray(j_state[1]))
    got = u64.u64_from_keys(t_state)
    assert np.array_equal(got, want)
    assert got[-1] != u64.UINT64_MAX  # the state filled up
    assert T._kmv_estimate(t_state) == J._kmv_estimate(j_state)


def _no_native(monkeypatch):
    monkeypatch.setenv("MIEKKI_NATIVE_IO", "0")
    for mod in (t_native, j_native):
        monkeypatch.setattr(mod, "_lib_checked", False)
        monkeypatch.setattr(mod, "_lib", None)


@pytest.mark.parametrize("case", ["long_record_python", "long_record_native",
                                  "flat6000", "two_files"])
def test_read_layouts_equal_reference(setup, monkeypatch, case):
    jidx, tidx = _indexes(setup, False)
    if case.startswith("long_record"):
        # a 5 kb record is longer than the 2,048-base batch: the Python
        # packer splits it with k - 1 overlap, the native one slices rows
        if case.endswith("python"):
            _no_native(monkeypatch)
        want, got, sj, st = _both(jidx, tidx, setup["genome0"], flat=2048)
        assert got[0]["containment"] == 1.0
    elif case == "flat6000":
        want, got, sj, st = _both(jidx, tidx, setup["fq"], flat=6000, p_values=True)
    else:
        want, got, sj, st = _both(jidx, tidx, setup["halves"], flat=FLAT, winner=True)
        whole = T.screen(tidx, setup["fq"], flat=FLAT, winner=True, device="cpu")
        assert [r["hits"] for r in got] == [r["hits"] for r in whole]
    assert got == want
    assert st == sj


def test_empty_db_gives_reference_rows(setup):
    empty = JParams(k=K, s=S)
    j0 = JIndex.from_sketches([], [], empty)
    t0 = TIndex.from_sketches([], [], T.SketchParams(k=K, s=S))
    assert T.screen(t0, setup["fq"], flat=FLAT, device="cpu") == \
        J.screen(j0, setup["fq"], flat=FLAT) == []
    blank = [np.zeros(0, np.uint64)] * 2
    j2 = JIndex.from_sketches(blank, ["a", "b"], empty)
    t2 = TIndex.from_sketches(blank, ["a", "b"], T.SketchParams(k=K, s=S))
    want, got, sj, st = _both(j2, t2, setup["fq"], flat=FLAT, p_values=True)
    assert got == want and len(got) == 2 and got[0]["hits"] == 0
    assert st == sj == {}


def test_screen_asked_for_cuda_without_a_card_raises(setup, monkeypatch):
    """No CPU path runs when the caller asked for the card."""
    _, tidx = _indexes(setup, False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T.screen(tidx, setup["fq"], flat=FLAT)


def test_helpers_equal_reference():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1 << 64, size=200_000, dtype=np.uint64)
    v[::7] = v[0]  # equal-value runs spanning the sign bit
    v[1::11] = np.uint64(1 << 63)
    big = np.concatenate([v] * 6)  # above the 2^20 torch-path threshold
    for x in (v, big):
        assert np.array_equal(T._stable_argsort_u64(x), J._stable_argsort_u64(x))
    sv = np.sort(v)
    assert np.array_equal(T._first_occ_idx(sv), J._first_occ_idx(sv))
    assert np.array_equal(T._first_occ_idx(np.zeros(0, np.uint64)),
                          J._first_occ_idx(np.zeros(0, np.uint64)))
    for n in (1, 8, 12_345):
        acc = rng.random(n) < 0.3
        assert np.array_equal(T._pull_bitmap(torch.from_numpy(acc)), acc)
        assert np.array_equal(T._pull_bitmap(torch.from_numpy(acc)),
                              J._pull_bitmap(jnp.asarray(acc)))
    vals = np.repeat(rng.integers(0, 1 << 62, size=300, dtype=np.uint64), 3)
    gid = rng.integers(0, 9, size=vals.size).astype(np.int32)
    hit = rng.random(vals.size) < 0.4
    sizes = rng.integers(1, 200, size=9)
    assert np.array_equal(T._winner_from_hitall(vals, gid, hit, 9, sizes),
                          J._winner_from_hitall(vals, gid, hit, 9, sizes))
    sv = np.sort(vals)
    acc = np.concatenate([rng.random(sv.size) < 0.4, [False]])
    assert np.array_equal(T._hits_winner_takes_all(sv, gid, acc, 9, sizes),
                          J._hits_winner_takes_all(sv, gid, acc, 9, sizes))


@pytest.mark.parametrize("path", ["native", "python"])
def test_packed_read_batches_equal_reference(setup, monkeypatch, path):
    if path == "python":
        _no_native(monkeypatch)
    assert t_native.available() == (path == "native") == j_native.available()
    for src, flat in ((setup["fq"], FLAT), (setup["genome0"], 2048), (setup["fq"], 6000)):
        got = list(T._packed_read_batches(src, K, flat))
        want = list(J._packed_read_batches(src, K, flat))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


def test_flat_db_matches_reference(setup):
    """The card-side flat DB (one stable sort of the key table) equals the
    reference's host flatten, raw and compact."""
    for compact in (False, True):
        jidx, tidx = _indexes(setup, compact)
        db, vals, gids = T._flatten_db(tidx, "cpu")
        want_v, want_g = J._flatten_db(jidx)
        assert np.array_equal(vals, want_v) and np.array_equal(gids, want_g)
        assert vals.dtype == want_v.dtype and gids.dtype == want_g.dtype
        assert np.array_equal(u64.u64_from_keys(db), want_v)


def test_budgets_cap_groups_by_the_flat_db_build(setup, monkeypatch):
    """Both screen budgets are the reference's, capped by the port's
    on-device flat-DB build; MIEKKI_SCREEN_DB_VALS overrides both.  Under a
    memory limit that the 640-value DB exceeds, the port screens in more
    groups than the reference and gives its rows."""
    from miekki_tpu_torch.utils import hbm

    for limit in ("40000", str(16 << 30), str(80 << 30)):
        monkeypatch.setenv("MIEKKI_HBM_LIMIT", limit)
        cap = int(int(limit) * hbm.SCREEN_RESIDENT_FRAC) // hbm.SCREEN_FLATTEN_BYTES_PER_VALUE
        assert hbm.screen_flatten_value_budget("cpu") == cap
        assert T._screen_db_value_budgets("cpu") == (
            min(hbm.screen_merge_value_budget("cpu"), cap),
            min(hbm.screen_resident_value_budget("cpu"), cap))
    monkeypatch.setenv("MIEKKI_SCREEN_DB_VALS", "77")
    assert T._screen_db_value_budgets("cpu") == (77, 77)
    monkeypatch.delenv("MIEKKI_SCREEN_DB_VALS")
    monkeypatch.setenv("MIEKKI_HBM_LIMIT", "40000")
    jidx, tidx = _indexes(setup, False)
    want, got, sj, st = _both(jidx, tidx, setup["fq"], flat=FLAT, winner=True)
    assert got == want
    per_group = T._screen_db_value_budgets("cpu")[1]
    assert st["n_slabs"] > sj["n_slabs"] >= 1 and per_group < 640
    for key in ("n_windows", "n_batches"):
        assert st[key] == sj[key]
