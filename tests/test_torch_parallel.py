"""Port parity of the multi-device paths (miekki_tpu_torch.parallel) in one
process, against miekki_tpu.parallel on conftest's 8 faked CPU devices.

The port's positions are ``["cpu"] * D`` (one device named D times, each a
mesh position of its own).  Count matrices must be bitwise equal (every
output is an integer), screen rows equal in every column and the stats
equal.  Sizes: at most 64 genomes, s <= 128, D <= 8."""

import os

import jax
import numpy as np
import pytest
import torch

from miekki_tpu import engine as J
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.parallel import allvsall as jring
from miekki_tpu.parallel import dist_sharded as jdist_sharded
from miekki_tpu.parallel import local_mesh as jlocal_mesh
from miekki_tpu.parallel import screen as jscreen
from miekki_tpu.parallel import screen_sharded as jscreen_sharded
from miekki_tpu.parallel.mesh import DATA_AXIS as J_DATA, DB_AXIS as J_DB
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.params import SketchParams as TParams
from miekki_tpu_torch.parallel import (dist_sharded, dist_sharded_hostring,
                                       initialize_distributed, local_mesh, screen_sharded)
from miekki_tpu_torch.parallel import allvsall as tring
from miekki_tpu_torch.parallel import screen as tscreen
from miekki_tpu_torch.parallel.mesh import DATA_AXIS, DB_AXIS

from fixtures import make_genome_family, reads_from_genome, write_fasta, write_fastq

KEYS = ("shared", "union", "inter")


def _both(sketches, s, k=21):
    names = [f"g{i}" for i in range(len(sketches))]
    return (JIndex.from_sketches(sketches, names, JParams(k=k, s=s)),
            TIndex.from_sketches(sketches, names, TParams(k=k, s=s)))


def _family_sketches(n, s, seed, short_every=5):
    """Heavy sharing (a pool of 4 s values), every `short_every`-th sketch
    short, so sentinel padding flows through every stage."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2 ** 63, size=8 * s, dtype=np.uint64))[: 4 * s]
    out = []
    for i in range(n):
        sk = np.unique(pool[rng.choice(4 * s, size=s + 20, replace=False)])[:s]
        out.append(sk[: s // 3] if i % short_every == short_every - 1 else sk)
    return out


def _sub(idx, a, b):
    return type(idx)(idx.params, idx.names[a:b], idx.hi[a:b], idx.lo[a:b])


_JAX_CACHE = {}


@pytest.fixture(scope="module")
def cases():
    """case → (JAX index A, JAX index B or None, port A, port B or None).
    N = 16 and 23 (not divisible by 3 or 8), raw, compact and A-vs-B."""
    j16, t16 = _both(_family_sketches(16, 64, 0), 64)
    j23, t23 = _both(_family_sketches(23, 48, 1, short_every=4), 48)
    return {
        "raw": (j16, None, t16, None),
        "uneven": (j23, None, t23, None),
        "compact": (j16.to_compact(), None, t16.to_compact(), None),
        "rect": (_sub(j23, 0, 7), j23, _sub(t23, 0, 7), t23),
    }


def _jax_counts(cases, case):
    """miekki_tpu.parallel.dist_sharded on conftest's 8-device mesh (its
    result does not depend on the mesh: the JAX package's own tests)."""
    if case not in _JAX_CACHE:
        ja, jb, _, _ = cases[case]
        _JAX_CACHE[case] = jdist_sharded(ja, jlocal_mesh(axis_names=(J_DB,)), index_b=jb)
    return _JAX_CACHE[case]


def _assert_counts_equal(got, want):
    for key in KEYS:
        assert got[key].dtype == np.int32, key
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("case", ["raw", "uneven", "compact", "rect"])
@pytest.mark.parametrize("D", [1, 3, 8])
def test_hostring_equals_jax(cases, case, D):
    _, _, ta, tb = cases[case]
    got = dist_sharded_hostring(ta, ["cpu"] * D, tile=3, index_b=tb)
    _assert_counts_equal(got, _jax_counts(cases, case))


@pytest.mark.parametrize("D", [1, 3, 8])
def test_dist_sharded_routes_equal_jax(cases, D, monkeypatch):
    """D > 1 positions run the host ring, one position dist_counts_matrix
    symmetrised; both equal the reference."""
    calls = []
    real = tring.dist_sharded_hostring
    monkeypatch.setattr(tring, "dist_sharded_hostring",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, _, ta, _ = cases["uneven"]
    got = dist_sharded(ta, local_mesh(devices=["cpu"] * D), tile=4)
    assert bool(calls) == (D > 1)
    _assert_counts_equal(got, _jax_counts(cases, "uneven"))


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_dist_sharded_2d_mesh_rings_over_its_axis(cases, shape):
    _, _, ta, _ = cases["uneven"]
    mesh = local_mesh(shape=shape, axis_names=(DATA_AXIS, DB_AXIS), devices=["cpu"] * 8)
    assert [str(d) for d in mesh.axis_devices(DB_AXIS)] == ["cpu"] * shape[1]
    _assert_counts_equal(dist_sharded(ta, mesh, tile=3), _jax_counts(cases, "uneven"))


def test_diagonal_from_the_kernel_equals_dist_counts_matrix(cases):
    """The host ring's diagonal comes from the kernel (a sketch against
    itself); dist_counts_matrix fills it by hand; the upper triangles are
    the same counts."""
    _, _, ta, _ = cases["uneven"]
    ring = dist_sharded_hostring(ta, ["cpu"] * 3, tile=4)
    bulk = T.dist_counts_matrix(ta, tile=4, device="cpu")
    sizes = ta.sizes()
    s = ta.params.s
    for key in KEYS:
        assert np.array_equal(np.diagonal(ring[key]), np.diagonal(bulk[key])), key
        assert np.array_equal(np.triu(ring[key]), np.triu(bulk[key])), key
        assert np.array_equal(ring[key], ring[key].T), key
    assert np.array_equal(np.diagonal(ring["inter"]), sizes)
    assert np.array_equal(np.diagonal(ring["shared"]), np.minimum(sizes, s))


class _Interrupted(Exception):
    pass


def test_checkpoint_interrupted_then_resumed(cases, tmp_path, monkeypatch):
    """A run that dies after writing step 1 resumes from it (replaying the
    rotations only) to the uninterrupted result; its step files hold the
    reference's members, `inter` equal to the reference hostring's."""
    ja, _, ta, _ = cases["raw"]
    want = _jax_counts(cases, "raw")
    ckpt = tmp_path / "ckpt"
    real = tring._save_checkpoint

    def die_after_step1(path, t, shared, inter, amb=None):
        real(path, t, shared, inter, amb=amb)
        if t == 1:
            raise _Interrupted

    monkeypatch.setattr(tring, "_save_checkpoint", die_after_step1)
    with pytest.raises(_Interrupted):
        dist_sharded_hostring(ta, ["cpu"] * 8, tile=3, checkpoint=str(ckpt))
    monkeypatch.setattr(tring, "_save_checkpoint", real)
    assert sorted(os.listdir(ckpt)) == ["hostring_step0.npz", "hostring_step1.npz"]
    launches = []
    real_counts = T._intersect.tile_counts

    def counting(*a, **kw):
        launches.append(1)
        return real_counts(*a, **kw)

    monkeypatch.setattr(T._intersect, "tile_counts", counting)
    resumed = dist_sharded_hostring(ta, ["cpu"] * 8, tile=3, checkpoint=str(ckpt))
    assert len(launches) == 6 * 1 * 8  # steps 2..7, one sub-tile pair, 8 positions
    _assert_counts_equal(resumed, want)
    jckpt = tmp_path / "jax_ckpt"
    jring.dist_sharded_hostring(ja, mxu_tile=3, checkpoint=str(jckpt))
    for t in range(8):
        with np.load(ckpt / f"hostring_step{t}.npz") as z, \
                np.load(jckpt / f"hostring_step{t}.npz") as zj:
            assert sorted(z.files) == sorted(zj.files)
            assert np.array_equal(z["inter"], zj["inter"]), t
            assert z["amb_i"].size == z["amb_j"].size == 0


@pytest.mark.parametrize("window", ["16", "1"])
def test_window_of_2d_launches(cases, window, monkeypatch):
    """MIEKKI_HOSTRING_WINDOW = 2 · D over 8 positions (16), and a value
    below the minimum over 3 positions (held at 2 · D = 6)."""
    monkeypatch.setenv("MIEKKI_HOSTRING_WINDOW", window)
    _, _, ta, tb = cases["rect"]
    got = dist_sharded_hostring(ta, ["cpu"] * (8 if window == "16" else 3), tile=2,
                                index_b=tb)
    _assert_counts_equal(got, _jax_counts(cases, "rect"))


@pytest.mark.parametrize("D,nl_rows,nl_cols", [(1, 3, 2), (3, 2, 5), (8, 1, 3)])
def test_unrotate_equals_jax(D, nl_rows, nl_cols):
    rng = np.random.default_rng(D)
    x = rng.integers(0, 1000, size=(D, D * nl_rows, nl_cols), dtype=np.int32)
    want = np.asarray(jring._unrotate(jax.numpy.asarray(x), D=D, nl_rows=nl_rows,
                                      nl_cols=nl_cols))
    got = tring._unrotate(torch.from_numpy(x), D=D, nl_rows=nl_rows, nl_cols=nl_cols)
    assert np.array_equal(got.numpy(), want)
    sq = rng.integers(0, 1000, size=(D, D * nl_rows, nl_rows), dtype=np.int32)
    assert np.array_equal(tring.unrotate_chunks(sq, D=D), jring.unrotate_chunks(sq, D=D))


def test_local_mesh_positions():
    mesh = local_mesh(device="cpu")
    assert mesh.shape == {DB_AXIS: 1} and mesh.group is None
    assert [str(d) for d in mesh.devices.flat] == ["cpu"]
    mesh = local_mesh(shape=(2, 3), axis_names=(DATA_AXIS, DB_AXIS), devices=["cpu"] * 6)
    assert mesh.shape == {DATA_AXIS: 2, DB_AXIS: 3} and mesh.axis_names == (DATA_AXIS, DB_AXIS)
    assert len(mesh.axis_devices(DATA_AXIS)) == 2
    with pytest.raises(ValueError, match="mesh shape"):
        local_mesh(shape=(4,), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axis_names"):
        local_mesh(shape=(3,), axis_names=(DATA_AXIS, DB_AXIS), devices=["cpu"] * 3)


def test_initialize_distributed_is_a_noop_without_an_address(monkeypatch):
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_padding_rows_count_nothing():
    """3 sketches over 8 positions: 5 sentinel rows per side pad the ring
    and contribute nothing (the reference's test_ring_counts_padding_rows)."""
    sketches = [np.sort(np.random.default_rng(i).integers(0, 2 ** 63, size=16,
                                                          dtype=np.uint64)) for i in range(3)]
    jidx, tidx = _both(sketches, 16)
    got = dist_sharded(tidx, local_mesh(devices=["cpu"] * 8))
    assert got["shared"].shape == (3, 3)
    assert (np.diag(got["union"]) == 16).all()
    _assert_counts_equal(got, jdist_sharded(jidx, jlocal_mesh(axis_names=(J_DB,))))


def test_cli_distributed_without_a_card_raises(cases, tmp_path, monkeypatch):
    """`--distributed` on cuda without a card raises, as every entry point
    does: no CPU fallback."""
    from miekki_tpu_torch import cli

    _, _, ta, _ = cases["raw"]
    db = tmp_path / "db.npz"
    ta.save(db)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["dist", str(db), "--distributed", "-o", str(tmp_path / "d.tsv")])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["screen", str(db), str(db), "--distributed", "-o", str(tmp_path / "s.tsv")])
    assert not (tmp_path / "d.tsv").exists()


def test_cuda_without_a_card_raises(cases, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, ta, _ = cases["raw"]
    with pytest.raises(RuntimeError, match="cuda"):
        local_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        dist_sharded_hostring(ta)
    with pytest.raises(RuntimeError, match="cuda"):
        local_mesh(devices=["cuda:0"] * 2)


# ---------------------------------------------------------------- screen

K, S, FLAT = 17, 128, 2048
MODES = {"plain": {}, "winner": {"winner": True}, "p_values": {"p_values": True}}


@pytest.fixture(scope="module")
def screen_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parallel_screen")
    rng = np.random.default_rng(43)
    genomes = make_genome_family(rng, 6, 4000, sub_rate=0.03)
    paths = [str(write_fasta(tmp / f"g{i}.fa", [(f"g{i}", g)]))
             for i, g in enumerate(genomes)]
    jidx = J.build_index(paths, JParams(k=K, s=S))
    tidx = TIndex(TParams(k=K, s=S), jidx.names, jidx.hi, jidx.lo)
    reads = (reads_from_genome(rng, genomes[1], 140, 90)
             + reads_from_genome(rng, genomes[4], 60, 90))
    fq = str(write_fastq(tmp / "reads.fq", [(f"r{i}", r) for i, r in enumerate(reads)]))
    return jidx, tidx, fq


_MESHES = {
    "1d_d8": ((8,), (J_DATA,), None),
    "2d_4x2_db": ((4, 2), (J_DATA, J_DB), J_DB),
    "2d_2x4_db": ((2, 4), (J_DATA, J_DB), J_DB),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", list(_MESHES))
def test_screen_sharded_equals_jax_and_engine(screen_setup, layout, mode):
    jidx, tidx, fq = screen_setup
    shape, names, db_axis = _MESHES[layout]
    jstats, tstats, estats = {}, {}, {}
    want = jscreen_sharded(jidx, fq, jlocal_mesh(shape=shape, axis_names=names), flat=FLAT,
                           db_axis=db_axis, stats=jstats, **MODES[mode])
    mesh = local_mesh(shape=shape, axis_names=(DATA_AXIS, DB_AXIS)[:len(shape)],
                      devices=["cpu"] * 8)
    got = screen_sharded(tidx, fq, mesh, flat=FLAT, db_axis=db_axis and DB_AXIS,
                         stats=tstats, **MODES[mode])
    assert got == want
    assert tstats == jstats
    assert got == T.screen(tidx, fq, flat=FLAT, stats=estats, device="cpu", **MODES[mode])
    assert sum(r["hits"] for r in got) > 0
    assert (tstats["n_windows"], tstats["n_survivors"]) == (estats["n_windows"],
                                                            estats["n_survivors"])


@pytest.mark.parametrize("group", [1, 3])
def test_batch_groups_equal_jax(screen_setup, group):
    _, _, fq = screen_setup
    want = list(jscreen._batch_groups(fq, K, FLAT, group))
    got = list(tscreen._batch_groups(fq, K, FLAT, group))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert np.array_equal(np.stack(g), w)


# ------------------------------------------- device planes and the stream pass


@pytest.mark.parametrize("impl", ["auto", "mxu"])
@pytest.mark.parametrize("case", ["raw", "rect"])
def test_hostring_device_planes_build_no_host_table(cases, case, impl, monkeypatch):
    """A raw side with device_planes on the positions' device is cut from
    them (index_to_device never runs for it): bitwise equal to the
    host-planes run and to the reference's host ring."""
    if impl == "mxu":
        monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    ja, jb, ta, tb = cases[case]
    host = dist_sharded_hostring(ta, ["cpu"] * 3, tile=3, index_b=tb)

    def with_planes(idx):
        out = TIndex(idx.params, idx.names, idx.hi, idx.lo)
        out.device_planes = tring.index_to_device(idx, "cpu").clone()
        return out

    pa = with_planes(ta)
    pb = None if tb is None else with_planes(tb)
    built = []
    real = tring.index_to_device
    monkeypatch.setattr(tring, "index_to_device",
                        lambda idx, *a, **kw: built.append(idx) or real(idx, *a, **kw))
    got = dist_sharded_hostring(pa, ["cpu"] * 3, tile=3, index_b=pb)
    assert built == []
    _assert_counts_equal(got, host)
    _assert_counts_equal(got, jring.dist_sharded_hostring(ja, jax.devices()[:3], mxu_tile=3,
                                                          index_b=jb))


def test_hostring_compact_device_planes_keep_the_host_path(cases, monkeypatch):
    """A compact side keeps the host path (as the reference's), planes or
    not."""
    _, _, ta, _ = cases["compact"]
    planes = TIndex(ta.params, ta.names, ta.hi, ta.lo)
    planes.device_planes = tring.index_to_device(ta, "cpu").clone()
    built = []
    real = tring.index_to_device
    monkeypatch.setattr(tring, "index_to_device",
                        lambda idx, *a, **kw: built.append(idx) or real(idx, *a, **kw))
    got = dist_sharded_hostring(planes, ["cpu"] * 3, tile=3)
    assert built == [planes]
    _assert_counts_equal(got, _jax_counts(cases, "compact"))


@pytest.mark.parametrize("case", ["raw", "uneven", "compact", "rect"])
@pytest.mark.parametrize("D", [1, 3, 8])
def test_hostring_mxu_equals_jax(cases, case, D, monkeypatch):
    """MIEKKI_INTERSECT=mxu: the stream pass per sub-tile pair, no K3/K4,
    one deferred resolve; equal to the reference."""
    want = _jax_counts(cases, case)  # before the variable: the reference's default route
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    launches = []
    monkeypatch.setattr(T._intersect, "tile_counts", lambda *a, **kw: launches.append(1))
    monkeypatch.setattr(T._intersect, "tile_counts_compact",
                        lambda *a, **kw: launches.append(1))
    T._mxu.reset_counts()
    _, _, ta, tb = cases[case]
    got = dist_sharded_hostring(ta, ["cpu"] * D, tile=3, index_b=tb)
    assert launches == [] and T._mxu.PASS_COUNTS["full"] > 0
    _assert_counts_equal(got, want)


def test_mxu_checkpoints_carry_ambiguous_pairs_both_ways(cases, tmp_path, monkeypatch):
    """Under mxu the step files hold the deferred pairs: the port's equal
    the reference's member for member, a run interrupted after step 1
    resumes from them, and each package resumes from the other's files."""
    ja, _, ta, _ = cases["raw"]
    want = _jax_counts(cases, "raw")
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    _assert_counts_equal(dist_sharded_hostring(ta, ["cpu"] * 8, tile=3, checkpoint=str(tdir)),
                         want)
    jring.dist_sharded_hostring(ja, mxu_tile=3, checkpoint=str(jdir))
    amb = 0
    for t in range(8):
        with np.load(tdir / f"hostring_step{t}.npz") as z, \
                np.load(jdir / f"hostring_step{t}.npz") as zj:
            assert sorted(z.files) == sorted(zj.files)
            for m in zj.files:
                assert np.array_equal(z[m], zj[m]), (t, m)
            amb = z["amb_i"].size
    assert amb > 0
    for src, run in ((jdir, lambda d: dist_sharded_hostring(ta, ["cpu"] * 8, tile=3,
                                                              checkpoint=d)),
                     (tdir, lambda d: jring.dist_sharded_hostring(ja, mxu_tile=3,
                                                                  checkpoint=d))):
        part = tmp_path / f"from_{src.name}"
        part.mkdir()
        for t in range(2):
            (part / f"hostring_step{t}.npz").write_bytes(
                (src / f"hostring_step{t}.npz").read_bytes())
        _assert_counts_equal(run(str(part)), want)

    real = tring._save_checkpoint

    def die_after_step1(path, t, shared, inter, amb=None):
        real(path, t, shared, inter, amb=amb)
        if t == 1:
            raise _Interrupted

    ckpt = tmp_path / "ckpt"
    monkeypatch.setattr(tring, "_save_checkpoint", die_after_step1)
    with pytest.raises(_Interrupted):
        dist_sharded_hostring(ta, ["cpu"] * 8, tile=3, checkpoint=str(ckpt))
    monkeypatch.setattr(tring, "_save_checkpoint", real)
    T._mxu.reset_counts()
    _assert_counts_equal(dist_sharded_hostring(ta, ["cpu"] * 8, tile=3, checkpoint=str(ckpt)),
                         want)
    assert T._mxu.PASS_COUNTS["full"] == 6 * 8  # steps 2..7, one sub-tile pair, 8 positions


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_mxu_checkpoint_resumed_under_k3(cases, tmp_path, writer, monkeypatch):
    """Step files with deferred pairs (the port's mxu run, or the
    reference's host ring, which is mxu-only) resumed with the variable
    unset: K3/K4 finish the sweep, the carried pairs are still resolved
    and kept in the later step files, and the result equals the reference."""
    ja, _, ta, _ = cases["raw"]
    want = _jax_counts(cases, "raw")
    src = tmp_path / "src"
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    if writer == "port":
        dist_sharded_hostring(ta, ["cpu"] * 8, tile=3, checkpoint=str(src))
    else:
        jring.dist_sharded_hostring(ja, mxu_tile=3, checkpoint=str(src))
    monkeypatch.delenv("MIEKKI_INTERSECT")
    part = tmp_path / "part"
    part.mkdir()
    for t in range(2):
        (part / f"hostring_step{t}.npz").write_bytes(
            (src / f"hostring_step{t}.npz").read_bytes())
    with np.load(part / "hostring_step1.npz") as z:
        carried = z["amb_i"].size
    assert carried > 0
    _assert_counts_equal(dist_sharded_hostring(ta, ["cpu"] * 8, tile=3, checkpoint=str(part)),
                         want)
    with np.load(part / "hostring_step7.npz") as z:
        assert z["amb_i"].size == z["amb_j"].size == carried


@pytest.mark.parametrize("D", [1, 4])
def test_dist_sharded_mxu_routes_as_the_reference(cases, D, monkeypatch):
    """Under mxu, one position takes dist_counts_matrix's deferred pass and
    several the host ring's; _traced_mxu needs a process group."""
    want = _jax_counts(cases, "rect")
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    calls = []
    real = tring.dist_sharded_hostring
    monkeypatch.setattr(tring, "dist_sharded_hostring",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    T._mxu.reset_counts()
    _, _, ta, tb = cases["rect"]
    got = dist_sharded(ta, local_mesh(devices=["cpu"] * D), index_b=tb, tile=4)
    assert bool(calls) == (D > 1) and T._mxu.PASS_COUNTS["full"] > 0
    _assert_counts_equal(got, want)
    with pytest.raises(ValueError, match="process-group"):
        dist_sharded(ta, local_mesh(devices=["cpu"] * D), _traced_mxu=True)
