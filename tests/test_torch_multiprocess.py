"""Port parity of the collective rings across processes: W torch.distributed
ranks on gloo/CPU, one per mesh position, run by
`python -m miekki_tpu_torch.tools.multiprocess_ring --device cpu` (each
rank holds its results bitwise against one device and prints its verdict;
the tool prints "ALL RANKS OK").  Rank 0's count matrices, the chunk files
of the fault-injection run and rank 0's screen rows are then held against
miekki_tpu.parallel on the first W of conftest's faked CPU devices:
bitwise for the counts, equal in every column for the rows.  Every run is a
subprocess with its own timeout, so no process group outlives it here."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.parallel import dist_sharded as jdist_sharded
from miekki_tpu.parallel import local_mesh as jlocal_mesh
from miekki_tpu.parallel import screen_sharded as jscreen_sharded
from miekki_tpu.parallel.allvsall import unrotate_chunks as junrotate_chunks
from miekki_tpu.parallel.mesh import DATA_AXIS, DB_AXIS

import jax

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
MODES = ("square", "rect", "compact")
SCREEN = {"plain": {}, "winner": {"winner": True}, "p_values": {"p_values": True},
          "files": {}}
READ_PARTS = 4


def _tool(*argv, timeout=TIMEOUT):
    res = subprocess.run(
        [sys.executable, "-m", "miekki_tpu_torch.tools.multiprocess_ring", *argv,
         "--device", "cpu", "--timeout", str(timeout - 20)],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "ALL RANKS OK" in res.stdout
    return [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def ring_run(request, tmp_path_factory):
    world = request.param
    out = tmp_path_factory.mktemp(f"ring_w{world}")
    # 42 genomes: W = 4 pads them to 44, and the rect side's 21 to 24
    lines = _tool("--ranks", str(world), "--modes", "square,rect,compact,screen",
                  "--genomes", "42", "-s", "96", "--out", str(out))
    return world, out, lines


def _jax_mesh(world, axis):
    return jlocal_mesh(axis_names=(axis,), devices=jax.devices()[:world])


@pytest.mark.parametrize("mode", MODES)
def test_ring_counts_equal_jax(ring_run, mode):
    world, out, lines = ring_run
    verdicts = [ln for ln in lines if ln.get("mode") == mode]
    assert sorted(ln["rank"] for ln in verdicts) == list(range(world))
    assert all(ln["equal"] for ln in verdicts)
    index = JIndex.load(out / "index.npz")
    a, b = index, None
    if mode == "rect":
        half = len(index) // 2
        a = JIndex(index.params, index.names[:half], index.hi[:half], index.lo[:half])
        b = index
    elif mode == "compact":
        a = index.to_compact()
    want = jdist_sharded(a, _jax_mesh(world, DB_AXIS), index_b=b)
    with np.load(out / f"counts_{mode}.npz") as got:
        assert sorted(got.files) == ["inter", "shared", "union"]
        for key in got.files:
            assert got[key].dtype == np.int32
            assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("variant", list(SCREEN))
def test_screen_merged_by_all_reduce_equals_jax(ring_run, variant):
    world, out, lines = ring_run
    verdicts = [ln for ln in lines if ln.get("mode") == f"screen_{variant}"]
    assert len(verdicts) == world and all(ln["equal"] for ln in verdicts)
    assert all(ln["hits"] > 0 for ln in verdicts)
    index = JIndex.load(out / "screen_db.npz")
    reads = str(out / "reads.fq")
    if variant == "files":  # the same reads in 4 files, dealt to the ranks
        reads = [str(out / f"reads_part{i}.fq") for i in range(READ_PARTS)]
    stats = {}
    want = jscreen_sharded(index, reads, _jax_mesh(world, DATA_AXIS),
                           flat=4096, stats=stats, **SCREEN[variant])
    assert json.loads((out / f"screen_{variant}.json").read_text()) == want
    assert {ln["groups"] for ln in verdicts} == {stats["n_batches"]}


@pytest.mark.parametrize("world", [2, 4])
def test_fault_injection_then_resume(world, tmp_path):
    """Rank 1 exits after its first chunk; the rerun resumes at chunk 1 on
    every rank, and the unrotated chunks of every rank equal one device's
    matrix and, bit for bit, the reference's dist_sharded; the resumed
    ranks then run the square ring."""
    lines = _tool("--ranks", str(world), "--die-after", "1", "--genomes", "32",
                  "-s", "64", "--out", str(tmp_path))
    fault = next(ln["fault_run"] for ln in lines if "fault_run" in ln)
    assert fault == {"rank1_exit": 17, "rank1_chunks": ["chunk0_rank1.npz"]}
    assert sorted(ln["resume_at_chunk"] for ln in lines if "resume_at_chunk" in ln) \
        == [0] * world + [1] * world
    done = [ln for ln in lines if ln.get("mode") == "chunks"]
    assert len(done) == world and all(ln["equal"] and ln["chunks_run"] == world - 1
                                      for ln in done)
    square = [ln for ln in lines if ln.get("mode") == "square"]
    assert len(square) == world and all(ln["equal"] for ln in square)
    want = jdist_sharded(JIndex.load(tmp_path / "index.npz"), _jax_mesh(world, DB_AXIS))
    n = want["shared"].shape[0]
    nl = n // world
    for key in ("shared", "union", "inter"):
        ring = np.zeros((world, n, nl), np.int32)
        for t in range(world):
            for r in range(world):
                with np.load(tmp_path / f"chunk{t}_rank{r}.npz") as z:
                    ring[t, r * nl:(r + 1) * nl] = z[key]
        assert np.array_equal(junrotate_chunks(ring, D=world), want[key]), key


MXU_TILE = 8


@pytest.fixture(scope="module")
def mxu_run(tmp_path_factory):
    """Two gloo ranks running the collective stream-pass ring (square,
    rect, compact) at sub-tile MXU_TILE."""
    out = tmp_path_factory.mktemp("ring_mxu")
    lines = _tool("--ranks", "2", "--modes", "mxu_square,mxu_rect,mxu_compact",
                  "--genomes", "42", "-s", "96", "--mxu-tile", str(MXU_TILE), "--out", str(out))
    return out, lines


@pytest.mark.parametrize("mode", MODES)
def test_mxu_ring_counts_equal_jax(mxu_run, mode, monkeypatch):
    """dist_sharded under MIEKKI_INTERSECT=mxu over two gloo ranks (the
    collective ring, one resolve after un-rotation) equals the reference's
    traced mxu ring on two devices, and each rank one device."""
    out, lines = mxu_run
    verdicts = [ln for ln in lines if ln.get("mode") == f"mxu_{mode}"]
    assert sorted(ln["rank"] for ln in verdicts) == [0, 1]
    assert all(ln["equal"] and ln["launches"]["mxu_passes"] > 0 for ln in verdicts)
    index = JIndex.load(out / "index.npz")
    a, b = index, None
    if mode == "rect":
        half = len(index) // 2
        a = JIndex(index.params, index.names[:half], index.hi[:half], index.lo[:half])
        b = index
    elif mode == "compact":
        a = index.to_compact()
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    want = jdist_sharded(a, _jax_mesh(2, DB_AXIS), index_b=b, mxu_tile=MXU_TILE)
    with np.load(out / f"counts_mxu_{mode}.npz") as got:
        for key in ("shared", "union", "inter"):
            assert got[key].dtype == np.int32
            assert np.array_equal(got[key], want[key]), key


def test_mxu_ring_brackets_equal_jax(mxu_run):
    """ring_rect_counts_mxu's (lb, ub, inter) in global order equal the
    reference's bit for bit, ambiguous pairs included."""
    from miekki_tpu.parallel.allvsall import ring_rect_counts_mxu

    import jax.numpy as jnp

    out, lines = mxu_run
    index = JIndex.load(out / "index.npz")
    n = len(index)
    assert n % 2 == 0
    hi, lo = jnp.asarray(index.hi), jnp.asarray(index.lo)
    want = ring_rect_counts_mxu(hi, lo, hi, lo, s=index.params.s,
                                mesh=_jax_mesh(2, DB_AXIS), tile=MXU_TILE)
    with np.load(out / "mxu_brackets.npz") as got:
        for key, w in zip(("lb", "ub", "inter"), want):
            assert np.array_equal(got[key], np.asarray(w)), key
        ambiguous = int((got["lb"] != got["ub"]).sum())
    assert ambiguous > 0
    assert [ln["mxu_ambiguous"] for ln in lines if "mxu_ambiguous" in ln] == [ambiguous] * 2
