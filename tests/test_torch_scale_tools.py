"""The port's full-scale acceptance tools on the CPU at tiny sizes:
miekki_tpu_torch.tools.scale100k (the DB made on the device, phase A on
the compact device planes, phase B's grouped screen), its synthetic
table's invariants, miekki_tpu_torch.tools.acceptance at CI size, the
tools' fixture copies against tests/fixtures.py, and the screen's chunked
hit count against the JAX package's."""

import json

import numpy as np
import pytest
import torch

from miekki_tpu import engine as J
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex, index_to_device
from miekki_tpu_torch.ops import compact, u64
from miekki_tpu_torch.params import SketchParams
from miekki_tpu_torch.tools import acceptance, scale100k, synth

import fixtures

TINY = ["--genomes", "96", "--real", "8", "--s", "256", "--genome-len", "5000",
        "--queries", "16", "--tile", "16", "--reads-per-genome", "300", "--device", "cpu"]


@pytest.fixture(scope="module")
def scale_report(tmp_path_factory):
    """scale100k at a tiny size with --dist-u64, the screen forced into 3
    genome groups."""
    out = tmp_path_factory.mktemp("scale") / "report.json"
    mp = pytest.MonkeyPatch()
    mp.setenv("MIEKKI_SCREEN_DB_VALS", "12000")
    try:
        rc = scale100k.main(TINY + ["--dist-u64", "--out", str(out)])
    finally:
        mp.undo()
    report = json.loads(out.read_text())
    report["rc"] = rc
    return report


@pytest.mark.parametrize("check", ["dist_identity_ok", "dist_plain_spots_ok",
                                   "compact_bias_ok", "dist_u64_identity_ok",
                                   "dist_u64_oracle_ok", "screen_top_ok", "screen_others_ok"])
def test_scale100k_checks(scale_report, check):
    assert scale_report["checks"][check] is True
    assert scale_report["pass"] is True and scale_report["rc"] == 0


def test_scale100k_report(scale_report):
    r = scale_report
    assert r["screen_stats"]["n_slabs"] >= 2
    assert r["n_reads"] == 900 and r["dist_pairs"] == 16 * 96
    assert r["db_bytes"] == 96 * 256 * 8 and r["db_bytes_compact"] == 96 * 256 * 4
    assert {name for name, _ in r["screen_top5"][:3]} == {"real0", "real1", "real7"}
    for key in ("real_sketch_launches", "dist_launches", "spot_launches", "screen_launches",
                "dist_u64_launches"):
        assert set(r[key]) == {"k1", "k3", "k4"}
    # --dist-u64 streams the raw DB's key blocks from its host planes: the
    # query block and each of the 6 DB blocks at least once
    assert r["dist_u64_blocks"]["loads"] >= 7
    assert r["dist_u64_blocks"]["bytes_uploaded"] >= (16 + 96) * 256 * 8
    assert r["peak_host_rss_bytes"] > 0 and r["host_memory_at_start"]["total_bytes"] > 0


def test_synthetic_table_invariants():
    rng = np.random.default_rng(3)
    n, n_real, s = 40, 5, 128
    real = torch.sort(torch.from_numpy(
        rng.integers(-(1 << 63), (1 << 63) - 1, size=(n_real, s), dtype=np.int64)), 1).values
    real[2, 100:] = u64.INF_KEY  # a short real sketch
    hi, lo, codes, codes_dev = scale100k.synth_db(n, real, s, torch.device("cpu"), chunk=16)
    keys = u64.keys_from_planes(hi, lo)
    assert np.array_equal(keys[:n_real], real.numpy())
    syn = u64.join(hi[n_real:], lo[n_real:])
    assert np.all(np.diff(keys[n_real:], axis=1) >= 0)
    assert int(syn.max()) < 1 << scale100k.VALUE_BITS
    assert np.array_equal(codes_dev.numpy(), compact.compact_rows(torch.from_numpy(keys)).numpy())
    idx = SketchIndex(SketchParams(k=31, s=s), [f"g{i}" for i in range(n)], hi, lo)
    assert np.array_equal(codes, idx.to_compact().hi)
    again = scale100k.synth_db(n, real, s, torch.device("cpu"), chunk=16)
    assert np.array_equal(again[0], hi) and np.array_equal(again[1], lo)  # seeded


def test_scale100k_arguments():
    with pytest.raises(SystemExit):
        scale100k.main(["--real", "4", "--device", "cpu"])  # genome 7 is a read source


@pytest.fixture(scope="module")
def acceptance_rows(tmp_path_factory):
    return acceptance.run(False, tmp_path_factory.mktemp("acceptance"), "cpu")


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5])
def test_acceptance_ci_size(acceptance_rows, config):
    row = acceptance_rows[config - 1]
    assert row["config"] == config and row["pass"] is True, row
    if config == 5:
        assert row["mesh_devices"] == 8


@pytest.mark.parametrize("name", ["random_seq", "mutate", "family", "reads", "files"])
def test_synth_equals_test_fixtures(tmp_path, name):
    def run(mod, seed=9):
        rng = np.random.default_rng(seed)
        if name == "random_seq":
            return mod.random_seq(rng, 1000)
        if name == "mutate":
            return mod.mutate(rng, b"ACGTN" * 200, 0.1)
        if name == "family":
            return mod.make_genome_family(rng, 4, 500, 0.05)
        if name == "reads":
            return mod.reads_from_genome(rng, b"ACGT" * 100, 50, 30)
        recs = [("a", b"ACGT" * 40), ("b", b"TTGCA" * 9)]
        return (mod.write_fasta(tmp_path / f"{mod.__name__}.fa", recs).read_bytes(),
                mod.write_fastq(tmp_path / f"{mod.__name__}.fq", recs).read_bytes())

    assert run(synth) == run(fixtures)


def test_hits_from_bitmap_chunked_equals_reference(monkeypatch):
    """Steps of HITS_CHUNK slots that end on run boundaries: runs of equal
    values straddle the nominal step ends."""
    rng = np.random.default_rng(4)
    vals = np.sort(rng.integers(0, 60, size=500).astype(np.uint64))
    gid = rng.integers(0, 7, size=500).astype(np.int32)
    acc = rng.random(501) < 0.3
    want = J._hits_from_bitmap(vals, gid, acc, 7)
    for chunk in (1, 7, 64, 1 << 26):
        monkeypatch.setattr(T, "HITS_CHUNK", chunk)
        assert np.array_equal(T._hits_from_bitmap(vals, gid, acc, 7), want), chunk


def test_flatten_db_matches_reference():
    """The flat DB's values and genome ids equal the reference's host
    build (the values now come off the device as u64)."""
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 2**63, size=300, dtype=np.uint64)
    sketches = [np.unique(rng.choice(pool, size=int(rng.integers(0, 40)))) for _ in range(9)]
    idx = SketchIndex.from_sketches(sketches, [f"g{i}" for i in range(9)],
                                    SketchParams(k=21, s=40))
    jidx = JIndex(JParams(k=21, s=40), idx.names, idx.hi, idx.lo)
    db, vals, gid = T._flatten_db(idx, torch.device("cpu"))
    want_vals, want_gid = J._flatten_db(jidx)
    assert np.array_equal(vals, want_vals) and np.array_equal(gid, want_gid)
    assert np.array_equal(u64.u64_from_keys(db), want_vals)
    assert torch.equal(index_to_device(idx, "cpu"), torch.from_numpy(
        u64.keys_from_planes(idx.hi, idx.lo)))
