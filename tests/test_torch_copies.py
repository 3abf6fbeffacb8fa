"""The port's copies of the JAX package's host modules (params, oracle/, io/,
utils/metrics, utils/hbm, the numpy half of ops/compact) behave exactly as
the originals: the same inputs give equal outputs (integers and byte
strings bitwise, floats as the same float64 values)."""

import json

import numpy as np
import pytest

import miekki_tpu.io.encode as j_encode
import miekki_tpu.ops.compact as j_compact
import miekki_tpu.io.native as j_native
import miekki_tpu.io.reader as j_reader
import miekki_tpu.oracle.compare as j_compare
import miekki_tpu.oracle.nthash as j_nthash
import miekki_tpu.oracle.sketch as j_sketch
import miekki_tpu.params as j_params
import miekki_tpu.utils.hbm as j_hbm
import miekki_tpu.utils.metrics as j_metrics
import miekki_tpu_torch.io.encode as t_encode
import miekki_tpu_torch.ops.compact as t_compact
import miekki_tpu_torch.io.native as t_native
import miekki_tpu_torch.io.reader as t_reader
import miekki_tpu_torch.oracle.compare as t_compare
import miekki_tpu_torch.oracle.nthash as t_nthash
import miekki_tpu_torch.oracle.sketch as t_sketch
import miekki_tpu_torch.params as t_params
import miekki_tpu_torch.utils.hbm as t_hbm
import miekki_tpu_torch.utils.metrics as t_metrics

from fixtures import random_genome_fasta, random_reads_fastq


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def test_params_copy():
    assert t_params.HASH_VERSION == j_params.HASH_VERSION
    for kw in ({}, {"k": 21, "s": 300}, {"k": 64, "s": 1, "compact": True}):
        t, j = t_params.SketchParams(**kw), j_params.SketchParams(**kw)
        assert t.to_dict() == j.to_dict()
        assert t_params.SketchParams.from_dict(j.to_dict()) == t
    for bad in ({"k": 0}, {"k": 65}, {"s": 0}):
        with pytest.raises(ValueError):
            t_params.SketchParams(**bad)


@pytest.mark.parametrize("k", [1, 15, 31, 64])
def test_oracle_hash_and_sketch_copies(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, size=3000).astype(np.int64)
    _same(t_nthash.hash_kmers(codes, k), j_nthash.hash_kmers(codes, k))
    _same(t_nthash.hash_kmers_scalar(codes[:200], k), j_nthash.hash_kmers_scalar(codes[:200], k))
    _same(t_nthash.canonical_hashes(codes, k), j_nthash.canonical_hashes(codes, k))
    vals = rng.integers(0, 2**64 - 1, size=100, dtype=np.uint64)
    _same(t_nthash.rol64(vals, k), j_nthash.rol64(vals, k))
    _same(t_nthash.ror64(vals, k), j_nthash.ror64(vals, k))
    _same(t_sketch.sketch_codes(codes, k, 50), j_sketch.sketch_codes(codes, k, 50))
    parts = [codes[:1000], codes[1000:]]
    _same(t_sketch.sketch_records(parts, k, 80), j_sketch.sketch_records(parts, k, 80))
    h = np.concatenate([vals, vals[:40]])
    _same(t_sketch.bottom_s_min_copies(h, 30, 2), j_sketch.bottom_s_min_copies(h, 30, 2))
    _same(t_sketch.pad_sketch(vals[:10], 16), j_sketch.pad_sketch(vals[:10], 16))


def test_oracle_compare_copy():
    rng = np.random.default_rng(4)
    pool = rng.integers(0, 2**64 - 1, size=900, dtype=np.uint64)
    a = np.unique(rng.choice(pool, 300, replace=False))
    b = np.unique(rng.choice(pool, 300, replace=False))
    k, s = 21, 250
    for name in ("intersection_size", "containment"):
        _same(getattr(t_compare, name)(a, b), getattr(j_compare, name)(a, b))
    _same(t_compare.mash_jaccard(a, b, s), j_compare.mash_jaccard(a, b, s))
    _same(t_compare.compare_sketches(a, b, k, s), j_compare.compare_sketches(a, b, k, s))
    _same(t_compare.all_vs_all([a, b, a[:50]], k, s), j_compare.all_vs_all([a, b, a[:50]], k, s))
    _same(t_compare.kmv_cardinality(a, s), j_compare.kmv_cardinality(a, s))
    j = np.linspace(0.0, 1.0, 41)
    shared = rng.integers(0, 200, size=41)
    union = shared + rng.integers(0, 300, size=41)
    for name, args in (
        ("mash_distance_vec", (j, k)), ("ani_from_distance_vec", (j,)),
        ("ani_from_containment_vec", (j, k)),
        ("chance_p_value_vec", (shared, union, 5e6 * np.ones(41), 4e6 * np.ones(41), k)),
        ("screen_p_value_vec", (shared, union, 3e6, k)),
        ("jaccard_ci_vec", (shared, union)), ("distance_ci_vec", (shared, union, k)),
        ("betainc_vec", (shared + 1.0, union + 1.0, j)),
    ):
        _same(getattr(t_compare, name)(*args), getattr(j_compare, name)(*args))
    for sh, un in ((0, 0), (3, 10), (250, 250), (17, 250)):
        for name, args in (("mash_distance", (sh / max(un, 1), k)),
                           ("ani_from_distance", (sh / max(un, 1),)),
                           ("ani_from_containment", (sh / max(un, 1), k)),
                           ("chance_p_value", (sh, un, 5e6, 4e6, k)),
                           ("jaccard_ci", (sh, un)), ("distance_ci", (sh, un, k))):
            _same(getattr(t_compare, name)(*args), getattr(j_compare, name)(*args))


@pytest.mark.parametrize("gz", [False, True])
def test_io_copies(tmp_path, gz, monkeypatch):
    rng = np.random.default_rng(6)
    fa = random_genome_fasta(tmp_path / "g.fa", rng, n_records=3, length=777,
                             n_prob=0.01, gz=gz)
    fq = random_reads_fastq(tmp_path / "r.fq", rng, n_reads=20, length=90, gz=gz)
    assert t_native.available() == j_native.available()
    for path in (fa, fq):
        _same(list(t_reader.read_records(path)), list(j_reader.read_records(path)))
        _same(list(t_reader.read_encoded(path)), list(j_reader.read_encoded(path)))
        _same(t_reader.read_genome_codes(path), j_reader.read_genome_codes(path))
    monkeypatch.setenv("MIEKKI_NATIVE_IO", "0")
    monkeypatch.setattr(t_native, "_lib_checked", False)
    monkeypatch.setattr(j_native, "_lib_checked", False)
    _same(list(t_reader.read_encoded(fa)), list(j_reader.read_encoded(fa)))
    seq = b"ACGTNacgtRYX-" * 7
    _same(t_encode.encode(seq), j_encode.encode(seq))
    _same(t_encode.encode_str("ACGTN"), j_encode.encode_str("ACGTN"))
    recs = [t_encode.encode(seq), t_encode.encode(seq[:20])]
    _same(t_encode.pack_records(recs, 21), j_encode.pack_records(recs, 21))
    _same(t_encode.pack_base5(recs[0]), j_encode.pack_base5(recs[0]))


def test_metrics_copy(tmp_path):
    for mod in (t_metrics, j_metrics):
        mod.emit(str(tmp_path / f"{mod.__name__}.jsonl"), phase="sketch", genomes=3)
    rows = [mod.read(str(tmp_path / f"{mod.__name__}.jsonl"))
            for mod in (t_metrics, j_metrics)]
    for r in rows:
        r[0].pop("ts")
    assert rows[0] == rows[1] == [{"phase": "sketch", "genomes": 3}]
    assert json.dumps(t_metrics.emit(None, x=1)["x"]) == "1"


def test_compact_host_copies():
    rng = np.random.default_rng(10)
    edges = np.array([0, 1, 2, 3, (1 << 26) + 5, (1 << 27) - 1, 1 << 32, 1 << 63,
                      0xFFFFFFFFFFFFFF00, 0xFFFFFFFFFFFFFFFE, 0xFFFFFFFFFFFFFFFF],
                     dtype=np.uint64)
    shifts = rng.integers(0, 64, size=3000).astype(np.uint64)
    vals = np.concatenate([edges, rng.integers(0, 2**64 - 1, size=3000,
                                               dtype=np.uint64) >> shifts])
    assert t_compact.MANTISSA == j_compact.MANTISSA
    _same(t_compact.encode_u64(vals), j_compact.encode_u64(vals))
    codes = j_compact.encode_u64(vals)
    _same(t_compact.decode_approx(codes), j_compact.decode_approx(codes))
    _same(t_compact.lo_plane_np(codes), j_compact.lo_plane_np(codes))


@pytest.mark.parametrize("limit", ["1000000", str(16 << 30), str(80 << 30)])
def test_hbm_budgets_copy(monkeypatch, limit):
    """The memory budgets equal the reference's under a MIEKKI_HBM_LIMIT
    override (on the CPU both fall back to DEFAULT_LIMIT without one)."""
    monkeypatch.setenv("MIEKKI_HBM_LIMIT", limit)
    for name in ("DEFAULT_LIMIT", "PLANES_FRAC", "DIST_TOTAL_FRAC", "SCREEN_MERGE_FRAC",
                 "SCREEN_RESIDENT_FRAC", "SCREEN_RESIDENT_BYTES_PER_VALUE",
                 "CACHE_MIN_BYTES"):
        assert getattr(t_hbm, name) == getattr(j_hbm, name), name
    assert t_hbm.bytes_limit("cpu") == j_hbm.bytes_limit() == int(limit)
    assert t_hbm.screen_merge_value_budget("cpu") == j_hbm.screen_merge_value_budget()
    assert (t_hbm.screen_resident_value_budget("cpu")
            == j_hbm.screen_resident_value_budget())
    for table in (0, 1 << 20, int(limit) // 4, int(limit) // 4 + 1, 1 << 40):
        assert t_hbm.keep_planes_ok(table, "cpu") == j_hbm.keep_planes_ok(table)
    for args in ((0, 0, 0), (1 << 30, 2, 1 << 28), (1 << 33, 1, 1 << 30), (10, 3, 7)):
        assert t_hbm.dist_cache_bytes(*args, "cpu") == j_hbm.dist_cache_bytes(*args)
    monkeypatch.delenv("MIEKKI_HBM_LIMIT")
    assert t_hbm.bytes_limit("cpu") == t_hbm.DEFAULT_LIMIT
