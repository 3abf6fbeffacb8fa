"""Port parity of the counted sketch (`sketch -m`, ops.sketch_counted)
against the numpy oracle (oracle.sketch.bottom_s_min_copies) and the JAX
package's sketch_codes_device_counted, bitwise, including the doubled-cap
retry.  The cases of tests/test_screen_features.py::TestCountedSketch run
on the port with `device="cpu"` (K1's plain version)."""

import json

import numpy as np
import pytest
import torch

from miekki_tpu import cli as jcli
from miekki_tpu import engine as J
from miekki_tpu.ops import sketch_counted as JC
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu_torch import cli as tcli
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex
from miekki_tpu_torch.io import encode, reader
from miekki_tpu_torch.ops import sketch_counted as TC
from miekki_tpu_torch.ops import u64
from miekki_tpu_torch.oracle import nthash
from miekki_tpu_torch.oracle import sketch as oracle_sketch
from miekki_tpu_torch.params import SketchParams

from fixtures import random_seq, reads_from_genome, write_fastq


def _readset_codes(rng, n_repeat=2000, n_unique=4000, copies=3):
    """2-bit codes imitating a read set: a 'genomic' segment repeated
    `copies` times (coverage) and a one-off 'error' sequence."""
    core = rng.integers(0, 4, size=n_repeat, dtype=np.uint8)
    parts = [core] * copies + [rng.integers(0, 4, size=n_unique, dtype=np.uint8)]
    return np.concatenate(parts)


def _oracle(codes, k, s, m):
    return oracle_sketch.bottom_s_min_copies(nthash.canonical_hashes(codes, k), s, m)


@pytest.mark.parametrize("k,s,m", [(21, 64, 2), (15, 128, 3), (31, 32, 2)])
def test_oracle_parity(k, s, m):
    rng = np.random.default_rng(k * 1000 + s + m)
    codes = _readset_codes(rng)
    got = TC.sketch_codes_device_counted(codes, k, s, m, device="cpu")
    want = _oracle(codes, k, s, m)
    assert got.dtype == np.uint64 and len(want) == s
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JC.sketch_codes_device_counted(codes, k, s, m))


def test_retry_path_exact(monkeypatch):
    """A tiny starting cap forces the doubled-cap retry; the result stays
    bitwise exact."""
    rng = np.random.default_rng(7)
    codes = _readset_codes(rng, n_repeat=500, n_unique=8000, copies=2)
    k, s, m = 17, 48, 2
    caps = []
    real = TC._sketch_chunked_counted

    def spy(chunks, k_, cap):
        caps.append(cap)
        return real(chunks, k_, cap)

    monkeypatch.setattr(TC, "_sketch_chunked_counted", spy)
    got = TC.sketch_codes_device_counted(codes, k, s, m, cap=64, device="cpu")
    assert caps[:2] == [64, 128] and len(caps) >= 2
    want = _oracle(codes, k, s, m)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JC.sketch_codes_device_counted(codes, k, s, m, cap=64))


def test_past_max_cap_raises():
    rng = np.random.default_rng(7)
    codes = _readset_codes(rng, n_repeat=500, n_unique=8000, copies=2)
    with pytest.raises(ValueError, match="min-copies sketch needs cap > 128"):
        TC.sketch_codes_device_counted(codes, 17, 48, 2, cap=64, max_cap=128, device="cpu")
    with pytest.raises(ValueError, match="min-copies sketch needs cap > 128"):
        JC.sketch_codes_device_counted(codes, 17, 48, 2, cap=64, max_cap=128)


def test_min_copies_one_is_plain():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
    got = TC.sketch_codes_device_counted(codes, 21, 64, 1, device="cpu")
    np.testing.assert_array_equal(got, oracle_sketch.sketch_codes(codes, 21, 64))


def test_high_m_filters_everything():
    """No k-mer occurs 50 times → empty sketch."""
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    got = TC.sketch_codes_device_counted(codes, 21, 64, 50, device="cpu")
    assert len(got) == 0
    assert len(JC.sketch_codes_device_counted(codes, 21, 64, 50)) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_counted_equals_reference(seed):
    """One buffer merge with repeats inside the chunk and values already in
    the buffer: keys, counts and the dropped flag equal the reference's
    (hi, lo, count) planes, with and without truncation."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    cap = 32
    pool = rng.integers(0, 2 ** 64 - 1, size=40, dtype=np.uint64)
    resident = np.sort(rng.choice(pool, size=20 + 6 * seed, replace=False))
    buf_v = np.full(cap, u64.UINT64_MAX)
    buf_v[:len(resident)] = resident
    buf_c = np.zeros(cap, np.int32)
    buf_c[:len(resident)] = rng.integers(1, 5, size=len(resident))
    vals = rng.choice(pool, size=50)
    vals[rng.random(50) < 0.2] = u64.UINT64_MAX
    cnts = np.where(vals != u64.UINT64_MAX, 1, 0).astype(np.int32)

    (ov, oc), dropped = TC._merge_counted(
        (torch.from_numpy(u64.keys_from_u64(buf_v)), torch.from_numpy(buf_c)),
        torch.from_numpy(u64.keys_from_u64(vals)), torch.from_numpy(cnts), cap)
    jb = tuple(jnp.asarray(x) for x in u64.split(buf_v)) + (jnp.asarray(buf_c),)
    (jh, jl, jc), jd = JC._merge_counted(
        jb, tuple(jnp.asarray(x) for x in u64.split(vals)), jnp.asarray(cnts), cap)
    np.testing.assert_array_equal(u64.u64_from_keys(ov), u64.join(np.asarray(jh), np.asarray(jl)))
    np.testing.assert_array_equal(oc.numpy(), np.asarray(jc))
    assert oc.dtype == torch.int32 and bool(dropped) == bool(jd)


def test_merge_chunk_counted_keeps_the_threshold_value():
    """The prefilter keeps h == the cap-th value: its count goes up."""
    cap = 4
    keys = torch.tensor([10, 20, 30, 40], dtype=torch.int64)
    buf = (keys, torch.tensor([1, 1, 1, 1], dtype=torch.int32))
    h = torch.tensor([40, 40, 50, u64.INF_KEY, 10], dtype=torch.int64)
    (ov, oc), dropped = TC.merge_chunk_counted(buf, h, cap)
    assert ov.tolist() == [10, 20, 30, 40] and oc.tolist() == [2, 1, 1, 3]
    assert bool(dropped)  # 50 was above the threshold


@pytest.fixture(scope="module")
def read_fq(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_counted")
    rng = np.random.default_rng(21)
    genome = random_seq(rng, 4000)
    reads = reads_from_genome(rng, genome, 200, 80)
    # error reads that appear once
    reads += [random_seq(rng, 80) for _ in range(50)]
    fq = write_fastq(tmp / "r.fq", [(f"r{i}", r) for i, r in enumerate(reads)])
    short = write_fastq(tmp / "short.fq", [("tiny", b"ACGTACGTAC")])
    return fq, short


def test_build_index_min_copies(read_fq):
    fq, short = read_fq
    params = SketchParams(k=21, s=64)
    idx = T.build_index([fq, short], params, min_copies=2, device="cpu")
    codes = encode.pack_records(reader.read_genome_codes(fq), params.k)
    np.testing.assert_array_equal(idx.sketch_u64(0), _oracle(codes, params.k, params.s, 2))
    assert len(idx.sketch_u64(0)) == params.s
    assert len(idx.sketch_u64(1)) == 0  # shorter than k
    ref = J.build_index([fq, short], JParams(k=21, s=64), min_copies=2)
    assert np.array_equal(idx.hi, ref.hi) and np.array_equal(idx.lo, ref.lo)


@pytest.mark.parametrize("extra", [[], ["--per-record"], ["--compress"]])
def test_cli_min_copies_equals_reference(read_fq, tmp_path, extra):
    fq, _ = read_fq
    jdb, tdb = tmp_path / "j.npz", tmp_path / "t.npz"
    common = ["-k", "21", "-s", "64", "-m", "2", *extra]
    assert jcli.main(["sketch", str(fq), "-o", str(jdb), *common]) == 0
    assert tcli.main(["sketch", str(fq), "-o", str(tdb), *common, "--device", "cpu"]) == 0
    with np.load(jdb) as zj, np.load(tdb) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert json.loads(bytes(zj["header"])) == json.loads(bytes(zt["header"]))
        for name in zj.files:
            assert zj[name].dtype == zt[name].dtype and np.array_equal(zj[name], zt[name])
    if not extra:
        plain = tmp_path / "p.npz"
        assert tcli.main(["sketch", str(fq), "-o", str(plain), "-k", "21", "-s", "64",
                          "--device", "cpu"]) == 0
        sk_m, sk_p = SketchIndex.load(tdb).sketch_u64(0), SketchIndex.load(plain).sketch_u64(0)
        assert not np.array_equal(sk_m, sk_p)  # the singleton k-mers went
