"""Port parity: the fused sketch strategy (MIEKKI_MERGE=fused) — the K2
plain version (ops.fused_sketch.hash_reduce_plain) against the JAX
package's Pallas kernel hash_reduce_pallas (interpret mode), and the fused
sketch_chunked against the JAX package's fused strategy and the numpy
oracle.  Tolerance: none — candidates, counts and sketches are integers
and are compared bitwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miekki_tpu.ops import pallas_sketch as JPS
from miekki_tpu.ops import sketch as JS
from miekki_tpu.oracle import sketch as OS
from miekki_tpu_torch import engine as TE
from miekki_tpu_torch.ops import cuda_sketch as TCS
from miekki_tpu_torch.ops import fused_sketch as TF
from miekki_tpu_torch.ops import hash as TH
from miekki_tpu_torch.ops import sketch as TS
from miekki_tpu_torch.ops import u64 as tu64
from miekki_tpu_torch.params import SketchParams

K = 21


def _ref_hash_reduce(codes, thr_key, levels):
    """hash_reduce_pallas (interpret) with one threshold key for all rows →
    (int64 candidate keys, overflow flag)."""
    thr = tu64.u64_from_keys(np.array([thr_key], np.int64))[0]
    thi, tlo = np.uint32(thr >> np.uint64(32)), np.uint32(thr & np.uint64(0xFFFFFFFF))
    (hi, lo), overflow = JPS.hash_reduce_pallas(jnp.asarray(codes), K, (thi, tlo),
                                                interpret=True, levels=levels)
    return tu64.keys_from_planes(np.asarray(hi), np.asarray(lo)), bool(overflow)


@pytest.fixture(scope="module")
def code_rows():
    """Two genomes of 8 rows of 2,048 windows each, 1 % invalid codes."""
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=(16, 2048 + K - 1)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    return codes


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("tightness", ["inf", "mid", "tight"])
def test_plain_hash_reduce_matches_pallas(code_rows, levels, tightness):
    """Per-genome thresholds (one per 8 rows): INF overflows every group,
    the median overflows most, the 1 % quantile none."""
    h = TH.hash_windows(torch.from_numpy(code_rows), K)
    finite = h[h != tu64.INF_KEY].double()
    q = {"inf": None, "mid": (0.5, 0.45), "tight": (0.01, 0.012)}[tightness]
    thr = ([tu64.INF_KEY] * 2 if q is None
           else [int(torch.quantile(finite, x)) for x in q])
    got, cmax = TF.hash_reduce_plain(torch.from_numpy(code_rows), K,
                                     torch.tensor(thr), levels)
    assert got.shape == (16, 2048 // 4 ** levels) and cmax.dtype == torch.int32
    for gi in range(2):
        rows = slice(8 * gi, 8 * gi + 8)
        want, overflow = _ref_hash_reduce(code_rows[rows], thr[gi], levels)
        assert np.array_equal(got[rows].numpy(), want)
        assert bool(cmax[rows].max() > TF.GROUP_CAP) == overflow
    assert bool((cmax > TF.GROUP_CAP).any()) == (tightness != "tight")
    per_row, _ = TF.hash_reduce_plain(torch.from_numpy(code_rows), K,
                                      torch.tensor(thr).repeat_interleave(8), levels)
    assert torch.equal(per_row, got)


def test_levels_zero_and_three_and_the_width_rule(code_rows):
    """levels 0 is the thresholded hash; level 3 reduces level 2's output
    once more; widths the JAX kernel refuses raise its message."""
    codes = torch.from_numpy(code_rows[:2])
    thr = torch.tensor([tu64.INF_KEY])
    flat, cmax = TF.hash_reduce_plain(codes, K, thr, 0)
    assert torch.equal(flat, TH.hash_windows(codes, K)) and int(cmax.max()) == 0
    three, cmax3 = TF.hash_reduce_plain(codes, K, thr, 3)
    two, _ = TF.hash_reduce_plain(codes, K, thr, 2)
    assert three.shape == (2, 32) and int(cmax3.max()) == 128
    assert torch.equal(three, torch.sort(two.reshape(2, 1, 128), -1).values[..., :32].reshape(2, 32))
    with pytest.raises(ValueError, match="window count 2048 incompatible with 4 levels"):
        TF.hash_reduce_plain(codes, K, thr, 4)
    with pytest.raises(ValueError, match="window count 2048 incompatible with 4 levels"):
        TCS.hash_reduce_cuda(codes, K, thr, 4)
    with pytest.raises(ValueError, match="levels must be >= 0"):
        TF.hash_reduce_plain(codes, K, thr, -1)
    with pytest.raises(ValueError, match="do not divide"):
        TF.hash_reduce_plain(codes, K, torch.tensor([1, 2, 3]), 1)


def test_wrapper_on_cpu_runs_plain_version_without_launching(code_rows):
    codes = torch.from_numpy(code_rows)
    thr = torch.tensor([tu64.INF_KEY, 0])
    before = TCS.hash_reduce_cuda.launches
    got = TCS.hash_reduce_cuda(codes, K, thr, 2)
    assert TCS.hash_reduce_cuda.launches == before
    want = TF.hash_reduce_plain(codes, K, thr, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        TCS.hash_reduce_cuda(codes.to(torch.int32), K, thr, 2)
    with pytest.raises(ValueError):
        TCS.hash_reduce_cuda(codes, K, thr.to(torch.int32), 2)


def _jax_fused(rows, s, levels=2):
    hi, lo = JS.sketch_chunked(jnp.asarray(rows), K, s, strategy="fused",
                               fused_levels=levels)
    return tu64.keys_from_planes(np.asarray(hi), np.asarray(lo))


def _oracle_keys(codes, s):
    vals = OS.sketch_codes(np.asarray(codes, np.int64), K, s)
    return tu64.keys_from_u64(OS.pad_sketch(vals, s))


@pytest.mark.parametrize("levels", [1, 2])
def test_fused_sketch_matches_reference_and_oracle(levels):
    rng = np.random.default_rng(40 + levels)
    codes = rng.integers(0, 4, size=60_000).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 4
    rows = TS.bucketed_chunk_codes(codes, K, 4096)
    got = TS.sketch_chunked(torch.from_numpy(rows), K, 500, strategy="fused",
                            fused_levels=levels).numpy()
    assert np.array_equal(got, _jax_fused(rows, 500, levels))
    assert np.array_equal(got, _oracle_keys(codes, 500))


def test_fused_repetitive_genome_forces_the_exact_fallback(monkeypatch):
    """A genome made of one repeated motif keeps its threshold loose, so
    its groups overflow and every step is redone from the raw hashes; its
    batch neighbour (random) does not overflow after the cold first step."""
    calls = []
    real = TS._with_fallback

    def spy(out, overflow, exact):
        calls.append(overflow.tolist())
        return real(out, overflow, exact)

    monkeypatch.setattr(TS, "_with_fallback", spy)
    rng = np.random.default_rng(8)
    s = 300
    motif = rng.integers(0, 4, size=512)
    genomes = [np.tile(motif, 64).astype(np.uint8),  # 16 full rows of 2,048
               rng.integers(0, 4, size=32_768).astype(np.uint8)]
    rows = np.stack([TS.bucketed_chunk_codes(g, K, 2048) for g in genomes])
    got = TS.sketch_chunked(torch.from_numpy(rows), K, s, group=2, strategy="fused").numpy()
    assert len(calls) > 2 and all(c[0] for c in calls) and not all(c[1] for c in calls)
    for g in range(2):
        assert np.array_equal(got[g], _oracle_keys(genomes[g], s)), g
        assert np.array_equal(got[g], _jax_fused(rows[g], s)), g


def test_fused_with_chunk_1000_takes_the_plain_merge():
    """W - k + 1 = 1,000 is no multiple of 2,048: no K2, a plain sort-merge
    of every step, as in the JAX package."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=20_000).astype(np.uint8)
    rows = TS.chunk_codes(codes, K, 1000)
    assert (rows.shape[1] - K + 1) % TS.FUSED_WIDTH
    got = TS.sketch_chunked(torch.from_numpy(rows), K, 300, strategy="fused").numpy()
    assert np.array_equal(got, _jax_fused(rows, 300))
    assert np.array_equal(got, _oracle_keys(codes, 300))


def test_strategy_from_the_environment(monkeypatch):
    """MIEKKI_MERGE / MIEKKI_FUSED_LEVELS are read at call time, and both
    entry points of the sketch half (sketch_codes_device and the batched
    index build) reach the fused step; unported strategies raise."""
    steps = []
    real = TS._fused_step

    def spy(sketch, block, k, s, levels):
        steps.append(levels)
        return real(sketch, block, k, s, levels)

    monkeypatch.setattr(TS, "_fused_step", spy)
    rng = np.random.default_rng(6)
    codes = [rng.integers(0, 4, size=9_000).astype(np.uint8) for _ in range(3)]
    want = [TS.sketch_codes_device(c, K, 200, chunk=4096, device="cpu") for c in codes]
    assert not steps
    monkeypatch.setenv("MIEKKI_MERGE", "FUSED")
    monkeypatch.setenv("MIEKKI_FUSED_LEVELS", "1")
    got = TS.sketch_codes_device(codes[0], K, 200, chunk=4096, device="cpu")
    assert np.array_equal(got, want[0]) and steps == [1]
    idx = TE._build_index_from_codes(codes, ["a", "b", "c"], SketchParams(k=K, s=200),
                                     chunk=4096, batch=16, device="cpu")
    assert len(steps) == 2
    for i in range(3):
        assert np.array_equal(idx.sketch_u64(i), want[i])
    for bad in ("threshold", "sort"):
        monkeypatch.setenv("MIEKKI_MERGE", bad)
        with pytest.raises(ValueError, match="tree and fused"):
            TS.sketch_codes_device(codes[0], K, 200, chunk=4096, device="cpu")
