"""Port parity: bottom-s sketching (miekki_tpu_torch.ops.sketch) against the
JAX package's tree strategy and the numpy oracle.  Tolerance: none —
sketches are sets of 64-bit integers and must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miekki_tpu.ops import sketch as JS
from miekki_tpu.oracle import sketch as OS
from miekki_tpu_torch.ops import sketch as TS
from miekki_tpu_torch.ops import u64 as tu64


def _oracle(codes, k, s):
    return OS.sketch_codes(np.asarray(codes, np.int64), k, s)


def _jax_sketch(rows, k, s, group):
    hi, lo = JS.sketch_chunked(jnp.asarray(rows), k, s, group=group,
                               strategy="tree", hash_impl="xla")
    return tu64.keys_from_planes(np.asarray(hi), np.asarray(lo))


@pytest.mark.parametrize("k,s,chunk,n", [
    (21, 500, 4096, 60_000),   # one step, tree levels + cold-sketch fallback
    (31, 300, 777, 20_000),    # per-step merges
    (15, 256, 4096, 20_000),
    (63, 256, 4096, 20_000),
])
def test_sketch_codes_device_matches_oracle(k, s, chunk, n):
    rng = np.random.default_rng(k * 7 + n)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.random(n) < 0.002] = 4
    got = TS.sketch_codes_device(codes, k, s, chunk=chunk, device="cpu")
    assert np.array_equal(got, _oracle(codes, k, s))


@pytest.mark.parametrize("group,w,n_rows", [
    (1, 2048 + 20, 48),   # warmup + full groups + remainder group
    (2, 128 + 20, 38),    # group merge with a remainder of 3 steps
    (0, 4096 + 20, 4),    # auto group: below the group-merge gate
])
def test_sketch_chunked_matches_jax_tree(group, w, n_rows):
    rng = np.random.default_rng(group * 100 + n_rows)
    k, s = 21, 400
    rows = rng.integers(0, 4, size=(n_rows, w)).astype(np.uint8)
    rows[rng.random(rows.shape) < 0.001] = 4
    got = TS.sketch_chunked(torch.from_numpy(rows), k, s, group=group).numpy()
    assert np.array_equal(got, _jax_sketch(rows, k, s, group))


def test_repetitive_genome_forces_exact_fallback(monkeypatch):
    """A tiny survivor budget makes every tree level overflow on a
    repetitive genome (crowded rows); the exact fallback keeps the sketch
    equal to the oracle and to the JAX package."""
    monkeypatch.setattr(TS, "CAND_BUDGET", 64)
    calls = []
    real = TS._with_fallback

    def spy(out, overflow, exact):
        calls.append(bool(overflow.any()))
        return real(out, overflow, exact)

    monkeypatch.setattr(TS, "_with_fallback", spy)
    rng = np.random.default_rng(7)
    k, s = 21, 200
    motif = rng.integers(0, 4, size=150)
    genome = np.tile(motif, 300).astype(np.uint8)
    rows = TS.bucketed_chunk_codes(genome, k, 1024)
    got = TS.sketch_chunked(torch.from_numpy(rows), k, s, group=2).numpy()
    assert any(calls)
    assert np.array_equal(tu64.u64_from_keys(got[got != tu64.INF_KEY]),
                          _oracle(genome, k, s))
    assert np.array_equal(got, _jax_sketch(rows, k, s, 2))


def test_group_path_tree_levels_match_oracle(monkeypatch):
    """Small budgets make the group path run real tree levels (cap0 level,
    then cap levels) at test size; the result must stay exact."""
    monkeypatch.setattr(TS, "CAND_BUDGET", 256)
    rng = np.random.default_rng(11)
    k, s = 21, 100
    codes = rng.integers(0, 4, size=90_000).astype(np.uint8)
    rows = TS.bucketed_chunk_codes(codes, k, 2048)
    got = TS.sketch_chunked(torch.from_numpy(rows), k, s, group=2).numpy()
    assert np.array_equal(tu64.u64_from_keys(got), _oracle(codes, k, s))


def test_batched_genomes_equal_one_at_a_time():
    """The batch dimension (the JAX package's vmap) is exact per genome,
    including a genome whose fallback fires while its neighbours' do not."""
    rng = np.random.default_rng(5)
    k, s, w = 21, 150, 1024 + 20
    rows = rng.integers(0, 4, size=(3, 16, w)).astype(np.uint8)
    unit = rng.integers(0, 4, size=24)
    rows[1] = np.tile(unit, w // 24 + 1)[:w]  # repetitive: overflows
    got = TS.sketch_chunked(torch.from_numpy(rows), k, s, group=2)
    for g in range(3):
        one = TS.sketch_chunked(torch.from_numpy(rows[g]), k, s, group=2)
        assert torch.equal(got[g], one), g
        assert np.array_equal(one.numpy(), _jax_sketch(rows[g], k, s, 2)), g


def test_merge_into_sketch_incremental_matches_oracle():
    rng = np.random.default_rng(3)
    s = 64
    sk = TS.empty_sketch(s)
    seen = []
    # budget 64: 300 candidates > budget + s take the tree path (one level,
    # 3 rows of 128 -> 96 <= 2 * budget); the cold first merge overflows
    for _ in range(5):
        vals = rng.integers(0, 2**64 - 1, size=300, dtype=np.uint64)
        seen.append(vals)
        sk = TS.merge_into_sketch(sk, torch.from_numpy(tu64.keys_from_u64(vals)),
                                  s, budget=64)
        want = np.unique(np.concatenate(seen))[:s]
        assert np.array_equal(tu64.u64_from_keys(sk), want)


def test_chunk_codes_match_reference():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 5, size=10_001).astype(np.uint8)
    for k, chunk in ((21, 1000), (31, 4096), (15, 8192)):
        assert np.array_equal(TS.chunk_codes(codes, k, chunk),
                              JS.chunk_codes(codes, k, chunk))
        assert np.array_equal(TS.bucketed_chunk_codes(codes, k, chunk),
                              JS.bucketed_chunk_codes(codes, k, chunk))

