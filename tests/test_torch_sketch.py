"""Port parity: bottom-s sketching (miekki_tpu_torch.ops.sketch) against the
JAX package's tree strategy and the numpy oracle.  Tolerance: none —
sketches are sets of 64-bit integers and must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miekki_tpu.ops import sketch as JS
from miekki_tpu.oracle import sketch as OS
from miekki_tpu_torch import engine as TE
from miekki_tpu_torch.io import encode as TENC
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



def _layout_genomes(case, k, chunk, rng):
    """Genomes of one shape bucket for a layout case, and the batch's g_pad."""
    def codes(n):
        return rng.integers(0, 4, size=n).astype(np.uint8)

    if case == "two_records":  # packed with its k - 1 separators
        return [TENC.pack_records([codes(5000), codes(2500)], k)], 1
    if case == "padding_genomes":  # 3 genomes of one shape in a batch of 4
        return [codes(n) for n in (chunk + 100, chunk + 2000, 2 * chunk)], 4
    n = {"zero": 0, "k-1": k - 1, "k": k, "long": 300_001,
         "chunk_multiple": 5 * chunk}.get(case)
    return [codes(int(case) if n is None else n)], 1


@pytest.mark.parametrize("k", [21, 31])
@pytest.mark.parametrize("case", ["zero", "k-1", "k", "4095", "4096", "4097", "8192",
                                  "8193", "chunk_multiple", "two_records", "long",
                                  "padding_genomes"])
def test_device_layout_equals_host_rows(case, k):
    """The index build's layout (codes staged end to end, copied into an
    INVALID-filled flat buffer, unfolded into overlapping rows) equals
    bucketed_chunk_codes byte for byte for each genome, all-INVALID rows
    for padding genomes, and bucketed_shape is the rows' shape."""
    chunk = 8192
    genomes, g_pad = _layout_genomes(case, k, chunk, np.random.default_rng(len(case) + k))
    shapes = {TS.bucketed_shape(len(g), k, chunk) for g in genomes}
    assert len(shapes) == 1
    (shape,) = shapes
    staging = TE._CodeStaging(pinned=False)
    off = staging.pack(0, genomes)
    assert off[-1] == sum(len(g) for g in genomes)
    rows = staging.upload(0, off, g_pad, shape, k, torch.device("cpu"))
    assert rows.shape == (g_pad,) + shape and rows.dtype == torch.uint8
    for gi, g in enumerate(genomes):
        want = TS.bucketed_chunk_codes(g, k, chunk)
        assert want.shape == shape
        assert np.array_equal(want, JS.bucketed_chunk_codes(g, k, chunk))
        assert np.array_equal(rows[gi].numpy(), want), gi
    assert bool((rows[len(genomes):] == TS.INVALID_CODE).all())
