"""Port parity of the merge strategies (MIEKKI_MERGE=threshold|sort|tree|
fused), MIEKKI_HASH and MIEKKI_TREE_CAP0: miekki_tpu_torch.ops.sketch
against miekki_tpu.ops.sketch on the CPU (the JAX package's fused kernel in
interpret mode) and the numpy oracle, on seeded genomes of 60-150 kb at
k = 21.  The threshold cases are the reference's test_merge_threshold_*
(tests/test_ops_hash_sketch.py), batched over genomes so that the exact
fallback runs per genome.  Tolerance: none — sketches are u64 values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miekki_tpu.ops import sketch as JS
from miekki_tpu.ops import u64 as ju64
from miekki_tpu.oracle import nthash as O
from miekki_tpu_torch.ops import sketch as TS
from miekki_tpu_torch.ops import u64 as tu64

K = 21
INF = np.uint64(0xFFFFFFFFFFFFFFFF)


def _keys(vals):
    return torch.from_numpy(tu64.keys_from_u64(np.asarray(vals, np.uint64)))


def _jax_merge(sketch, vals, s, budget, strategy):
    out = JS.merge_into_sketch(tuple(jnp.asarray(p) for p in ju64.split(sketch)),
                               tuple(jnp.asarray(p) for p in ju64.split(vals)), s,
                               budget=budget, strategy=strategy)
    return ju64.join(np.asarray(out[0]), np.asarray(out[1]))


def test_merge_threshold_overflow_fallback(monkeypatch):
    """More survivors than the budget (a cold sketch) falls back exactly,
    for the overflowing genome only: the batch's second genome stays under
    the budget and keeps the compacted merge."""
    monkeypatch.setenv("MIEKKI_MERGE", "threshold")
    rng = np.random.default_rng(0)
    s, budget = 16, 8
    vals = rng.integers(0, 2 ** 40, size=256, dtype=np.uint64)  # many survivors
    seeded = np.sort(rng.integers(2 ** 20, 2 ** 40, size=s, dtype=np.uint64))
    cand = np.full(256, INF)
    cand[:40] = rng.integers(2 ** 41, 2 ** 42, size=40, dtype=np.uint64)  # above it
    cand[:4] = seeded[0] - np.arange(1, 5, dtype=np.uint64)  # 4 below the threshold
    sketch = np.stack([np.full(s, INF), seeded])
    exact = []
    real = TS._merge_sorted_trunc

    def spy(sk, c, s_):
        exact.append(c.shape)
        return real(sk, c, s_)

    monkeypatch.setattr(TS, "_merge_sorted_trunc", spy)
    got = TS.merge_into_sketch(_keys(sketch), _keys(np.stack([vals, cand])), s, budget=budget)
    assert [1, 256] in [list(x) for x in exact]  # the exact redo of genome 0 alone
    for g, (sk, c) in enumerate(((sketch[0], vals), (sketch[1], cand))):
        want = np.unique(np.concatenate([sk, c]))[:s]
        assert np.array_equal(tu64.u64_from_keys(got[g]), want), g
        assert np.array_equal(_jax_merge(sk, c, s, budget, "threshold"), want), g
    one = TS.merge_into_sketch(_keys(np.full(s, INF)), _keys(vals), s, budget=budget)
    assert np.array_equal(tu64.u64_from_keys(one), np.unique(vals)[:s])


def test_merge_threshold_small_path_with_duplicates(monkeypatch):
    """Repetitive input (many duplicate survivors) through the top-k
    compaction stays exact."""
    monkeypatch.setenv("MIEKKI_MERGE", "threshold")
    rng = np.random.default_rng(1)
    s, budget = 8, 32
    base = rng.integers(0, 2 ** 40, size=8, dtype=np.uint64)
    vals = np.concatenate([np.tile(base, 8), np.full(200 - 64, INF)])
    seed_vals = np.sort(rng.integers(2 ** 41, 2 ** 42, size=s, dtype=np.uint64))
    got = TS.merge_into_sketch(_keys(seed_vals), _keys(vals), s, budget=budget)
    want = np.unique(np.concatenate([seed_vals, base]))[:s]
    assert np.array_equal(tu64.u64_from_keys(got), want)
    assert np.array_equal(_jax_merge(seed_vals, vals, s, budget, "threshold"), want)


@pytest.mark.parametrize("strategy", ["sort", "threshold", "tree", "fused"])
def test_strategies_equal_reference_and_oracle(strategy):
    """Three genomes of 150 kb side by side in [3, 37, 4096 + k - 1] rows,
    8 rows a step (32,768 windows: threshold compacts and falls back on the
    cold first step, tree runs its warmup and group merges, fused its K2
    plain version); each genome's sketch equals the JAX package's under the
    same strategy and the oracle."""
    rng = np.random.default_rng(42)
    s = 500
    genomes = [rng.integers(0, 4, size=150_000).astype(np.uint8) for _ in range(3)]
    rows = np.stack([TS.chunk_codes(g, K, 4096) for g in genomes])
    if strategy == "fused":  # K2's path needs W - k + 1 a multiple of FUSED_WIDTH
        assert (rows.shape[-1] - K + 1) % TS.FUSED_WIDTH == 0
    got = TS.sketch_chunked(torch.from_numpy(rows), K, s, group=8, strategy=strategy)
    for g, genome in enumerate(genomes):
        hi, lo = JS.sketch_chunked(jnp.asarray(rows[g]), K, s, group=8, strategy=strategy,
                                   hash_impl="xla")
        want = ju64.join(np.asarray(hi), np.asarray(lo))
        assert np.array_equal(tu64.u64_from_keys(got[g]), want), (strategy, g)
        oracle = np.unique(O.canonical_hashes(genome.astype(np.int64), K))[:s]
        assert np.array_equal(want[want != INF], oracle), (strategy, g)


def test_tree_cap0_from_the_environment(monkeypatch):
    """MIEKKI_TREE_CAP0 is the group path's first-level cap, read at call
    time (unset or 0: TREE_CAP0); a cap of 1 overflows every group, whose
    genomes are redone exactly: the same sketch as the JAX package's under
    the same variable."""
    rng = np.random.default_rng(7)
    s = 300
    # 147 rows of 2,048 windows, 32 a step (65,536 windows, so a step's
    # first tree level runs): 2 warmup steps, then one group of 3
    genome = rng.integers(0, 4, size=300_000).astype(np.uint8)
    rows = TS.chunk_codes(genome, K, 2048)
    caps, fallbacks = [], []
    real_step, real_fb = TS._step_cand, TS._with_fallback

    def step(block, thr, k, overflow, cap0=TS.TREE_CAP0):
        caps.append(cap0)
        return real_step(block, thr, k, overflow, cap0)

    def fallback(out, overflow, exact):
        fallbacks.append(bool(overflow.any()))
        return real_fb(out, overflow, exact)

    monkeypatch.setattr(TS, "_step_cand", step)
    monkeypatch.setattr(TS, "_with_fallback", fallback)
    want = TS.sketch_chunked(torch.from_numpy(rows), K, s, group=32).numpy()
    assert set(caps) == {TS.TREE_CAP0}
    for value, cap in (("0", TS.TREE_CAP0), ("1", 1)):
        caps.clear()
        fallbacks.clear()
        monkeypatch.setenv("MIEKKI_TREE_CAP0", value)
        got = TS.sketch_chunked(torch.from_numpy(rows), K, s, group=32).numpy()
        assert np.array_equal(got, want) and set(caps) == {cap}, value
        hi, lo = JS.sketch_chunked(jnp.asarray(rows), K, s, group=32, strategy="tree",
                                   hash_impl="xla")
        assert np.array_equal(tu64.u64_from_keys(got), ju64.join(np.asarray(hi),
                                                                  np.asarray(lo)))
    assert fallbacks[-1]  # the last group under a cap of 1 overflowed


def test_hash_impl_values_select_k1(monkeypatch):
    """MIEKKI_HASH=auto|pallas|xla all run K1's wrapper (its plain version on
    CPU tensors) and give the same sketch; another value raises."""
    from miekki_tpu_torch.ops import cuda_hash

    rng = np.random.default_rng(3)
    rows = TS.chunk_codes(rng.integers(0, 4, size=20_000).astype(np.uint8), K, 4096)
    want = TS.sketch_chunked(torch.from_numpy(rows), K, 200)
    real = TS.hash_windows_cuda
    for value in ("auto", "pallas", "xla", "XLA"):
        calls = []
        monkeypatch.setattr(TS, "hash_windows_cuda",
                            lambda codes, k: calls.append(1) or real(codes, k))
        monkeypatch.setenv("MIEKKI_HASH", value)
        assert torch.equal(TS.sketch_chunked(torch.from_numpy(rows), K, 200), want)
        assert calls, value
    assert real is cuda_hash.hash_windows_cuda
    monkeypatch.setenv("MIEKKI_HASH", "nope")
    with pytest.raises(ValueError, match="MIEKKI_HASH"):
        TS.sketch_chunked(torch.from_numpy(rows), K, 200)
