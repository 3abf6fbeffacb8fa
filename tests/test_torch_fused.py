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
from miekki_tpu_torch.oracle import nthash as TO
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
    index build) reach the fused step; threshold and sort give the same
    sketches, and a strategy the JAX package does not know raises."""
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
    for other in ("threshold", "sort"):
        monkeypatch.setenv("MIEKKI_MERGE", other)
        got = TS.sketch_codes_device(codes[0], K, 200, chunk=4096, device="cpu")
        assert np.array_equal(got, want[0]) and len(steps) == 2
    monkeypatch.setenv("MIEKKI_MERGE", "nope")
    with pytest.raises(ValueError, match="unknown merge strategy"):
        TS.sketch_codes_device(codes[0], K, 200, chunk=4096, device="cpu")


# ---- A CPU model of kernel K2's decomposition (csrc/hash_reduce.cu): runs
# of 32 windows hashed from one seed each, four runs per level-1 group
# (lane i holding window i of each run), and the group reduction (ballot compaction and a 32-wide bitonic sort cut at the least
# power of two >= the count for up to 32 finite values, the exact
# 128-value sort above).  Change it together with the kernel.

RUN, SPAN = 32, 4096
U64_INF = TO.UINT64_MAX


def _run_hashes(codes, k, run=RUN):
    """The kernel's hash of one code row [W] → u64 [n], INF where invalid:
    windows in runs of `run`, each run seeded once (F = XOR rol(seedF[c_i],
    k - 1 - i), R = XOR rol(seedR[c_i], i)) and rolled with one table entry
    per (outgoing, incoming) code pair; the last invalid code read decides
    validity."""
    n = codes.shape[0] - k + 1
    n_runs = -(-n // run)
    staged = np.full(n_runs * run + k - 1, 4, np.int64)
    staged[:codes.shape[0]] = np.minimum(codes, 4)
    invalid = staged == 4
    c = np.where(invalid, 0, staged)
    sf, sr = TO.SEEDS, TO.SEEDS[::-1]
    roll_f = TO.rol64(sf, k)[:, None] ^ sf[None, :]
    roll_r = TO.ror64(sr, 1)[:, None] ^ TO.rol64(sr, k - 1)[None, :]
    p0 = np.arange(n_runs) * run
    f = np.zeros(n_runs, np.uint64)
    r = np.zeros(n_runs, np.uint64)
    bad = np.full(n_runs, -1)
    for i in range(k):
        bad = np.where(invalid[p0 + i], i, bad)
        f ^= TO.rol64(sf[c[p0 + i]], k - 1 - i)
        r ^= TO.rol64(sr[c[p0 + i]], i)
    out = np.empty((n_runs, run), np.uint64)
    for j in range(run):
        if j:
            pin = j - 1 + k
            bad = np.where(invalid[p0 + pin], pin, bad)
            co, ci = c[p0 + j - 1], c[p0 + pin]
            f = TO.rol64(f, 1) ^ roll_f[co, ci]
            r = TO.ror64(r, 1) ^ roll_r[co, ci]
        out[:, j] = np.where(bad < j, np.minimum(f, r), U64_INF)
    return out.reshape(-1)[:n]


def _bitonic32(x, count):
    lane = np.arange(32)
    size = 2
    while size <= 32 and size < 2 * count:
        up = (lane & size) == 0
        j = size >> 1
        while j:
            o = x[lane ^ j]
            x = np.where(up == ((lane & j) == 0), np.minimum(x, o), np.maximum(x, o))
            j >>= 1
        size <<= 1
    return x


def _reduce_group(v):
    """reduce_group on a group held as v [4, 32] (register, lane) →
    (count, its 32 outputs by lane)."""
    finite = v != U64_INF
    count = int(finite.sum())
    if count == 0:
        return 0, np.full(32, U64_INF)
    if count > 32:
        return count, np.sort(v.reshape(-1))[:32]
    scratch = np.full(32, U64_INF)
    slot = 0
    for reg, m in zip(v, finite):
        scratch[(slot + np.cumsum(m) - m)[m]] = reg[m]  # slot + finite lanes below
        slot += int(m.sum())
    return count, _bitonic32(np.where(np.arange(32) < count, scratch, U64_INF), count)


def _model_hash_reduce(vals, levels):
    """The kernel's layout and reductions on thresholded values [R, n] (u64,
    window order) → (candidates [R, n / 4^levels], counts [R])."""
    rows, n = vals.shape
    spans = -(-n // SPAN)
    cands, cmax = [], np.zeros(rows, np.int32)
    for row in range(rows):
        full = np.full(spans * SPAN, U64_INF)
        full[:n] = vals[row]
        level = []
        for s in range(spans):
            outs = full[s * SPAN:(s + 1) * SPAN].reshape(32, 4, 32)  # group g: runs 4 g + q
            for _ in range(min(levels, 3)):
                red = [_reduce_group(v) for v in outs]
                cmax[row] = max([cmax[row]] + [c for c, _ in red])
                outs = np.stack([o for _, o in red])
                if len(outs) >= 4:
                    outs = outs.reshape(-1, 4, 32)
            level.append(outs.reshape(-1))
        row_out = np.concatenate(level)[:n >> (2 * min(levels, 3))]
        for _ in range(levels - 3):  # the extra pass: 128 consecutive candidates
            red = [_reduce_group(v) for v in row_out.reshape(-1, 4, 32)]
            cmax[row] = max([cmax[row]] + [c for c, _ in red])
            row_out = np.concatenate([o for _, o in red])
        cands.append(row_out)
    return np.stack(cands), cmax


def _thresholded(codes, thr_keys):
    h = TH.hash_windows(torch.from_numpy(codes), K)
    h = torch.where(h < torch.tensor(thr_keys)[:, None], h, tu64.INF_KEY)
    return tu64.u64_from_keys(h.numpy())


DECOMPOSITION_CASES = (
    [("hash", k, run) for k, run in ((1, 32), (2, 32), (17, 7), (21, 4), (31, 32),
                                     (33, 32), (63, 32), (64, 32), (64, 1))]
    + [("layout", levels, 0) for levels in (1, 2, 3, 4)]
    + [("permuted", levels, 0) for levels in (1, 2, 3)]
    + [("select", count, tied) for count in (0, 1, 31, 32, 33) for tied in (0, 1)])


@pytest.mark.parametrize("kind,a,b", DECOMPOSITION_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in DECOMPOSITION_CASES])
def test_k2_decomposition_matches_plain(kind, a, b):
    """"hash": runs of b windows rolled from one seed equal ops.hash at
    k = a, with invalid codes and a partial last run.  "layout": the
    kernel's runs, swizzle, groups and levels (a levels) on per-row INF,
    loose, tight and all-A inputs equal hash_reduce_plain bitwise, counts
    included; "permuted": the same after shuffling each 128-window group.
    "select": one group of a finite values (b: all tied, as an all-A row
    gives) reduces to the plain sort's 32 smallest."""
    rng = np.random.default_rng(100 + a + 7 * b)
    if kind == "hash":
        codes = rng.integers(0, 4, size=300 + a - 1).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.03] = rng.choice([4, 5, 255])
        want = TH.hash_windows(torch.from_numpy(codes[None]), a)[0].numpy()
        assert np.array_equal(_run_hashes(codes, a, b), tu64.u64_from_keys(want))
        return
    if kind == "select":
        v = np.full(128, U64_INF)
        pos = rng.choice(128, size=a, replace=False)
        v[pos] = 12345 if b else rng.integers(0, 1 << 20, size=a, dtype=np.uint64)
        count, out = _reduce_group(v.reshape(4, 32))
        assert count == a and np.array_equal(out, np.sort(v)[:32])
        return
    n = 8192 if a == 4 else 6144  # 6,144: a tail span of 2,048 windows
    codes = rng.integers(0, 4, size=(4, n + K - 1)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[3] = 0  # all-A: every window hashes alike
    h = TH.hash_windows(torch.from_numpy(codes), K)
    finite = h[h != tu64.INF_KEY].double()
    thr = np.array([tu64.INF_KEY, int(torch.quantile(finite, 0.3)),
                    int(torch.quantile(finite, 0.003)), int(h[3, 0]) + 1], np.int64)
    vals = _thresholded(codes, thr)
    if kind == "permuted":
        groups = vals.reshape(4, -1, 128)
        vals = np.take_along_axis(groups, rng.permuted(
            np.broadcast_to(np.arange(128), groups.shape), axis=-1), -1).reshape(4, -1)
    got, cmax = _model_hash_reduce(vals, a)
    want, want_max = TF.hash_reduce_plain(torch.from_numpy(codes), K, torch.from_numpy(thr), a)
    assert np.array_equal(got, tu64.u64_from_keys(want.numpy()))
    assert np.array_equal(cmax, want_max.numpy())
    assert cmax.max() > 32 and (a == 1 or cmax.min() > 0)
