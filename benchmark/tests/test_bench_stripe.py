"""The `stripe` cell's pieces: the reference's compact encoder against the
port's (`ops.compact.encode_u64`, `SketchIndex.to_compact`,
`compact_rows`), the judge telling compact counts from the raw values'
counts, and K4's bound of one stripe job counted by hand."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness
from benchmark.jobs import stripe
from benchmark.reference import compact as ref_compact
from benchmark.reference import compare, nthash
from benchmark.yardstick import roofline

CELL = "bacteria-100k.stripe"
# 0, 1, the mantissa's edges, the top bit alone, the largest value below
# the sentinel's cell, values that would land on the sentinel, UINT64_MAX
EDGES = [0, 1, 2, 3, (1 << 26) - 1, 1 << 26, (1 << 26) + 1, 1 << 27, (1 << 27) + 1,
         (1 << 56) - 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - (1 << 37) - 1,
         (1 << 64) - (1 << 37), (1 << 64) - 2, (1 << 64) - 1]


def _keys(values: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.uint64).view(np.int64) ^ np.int64(-(1 << 63)))


def test_encode_equals_the_ports_at_the_edges():
    from miekki_tpu_torch.ops import compact

    values = np.array(EDGES, np.uint64)
    got = ref_compact.encode(_keys(values)).numpy()
    assert np.array_equal(got, compact.encode_u64(values).astype(np.int64))
    assert got[0] == 0 and got[-1] == 0xFFFFFFFF
    assert list(got[-4:-1]) == [0xFFFFFFFE] * 3  # clamped below the sentinel


def _rows_with_collisions(seed: int, n: int, s: int) -> np.ndarray:
    """[n, s] sorted distinct u64 rows, INF-padded, whose values often share
    a code: runs of neighbours 1 apart, around the edges above."""
    rng = np.random.default_rng(seed)
    table = np.full((n, s), np.uint64(0xFFFFFFFFFFFFFFFF))
    for i in range(n):
        base = rng.choice(np.array(EDGES[:-1], np.uint64), s // 2)
        near = rng.integers(0, 1 << 40, s // 2, dtype=np.uint64)
        vals = np.unique(np.concatenate([base, base + np.uint64(1), near]))
        vals = vals[vals != np.uint64(0xFFFFFFFFFFFFFFFF)]
        size = int(rng.integers(1, min(s, len(vals)) + 1))
        table[i, :size] = vals[:size]
    return table


@pytest.mark.parametrize("seed", [3, 4])
def test_compact_table_equals_the_ports(seed):
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.ops import compact
    from miekki_tpu_torch.params import SketchParams

    n, s = 12, 48
    table = _rows_with_collisions(seed, n, s)
    keys = _keys(table)
    got = ref_compact.compact_table(keys, chunk=5)
    index = SketchIndex(SketchParams(k=31, s=s), [str(i) for i in range(n)],
                        (table >> np.uint64(32)).astype(np.uint32),
                        (table & np.uint64(0xFFFFFFFF)).astype(np.uint32)).to_compact()
    want = torch.from_numpy(index.hi.astype(np.int64))
    assert torch.equal(got, ref_compact.code_keys(want))
    port = compact.codes_from_keys32(compact.compact_rows(keys))
    assert torch.equal(torch.from_numpy(port.astype(np.int64)), want)
    assert (got == nthash.INF_KEY).sum() > (keys == nthash.INF_KEY).sum()  # codes collided


def test_judge_tells_compact_counts_from_raw_ones(tmp_path):
    """The same pairs counted on the raw 64-bit values, with no compaction,
    in the program's place, are judged not correct."""
    cell = tiny.cell(CELL, control=True)
    run = harness.Run(cell, 7, "cpu", tmp_path, trace=False)
    stripe.setup(run)
    stripe.release(run)
    gi, gj = stripe.sample(run, 0)
    gi = stripe.stripe_start(run, 0) + gi
    run.outputs = [(gi, gj, *compare.pair_counts(stripe.keys(run), gi, gj,
                                                 run.config["s"]))]
    (wrong, limit), = stripe.judge(run).values()
    assert wrong > limit


def test_k4_bound_of_a_stripe_job():
    """512 stripe rows against 102,400 DB rows at 10,000 codes each: one
    int32 operation a key a pair, 62.7 ms on an H100's int32 lanes."""
    h100 = roofline.peaks("NVIDIA H100 80GB HBM3")
    ops, nbytes = roofline.k3_work_rect([10_000] * 512, [10_000] * 102_400, key_bytes=4,
                                        ops_per_key=1)
    assert ops == 2 * 512 * 102_400 * 10_000
    assert nbytes == 4 * (512 + 102_400) * 10_000 + 12 * 512 * 102_400
    assert ops / (132 * 64 * 1.98e9) == pytest.approx(0.06269, abs=1e-5)
    assert roofline.bound_s(ops, nbytes, h100) * 1e3 == pytest.approx(62.69, abs=0.01)


def test_reference_compact_loads_nothing_of_the_port():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(tiny.ROOT)!r})\n"
        "import benchmark.reference.compact\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'miekki_tpu', 'miekki_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-3000:]
