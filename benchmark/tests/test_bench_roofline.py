"""The roofline counts at the shapes of the port's kernel table: a 512 x 512
K3 tile at s = 10,000 and a [1024, 8222] K1 block at k = 31, and the
bounds of the cells' jobs."""

import pytest

import tiny  # noqa: F401
from benchmark.yardstick import roofline

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_h100_peaks():
    assert H100["int32_ops_per_s"] == pytest.approx(132 * 64 * 1.98e9)
    assert H100["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks("NVIDIA A100-SXM4-80GB") is None


def test_k3_512_tile():
    ops, nbytes = roofline.k3_work_rect([10_000] * 512, [10_000] * 512)
    assert ops == 2 * (512 * 512 * 10_000 * 2)
    assert nbytes == 8 * 2 * 512 * 10_000 + 12 * 512 * 512
    assert roofline.bound_s(ops, nbytes, H100) * 1e3 == pytest.approx(0.6269, abs=1e-4)


def test_k4_512_tile_and_defaults():
    """K4's 32-bit keys: one int32 operation and 4 B a key; the defaults
    count K3's 64-bit keys."""
    ops, nbytes = roofline.k3_work_rect([10_000] * 512, [10_000] * 512, key_bytes=4,
                                        ops_per_key=1)
    assert ops == 512 * 512 * 10_000 * 2
    assert nbytes == 4 * 2 * 512 * 10_000 + 12 * 512 * 512
    assert roofline.bound_s(ops, nbytes, H100) * 1e3 == pytest.approx(0.3134, abs=1e-4)
    sizes = [3, 5, 7]
    assert roofline.k3_work_self(sizes, key_bytes=4, ops_per_key=1) == (
        (3 + 5) + (3 + 7) + (5 + 7), 4 * 15 + 12 * 3)
    assert roofline.k3_work_self(sizes) == roofline.k3_work_self(
        sizes, key_bytes=8, ops_per_key=roofline.K3_OPS_PER_KEY)


def test_k1_block():
    ops, nbytes = roofline.k1_work([8222] * 1024, 31)
    assert nbytes == 1024 * 8222 + 8 * 1024 * 8192
    assert ops == 24 * 1024 * 8192
    assert roofline.bound_s(ops, nbytes, H100) * 1e3 == pytest.approx(0.02255, abs=1e-5)
    assert ops / H100["int32_ops_per_s"] * 1e3 == pytest.approx(0.01203, abs=1e-5)


def test_cells_jobs():
    # bacteria-10k.counts: every pair i < j of 10,240 full sketches
    ops, nbytes = roofline.k3_work_self([10_000] * 10_240)
    assert ops == 2 * 10_239 * 10_240 * 10_000
    assert roofline.bound_s(ops, nbytes, H100) == pytest.approx(0.1254, abs=1e-4)
    # the self all-vs-all is the sum of its pairs
    sizes = [3, 5, 7]
    ops3, _ = roofline.k3_work_self(sizes)
    assert ops3 == 2 * ((3 + 5) + (3 + 7) + (5 + 7))
    # bacteria-1k.sketch: 64 genomes of 5 Mbase, bound by bytes
    ops, nbytes = roofline.k1_work([5_000_000] * 64, 31)
    assert nbytes / H100["hbm_bytes_per_s"] > ops / H100["int32_ops_per_s"]


def test_trace_summary(tmp_path):
    """Busy time is the union of device work inside the job spans; idle time
    is put under the host operation that covers it."""
    import json

    from benchmark.yardstick import trace

    ev = [{"ph": "X", "cat": "user_annotation", "name": "job", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "job", "ts": 200, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 90, "dur": 130},
          {"ph": "X", "cat": "cpu_op", "name": "aten::x", "ts": 40, "dur": 30}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(path, "job")
    assert s["window_us"] == 200 and s["busy_us"] == 60
    assert s["kernel_us"] == {"k": 40} and s["device_us"]["copy"] == 30
    assert s["idle_under_us"] == {"aten::x": 30, trace.NO_OP: 110}
    assert trace.top(s["device_us"], 1) == [["k", 40e-6]]
