"""Whole runs of each cell at CPU sizes: sound runs come out correct, the
control and the planted faults come out not correct."""

import pytest
import torch

import tiny
from benchmark import control

import miekki_tpu_torch.ops.intersect as intersect
import miekki_tpu_torch.ops.sketch as sketch_ops

INF = (1 << 63) - 1


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(name):
    res = tiny.run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    (metric,) = [m for m in res["metrics"] if m != "setup_s"]
    assert res["metrics"][metric]["value"] > 0


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_is_not_correct(name):
    res = control.control(tiny.cell(name, tiny.CONTROL), 7, "cpu")
    assert not res["correct"], res


def _alter_sketch(orig):
    def fn(*a, **kw):
        keys = orig(*a, **kw).clone()
        keys[0, 0] -= 1  # one sketch value altered where it is made
        return keys
    return fn


def _half_sketch(orig):
    def fn(*a, **kw):
        keys = orig(*a, **kw).clone()
        keys[keys.shape[0] // 2:] = INF  # half of the batch left out
        return keys
    return fn


def _alter_tile(orig):
    def fn(rows, cols, s):
        out = dict(orig(rows, cols, s))
        out["shared_in_x"] = out["shared_in_x"].clone()
        out["shared_in_x"][0, -1] += 1  # one count altered where it is made
        return out
    return fn


def _half_tile(orig):
    def fn(rows, cols, s):
        out = dict(orig(rows, cols, s))
        for key in ("shared_in_x", "union_size", "inter_full"):
            out[key] = out[key].clone()
            out[key][out[key].shape[0] // 2:] = 0  # half of the tile's rows left out
        return out
    return fn


FAULTS = [
    ("bacteria-1k.sketch", sketch_ops, "sketch_chunked", _alter_sketch),
    ("bacteria-1k.sketch", sketch_ops, "sketch_chunked", _half_sketch),
    ("bacteria-10k.counts", intersect, "tile_counts", _alter_tile),
    ("bacteria-10k.counts", intersect, "tile_counts", _half_tile),
]


@pytest.mark.parametrize("name,module,attr,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, _, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, module, attr, fault):
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    res = tiny.run(name)
    assert not res["correct"], res["checks"]


def test_run_refuses_without_a_card(tmp_path):
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: run.py would run")
    res = subprocess.run([sys.executable, str(tiny.ROOT / "benchmark" / "run.py"),
                          "--workload", "bacteria-1k.sketch", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert res.returncode == 2 and res.stdout == "", (res.returncode, res.stdout)
