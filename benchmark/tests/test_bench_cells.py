"""Whole runs of each cell at CPU sizes: sound runs come out correct, the
control and the planted faults come out not correct."""

import pytest
import torch

import tiny
from benchmark import control


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
    res = control.control(tiny.cell(name, control=True), 7, "cpu")
    assert not res["correct"], res


# every fault of a cell's job kind (kinds/<kind>.py), planted in each cell of that kind
FAULTS = [(name, module, attr, fault) for name in tiny.CELLS
          for module, attr, fault in tiny.kind_of(name).FAULTS]


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
