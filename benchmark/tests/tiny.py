"""Cells of BENCHMARK.json cut to sizes a CPU test holds (the widths and
shapes of real runs come only from the card).  Each job kind's cut, its
control's sizes and its planted faults are in kinds/<kind>.py."""

import functools
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CELLS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])


@functools.cache
def kind(name: str):
    """The module kinds/<name>.py of the benchmark's tests."""
    path = Path(__file__).resolve().parent / "kinds" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_test_kinds.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_of(cell_name: str):
    """The kinds/ module of a cell's job kind."""
    return kind(harness.load_cell(cell_name).workload["kind"])


def cell(name: str, control: bool = False) -> harness.Cell:
    """The cell cut to its kind's CPU sizes (control: the control's)."""
    c = harness.load_cell(name)
    k = kind(c.workload["kind"])
    sizes = k.CONTROL if control else k.TINY
    c.config.update({key: v for key, v in sizes.items() if key in c.config})
    c.workload.update({key: v for key, v in sizes.items() if key in c.workload})
    return c


def run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.2):
    return harness.run_cell(cell(name), seed, seconds, False, "cpu", 0.0)
