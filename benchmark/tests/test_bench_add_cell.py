"""A cell comes in by files and entries alone.  In a copy of BENCHMARK.json
and benchmark/, a second `counts` cell is added as a cell-adding change
adds one: its workload file, its `workloads` entry, and its name in the
lists of the metrics the first counts cell reports.  The copy's own spec
and cell tests, with none of their files edited, then load it, run it
correct at CPU sizes, and find its control and its kind's faults not
correct."""

import json
import os
import shutil
import subprocess
import sys

import tiny

NEW = "bacteria-10k.counts-t1024"
LIKE = "bacteria-10k.counts"


def test_a_counts_cell_by_files_and_entries_alone(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(tiny.ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))

    workload = json.loads((bench / "workloads" / f"{LIKE}.json").read_text())
    (bench / "workloads" / f"{NEW}.json").write_text(json.dumps({**workload, "tile": 1024}))
    spec = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": NEW, "config": "bacteria-10k", "traffic": "counts-t1024",
                              "chips": 1, "why": "count matrices at tile 1024"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if LIKE in m.get("workloads", []):
            m["workloads"].append(NEW)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(tiny.ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    tests = bench / "tests"
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-v",
         str(tests / "test_bench_spec.py"), str(tests / "test_bench_cells.py"), "-k",
         f"not test_bench_cells or {NEW}"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    passed = [line for line in res.stdout.splitlines() if NEW in line and "PASSED" in line]
    # sound run, control, both faults of the kind; the spec's per-cell test
    assert any("test_sound_run_is_correct" in line for line in passed), res.stdout[-4000:]
    assert any("test_control_is_not_correct" in line for line in passed)
    assert sum("test_fault_is_not_correct" in line for line in passed) == len(
        tiny.kind("counts").FAULTS)
    assert any("test_every_cell_reports" in line for line in passed)
    assert "test_the_cells PASSED" in res.stdout
