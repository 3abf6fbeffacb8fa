"""BENCHMARK.json keeps to the benchmark's contract: names, units and
texts of the allowed characters and lengths, every file it names present,
and each cell with its metrics."""

import json
import re

import pytest

import tiny

SPEC = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield entry["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


def _text_ok(t):
    return 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert all(PATH.fullmatch(p) and ".." not in p for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_text_ok(w) for w in SPEC["command"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text_ok(c["source"]) and _text_ok(c["why"]) and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _text_ok(w["why"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _text_ok(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_names_and_units():
    names = list(_names())
    assert all(NAME.fullmatch(n) for n in names), [n for n in names if not NAME.fullmatch(n)]
    for group in ("configs", "workloads"):
        group_names = [e["name"] for e in SPEC[group]]
        assert len(set(group_names)) == len(group_names)
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    units = [m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(UNIT.fullmatch(u) for u in units)
    assert all(m["better"] in ("lower", "higher") for m in SPEC["end_to_end"] + SPEC["per_layer"])


def test_the_cells():
    """Every cell has its workload file, its job kind's module and the
    kind's file of the CPU tests: a cell comes in by files and entries."""
    bench = tiny.ROOT / "benchmark"
    for w in SPEC["workloads"]:
        wl = bench / "workloads" / f"{w['name']}.json"
        assert wl.is_file(), w["name"]
        kind = json.loads(wl.read_text())["kind"]
        assert (bench / "jobs" / f"{kind}.py").is_file(), (w["name"], kind)
        assert (bench / "tests" / "kinds" / f"{kind}.py").is_file(), (w["name"], kind)
    assert {m["name"] for m in SPEC["end_to_end"]} == {"sketch_gbase_s", "dist_pairs_s",
                                                       "setup_s"}


def test_files_are_there_and_under_paths():
    root = tiny.ROOT
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (root / c["file"]).is_file()
        conf = json.loads((root / c["file"]).read_text())
        assert set(c["reduced"]) == set(conf["reduced"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        wl = json.loads((root / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        assert (root / "benchmark" / "jobs" / f"{wl['kind']}.py").is_file()
        assert wl["end_to_end"] in {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert (root / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_every_cell_reports(cell):
    c = tiny.harness.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.workload["end_to_end"] in e2e
    assert c.per_layer and all(m["moves"] in e2e for m in c.per_layer)


def test_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
