"""The readers of the program-span metrics: their arithmetic on a given
registry and run, None where a span is absent or the program has no
registry (a program from before the spans), and a number from each after a tiny
cell's jobs under a CPU profiler.  `upload_gb_s` divides the span's bytes
by the trace's host-to-device copy time."""

from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

import tiny
from benchmark import harness

from miekki_tpu_torch.utils import profiling

SKETCH = ("parse_span_gbase_s", "batching_ms_per_gbase", "upload_gb_s",
          "index_store_ms_per_gbase")
COUNTS = ("tile_dispatch_ms_per_tile", "pull_wait_ms_per_tile", "assembly_ms_per_tile")


def _rec(s, **counts):
    return {"calls": 3, "s": s, "self_s": s / 2, **counts}


REGISTRY = {
    "sketch": _rec(4.0), "sketch.parse": _rec(0.5, bases=10), "sketch.bucket": _rec(0.25),
    "sketch.pack": _rec(0.5), "sketch.upload": _rec(0.003, bytes=250_000_000),
    "index.assemble": _rec(0.1), "index.save": _rec(0.3, bytes=5),
    "dist.counts": _rec(9.0), "dist.dispatch": _rec(0.42), "dist.pull_wait": _rec(2.1),
    "dist.assemble": _rec(0.84), "dist.fill": _rec(0.42),
}
# the window's device time in microseconds: 0.125 s of host-to-device copies
DEVICE_US = {"Memcpy HtoD (Pinned -> Device)": 100_000.0,
             "Memcpy HtoD (Pageable -> Device)": 25_000.0,
             "Memcpy DtoH (Device -> Pinned)": 400_000.0, "tile_counts_kernel<long>": 9e6}
# 2 jobs of 0.32 Gbase; 2 jobs of 10,240 genomes at tile 512: 210 tiles each
WANT = {
    "parse_span_gbase_s": 0.64 / 0.5,
    "batching_ms_per_gbase": 1e3 * 0.75 / 0.64,
    "upload_gb_s": 0.25 / 0.125,
    "index_store_ms_per_gbase": 1e3 * 0.4 / 0.64,
    "tile_dispatch_ms_per_tile": 1e3 * 0.42 / 420,
    "pull_wait_ms_per_tile": 1e3 * 2.1 / 420,
    "assembly_ms_per_tile": 1e3 * 1.26 / 420,
}
# the spans each metric reads
READS = {
    "parse_span_gbase_s": ("sketch.parse",),
    "batching_ms_per_gbase": ("sketch.bucket", "sketch.pack"),
    "upload_gb_s": ("sketch.upload",),
    "index_store_ms_per_gbase": ("index.assemble", "index.save"),
    "tile_dispatch_ms_per_tile": ("dist.dispatch",),
    "pull_wait_ms_per_tile": ("dist.pull_wait",),
    "assembly_ms_per_tile": ("dist.assemble", "dist.fill"),
}


def _stub(device_us=DEVICE_US):
    return SimpleNamespace(walls=[1.0, 1.2], state={"gbase": 0.32, "tiles": 210},
                           summary={"device_us": dict(device_us)} if device_us else {})


@pytest.mark.parametrize("name", SKETCH + COUNTS)
def test_reader_arithmetic(monkeypatch, name):
    monkeypatch.setattr(profiling, "SPANS", dict(REGISTRY))
    got = harness.metric_reader(name).read(_stub())
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", SKETCH + COUNTS)
def test_reader_gives_none_without_its_span(monkeypatch, name):
    for gone in READS[name]:
        reg = {k: v for k, v in REGISTRY.items() if k != gone}
        monkeypatch.setattr(profiling, "SPANS", reg)
        assert harness.metric_reader(name).read(_stub()) is None, gone
    monkeypatch.setattr(profiling, "SPANS", {})
    assert harness.metric_reader(name).read(_stub()) is None
    monkeypatch.delattr(profiling, "SPANS")  # a program without spans
    assert harness.metric_reader(name).read(_stub()) is None


def test_upload_reads_the_link(monkeypatch):
    """The span's bytes over the copies' device seconds: not the span's own
    seconds (the enqueue), not the card's other copies; None where the
    trace holds no host-to-device copy or the run is not traced."""
    monkeypatch.setattr(profiling, "SPANS", dict(REGISTRY))
    reader = harness.metric_reader("upload_gb_s")
    assert reader.read(_stub()) == pytest.approx(2.0, rel=1e-12)
    pinned = {k: v for k, v in DEVICE_US.items() if "Pageable" not in k}
    assert reader.read(_stub(pinned)) == pytest.approx(2.5, rel=1e-12)
    assert reader.read(_stub({"Memcpy DtoH (Device -> Pinned)": 1e5})) is None
    assert reader.read(_stub(None)) is None


def test_new_metrics_are_listed_for_their_cell():
    for cell, names in (("bacteria-1k.sketch", SKETCH), ("bacteria-10k.counts", COUNTS)):
        listed = {m["name"]: m for m in harness.load_cell(cell).per_layer}
        for name in names:
            source = "device_trace" if name == "upload_gb_s" else "program_span"
            assert listed[name]["source"] == source
            assert listed[name]["workloads"] == [cell]


# upload_gb_s also needs the card's copies in the trace
@pytest.mark.parametrize("name,metrics", [
    ("bacteria-1k.sketch", tuple(m for m in SKETCH if m != "upload_gb_s")),
    ("bacteria-10k.counts", COUNTS)])
def test_readers_find_the_jobs_spans(tmp_path, name, metrics):
    """Two jobs of the tiny cell under a CPU profiler, as in a traced
    window: every span metric of the cell reads a positive number."""
    cell = tiny.cell(name)
    run = harness.Run(cell, 2 ** 31 + 5, "cpu", tmp_path, True)
    drv = harness.job_kind(cell.workload["kind"])
    drv.setup(run)
    profiling.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for j in range(2):
                drv.job(run, j)
                run.walls.append(1.0)
                drv.keep(run, j)
        for m in metrics:
            value = harness.metric_reader(m).read(run)
            assert value is not None and value > 0, m
    finally:
        profiling.reset_spans()
