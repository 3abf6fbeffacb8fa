"""The window's idle time keyed by what the host was doing: the innermost
program span open over it, else the top-level torch operation, else
nothing (Python and ctypes); the job spans and the warm-up burst are not
program spans, and the keys add up to the window's idle time."""

import json

import pytest

import tiny  # noqa: F401
from benchmark.yardstick import trace

JOB = "bench_job"


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _x("user_annotation", JOB, 0, 100), _x("user_annotation", JOB, 200, 100),
    _x("user_annotation", trace.WARMUP_SPAN, 0, 10),
    _x("user_annotation", "a", 10, 50), _x("user_annotation", "a.b", 20, 20),
    # started together: the first to end is the inner one
    _x("user_annotation", "c", 210, 70), _x("user_annotation", "d", 210, 40),
    _x("gpu_user_annotation", "a", 0, 300),  # the card's copy of a span: not the host's
    _x("kernel", "k", 40, 10),
    _x("cpu_op", "aten::y", 25, 10),  # under a.b: the span names it
    _x("cpu_op", "aten::x", 70, 10),  # under no span
]


def test_idle_under_the_innermost_program_span(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    s = trace.summarize(path, JOB)
    assert s["window_us"] == 200 and s["busy_us"] == 10
    want = {"a.b": 20, "a": 20, "d": 40, "c": 30, "aten::x": 10,
            # [0, 10] under the warm-up burst, [60, 70], [80, 100], [200, 210], [280, 300]
            trace.NO_OP: 70}
    assert s["idle_under_us"] == pytest.approx(want)
    assert sum(s["idle_under_us"].values()) == pytest.approx(s["window_us"] - s["busy_us"])
    assert trace.top(s["idle_under_us"], 2) == [[trace.NO_OP, 70e-6], ["d", 40e-6]]
