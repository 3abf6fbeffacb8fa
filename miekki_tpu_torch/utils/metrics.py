"""Structured phase metrics (SURVEY.md §5 "Metrics / logging / observability").

Each phase appends one JSON object to a metrics file (bases/s/chip, pairs/s,
scaling efficiency, ...) — the exact metric set BASELINE.json names — so
benchmark harnesses and tests can scrape them.
"""

from __future__ import annotations

import json
import time
from typing import Optional


def emit(path: Optional[str], **fields) -> dict:
    """Record one phase metric row; returns the row (writes if path given)."""
    row = {"ts": time.time(), **fields}
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
    return row


def read(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
