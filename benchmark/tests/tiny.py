"""Cells of BENCHMARK.json cut to sizes a CPU test holds (the widths and
shapes of real runs come only from the card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CELLS = ("bacteria-10k.counts", "bacteria-1k.sketch")
SMALL = {"genome_bases": 3000, "s": 64, "genomes": 16, "genomes_per_job": 8}
# large enough for 32-bit codes to collide: the control's sizes
CONTROL = {"genome_bases": 20000, "s": 2048, "genomes": 24, "genomes_per_job": 8}


def cell(name: str, sizes: dict = SMALL) -> harness.Cell:
    c = harness.load_cell(name)
    c.config.update({k: v for k, v in sizes.items() if k in c.config})
    c.workload.update({k: v for k, v in sizes.items() if k in c.workload})
    if c.workload["kind"] == "counts":
        c.workload.update(tile=8, sampled_pairs=64, diagonal_pairs=8)
    return c


def run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.2, sizes: dict = SMALL):
    return harness.run_cell(cell(name, sizes), seed, seconds, False, "cpu", 0.0)
