"""Job kind `counts`: `engine.dist_counts_matrix(index, tile=...)`, the
library call behind `dist --counts`: the shared, union and inter count
matrices of a self all-vs-all, as pipelines that cluster or dereplicate
thousands of assemblies use them.

Inputs: `genomes` synthetic sketches of the configuration's s in its
families, drawn on the card and handed to the program as an index with
host planes (its blocks go to the card through the block cache).  After
each job's wall, the counts of `sampled_pairs` pairs i <= j drawn from the
seed and the job's number (`diagonal_pairs` of them on the diagonal) are
kept and the matrices dropped.  The judge counts those pairs again from
the sketches.  Work: n(n+1)/2 pairs a job, the diagonal included, in
nb(nb+1)/2 tiles (nb blocks of the workload's tile).
"""

from __future__ import annotations

import numpy as np

from ..reference import compare, nthash
from ..yardstick import data
from .common import job_rng


def keys(run):
    return data.family_sketch_keys(run.seed, run.config["genomes"], run.config["s"],
                                   run.config["family_size"], data.member_rates(run.config),
                                   run.device)


def setup(run) -> None:
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.params import SketchParams

    table = keys(run)
    n = table.shape[0]
    values = data.u64_table(table)
    sizes = (table != data.INF_KEY).sum(1).cpu().numpy()
    del table
    fs = run.config["family_size"]
    index = SketchIndex(SketchParams(k=run.config["k"], s=run.config["s"]),
                        [f"syn{i // fs}_{i % fs}" for i in range(n)],
                        (values >> np.uint64(32)).astype(np.uint32),
                        (values & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    nb = -(-n // min(run.workload["tile"], max(n, 1)))
    run.state.update(index=index, pairs=n * (n + 1) // 2, tiles=nb * (nb + 1) // 2,
                     sizes=sizes, drain_tiles=lambda: _drain_tiles(run))


def _drain_tiles(run) -> None:
    """engine.dist_tiles alone, as dist_counts_matrix calls it (raw
    rectangles, 8 tiles in flight)."""
    from miekki_tpu_torch import engine

    for _ in engine.dist_tiles(run.state["index"], tile=run.workload["tile"],
                               device=run.device, raw=True, depth=8):
        pass


def job(run, j: int) -> None:
    from miekki_tpu_torch import engine

    run.state["counts"] = engine.dist_counts_matrix(run.state["index"],
                                                    tile=run.workload["tile"],
                                                    device=run.device)


def sample(run, j: int):
    """(i, j) of the pairs judged in job j."""
    n, wl = run.config["genomes"], run.workload
    rng = job_rng(run.seed, j)
    a = rng.integers(0, n, wl["sampled_pairs"])
    b = rng.integers(0, n, wl["sampled_pairs"])
    d = rng.integers(0, n, wl["diagonal_pairs"])
    return (np.concatenate([np.minimum(a, b), d]),
            np.concatenate([np.maximum(a, b), d]))


def keep(run, j: int) -> int:
    counts = run.state.pop("counts")
    if j >= 0:
        gi, gj = sample(run, j)
        run.outputs.append((gi, gj, counts["shared"][gi, gj], counts["union"][gi, gj],
                            counts["inter"][gi, gj]))
    return run.state["pairs"]


def release(run) -> None:
    run.state.pop("index", None)
    run.state.pop("drain_tiles", None)


def judge(run) -> dict:
    table = keys(run)
    wrong = 0
    for gi, gj, *got in run.outputs:
        want = compare.pair_counts(table, gi, gj, run.config["s"])
        bad = np.zeros(gi.shape[0], bool)
        for g, w in zip(got, want):
            bad |= np.asarray(g, np.int64) != w
        wrong += int(bad.sum())
    return {"pairs_wrong": (wrong, 0)}


def control(run) -> None:
    cut = nthash.dedup_rows(nthash.to_codes32(keys(run)))
    gi, gj = sample(run, 0)
    run.outputs = [(gi, gj, *compare.pair_counts(cut, gi, gj, run.config["s"]))]
