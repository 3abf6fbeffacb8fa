"""Job kind `stripe`: one row stripe of an all-vs-all's count matrices
against a compact DB held on the card, through
`engine.dist_counts_matrix(stripe, db, tile=...)`, the library call behind
`dist --counts`.  A deployment that shards the all-vs-all gives each
device the whole DB and its own stripes of rows.

Inputs: `genomes` synthetic sketches of the configuration's s in their
families, drawn on the card, compacted there by the program's own
`ops.compact.compact_rows` into one [genomes, s] int32 code-key table, and
handed to the program as a compact index whose host planes are the codes
(pulled once) and whose device_planes are the table: the resident DB of a
service, not timed.  Job j compares stripe j mod (genomes / rows_per_job),
rows [r0, r0 + rows_per_job) of the DB, made a compact index over views
of the DB's host planes and device planes, with the whole DB.  After each
job's wall the counts of `sampled_pairs` (stripe row, any DB row) pairs
drawn from the seed and the job's number, one pair of each stripe row
with another member of its family, and `self_pairs` of a stripe row with
itself are kept and the matrices dropped.  The judge counts those pairs
again from the sketches made anew and compacted by the reference's own
encoder.  Work: rows_per_job * genomes pairs a job.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import compact as ref_compact
from ..reference import compare
from .common import job_rng
from .counts import keys

COMPACT_ROWS = 4096  # rows compacted at a time in set-up


def setup(run) -> None:
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.ops import compact
    from miekki_tpu_torch.params import SketchParams

    cfg = run.config
    n, s, rows = cfg["genomes"], cfg["s"], cfg["rows_per_job"]
    if n % rows:
        raise ValueError(f"{n} genomes are not whole stripes of {rows} rows")
    raw = keys(run)
    table = torch.empty((n, s), dtype=torch.int32, device=run.device)
    for o in range(0, n, COMPACT_ROWS):
        table[o:o + COMPACT_ROWS] = compact.compact_rows(raw[o:o + COMPACT_ROWS])
    del raw
    codes = compact.codes_from_keys32(table)
    fs = cfg["family_size"]
    db = SketchIndex(SketchParams(k=cfg["k"], s=s, compact=True),
                     [f"syn{i // fs}_{i % fs}" for i in range(n)], codes,
                     compact.lo_plane_np(codes))
    db.device_planes = table
    tile = min(run.workload["tile"], max(n, 1))
    run.state.update(db=db, rows=rows, stripes=n // rows, pairs=rows * n,
                     tiles=-(-rows // tile) * -(-n // tile), window_stripes=[],
                     sizes=(table != compact.INF_KEY32).sum(1).cpu().numpy())


def stripe_start(run, j: int) -> int:
    """First DB row of job j's stripe."""
    return (j % run.state["stripes"]) * run.state["rows"]


def job(run, j: int) -> None:
    from miekki_tpu_torch import engine
    from miekki_tpu_torch.index.store import SketchIndex

    db, rows = run.state["db"], run.state["rows"]
    r0 = stripe_start(run, j)
    part = slice(r0, r0 + rows)
    stripe = SketchIndex(db.params, db.names[part], db.hi[part], db.lo[part])
    stripe.device_planes = db.device_planes[part]
    run.state["counts"] = engine.dist_counts_matrix(stripe, db, tile=run.workload["tile"],
                                                    device=run.device)


def sample(run, j: int):
    """(stripe rows, DB rows) of the pairs judged in job j."""
    cfg, wl = run.config, run.workload
    n, rows, fs = cfg["genomes"], cfg["rows_per_job"], cfg["family_size"]
    rng = job_rng(run.seed, j)
    own = stripe_start(run, j) + np.arange(rows)
    mate = own - own % fs + (own % fs + rng.integers(1, fs, rows)) % fs
    d = rng.integers(0, rows, wl["self_pairs"])
    return (np.concatenate([rng.integers(0, rows, wl["sampled_pairs"]), np.arange(rows), d]),
            np.concatenate([rng.integers(0, n, wl["sampled_pairs"]), mate, own[d]]))


def keep(run, j: int) -> int:
    counts = run.state.pop("counts")
    if j >= 0:
        gi, gj = sample(run, j)
        r0 = stripe_start(run, j)
        run.state["window_stripes"].append(r0)
        run.outputs.append((r0 + gi, gj, counts["shared"][gi, gj], counts["union"][gi, gj],
                            counts["inter"][gi, gj]))
    return run.state["pairs"]


def release(run) -> None:
    run.state.pop("db", None)


def judge(run) -> dict:
    table = ref_compact.compact_table(keys(run))
    wrong = 0
    for gi, gj, *got in run.outputs:
        want = compare.pair_counts(table, gi, gj, run.config["s"])
        bad = np.zeros(gi.shape[0], bool)
        for g, w in zip(got, want):
            bad |= np.asarray(g, np.int64) != w
        wrong += int(bad.sum())
    return {"pairs_wrong": (wrong, 0)}


def control(run) -> None:
    cut = ref_compact.to_codes16(ref_compact.compact_table(keys(run)))
    gi, gj = sample(run, 0)
    gi = stripe_start(run, 0) + gi
    run.outputs = [(gi, gj, *compare.pair_counts(cut, gi, gj, run.config["s"]))]
