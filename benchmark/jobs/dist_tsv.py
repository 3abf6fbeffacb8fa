"""Job kind `dist_tsv`: `cli dist <index> -o <file>` of a saved sketch
index, the all-vs-all that users run as `mash dist db.msh db.msh >
dist.tsv` to get one row a pair (names, shared, union, Jaccard, Mash
distance, ANI, p-value) for trees, clustering and ANI screens.

Inputs: `genomes` synthetic sketches of the configuration's s in its
families, drawn on the card, put in an index with the names fam{f}_g{m}
and saved by the program's own `SketchIndex.save` as the file a user
holds.  Each job loads that file, compares every pair i < j at the
workload's tile and writes the TSV to a file of its own: the wall holds
the load, the tiles, the formatting and the write.  After the wall the
file's SHA-256 is kept and every older job's file deleted, so a run keeps
one.  The judge holds every job's digest to the kept file's, and the kept
file, row by row, to the plain reference (reference/mash.py): every column
equal as text, and a p-value equal as text or within P_TOLERANCE of the
reference's.  Work: the n(n-1)/2 rows of a job.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..reference import mash, nthash
from ..yardstick import data
from .common import cli, lines_differing
from .counts import keys

# Relative distance allowed between a p-value and the reference's: two
# float64 continued fractions agree to the last few bits, which can round
# the 10th significant digit apart; a p-value in float32 (7 digits) is far
# outside it.
P_TOLERANCE = 5e-10
P_COLUMN = mash.COLUMNS.index("p_value")


def names(run) -> list:
    fs = run.config["family_size"]
    return [f"fam{i // fs}_g{i % fs}" for i in range(run.config["genomes"])]


def setup(run) -> None:
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.params import SketchParams

    cfg = run.config
    values = data.u64_table(keys(run))
    index = SketchIndex(SketchParams(k=cfg["k"], s=cfg["s"]), names(run),
                        (values >> np.uint64(32)).astype(np.uint32),
                        (values & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    db = run.tmp / "db.npz"
    index.save(db)
    n = cfg["genomes"]
    nb = -(-n // min(run.workload["tile"], max(n, 1)))
    run.state.update(db=db, rows=n * (n - 1) // 2, tiles=nb * (nb + 1) // 2, digests=[])


def _out(run, j: int):
    return run.tmp / (f"out{j}.tsv" if j >= 0 else "out-warm.tsv")


def job(run, j: int) -> None:
    cli(["dist", run.state["db"], "-o", _out(run, j), "--tile", run.workload["tile"],
         "--device", run.device.type])


def keep(run, j: int) -> int:
    path = _out(run, j)
    if j < 0:
        path.unlink()
        return run.state["rows"]
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    run.state["digests"].append(h.hexdigest())
    if j > 0:
        _out(run, j - 1).unlink()
    run.state["kept"] = path
    return run.state["rows"]


def release(run) -> None:
    pass


def reference(run, cut: bool = False) -> str:
    """The reference TSV of the run's sketches; cut: the control's, of the
    values cut to 32 bits."""
    table = keys(run)
    if cut:
        table = nthash.dedup_rows(nthash.to_codes32(table))
    return mash.tsv(table, names(run), run.config["k"], run.config["s"])


def rows_wrong(got: bytes, want: bytes) -> int:
    """Lines of `got` whose columns other than the p-value differ from
    `want`'s at the same place, plus its p-values equal neither as text nor
    within P_TOLERANCE, plus the difference in the line counts."""
    if got == want:
        return 0
    g, w = got.split(b"\n"), want.split(b"\n")
    wrong = lines_differing(b"\n".join(_without_p(line) for line in g),
                            b"\n".join(_without_p(line) for line in w))
    for a, b in zip(g, w):
        pa, pb = _p(a), _p(b)
        if pa == pb:
            continue
        try:
            x, y = float(pa), float(pb)
        except ValueError:
            wrong += 1
            continue
        wrong += not abs(x - y) <= P_TOLERANCE * abs(y)
    return wrong


def _without_p(line: bytes) -> bytes:
    cols = line.split(b"\t")
    return b"\t".join(cols[:P_COLUMN] + cols[P_COLUMN + 1:])


def _p(line: bytes) -> bytes:
    cols = line.split(b"\t")
    return cols[P_COLUMN] if len(cols) > P_COLUMN else b""


def judge(run) -> dict:
    want = reference(run).encode()
    digests = run.state["digests"]
    wrong = rows_wrong(run.state["kept"].read_bytes(), want)
    # a job whose file differs from the kept one: its rows are not checked
    wrong += run.state["rows"] * sum(d != digests[-1] for d in digests)
    return {"rows_wrong": (wrong, 0)}


def control(run) -> None:
    text = reference(run, cut=True).encode()
    path = run.tmp / "control.tsv"
    path.write_bytes(text)
    run.state.update(kept=path, digests=[hashlib.sha256(text).hexdigest()])
