"""Job kind `screen`: `cli screen <index> <reads.fq> -p -o <file>` of a read
set against a saved sketch index, as users run `mash screen db.msh
reads.fq > screen.tab` to ask which reference genomes a sequencing run
holds (metagenome profiles, contamination checks, isolates against a
genus DB).

Inputs: the configuration's genomes in families (data.family_genomes),
each sketched on the device by the benchmark's own canonical ntHash and
bottom-s (reference/nthash.py) and saved by the program's own
SketchIndex.save as the index a user holds; and one read set made from the
seed (yardstick/reads.py), written once as plain FASTQ.  Each job loads
the index, screens the file with -p at the CLI's default batch and writes
the TSV to a file of its own: the wall holds the load, the read parse and
packing, the hashing and joins, the hits and the rows.  After the wall the
file's SHA-256 is kept and every older job's file deleted.  The judge
holds every job's digest to the kept file's, and the kept file, row by
row, to the plain reference (reference/screen.py) of the same index and
reads made again: every column equal as text, and a p-value equal as text
or within dist_tsv.P_TOLERANCE of the reference's.  Work: the read set's
bases, in Gbase.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..reference import nthash
from ..reference import screen as screen_ref
from ..yardstick import data, reads
from .common import cli
from .dist_tsv import names, rows_wrong

HASH_CHUNK = 1 << 18  # reads hashed a step by the reference


def _table(run) -> torch.Tensor:
    """[genomes, s] order keys: the bottom-s sketch of every genome."""
    cfg = run.config
    rates = data.member_rates(cfg)
    rows = []
    for f in range(cfg["genomes"] // cfg["family_size"]):
        members = torch.stack(data.family_genomes(run.seed, f, cfg["genome_bases"], rates,
                                                  run.device))
        rows += [nthash.bottom_s(r, cfg["s"]) for r in nthash.canonical_keys(members, cfg["k"])]
        del members
    return nthash.sketch_table(rows, cfg["s"])


def setup(run) -> None:
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.params import SketchParams

    cfg, wl = run.config, run.workload
    table = _table(run)
    values = data.u64_table(table)
    db = run.tmp / "db.npz"
    SketchIndex(SketchParams(k=cfg["k"], s=cfg["s"]), names(run),
                (values >> np.uint64(32)).astype(np.uint32),
                (values & np.uint64(0xFFFFFFFF)).astype(np.uint32)).save(db)
    fq = reads.write_fastq(run.tmp / "reads.fq", reads.read_set(run.seed, cfg, wl, run.device),
                           run.seed, wl["quality"])
    n, length = wl["reads"], wl["read_length"]
    run.state.update(db=db, reads=fq, table=table.cpu(), digests=[],
                     hashed_lengths=np.full(n, length), gbase=n * length / 1e9)


def _out(run, j: int):
    return run.tmp / (f"out{j}.tsv" if j >= 0 else "out-warm.tsv")


def job(run, j: int) -> None:
    cli(["screen", run.state["db"], run.state["reads"], "-p", "-o", _out(run, j),
         "--device", run.device.type])


def keep(run, j: int) -> float:
    path = _out(run, j)
    if j < 0:
        path.unlink()
        return run.state["gbase"]
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    run.state["digests"].append(h.hexdigest())
    if j > 0:
        _out(run, j - 1).unlink()
    run.state["kept"] = path
    return run.state["gbase"]


def release(run) -> None:
    pass


def reference(run, cut: bool = False) -> str:
    """The reference TSV of the run's index and reads; cut: the
    control's, every hash cut to 32 bits."""
    k = run.config["k"]
    table = run.state["table"].to(run.device)
    if cut:
        table = nthash.dedup_rows(nthash.to_codes32(table))
    h = screen_ref.distinct_hashes(
        reads.read_set(run.seed, run.config, run.workload, run.device).split(HASH_CHUNK), k,
        cut)
    return screen_ref.tsv(table, names(run), h, k)


def judge(run) -> dict:
    want = reference(run).encode()
    digests = run.state["digests"]
    wrong = rows_wrong(run.state["kept"].read_bytes(), want)
    # a job whose file differs from the kept one: its rows are not checked
    wrong += len(names(run)) * sum(d != digests[-1] for d in digests)
    return {"rows_wrong": (wrong, 0)}


def control(run) -> None:
    text = reference(run, cut=True).encode()
    path = run.tmp / "control.tsv"
    path.write_bytes(text)
    run.state.update(kept=path, digests=[hashlib.sha256(text).hexdigest()])
