"""Job kind `sketch`: `cli sketch <FASTA files> -o <index>` of a batch of
genomes, as a user sketches a new batch of assemblies.

Inputs: the workload's `genomes_per_job` genomes of the configuration's
length in its families, one FASTA file each.  Each job writes its own
index file; the judge reads every one and holds each sketch and name
against the plain reference (canonical ntHash and bottom-s of the same
genomes).  Work: FASTA bases, in Gbase.
"""

from __future__ import annotations

from ..reference import nthash
from ..yardstick import data
from .common import cli


def _genomes(run):
    cfg = run.config
    rates = data.member_rates(cfg)
    fs = cfg["family_size"]
    for f in range(run.workload["genomes_per_job"] // fs):
        for m, codes in enumerate(data.family_genomes(run.seed, f, cfg["genome_bases"],
                                                      rates, run.device)):
            yield f"fam{f}_g{m}", codes


def setup(run) -> None:
    d = run.tmp / "fasta"
    d.mkdir()
    paths, lengths = [], []
    for name, codes in _genomes(run):
        paths.append(str(data.write_fasta(d / f"{name}.fa", name, codes)))
        lengths.append(int(codes.shape[0]))
    run.state.update(paths=paths, hashed_lengths=lengths, gbase=sum(lengths) / 1e9)


def job(run, j: int) -> None:
    out = run.tmp / (f"index{j}.npz" if j >= 0 else "index-warm.npz")
    cli(["sketch", *run.state["paths"], "-o", out, "-k", run.config["k"],
         "-s", run.config["s"], "--device", run.device.type])
    run.state["last"] = out


def keep(run, j: int) -> float:
    if j >= 0:
        run.outputs.append(run.state["last"])
    return run.state["gbase"]


def release(run) -> None:
    pass


def reference(run, cut: bool = False) -> list:
    """The sketch of every genome as numpy uint64; cut: the control's, of
    the hashes cut to 32 bits."""
    k, s = run.config["k"], run.config["s"]
    out = []
    for _, codes in _genomes(run):
        keys = nthash.canonical_keys(codes, k)
        out.append(nthash.u64(nthash.bottom_s(nthash.to_codes32(keys) if cut else keys, s)))
    return out


def judge(run) -> dict:
    want = reference(run)
    paths = run.state["paths"]
    wrong = 0
    for out in run.outputs:
        if isinstance(out, tuple):
            names, rows = out
        else:
            names, table = data.read_index(out)
            rows = [r[r != data.U64_MAX] for r in table]
        if len(rows) != len(want) or list(names) != paths:
            wrong += len(want)
            continue
        wrong += sum(len(a) != len(b) or bool((a != b).any()) for a, b in zip(rows, want))
    return {"sketches_wrong": (int(wrong), 0)}


def control(run) -> None:
    run.outputs = [(list(run.state["paths"]), reference(run, cut=True))]
