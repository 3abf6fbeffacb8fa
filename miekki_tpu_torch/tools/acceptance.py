"""BASELINE.json configs 1-5 on the port (the counterpart of the JAX
package's tools/acceptance.py, with its checks and its CI and --full
sizes).

    python -m miekki_tpu_torch.tools.acceptance [--full] [--workdir DIR]
        [--device cuda|cpu]

  1 one genome sketched (k = 31) equals the numpy oracle; its
    self-comparison gives Jaccard 1 and distance 0;
  2 10 related genomes, every pair equal to the oracle (shared, union,
    distance);
  3 an all-vs-all of 64 genomes (1,000 with --full): the pair count, and
    the pairs of 6 sampled genomes equal to the oracle;
  4 reads of config 2's first genome screened against its index:
    containment > 0.5, every containment in [0, 1], and at CI size equal
    to the oracle's;
  5 parallel.dist_sharded over a mesh of 8 positions of the device
    ([device] * 8, the host ring) equal, pair for pair, to config 2's
    one-device rows.

Sizes: genomes of 50 kbase and s = 400 at CI size (config 3: 3 kbase,
s = 400; config 4: 2,000 reads of 100 bases); --full: 4.6 Mbase,
s = 10,000 (config 3: 1,000 genomes of 30 kbase; config 4: 10 M reads).
Prints one JSON line per config (pass, seconds, the kernels' launches
with each counter set to 0 just before its config) and then
{"all_pass": ...}; exits 1 if a config fails.  Runs on the card by
default and raises without one; `--device cpu` runs the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import engine
from ..io import encode
from ..ops import cuda_hash, cuda_intersect
from ..oracle import compare as oc
from ..oracle import nthash
from ..oracle import sketch as osk
from ..parallel import dist_sharded, local_mesh
from ..params import SketchParams
from ..utils import device as _device
from .synth import make_genome_family, reads_from_genome, write_fasta, write_fastq

K = 31
SEED = 2026
MESH_POSITIONS = 8


WRAPPERS = {"k1": cuda_hash.hash_windows_cuda, "k3": cuda_intersect.tile_counts_cuda}


def run(full: bool, workdir: Path, device, emit=None) -> list:
    """Configs 1-5 in order; returns their result rows (and passes each to
    `emit` as it is made)."""
    dev = _device.resolve(device)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    genome_len = 4_600_000 if full else 50_000
    n_genomes = 10
    s = 10_000 if full else 400
    params = SketchParams(k=K, s=s)
    results = []
    t0 = 0.0

    def start() -> None:
        nonlocal t0
        for fn in WRAPPERS.values():
            fn.launches = 0
        t0 = time.perf_counter()

    def done(config: int, ok, **kw) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        row = {"config": config, "pass": bool(ok), "seconds": time.perf_counter() - t0,
               **kw, "launches": {name: fn.launches for name, fn in WRAPPERS.items()},
               "device": str(dev)}
        results.append(row)
        if emit is not None:
            emit(row)

    # ---- 1: one genome, oracle-exact, self-comparison
    start()
    g1 = make_genome_family(rng, 1, genome_len)[0]
    p1 = write_fasta(workdir / "ecoli_like.fa", [("g1", g1)])
    sk_dev = engine.sketch_file(p1, params, device=dev)
    sk_oracle = osk.sketch_codes(encode.encode(g1), K, s)
    row = engine.dist(engine.build_index([p1, p1], params, device=dev), device=dev)[0]
    done(1, np.array_equal(sk_dev, sk_oracle) and row["jaccard"] == 1.0
         and row["mash_distance"] == 0.0, bases=genome_len)

    # ---- 2: related genomes, every pair equal to the oracle
    start()
    fam = make_genome_family(rng, n_genomes, genome_len // 5, sub_rate=0.03)
    paths = [write_fasta(workdir / f"fam{i}.fa", [(f"fam{i}", g)]) for i, g in enumerate(fam)]
    idx = engine.build_index(paths, params, device=dev)
    rows = engine.dist(idx, device=dev)
    sketches = [osk.sketch_codes(encode.encode(g), K, s) for g in fam]
    ok = len(rows) == n_genomes * (n_genomes - 1) // 2
    for r in rows:
        want = oc.compare_sketches(sketches[r["i"]], sketches[r["j"]], K, s)
        ok &= (r["shared"] == want["shared"] and r["union"] == want["union"]
               and r["mash_distance"] == want["distance"])
    done(2, ok, pairs=len(rows))

    # ---- 3: a larger all-vs-all, pair count and oracle spots
    start()
    n3 = 1000 if full else 64
    s3 = s if full else min(s, 1024)
    fam3 = make_genome_family(rng, n3, 30_000 if full else 3_000, sub_rate=0.06)
    paths3 = [write_fasta(workdir / f"c3_{i}.fa", [(f"c3_{i}", g)])
              for i, g in enumerate(fam3)]
    rows3 = engine.dist(engine.build_index(paths3, SketchParams(k=K, s=s3), device=dev),
                        device=dev)
    by_ij = {(r["i"], r["j"]): r for r in rows3}
    ok = len(rows3) == n3 * (n3 - 1) // 2
    chosen = list(rng.choice(n3, size=6, replace=False))
    sk3 = {i: osk.sketch_codes(encode.encode(fam3[i]), K, s3) for i in chosen}
    for a in range(len(chosen)):
        for b in range(a + 1, len(chosen)):
            i, j = sorted((chosen[a], chosen[b]))
            ok &= by_ij[(i, j)]["shared"] == oc.compare_sketches(sk3[i], sk3[j], K, s3)["shared"]
    done(3, ok, genomes=n3, pairs=len(rows3), s=s3)

    # ---- 4: read screening against config 2's index
    start()
    n_reads = 10_000_000 if full else 2_000
    reads = reads_from_genome(rng, fam[0], n_reads, 100)
    rp = write_fastq(workdir / "reads.fq", [(f"r{i}", x) for i, x in enumerate(reads)])
    if full:
        del reads  # the streamed path's memory is what is measured
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    scr = engine.screen(idx, rp, device=dev)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    ok = scr[0]["containment"] > 0.5 and all(0.0 <= r["containment"] <= 1.0 for r in scr)
    if not full:  # exact oracle parity at CI size
        # 'N'-joined reads: a window spanning a boundary covers an invalid
        # base, so the hash set is the union over the reads
        read_hashes = nthash.canonical_hashes(encode.encode(b"N".join(reads)), K)
        ok &= abs(scr[0]["containment"] - oc.containment(sketches[0], read_hashes)) < 1e-12
    done(4, ok, reads=n_reads, max_rss_mb=round(rss1 / 1024),
         rss_growth_mb=round((rss1 - rss0) / 1024))

    # ---- 5: the host ring over 8 positions == the one-device rows
    start()
    mesh = local_mesh(devices=[dev] * MESH_POSITIONS)
    c = dist_sharded(idx, mesh)
    ok = all(int(c["shared"][r["i"], r["j"]]) == r["shared"]
             and int(c["union"][r["i"], r["j"]]) == r["union"] for r in rows)
    done(5, ok, mesh_devices=mesh.devices.size)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="BASELINE scales")
    ap.add_argument("--workdir", default=None, help="default: a temporary directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    def emit(row):
        print(json.dumps(row), flush=True)

    with tempfile.TemporaryDirectory(prefix="miekki_acceptance_") as tmp:
        results = run(args.full, Path(args.workdir or tmp), dev, emit)
    all_pass = all(r["pass"] for r in results)
    print(json.dumps({"all_pass": all_pass}), flush=True)
    return 0 if all_pass else 1


if __name__ == "__main__":
    sys.exit(main())
