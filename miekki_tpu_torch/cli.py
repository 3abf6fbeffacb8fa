"""Command-line interface of the PyTorch/CUDA port, in the Mash idiom:

  python -m miekki_tpu_torch.cli sketch <genomes...> -o db.npz [-k 31] [-s 10000]
                                        [--per-record] [--shards N] [-l|--list]
                                        [-m N] [--compress]
  python -m miekki_tpu_torch.cli dist   <db.npz|shards...|genomes...>
                                        [--ref db2.npz] -o out.tsv
                                        [--counts c.npz] [--manifest m.jsonl]
                                        [--distributed]
                                        [--matrix] [--containment] [--bounds]
                                        [--max-dist D] [--max-p P] [--tile T]
  python -m miekki_tpu_torch.cli screen <db.npz> <reads.fq[.gz]...> -o out.tsv
                                        [-w] [-p] [--flat F] [--distributed]
  python -m miekki_tpu_torch.cli triangle <db.npz|genomes...> -o out.phylip
  python -m miekki_tpu_torch.cli info   <db.npz> [--dump]
  python -m miekki_tpu_torch.cli merge  <dbs...> -o merged.npz
  python -m miekki_tpu_torch.cli compress <db.npz> -o db32.npz

Every command that computes takes --device {cuda,cpu} (default cuda; cuda
without a card is an error).  Index files, count matrices and texts are
those of `python -m miekki_tpu.cli` (npz files member for member).
Inputs that are npz archives are loaded as sketch indexes (several =
shards, concatenated); anything else is a FASTA/FASTQ(.gz) genome file
sketched on the fly.  `sketch -m N` (the `mash sketch -m` analog) keeps
only k-mers seen at least N times, for read sets; `--shards N` writes N
shard files; `merge` concatenates indexes (`mash paste`).  `--compress`
and `compress` write a compact index (32-bit fingerprints, half the
file); `dist` of a compact index runs kernel K4, of a raw one K3.
`dist --counts FILE` writes the int32 shared/union/inter count matrices
(.npz; the artifact at 10k+ genomes), `--manifest FILE` makes the TSV
resumable tile by tile (rerun the same command to continue), `--matrix`
and `triangle` write Phylip distance matrices.  `screen` (the `mash
screen` analog; `-w` winner-takes-all, `-p` a p-value column) hashes the
reads with kernel K1 and writes the containment of each DB genome; DBs
beyond the device-memory budget (utils.hbm) are screened in genome groups
with the same rows.  MIEKKI_MERGE=fused (optionally MIEKKI_FUSED_LEVELS)
sketches through kernel K2.  `--metrics FILE` appends phase metrics JSON;
`--profile DIR` writes a torch.profiler trace of the command to DIR.
`dist --distributed` (TSV or `--counts`) and `screen --distributed` run
over every visible card of --device (parallel.local_mesh): the ring of
column blocks for dist, reads data-parallel for screen; their outputs are
the one-device outputs (`--distributed --counts` writes the full symmetric
matrices of a self-comparison).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import engine
from .index.npz import SAVE_COUNTS
from .index.store import SketchIndex
from .params import SketchParams
from .utils import metrics as _metrics
from .utils.profiling import span


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-k", type=int, default=31, help="k-mer length (default 31)")
    p.add_argument("-s", type=int, default=10_000, help="sketch size (default 10000)")
    p.add_argument("--chunk", type=int, default=engine.DEFAULT_CHUNK,
                   help="bases per device hashing step")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace to DIR")
    p.add_argument("--metrics", metavar="FILE", default=None,
                   help="write phase metrics JSON to FILE")


def _is_index_file(path) -> bool:
    """An index file is an npz (zip) archive; sequence files are FASTA/
    FASTQ or gzip.  Content sniffing, not extension."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"PK\x03\x04"
    except OSError:
        return False


def _load_or_build(paths, args) -> SketchIndex:
    paths = _expand_lists(paths, getattr(args, "list", False))
    idx = [p for p in paths if str(p).endswith(".npz") or _is_index_file(p)]
    if idx and len(idx) == len(paths):
        if len(paths) == 1:
            return SketchIndex.load(paths[0])
        return SketchIndex.load_sharded(paths)
    if idx:
        raise SystemExit(
            "inputs mix sketch index files and sequence files: "
            f"{[str(p) for p in idx]} are indexes; pass either all indexes "
            "or all FASTA/FASTQ")
    params = SketchParams(k=args.k, s=args.s)
    return engine.build_index(paths, params, chunk=args.chunk, device=args.device)


def _out(args):
    """Output handle usable in a `with` block; stdout is never closed."""
    if args.output != "-":
        return open(args.output, "w")
    import contextlib

    return contextlib.nullcontext(sys.stdout)


def _expand_lists(paths, list_mode: bool):
    """mash -l analog: with --list, each input is a text file of paths
    (one per line, blanks/# comments skipped)."""
    if not list_mode:
        return paths
    out = []
    for lf in paths:
        with open(lf) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    out.append(line)
    if not out:
        raise SystemExit(f"--list files named no inputs: {paths}")
    return out


def cmd_sketch(args) -> int:
    args.genomes = _expand_lists(args.genomes, args.list)
    params = SketchParams(k=args.k, s=args.s)
    t0 = time.perf_counter()
    if args.per_record:
        index = engine.build_index_per_record(args.genomes, params,
                                              chunk=args.chunk,
                                              min_copies=args.min_copies,
                                              device=args.device)
    else:
        index = engine.build_index(args.genomes, params, chunk=args.chunk,
                                   min_copies=args.min_copies,
                                   device=args.device)
    dt = time.perf_counter() - t0
    if args.compress:
        index = index.to_compact()
    with span("index.save") as sp:
        pieces = SAVE_COUNTS["pieces"]
        if args.shards > 1:
            paths = index.save_sharded(args.output.removesuffix(".npz"), args.shards)
        else:
            index.save(args.output)
            paths = [args.output]
        sp.add(bytes=sum(os.path.getsize(p) for p in paths),
               pieces=SAVE_COUNTS["pieces"] - pieces)
    if args.shards > 1:
        print(f"wrote {len(paths)} shards", file=sys.stderr)
    total = int(index.sizes().sum())
    _metrics.emit(args.metrics, phase="sketch", genomes=len(index),
                  sketch_hashes=total, seconds=dt)
    print(f"sketched {len(index)} genomes (k={params.k}, s={params.s}) "
          f"in {dt:.2f}s -> {args.output}", file=sys.stderr)
    return 0


def cmd_dist(args) -> int:
    index_a = _load_or_build(args.query, args)
    index_b = SketchIndex.load(args.ref) if args.ref else None
    cols = engine.select_columns(args.containment, args.bounds)
    t0 = time.perf_counter()
    if args.matrix:
        # a distance matrix has no per-pair rows: refuse row-level flags
        # rather than drop them
        if index_b is not None:
            print("dist: --matrix is self-all-vs-all only", file=sys.stderr)
            return 2
        if (args.containment or args.bounds or args.max_dist is not None
                or args.max_p is not None):
            print("dist: --matrix excludes --containment/--bounds/"
                  "--max-dist/--max-p", file=sys.stderr)
            return 2
        text = engine.dist_matrix_text(index_a, tile=args.tile, device=args.device)
        dt = time.perf_counter() - t0
        with _out(args) as f:
            f.write(text)
        _metrics.emit(args.metrics, phase="dist", seconds=dt, matrix=True)
        print(f"wrote {len(index_a)}x{len(index_a)} matrix in {dt:.2f}s",
              file=sys.stderr)
        return 0
    if args.distributed:
        return _dist_distributed(args, index_a, index_b, cols, t0)
    if args.counts:
        counts = engine.dist_counts_matrix(index_a, index_b, tile=args.tile,
                                           device=args.device)
        return _write_counts(args, index_a, index_b, counts, t0)
    if args.manifest:
        if args.output == "-":
            print("dist: --manifest requires -o FILE", file=sys.stderr)
            return 2
        n = engine.dist_resumable(index_a, args.output, args.manifest,
                                  index_b, tile=args.tile, columns=cols,
                                  max_dist=args.max_dist, max_p=args.max_p,
                                  bounds=args.bounds, device=args.device)
        dt = time.perf_counter() - t0
        _metrics.emit(args.metrics, phase="dist", pairs=n, seconds=dt,
                      pairs_per_s=n / dt if dt > 0 else 0.0)
        print(f"compared {n} new pairs in {dt:.2f}s (resumable via "
              f"{args.manifest})", file=sys.stderr)
        return 0
    with _out(args) as f:
        n = engine.dist_tsv_write(f, index_a, index_b, tile=args.tile,
                                  columns=cols, max_dist=args.max_dist,
                                  max_p=args.max_p, device=args.device)
    dt = time.perf_counter() - t0
    _metrics.emit(args.metrics, phase="dist", pairs=n, seconds=dt,
                  pairs_per_s=n / dt if dt > 0 else 0.0)
    print(f"compared {n} pairs in {dt:.2f}s", file=sys.stderr)
    return 0


def _write_counts(args, index_a, index_b, counts, t0, **extra) -> int:
    idx_b = index_b if index_b is not None else index_a
    np.savez_compressed(
        args.counts,
        shared=counts["shared"], union=counts["union"],
        inter=counts["inter"],
        k=index_a.params.k, s=index_a.params.s,
        query_names=np.array(index_a.names),
        reference_names=np.array(idx_b.names),
    )
    dt = time.perf_counter() - t0
    _metrics.emit(args.metrics, phase="dist", seconds=dt,
                  pairs=int(counts["shared"].size), **extra)
    print(f"wrote count matrices {counts['shared'].shape} "
          f"in {dt:.2f}s -> {args.counts}", file=sys.stderr)
    return 0


def _dist_distributed(args, index_a, index_b, cols, t0) -> int:
    """`dist --distributed`: full count matrices over the mesh of
    --device's cards, then the TSV (or `--counts`)."""
    from .parallel import dist_sharded, local_mesh

    counts = dist_sharded(index_a, local_mesh(device=args.device),
                          index_b=index_b, tile=args.tile)
    if args.counts:
        return _write_counts(args, index_a, index_b, counts, t0, distributed=True)
    with _out(args) as f:
        n = engine.counts_tsv_write(
            f, index_a, counts["shared"], counts["union"], index_b,
            inter=counts["inter"], columns=cols,
            max_dist=args.max_dist, max_p=args.max_p,
        )
    dt = time.perf_counter() - t0
    _metrics.emit(args.metrics, phase="dist", pairs=n, seconds=dt,
                  pairs_per_s=n / dt if dt > 0 else 0.0, distributed=True)
    print(f"compared {n} pairs on the device mesh in {dt:.2f}s",
          file=sys.stderr)
    return 0


def cmd_screen(args) -> int:
    index = SketchIndex.load(args.db)
    t0 = time.perf_counter()
    stats: dict = {}
    if args.distributed:
        from .parallel import local_mesh, screen_sharded
        from .parallel.mesh import DATA_AXIS

        rows = screen_sharded(index, args.reads,
                              local_mesh(axis_names=(DATA_AXIS,), device=args.device),
                              flat=args.flat, winner=args.winner, stats=stats,
                              p_values=args.p_values)
    else:
        rows = engine.screen(index, args.reads, flat=args.flat,
                             winner=args.winner, stats=stats,
                             p_values=args.p_values, device=args.device)
    dt = time.perf_counter() - t0
    cols = ("reference", "hits", "sketch_size", "containment",
            "containment_lo", "containment_hi", "ani")
    if args.p_values:
        cols = cols + ("p_value",)
    with span("screen.rows"), _out(args) as f:
        f.write(engine.rows_to_tsv(rows, columns=cols))
    _metrics.emit(args.metrics, phase="screen", genomes=len(rows), seconds=dt,
                  **stats)
    print(f"screened reads against {len(rows)} genomes in {dt:.2f}s",
          file=sys.stderr)
    return 0


def cmd_triangle(args) -> int:
    """Lower-triangular Phylip distance matrix (the `mash triangle` analog)."""
    index = _load_or_build(args.query, args)
    t0 = time.perf_counter()
    text = engine.dist_triangle_text(index, tile=args.tile, device=args.device)
    dt = time.perf_counter() - t0
    with _out(args) as f:
        f.write(text)
    _metrics.emit(args.metrics, phase="triangle", genomes=len(index),
                  seconds=dt)
    print(f"wrote {len(index)}-genome lower-triangular matrix in {dt:.2f}s",
          file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    index = SketchIndex.load(args.db)
    if args.dump:
        # mash info -d analog: full sketch contents as JSON
        print(json.dumps({
            "params": index.params.to_dict(),
            "sketches": [
                {"name": index.names[i],
                 "hashes": [int(h) for h in index.sketch_u64(i)]}
                for i in range(len(index))
            ],
        }))
        return 0
    card = index.cardinalities()
    print(json.dumps({
        "genomes": len(index),
        "params": index.params.to_dict(),
        "sketch_sizes": {"min": int(index.sizes().min()) if len(index) else 0,
                         "max": int(index.sizes().max()) if len(index) else 0},
        "est_distinct_kmers": {
            "min": int(card.min()) if len(index) else 0,
            "max": int(card.max()) if len(index) else 0,
        },
        "names": index.names[:10] + (["..."] if len(index) > 10 else []),
    }, indent=2))
    return 0


def cmd_merge(args) -> int:
    """Concatenate sketch indexes (the `mash paste` analog)."""
    parts = [SketchIndex.load(p) for p in args.inputs]
    base = parts[0]
    for p in parts[1:]:
        base.params.validate_compatible(p.params)
    merged = SketchIndex(
        base.params,
        [n for p in parts for n in p.names],
        np.concatenate([p.hi for p in parts]),
        np.concatenate([p.lo for p in parts]),
    )
    merged.save(args.output)
    print(f"merged {len(parts)} indexes -> {len(merged)} genomes",
          file=sys.stderr)
    return 0


def cmd_compress(args) -> int:
    """Convert a raw index to 32-bit compact fingerprints (ops.compact):
    half the index file; jaccard/containment gain a ~3e-4 collision bias.
    Compact and raw indexes are incomparable (params keyed)."""
    index = SketchIndex.load(args.db)
    if index.params.compact:
        print("index is already compact", file=sys.stderr)
        return 1
    index.to_compact().save(args.output)
    print(f"compressed {len(index)} genomes: "
          f"{os.path.getsize(args.db)} -> {os.path.getsize(args.output)} "
          f"bytes -> {args.output}", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    ap = argparse.ArgumentParser(prog="miekki-tpu-torch", description=__doc__)
    ap.add_argument("--version", action="version",
                    version=f"miekki-tpu-torch {__version__}")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("sketch", help="sketch genomes into an index file")
    p.add_argument("genomes", nargs="+")
    p.add_argument("-l", "--list", action="store_true",
                   help="inputs are text files listing genome paths, one "
                   "per line (mash -l analog)")
    p.add_argument("-o", "--output", required=True, help="output index (.npz)")
    p.add_argument("--per-record", action="store_true",
                   help="sketch each FASTA/FASTQ record separately "
                   "(mash sketch -i analog)")
    p.add_argument("--shards", type=int, default=1,
                   help="split the index into N shard files")
    p.add_argument("-m", "--min-copies", type=int, default=1,
                   help="keep only k-mers occurring at least this many times "
                   "— drops sequencing-error k-mers in read sets "
                   "(mash sketch -m analog)")
    p.add_argument("--compress", action="store_true",
                   help="store 32-bit compact fingerprints (half size, "
                   "~3e-4 jaccard bias)")
    _add_common(p)
    p.set_defaults(fn=cmd_sketch)

    p = sub.add_parser("dist", help="pairwise Mash distances")
    p.add_argument("query", nargs="+", help="index (.npz) or genome files")
    p.add_argument("-l", "--list", action="store_true",
                   help="query inputs are text files listing paths (mash -l)")
    p.add_argument("--ref", default=None, help="reference index (.npz); "
                   "default: all-vs-all on the query set")
    p.add_argument("-o", "--output", default="-", help="output TSV (default stdout)")
    p.add_argument("--tile", type=int, default=engine.DEFAULT_TILE)
    p.add_argument("--manifest", default=None, metavar="FILE",
                   help="JSONL tile manifest enabling checkpoint/resume of "
                   "the comparison (rerun with the same args to continue)")
    p.add_argument("--distributed", action="store_true",
                   help="all-vs-all over every card of --device (a ring of "
                   "column blocks); with --counts, the full matrices")
    p.add_argument("--matrix", action="store_true",
                   help="write a Phylip-style square distance matrix "
                   "(mash dist -t analog)")
    p.add_argument("--counts", metavar="FILE", default=None,
                   help="write raw shared/union/inter count matrices to "
                   "FILE (.npz) instead of a TSV — the right artifact at "
                   "10k+ genomes")
    p.add_argument("--containment", action="store_true",
                   help="add containment_q/containment_r/ani_containment "
                   "columns (BinDash-style sketch containment)")
    p.add_argument("--max-dist", type=float, default=None, metavar="D",
                   help="only output pairs with mash_distance <= D "
                   "(mash dist -d analog)")
    p.add_argument("--max-p", type=float, default=None, metavar="P",
                   help="only output pairs with p_value <= P "
                   "(mash dist -v analog)")
    p.add_argument("--bounds", action="store_true",
                   help="add 95%% Wilson interval columns for jaccard and "
                   "distance (mash bounds analog)")
    _add_common(p)
    p.set_defaults(fn=cmd_dist)

    p = sub.add_parser("screen", help="containment of DB genomes in a read set")
    p.add_argument("db", help="sketch index (.npz)")
    p.add_argument("reads", nargs="+", help="FASTA/FASTQ(.gz) read file(s)")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--flat", type=int, default=engine.DEFAULT_READ_FLAT,
                   help="packed bases per screening batch")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel screen across the cards of --device")
    p.add_argument("-w", "--winner", action="store_true",
                   help="winner-takes-all: credit each distinct hit hash to "
                   "only its best-containment genome (mash screen -w analog)")
    p.add_argument("-p", "--p-values", action="store_true",
                   help="add a p_value column: chance probability of >= hits "
                   "under a binomial null with the read set's distinct-k-mer "
                   "cardinality (KMV-estimated over the stream)")
    _add_common(p)
    p.set_defaults(fn=cmd_screen)

    p = sub.add_parser("triangle", help="lower-triangular Phylip distance "
                       "matrix (mash triangle analog)")
    p.add_argument("query", nargs="+", help="index (.npz) or genome files")
    p.add_argument("-l", "--list", action="store_true",
                   help="query inputs are text files listing paths (mash -l)")
    p.add_argument("-o", "--output", default="-",
                   help="output file (default stdout)")
    p.add_argument("--tile", type=int, default=engine.DEFAULT_TILE)
    _add_common(p)
    p.set_defaults(fn=cmd_triangle)

    p = sub.add_parser("info", help="describe a sketch index")
    p.add_argument("db")
    p.add_argument("-d", "--dump", action="store_true",
                   help="dump full sketch hashes as JSON (mash info -d)")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("compress", help="convert an index to 32-bit compact "
                       "fingerprints (half size, ~3e-4 jaccard bias)")
    p.add_argument("db")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_compress)

    p = sub.add_parser("merge", help="concatenate sketch indexes "
                       "(mash paste analog)")
    p.add_argument("inputs", nargs="+", help="input indexes (.npz)")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_merge)
    return ap


def _profiled(args) -> int:
    """Run the command under torch.profiler and write its chrome trace to
    the --profile directory: CPU activity always, CUDA activity when the
    command runs on the card.  On the card the window opens with a burst
    of tiny kernels that takes the records the profiler drops at a
    window's start (utils.profiling); if any of the command's own kernel
    launches still has no device record, stderr says so.  Then one stderr
    line per program span of the window (utils.profiling.SPANS, roots
    first): calls, seconds, self seconds, counts, and the card's idle
    seconds under the span as the innermost open one (None off the card);
    with --metrics, one `phase="trace"` row holds the same."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .utils import profiling

    on_card = args.device == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        profiling.reset_spans()
        if on_card:
            profiling.warm_up_window()
        rc = args.fn(args)
        if on_card:
            torch.cuda.synchronize()
    os.makedirs(args.profile, exist_ok=True)
    path = os.path.join(args.profile, f"{args.command}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if on_card:
        missing = profiling.missing_device_records(prof.profiler.kineto_results.events(),
                                                   skip=profiling.WARMUP_LAUNCHES)
        if missing:
            print(f"{args.command}: warning: {missing} kernel launches in the "
                  f"--profile trace {path} have no device record", file=sys.stderr)
    rows = profiling.span_rows(path if on_card else None)
    for name, row in rows.items():
        parts = [f"{key} {row[key]:.6f}" if isinstance(row[key], float) else f"{key} {row[key]}"
                 for key in row]
        print(f"{args.command}: span {name}: " + ", ".join(parts), file=sys.stderr)
    if rows:
        _metrics.emit(getattr(args, "metrics", None), phase="trace", spans=rows)
    return rc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "profile", None):
        return _profiled(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
