"""BASELINE config 5's DB scale on one card: a 102,400-genome sketch DB
(s = 10,000) made on the card and driven through the port's comparison
and screening paths (the counterpart of the JAX package's
tools/scale100k_tpu.py, with its arguments, defaults and checks).

    python -m miekki_tpu_torch.tools.scale100k [--genomes 102400]
        [--real 128] [--s 10000] [--genome-len 500000] [--queries 256]
        [--tile 256] [--reads-per-genome 30000] [--read-len 150]
        [--skip-dist] [--dist-u64] [--workdir DIR] [--out FILE]
        [--device cuda|cpu]

The DB: --real genomes of --genome-len random bases, sketched by
engine.build_index_per_record (K1), then synthetic sketches of s values
drawn uniform in [0, 2^58) (the range of a bottom-10,000 sketch of a
~0.5-Mbase genome, so the screen's threshold prefilter passes what it
would on real data) and sorted per row, on the device from a
torch.Generator seeded with SYNTH_SEED.  The whole DB's compact code table
is built on the device (ops.compact.compact_rows) and attached as the
compact index's device_planes; the host planes, raw and compact, are
pulled once, through a pinned buffer.

  A. engine.dist_counts_matrix of the first --queries rows against the
     whole DB on the compact device planes (K4, tiles of --tile), checked:
     query i is DB row i; four 64 x 64 blocks equal the plain compact
     counts; the compact-vs-raw bias of the shared counts against K3 on
     the same blocks is at most 32.  --dist-u64 also compares the raw
     index from its host planes (K3; key blocks streamed to the device
     under dist_tiles' block cache), checked: the identity and 64 cells
     against the numpy oracle.
  B. the compact planes freed, engine.screen of --reads-per-genome reads
     from each of real genomes 0, 1 and 7 against the raw DB (grouped on
     an 80 GB card), checked: the three sources are the top hits with
     containment >= 0.95 and every other genome is at most 0.05.

Prints one JSON report line (also written to --out): every check and
`pass`, seconds and rates per phase, the kernels' launches per phase (each
counter set to 0 just before its phase), peak device bytes per phase, the
peak host RSS and the host's memory.  Progress goes to stderr.  Exits 1 if
a check fails.  Runs on the card by default and raises without one;
`--device cpu` runs the kernels' plain versions (tests, at tiny sizes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import engine
from ..index.store import SketchIndex, index_to_device
from ..ops import compact, cuda_hash, cuda_intersect, cuda_intersect32, intersect, u64
from ..oracle import compare as oracle_compare
from ..params import SketchParams
from ..utils import device as _device
from .synth import random_seq, reads_from_genome, write_fasta, write_fastq

K = 31
SYNTH_SEED = 7
SYNTH_CHUNK = 4096       # synthetic rows drawn, sorted and pulled per step
VALUE_BITS = 58          # synthetic values are uniform in [0, 2^58)
SOURCES = (0, 1, 7)      # real genomes the phase-B reads come from
SPOT_BLOCKS, SPOT_EDGE = 4, 64
BIAS_MAX = 32            # compact-vs-raw shared delta allowed (expected ~3)
TOP_MIN, OTHERS_MAX = 0.95, 0.05
ORACLE_PAIRS = 64        # --dist-u64 cells held to the numpy oracle

WRAPPERS = {"k1": cuda_hash.hash_windows_cuda, "k3": cuda_intersect.tile_counts_cuda,
            "k4": cuda_intersect32.tile_counts32_cuda}


def _log(msg: str) -> None:
    print(f"[scale100k] {msg}", file=sys.stderr, flush=True)


class _Phase:
    """Seconds, kernel launches, dist_tiles' block counters, and device
    bytes at the start and at the peak of one phase: the counters and the
    device's peak are reset on entry."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def __enter__(self):
        for fn in WRAPPERS.values():
            fn.launches = 0
        engine.reset_block_counts()
        self.device_bytes_at_start = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.device_bytes_at_start = torch.cuda.memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.seconds = time.perf_counter() - self.t0
        self.launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        self.blocks = dict(engine.BLOCK_COUNTS)
        self.peak_device_bytes = (torch.cuda.max_memory_allocated(self.dev)
                                  if self.dev.type == "cuda" else None)
        return False


def host_memory() -> dict:
    """The host's total and available memory (/proc/meminfo), bytes."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                info[key] = int(val.split()[0]) * 1024
    return {"total_bytes": info.get("MemTotal"), "available_bytes": info.get("MemAvailable")}


def synth_db(n: int, real_keys: torch.Tensor, s: int, dev: torch.device,
             chunk: int = SYNTH_CHUNK, seed: int = SYNTH_SEED):
    """The DB's tables: rows [0, n_real) are `real_keys` (int64 order keys
    [n_real, s] on `dev`), the other n - n_real rows synthetic sketches
    drawn on `dev` (s values uniform in [0, 2^VALUE_BITS), sorted).  The
    compact code keys of every row are made on `dev` into one [n, s] int32
    table; the raw (hi, lo) planes and the compact codes are pulled to the
    host once, `chunk` rows at a time through pinned buffers.  Returns
    (hi, lo, codes: host uint32 [n, s], the device code-key table)."""
    n_real = real_keys.shape[0]
    codes_dev = torch.empty((n, s), dtype=torch.int32, device=dev)
    hi = np.empty((n, s), np.uint32)
    lo = np.empty((n, s), np.uint32)
    codes = np.empty((n, s), np.uint32)
    rows = max(1, min(chunk, n))
    pin = dev.type == "cuda"
    stage64 = torch.empty((rows, s), dtype=torch.int64, pin_memory=pin)
    stage32 = torch.empty((rows, s), dtype=torch.int32, pin_memory=pin)

    def put(o: int, keys: torch.Tensor) -> None:
        c = keys.shape[0]
        code_keys = compact.compact_rows(keys)
        codes_dev[o:o + c] = code_keys
        stage64[:c].copy_(keys)
        stage32[:c].copy_(code_keys)
        words = u64.u64_from_keys(stage64[:c].numpy()).view(np.uint32).reshape(c, s, 2)
        lo[o:o + c] = words[..., 0]  # little-endian: the low word first
        hi[o:o + c] = words[..., 1]
        codes[o:o + c] = compact.codes_from_keys32(stage32[:c].numpy())

    for o in range(0, n_real, rows):
        put(o, real_keys[o:o + rows])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for o in range(n_real, n, rows):
        c = min(rows, n - o)
        v = torch.randint(0, 1 << VALUE_BITS, (c, s), generator=gen, device=dev,
                          dtype=torch.int64)
        put(o, u64.to_keys(torch.sort(v, dim=1).values))
    return hi, lo, codes, codes_dev


def spot_checks(counts: dict, codes_dev: torch.Tensor, hi: np.ndarray, lo: np.ndarray,
                s: int, n_queries: int, dev: torch.device) -> dict:
    """Four SPOT_EDGE-square blocks of phase A's matrices (the first
    queries against random DB blocks): equal to the plain compact counts
    on the same code keys, and the compact-vs-raw delta of `shared`
    against K3 on the raw keys of the same rows."""
    rv = np.random.default_rng(11)
    v = min(SPOT_EDGE, n_queries)
    n = codes_dev.shape[0]
    spots_ok, bias_max, bias_sum, bias_pairs = True, 0, 0, 0
    rows32 = intersect._pad_lane(codes_dev[:v])
    rows64 = torch.from_numpy(u64.keys_from_planes(hi[:v], lo[:v])).to(dev)
    for _ in range(SPOT_BLOCKS):
        bj = int(rv.integers(0, n // v))
        c0, c1 = bj * v, (bj + 1) * v
        plain = intersect.tile_counts_compact_plain(
            rows32, intersect._pad_lane(codes_dev[c0:c1]), s)
        for key, name in (("shared_in_x", "shared"), ("union_size", "union"),
                          ("inter_full", "inter")):
            spots_ok &= bool(np.array_equal(plain[key].cpu().numpy(),
                                            counts[name][:v, c0:c1]))
        cols64 = torch.from_numpy(u64.keys_from_planes(hi[c0:c1], lo[c0:c1])).to(dev)
        ref = intersect.tile_counts(rows64, cols64, s)["shared_in_x"].cpu().numpy()
        d = np.abs(counts["shared"][:v, c0:c1].astype(np.int64) - ref.astype(np.int64))
        bias_max = max(bias_max, int(d.max()))
        bias_sum += int(d.sum())
        bias_pairs += d.size
    return {"dist_plain_spots_ok": bool(spots_ok), "compact_bias_max_shared_delta": bias_max,
            "compact_bias_mean_shared_delta": bias_sum / bias_pairs,
            "compact_bias_ok": bias_max <= BIAS_MAX}


def oracle_sample_ok(counts: dict, queries: SketchIndex, index: SketchIndex, s: int,
                     n_pairs: int = ORACLE_PAIRS, seed: int = 12) -> bool:
    """n_pairs cells of an A-vs-B count matrix (a quarter of them a query
    against its own DB row) equal the numpy oracle's shared, union and
    intersection of the two sketches."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, len(queries), size=n_pairs)
    j = rng.integers(0, len(index), size=n_pairs)
    j[:n_pairs // 4] = i[:n_pairs // 4]
    for a, b in zip(i.tolist(), j.tolist()):
        x, y = queries.sketch_u64(a), index.sketch_u64(b)
        shared, union, _ = oracle_compare.mash_jaccard(x, y, s)
        inter = len(np.intersect1d(x, y, assume_unique=True))
        got = (int(counts["shared"][a, b]), int(counts["union"][a, b]),
               int(counts["inter"][a, b]))
        if got != (shared, union, inter):
            return False
    return True


def phase_a(args, index: SketchIndex, index32: SketchIndex, dev: torch.device,
            report: dict, checks: dict) -> None:
    """dist_counts_matrix of the first --queries rows against the whole DB
    on the compact device planes (K4), its identity and spot checks, and
    with --dist-u64 the same on the raw index's host planes (K3)."""
    nq, n, s = args.queries, len(index), args.s
    q32 = SketchIndex(index32.params, index32.names[:nq], index32.hi[:nq], index32.lo[:nq])
    q32.device_planes = index32.device_planes[:nq]
    with _Phase(dev) as ph:
        counts = engine.dist_counts_matrix(q32, index32, tile=args.tile, device=dev)
    pairs = nq * n
    report.update(dist_pairs=pairs, dist_seconds=ph.seconds,
                  dist_pairs_per_s=pairs / ph.seconds, dist_launches=ph.launches,
                  dist_peak_device_bytes=ph.peak_device_bytes,
                  dist_form="compact_device_planes",
                  dist_host_matrix_bytes=int(sum(m.nbytes for m in counts.values())))
    _log(f"dist: {pairs} pairs in {ph.seconds:.2f} s")
    sizes = q32.sizes()
    checks["dist_identity_ok"] = bool(
        np.array_equal(np.diagonal(counts["shared"][:, :nq]), np.minimum(sizes, s))
        and np.array_equal(np.diagonal(counts["inter"][:, :nq]), sizes))
    with _Phase(dev) as ph:
        spots = spot_checks(counts, index32.device_planes, index.hi, index.lo, s, nq, dev)
    report.update(spot_seconds=ph.seconds, spot_launches=ph.launches,
                  compact_bias_max_shared_delta=spots.pop("compact_bias_max_shared_delta"),
                  compact_bias_mean_shared_delta=spots.pop("compact_bias_mean_shared_delta"))
    checks.update(spots)
    if args.dist_u64:
        q_idx = SketchIndex(index.params, index.names[:nq], index.hi[:nq], index.lo[:nq])
        with _Phase(dev) as ph:
            counts = engine.dist_counts_matrix(q_idx, index, tile=args.tile, device=dev)
        report.update(dist_u64_seconds=ph.seconds, dist_u64_pairs_per_s=pairs / ph.seconds,
                      dist_u64_launches=ph.launches, dist_u64_blocks=ph.blocks,
                      dist_u64_peak_device_bytes=ph.peak_device_bytes,
                      dist_u64_device_bytes_at_start=ph.device_bytes_at_start)
        _log(f"dist (raw, host planes): {pairs} pairs in {ph.seconds:.2f} s")
        checks["dist_u64_identity_ok"] = bool(np.array_equal(
            np.diagonal(counts["inter"][:, :nq]), q_idx.sizes()))
        checks["dist_u64_oracle_ok"] = oracle_sample_ok(counts, q_idx, index, s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=102_400)
    ap.add_argument("--real", type=int, default=128)
    ap.add_argument("--s", type=int, default=10_000)
    ap.add_argument("--genome-len", type=int, default=500_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--reads-per-genome", type=int, default=30_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--workdir", default=None,
                    help="FASTA/FASTQ directory (default: a temporary one)")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--skip-dist", action="store_true", help="run only phase B")
    ap.add_argument("--dist-u64", action="store_true",
                    help="also run phase A on the raw index from its host planes (K3)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.real <= max(SOURCES) or args.genomes < args.real or args.queries > args.genomes:
        ap.error(f"need --real > {max(SOURCES)}, --genomes >= --real, "
                 "--queries <= --genomes")
    dev = _device.resolve(args.device)
    with tempfile.TemporaryDirectory(prefix="miekki_scale100k_") as tmp:
        report = run(args, Path(args.workdir or tmp), dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0 if report["pass"] else 1


def run(args, workdir: Path, dev: torch.device) -> dict:
    """The DB, phase A and phase B (see the module docstring); returns the
    report."""
    workdir.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    n, n_real, s = args.genomes, args.real, args.s
    params = SketchParams(k=K, s=s)
    report = {"genomes": n, "real_genomes": n_real, "s": s, "k": K, "device": str(dev),
              "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                              else "cpu"),
              "host_memory_at_start": host_memory()}

    # ---- the DB: real genomes sketched by the builder, synthetic rows
    rng = np.random.default_rng(7)
    genomes = [random_seq(rng, args.genome_len) for _ in range(n_real)]
    fa = write_fasta(workdir / "real.fa", [(f"real{i}", g) for i, g in enumerate(genomes)])
    with _Phase(dev) as ph:
        real_idx = engine.build_index_per_record([str(fa)], params, device=dev)
    report.update(real_sketch_seconds=ph.seconds, real_sketch_launches=ph.launches)
    _log(f"sketched {n_real} real genomes in {ph.seconds:.1f} s")

    with _Phase(dev) as ph:
        real_keys = engine._planes_on(real_idx, dev)  # kept by the index build, if it did
        if real_keys is None:
            real_keys = index_to_device(real_idx, dev)
        hi, lo, codes, codes_dev = synth_db(n, real_keys, s, dev)
        del real_keys
        real_idx.device_planes = None
        names = real_idx.names + [f"syn{i}" for i in range(n - n_real)]
        index = SketchIndex(params, names, hi, lo)
        params32 = dataclasses.replace(params, compact=True)
        index32 = SketchIndex(params32, names, codes, compact.lo_plane_np(codes))
        index32.device_planes = codes_dev
    report.update(synth_seconds=ph.seconds, synth_peak_device_bytes=ph.peak_device_bytes,
                  db_bytes=int(hi.nbytes + lo.nbytes), db_bytes_compact=int(codes.nbytes),
                  synthetic_rows_made_on_device=True)
    _log(f"DB of {n} x {s} made in {ph.seconds:.1f} s")

    # ---- phase A: the first queries against the whole DB, compact, on the
    # device planes (K4)
    checks = {}
    if args.skip_dist:
        report["dist_skipped"] = True
    else:
        phase_a(args, index, index32, dev, report, checks)

    # the screen holds the raw flat DB and its bitmap on the device; the
    # compact table goes first
    index32.device_planes = None
    del index32, codes, codes_dev, hi, lo
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- phase B: reads of three real genomes screened against the DB
    reads = []
    for g in SOURCES:
        reads += [(f"r{g}_{i}", r) for i, r in enumerate(
            reads_from_genome(rng, genomes[g], args.reads_per_genome, args.read_len))]
    fq = write_fastq(workdir / "reads.fq", reads)
    stats: dict = {}
    with _Phase(dev) as ph:
        rows = engine.screen(index, [str(fq)], stats=stats, device=dev)
    one_pass, per_group = engine._screen_db_value_budgets(dev)
    report.update(n_reads=len(reads), screen_seconds=ph.seconds,
                  screen_reads_per_s=len(reads) / ph.seconds, screen_launches=ph.launches,
                  screen_peak_device_bytes=ph.peak_device_bytes, screen_stats=stats,
                  screen_db_values=int(index.sizes().sum()),
                  screen_value_budgets={"one_pass": one_pass, "per_group": per_group})
    want = {f"real{g}" for g in SOURCES}
    top = sorted(rows, key=lambda r: -r["containment"])[:5]
    report["screen_top5"] = [(r["reference"], r["containment"]) for r in top]
    checks["screen_top_ok"] = ({r["reference"] for r in top[:3]} == want
                               and all(r["containment"] >= TOP_MIN for r in top[:3]))
    others_max = max((r["containment"] for r in rows if r["reference"] not in want),
                     default=0.0)
    report["screen_others_max_containment"] = others_max
    checks["screen_others_ok"] = others_max <= OTHERS_MAX
    _log(f"screen: {len(reads)} reads in {ph.seconds:.1f} s, "
         f"{stats.get('n_slabs', 1)} group(s)")

    report["checks"] = checks
    report["pass"] = all(checks.values())
    report["total_seconds"] = time.perf_counter() - t_start
    report["peak_host_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    report["host_memory_at_end"] = host_memory()
    return report


if __name__ == "__main__":
    sys.exit(main())
