#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (miekki_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from miekki_tpu_torch/csrc, holds each against its
plain torch version on the card, then drives the port's paths through its
CLI, each with the kernels' launch counters reset just before and read just
after: `sketch` of 64 synthetic bacterial-size genomes (k=31, s=10,000) and
`dist` of the resulting index (K1, K3); the same `sketch` with
MIEKKI_MERGE=fused (K2, and K1 for exact fallbacks); `compress` of the
index and `dist` of the compact index (K4).  One sketch batch of each
strategy is traced with torch.profiler (the card's busy time, idle share,
and the host ops that ran while it idled).  The last phases run the
all-vs-all at config-3 scale (1,024 sketches), raw and compact, and
`screen` at config-4 scale (a 1,024-genome DB, 1 M FASTQ reads) in plain,
`-w` and `-p` modes (K1), checked against an independent count, the CPU
path, the numpy oracle and a forced grouped run; two screen batches are
traced.  Then: the count matrices of 10,240 sketches made on the card
(`engine.dist_counts_matrix`, 210 K3 tiles, checked on the diagonal and
64 pairs against the oracle), again with its key blocks streamed from the
host planes under the default budget and under a cache of 4 blocks, each
bitwise equal and within its device-memory bound; `cli dist --counts`, `--matrix`, `triangle`
and an interrupted then resumed `--manifest` run on the 1,024-sketch index,
raw (K3) and compact (K4); `cli sketch -m 2` of the 1 M reads (K1), held
to an independent count on the card and, on the first reads, the CPU path
to the oracle; `cli sketch --shards 4`, `cli merge` of the shards, and one
`cli dist --profile` in the smoke's own process whose trace must name K3
and hold every kernel the command launched.  The reference's stream-pass
route (MIEKKI_INTERSECT=mxu, ops/mxu_intersect.py, no kernel of its own)
on the 1,024 sketches, raw and compact: `cli dist`, the count matrices
with their resolve deferred, and the host ring, each equal to the K3/K4
run with no K3/K4 launch; one 512 x 512 tile at s = 10,000 timed, with
its bound, matmul share, ambiguous pairs and resolve seconds; a tile with
more than 256 matches of one pair in a chunk, exact against K3.  The
reference's other selectable routes on the same data, each equal to the
default route's output (`reference_routes`): sketch-64 under
MIEKKI_MERGE=threshold and sort, at MIEKKI_PIPELINE=0 and 1 and at
MIEKKI_TREE_CAP0=8 and 32 (K1), the
64-genome `cli dist` raw and compact under MIEKKI_INTERSECT=bitonic and
searchsorted (no K3/K4 launch), one config-3 512 x 512 tile timed on each
route beside K3/K4, the 1 M-read `cli screen` under MIEKKI_SCREEN_JOIN=merge
and searchsorted at MIEKKI_SCREEN_CHUNK=999 (K1 once a batch) with each
join's device peak on one batch, and the 10,240 sketches' count matrices
at MIEKKI_PIPELINE=1 and 8 (210 K3 launches each).  Last, the multi-device paths
(miekki_tpu_torch.parallel), each held bitwise against one device: the
host ring over four positions of this card on the 10,240 sketches (400
K3 tiles, its blocks cut from the keys made on the card, with no host
key table) and on the 1,024 (raw and compact, self and A-vs-B, a
checkpointed run interrupted and resumed, `cli dist --distributed` and
`--distributed --counts`); two gloo ranks computing on the card, one
dying after its first chunk of the chunked ring, the resume and then the
square ring, beside a one-rank NCCL group (also through the collective
stream-pass ring), each in processes of their own
(tools/multiprocess_ring.py); the
screen of the 1 M reads over four positions, and -w, -p and a 2 x 2
(data, db) mesh and `cli screen --distributed` on the first reads (K1).
The device-resident index: the sketch-64 index built with
MIEKKI_KEEP_DEV=1 keeps device planes equal to its host table, and the
10,240 sketches' count matrices through their planes (made on the card)
equal the host path's (K3).  Last, the full-scale tools: tools/scale100k
at its default sizes in a process of its own (a 102,400-genome, s = 10,000
DB made on the card; 256 queries against it on the compact planes, K4,
with spot and bias checks, K3; with --dist-u64 the same queries against
the raw DB from its host planes under a 1 GiB block cache, K3, 64 cells
against the oracle; the grouped screen of 90,000 reads, K1), and
tools/acceptance at CI size (BASELINE configs 1-5; K1, K3).
Kernels are held to their plain versions with tolerance 0
(`torch.equal`), K1 also at the screen's one-row batch shape: every
output is an integer.  Every phase prints one JSON line; any failed check
raises, so the exit code is non-zero.  The last three lines are the
`kernels` summary, the card's name and power limit, and
`{"ok": true, "device": {...}}`.  Exits non-zero with no result when
torch sees no CUDA card.  Nothing here imports JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 20261016
K, S = 31, 10_000
GENOME_LEN = 5_000_000          # bacterial size
FAMILIES, PER_FAMILY = 8, 8     # 64 genomes, 320 Mbase
CONFIG3_GENOMES = 1024          # BASELINE config 3: all-vs-all, 1k genomes
TILE = 512
DIST10K_GENOMES = 10_240        # the one-card all-vs-all of 10,240 genomes
NCCL_GENOMES = 512              # the index of the one-rank NCCL group
SCREEN_GENOMES = 1024           # BASELINE config 4: 1k-genome sketch DB
SCREEN_READS = 1_000_000        # config 4 screens 10 M reads; cut to keep the phase short
READ_LEN, READ_SUB = 150, 0.01  # FASTQ reads of 150 bases at 1 % substitution
SCREEN_CHECK_READS = 20_000     # reads of the card-vs-CPU, oracle and grouped checks
SCREEN_GROUP_VALS = 2_000_000   # MIEKKI_SCREEN_DB_VALS of the grouped check: 6 groups
SCREEN_TRACE_READS = 46_000     # two packed batches of 2^22 bases

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP16_DENSE_FLOPS = 989e12       # H100 SXM dense float16 tensor-core peak
MXU_COUNT_PLANES = 8            # int32 [ti, tj] planes of count state the unfused pass moves a chunk
MXU_RING_TILE = 256             # sub-tile edge of mxu_route's host ring (as dist_sharded_config3)
INT32_LANES_PER_SM = 64         # GH100: 16 INT32 lanes per SM partition (Hopper white paper)
K1_OPS_PER_WINDOW = 24          # rolling update: ~12 64-bit ops, 2 int32 each
K2_OPS_PER_WINDOW = 30          # K1's, plus the 64-bit threshold compare and the group count
FUSED_LEVELS = 2                # MIEKKI_FUSED_LEVELS default


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events, warmed)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of the work one call of fn enqueues: the
    call is captured once in a CUDA graph and replayed between CUDA events,
    so the host's time per call (checks, allocations, the launch itself)
    drops out."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def trace_summary(path: Path, span: str) -> dict:
    """From a torch.profiler chrome trace: the wall of the annotated span,
    the card's busy time inside it (the union of kernels, copies and
    memsets) and its idle share, the device time by kernel, the host's CUDA
    runtime calls, and the top-level host ops that ran while the card was
    idle (gap time under no torch op is Python and ctypes)."""
    ev = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    span_ev = [e for e in ev if e.get("cat") == "user_annotation" and e["name"] == span]
    if not span_ev:
        return {"traced": False}
    t0, t1 = span_ev[0]["ts"], span_ev[0]["ts"] + span_ev[0]["dur"]
    inside = [e for e in ev if t0 <= e["ts"] < t1]
    traced = {e.get("args", {}).get("correlation") for e in ev if e.get("cat") == "kernel"}
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in inside
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    gaps, busy, at = [], 0.0, t0
    for a, b, _ in dev:
        if a > at:
            gaps.append((at, a))
        busy += max(0.0, b - max(a, at))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))

    def by_name(items, top=8):
        acc = {}
        for name, us in items:
            n, t = acc.get(name, (0, 0.0))
            acc[name] = (n + 1, t + us)
        return [{"name": k[:100], "count": n, "ms": t / 1e3}
                for k, (n, t) in sorted(acc.items(), key=lambda kv: -kv[1][1])[:top]]

    tops, end = [], t0
    for e in sorted((e for e in inside if e.get("cat") == "cpu_op"),
                    key=lambda e: (e["ts"], -e["dur"])):
        if e["ts"] >= end:
            tops.append(e)
            end = e["ts"] + e["dur"]
    idle_under = []
    for e in tops:
        a, b = e["ts"], e["ts"] + e["dur"]
        over = sum(max(0.0, min(b, g1) - max(a, g0)) for g0, g1 in gaps)
        if over > 0:
            idle_under.append((e["name"], over))
    idle = sum(g1 - g0 for g0, g1 in gaps)
    covered = sum(us for _, us in idle_under)
    host_idle = by_name(idle_under)
    host_idle.append({"name": "(no torch op: Python, ctypes)", "count": None,
                      "ms": (idle - covered) / 1e3})
    return {"traced": True, "wall_ms": (t1 - t0) / 1e3, "device_events": len(dev),
            "device_busy_ms": busy / 1e3,
            "launches_without_kernel": sum(
                e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]
                and e.get("args", {}).get("correlation") not in traced for e in inside),
            "device_idle_share": 1 - busy / (t1 - t0) if dev else None,
            "idle_gaps": len(gaps), "longest_gap_ms": max((b - a for a, b in gaps),
                                                          default=0.0) / 1e3,
            "device_by_kernel": by_name((n, b - a) for a, b, n in dev),
            "cuda_runtime": by_name((e["name"], e["dur"]) for e in inside
                                    if e.get("cat") == "cuda_runtime"),
            "host_ops_while_idle": host_idle}


def ptxas_usage(log: str) -> dict:
    """{kernel entry: its ptxas 'Used N registers, ...' line} from an nvcc
    -Xptxas=-v log."""
    usage, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln and entry:
            usage[entry] = ln.split(":", 1)[-1].strip()
    return usage


def max_abs_err(got, want) -> int:
    diff = (got != want).nonzero()
    if diff.numel() == 0:
        return 0
    idx = tuple(diff.t())
    a = got[idx].cpu().numpy().astype(object)
    b = want[idx].cpu().numpy().astype(object)
    return int(max(abs(x - y) for x, y in zip(a, b)))


def reset_counts() -> None:
    """Zero the launch counters of the four kernels' wrappers."""
    from miekki_tpu_torch.ops import cuda_hash, cuda_intersect, cuda_intersect32, cuda_sketch

    for fn in (cuda_hash.hash_windows_cuda, cuda_intersect.tile_counts_cuda,
               cuda_sketch.hash_reduce_cuda, cuda_intersect32.tile_counts32_cuda):
        fn.launches = 0


class _Interrupted(Exception):
    """Raised into a manifest run to stand for a dying host."""


def dist_counts_10k(dev, smi: str, n: int = DIST10K_GENOMES, s: int = S,
                    tile: int = TILE, seed: int = SEED + 10) -> dict:
    """`engine.dist_counts_matrix` (K3) over n synthetic sketches made on
    the card (families of PER_FAMILY, as config 3), checked on its diagonal
    and on 64 sampled pairs against the numpy oracle."""
    import torch

    from miekki_tpu_torch import engine
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.ops import cuda_intersect, u64
    from miekki_tpu_torch.oracle import compare as oracle_compare
    from miekki_tpu_torch.params import SketchParams

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    drop = torch.tensor(np.linspace(0.005, 0.05, PER_FAMILY) * 10, device=dev)
    fams, rows = n // PER_FAMILY, []
    for f0 in range(0, fams, 16):
        nf = min(16, fams - f0)
        base = torch.empty((nf, 1, 3 * s), dtype=torch.int64, device=dev).random_(generator=gen)
        fresh = torch.empty((nf, PER_FAMILY, 3 * s), dtype=torch.int64,
                            device=dev).random_(generator=gen)
        dropped = torch.rand((nf, PER_FAMILY, 3 * s), generator=gen, device=dev) < drop[:, None]
        v = torch.where(dropped, fresh, base).reshape(nf * PER_FAMILY, 3 * s)
        v = torch.sort(v.clamp_(max=u64.INF_KEY - 1), dim=1).values
        dup = torch.zeros_like(v, dtype=torch.bool)
        dup[:, 1:] = v[:, 1:] == v[:, :-1]
        rows.append(torch.sort(v.masked_fill_(dup, u64.INF_KEY), dim=1).values[:, :s])
    keys = torch.cat(rows)  # kept: the device_planes phase attaches them
    hi, lo = u64.planes_from_keys(keys)
    del rows, v, dup, base, fresh, dropped
    index = SketchIndex(SketchParams(k=K, s=s), [f"syn{i}" for i in range(n)], hi, lo)
    make_s = time.perf_counter() - t0

    reset_counts()
    engine.reset_block_counts()
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts = engine.dist_counts_matrix(index, tile=tile, device=dev)
    seconds = time.perf_counter() - t0
    launches = cuda_intersect.tile_counts_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    blocks = dict(engine.BLOCK_COUNTS)  # the key blocks' way to the card
    t0 = time.perf_counter()
    n_tiles = sum(1 for _ in engine.dist_tiles(index, tile=tile, device=dev, raw=True))
    tiles_s = time.perf_counter() - t0

    sizes = index.sizes()
    diag_ok = (np.array_equal(np.diagonal(counts["shared"]), np.minimum(sizes, s))
               and np.array_equal(np.diagonal(counts["union"]), np.minimum(sizes, s))
               and np.array_equal(np.diagonal(counts["inter"]), sizes))
    rng = np.random.default_rng(seed)
    fam_i = rng.integers(0, n // PER_FAMILY, size=32) * PER_FAMILY
    same = [(int(a), int(a) + int(d)) for a, d in zip(fam_i, rng.integers(1, PER_FAMILY, size=32))]
    anyp = [tuple(sorted(map(int, rng.choice(n, size=2, replace=False)))) for _ in range(32)]
    mism, shared_same = 0, []
    for i, j in same + anyp:
        a, b = index.sketch_u64(i), index.sketch_u64(j)
        sh, un, _ = oracle_compare.mash_jaccard(a, b, s)
        it = len(np.intersect1d(a, b, assume_unique=True))
        got = (int(counts["shared"][i, j]), int(counts["union"][i, j]), int(counts["inter"][i, j]))
        mism += got != (sh, un, it)
        if (i, j) in same:
            shared_same.append(sh)
    pairs = n * (n + 1) // 2
    line = {"phase": "dist_counts_10k", "genomes": n, "s": s, "tile": tile, "pairs": pairs,
            "synthetic_sketches": True, "made_on_card": True, "make_s": make_s,
            "seconds": seconds, "pairs_per_s": pairs / seconds, "k3_launches": launches,
            "tiles_only_seconds": tiles_s, "tiles_only_tiles": n_tiles,
            "blocks": blocks,
            "peak_device_bytes": peak, "device_bytes_at_start": at_start,
            "host_matrix_bytes": int(sum(m.nbytes for m in counts.values())),
            "diagonal_equal": diag_ok, "sampled_pairs": len(same) + len(anyp),
            "oracle_mismatches": mism, "mean_shared_same_family": float(np.mean(shared_same)),
            "card": smi}
    emit(line)
    n_blocks = -(-n // tile)
    require(launches == n_tiles == n_blocks * (n_blocks + 1) // 2,
            f"{n_blocks * (n_blocks + 1) // 2} K3 launches over {pairs} pairs")
    require(diag_ok, "the count matrices' diagonal")
    require(mism == 0, "sampled 10k pairs equal the oracle")
    require(min(shared_same) > 0, "same-family pairs share values")
    require(blocks["loads"] == n_blocks and blocks["evictions"] == 0,
            "each key block formed once under the default budget")
    return line, index, counts, keys


STREAM_CACHE_MB = 166  # MIEKKI_COL_CACHE_MB of dist_streamed_10k's capped run: 4 blocks


def dist_streamed_10k(dev, smi: str, index, matrices: dict, tile: int = TILE) -> dict:
    """dist-counts-10k's index from its host planes, key blocks streamed to
    the card (engine._KeyBlocks): dist_counts_matrix (a) under the default
    budget, where every block fits and is formed once, and (b) under
    MIEKKI_COL_CACHE_MB=STREAM_CACHE_MB, a cap of 4 blocks, so the sweep
    evicts.  Both must give dist_counts_10k's matrices bitwise in 210 K3
    launches, within cache + 3 blocks + 16 MiB of device memory over the
    start."""
    import torch

    from miekki_tpu_torch import engine
    from miekki_tpu_torch.ops import cuda_intersect, intersect

    n_blocks = -(-len(index) // tile)
    block_bytes = tile * intersect.lane_width(index.params.s) * 8
    runs = {}
    for tag, cache_mb in (("default", None), ("capped", STREAM_CACHE_MB)):
        if cache_mb is not None:
            os.environ["MIEKKI_COL_CACHE_MB"] = str(cache_mb)
        try:
            reset_counts()
            engine.reset_block_counts()
            torch.cuda.synchronize()
            at_start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            counts = engine.dist_counts_matrix(index, tile=tile, device=dev)
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - at_start
        finally:
            os.environ.pop("MIEKKI_COL_CACHE_MB", None)
        blocks = dict(engine.BLOCK_COUNTS)
        cache_bytes = ((cache_mb << 20) if cache_mb is not None
                       else engine._hbm.dist_cache_bytes(0, 1, block_bytes, dev))
        runs[tag] = {"seconds": seconds, "k3_launches": cuda_intersect.tile_counts_cuda.launches,
                     **blocks, "cache_bytes": cache_bytes, "block_bytes": block_bytes,
                     "peak_over_start_bytes": peak, "device_bytes_at_start": at_start,
                     "peak_bound_bytes": cache_bytes + 3 * block_bytes + (16 << 20),
                     "equal": all(np.array_equal(counts[c], matrices[c]) for c in matrices)}
        del counts
    line = {"phase": "dist_streamed_10k", "genomes": len(index), "s": index.params.s,
            "tile": tile, "blocks": n_blocks, "runs": runs, "card": smi}
    emit(line)
    n_tiles = n_blocks * (n_blocks + 1) // 2
    for tag, run in runs.items():
        require(run["equal"], f"streamed matrices equal dist_counts_10k's ({tag})")
        require(run["k3_launches"] == n_tiles, f"{n_tiles} K3 launches ({tag})")
        require(run["peak_over_start_bytes"] <= run["peak_bound_bytes"],
                f"the streamed sweep's device memory within its bound ({tag})")
    require(runs["default"]["loads"] == n_blocks and runs["default"]["evictions"] == 0,
            "each block loaded once under the default budget")
    require(runs["capped"]["cap"] == 4 and runs["capped"]["evictions"] > 0,
            "a cap of 4 blocks evicts")
    return line


def dist_outputs_config3(dev, smi: str, tmp: Path, indexes: dict, tile: int = TILE,
                         seed: int = SEED + 11) -> dict:
    """`cli dist --counts`, `--matrix`, `triangle` and an interrupted then
    resumed `--manifest` run on the config-3 index, raw (K3) and compact
    (K4).  indexes: tag → (SketchIndex, its plain `cli dist` TSV text,
    the kernel wrapper it runs)."""
    import torch

    from miekki_tpu_torch import cli, engine
    from miekki_tpu_torch.oracle import compare as oracle_compare

    rng = np.random.default_rng(seed)
    out = {}
    for tag, (index, tsv_text, kernel) in indexes.items():
        n = len(index)
        db = tmp / f"c3_{tag}.npz"
        index.save(db)
        cpath = tmp / f"c3_{tag}_counts.npz"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["dist", str(db), "--counts", str(cpath), "--tile", str(tile)])
        counts_s = time.perf_counter() - t0
        require(rc == 0, f"cli dist --counts exit code 0 ({tag})")
        launches = kernel.launches
        require(launches > 0, f"{kernel.__name__} launched on the --counts path ({tag})")
        with np.load(cpath) as z:
            got = {m: z[m] for m in z.files}
        want = engine.dist_counts_matrix(index, tile=tile, device=dev)
        require(all(got[c].dtype == np.int32 and np.array_equal(got[c], want[c])
                    for c in want), f"--counts members equal dist_counts_matrix ({tag})")
        require(list(got["query_names"]) == index.names == list(got["reference_names"])
                and int(got["k"]) == index.params.k and int(got["s"]) == index.params.s,
                f"--counts names, k and s ({tag})")
        buf = io.StringIO()
        engine.counts_tsv_write(buf, index, got["shared"], got["union"], inter=got["inter"])
        require(buf.getvalue() == tsv_text,
                f"counts_tsv_write's TSV equals the plain dist TSV ({tag})")

        mat, tri = tmp / f"c3_{tag}.matrix", tmp / f"c3_{tag}.triangle"
        t0 = time.perf_counter()
        rc = cli.main(["dist", str(db), "--matrix", "-o", str(mat), "--tile", str(tile)])
        matrix_s = time.perf_counter() - t0
        require(rc == 0, f"cli dist --matrix exit code 0 ({tag})")
        t0 = time.perf_counter()
        rc = cli.main(["triangle", str(db), "-o", str(tri), "--tile", str(tile)])
        triangle_s = time.perf_counter() - t0
        require(rc == 0, f"cli triangle exit code 0 ({tag})")
        sq, lower = mat.read_text().splitlines(), tri.read_text().splitlines()
        require(sq[0] == lower[0] == f"\t{n}" and len(sq) == len(lower) == n + 1,
                f"matrix and triangle shape ({tag})")
        require(all(lower[1 + i].split("\t") == sq[1 + i].split("\t")[:1 + i]
                    for i in range(n)), f"the triangle is the lower half of the matrix ({tag})")
        cell_mism = 0
        for _ in range(64):
            i, j = map(int, rng.choice(n, size=2, replace=False))
            _, _, jac = oracle_compare.mash_jaccard(index.sketch_u64(i), index.sketch_u64(j),
                                                    index.params.s)
            d = oracle_compare.mash_distance(jac, index.params.k)
            cell_mism += sq[1 + i].split("\t")[1 + j] != f"{d:.10g}"
        require(cell_mism == 0, f"sampled matrix cells equal the oracle ({tag})")

        tsv_m, mani = tmp / f"c3_{tag}_resumed.tsv", tmp / f"c3_{tag}.manifest"
        argv = ["dist", str(db), "-o", str(tsv_m), "--manifest", str(mani), "--tile", str(tile)]
        real = engine.dist_tiles

        def one_tile(*a, **kw):
            gen = real(*a, **kw)
            yield next(gen)
            raise _Interrupted

        engine.dist_tiles = one_tile
        interrupted = False
        try:
            cli.main(argv)
        except _Interrupted:
            interrupted = True
        finally:
            engine.dist_tiles = real
        after_crash = len(mani.read_text().splitlines())
        require(interrupted and after_crash == 1, f"the manifest run stopped after 1 tile ({tag})")
        t0 = time.perf_counter()
        rc = cli.main(argv)
        resume_s = time.perf_counter() - t0
        require(rc == 0, f"resumed cli dist --manifest exit code 0 ({tag})")
        tiles = [tuple(json.loads(ln).values()) for ln in mani.read_text().splitlines()]
        require(len(tiles) == len(set(tiles)) == 3, f"each tile once in the manifest ({tag})")
        require(sorted(tsv_m.read_text().splitlines()[1:]) == sorted(tsv_text.splitlines()[1:]),
                f"the resumed TSV's rows equal the plain TSV's ({tag})")
        out[tag] = {"counts_s": counts_s, "launches": launches,
                    "counts_file_bytes": cpath.stat().st_size, "matrix_s": matrix_s,
                    "matrix_bytes": mat.stat().st_size, "triangle_s": triangle_s,
                    "sampled_cells": 64, "resume_s": resume_s, "manifest_tiles": tiles}
    line = {"phase": "dist_outputs_config3", "genomes": len(next(iter(indexes.values()))[0]),
            "tile": tile, **out, "card": smi}
    emit(line)
    return line


def sketch_min_copies(dev, smi: str, tmp: Path, reads_fq: Path, head_fq: Path,
                      mbase: float, m: int = 2) -> dict:
    """`cli sketch -m m` of a read set (the counted sketch, K1 every step),
    held to an independent count on the card and, on the head of the
    reads, the CPU path to the numpy oracle."""
    import torch

    from miekki_tpu_torch import cli, engine
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.io import encode, reader
    from miekki_tpu_torch.ops import cuda_hash, u64
    from miekki_tpu_torch.ops import sketch as _sketch
    from miekki_tpu_torch.oracle import nthash as oracle_nthash
    from miekki_tpu_torch.oracle import sketch as oracle_sketch

    mdb = tmp / "reads_m.npz"
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["sketch", str(reads_fq), "-o", str(mdb), "-k", str(K), "-s", str(S),
                   "-m", str(m)])
    seconds = time.perf_counter() - t0
    require(rc == 0, "cli sketch -m exit code 0")
    launches = cuda_hash.hash_windows_cuda.launches
    require(launches > 0, "K1 launched on the sketch -m path")
    got = SketchIndex.load(mdb).sketch_u64(0)

    # steps of one try: the bucketed rows of the packed read set, ~2^19
    # window starts per step; every try hashes each step once
    t0 = time.perf_counter()
    packed = encode.pack_records(reader.read_genome_codes(reads_fq), K)
    rows = _sketch._next_pow2(-(-len(packed) // engine.DEFAULT_CHUNK))
    steps = -(-rows // (_sketch.STEP_TARGET // engine.DEFAULT_CHUNK))
    require(launches % steps == 0, "K1 launches are whole tries")
    tries = launches // steps
    x = torch.from_numpy(packed).to(dev)[None]
    h = cuda_hash.hash_windows_cuda(x, K)[0]
    vals, cnt = torch.unique(h[h != u64.INF_KEY], return_counts=True)
    indep = u64.u64_from_keys(vals[cnt >= m][:S])
    n_distinct, n_qual = int(vals.numel()), int((cnt >= m).sum())
    del x, h, vals, cnt
    indep_s = time.perf_counter() - t0
    require(len(got) == S and np.array_equal(got, indep),
            "the -m sketch equals the independent count on the card")

    t0 = time.perf_counter()
    cpu_db = tmp / "reads_head_m.npz"
    rc = cli.main(["sketch", str(head_fq), "-o", str(cpu_db), "-k", str(K), "-s", str(S),
                   "-m", str(m), "--device", "cpu"])
    require(rc == 0, "cli sketch -m --device cpu exit code 0")
    head = encode.pack_records(reader.read_genome_codes(head_fq), K)
    want = oracle_sketch.bottom_s_min_copies(oracle_nthash.canonical_hashes(head, K), S, m)
    cpu_s = time.perf_counter() - t0
    require(np.array_equal(SketchIndex.load(cpu_db).sketch_u64(0), want),
            "the CPU -m sketch of the head reads equals the numpy oracle")
    line = {"phase": "sketch_min_copies", "min_copies": m, "k": K, "s": S,
            "mbase": mbase, "seconds": seconds, "mbase_per_s": mbase / seconds,
            "k1_launches": launches, "steps_per_try": steps, "tries": tries,
            "final_cap": _sketch._next_pow2(4 * S) << (tries - 1),
            "distinct_hashes": n_distinct, "hashes_at_least_m": n_qual,
            "independent_count_s": indep_s, "head_check_s": cpu_s,
            "equal_independent": True, "head_cpu_equals_oracle": True, "card": smi}
    emit(line)
    return line


def shards_merge_profile(dev, smi: str, tmp: Path, paths, db: Path, dist_tsv: Path) -> dict:
    """`sketch --shards 4`, `merge` of the shards (equal to the unsharded
    index, member for member), and one `dist --profile` in this process,
    whose trace must name K3's kernel and hold a device record for every
    kernel the command launched."""
    import torch

    from miekki_tpu_torch import cli
    from miekki_tpu_torch.ops import cuda_hash
    from miekki_tpu_torch.utils.profiling import WARMUP_SPAN

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["sketch", *paths, "-o", str(tmp / "sharded.npz"), "-k", str(K),
                   "-s", str(S), "--shards", "4"])
    shards_s = time.perf_counter() - t0
    require(rc == 0, "cli sketch --shards exit code 0")
    k1 = cuda_hash.hash_windows_cuda.launches
    require(k1 > 0, "K1 launched on the sketch --shards path")
    shard_paths = sorted(tmp.glob("sharded.shard*-of-0004.npz"))
    require(len(shard_paths) == 4, "4 shard files")
    merged = tmp / "merged.npz"
    t0 = time.perf_counter()
    require(cli.main(["merge", *map(str, shard_paths), "-o", str(merged)]) == 0,
            "cli merge exit code 0")
    merge_s = time.perf_counter() - t0
    with np.load(merged) as zm, np.load(db) as zd:
        same = sorted(zm.files) == sorted(zd.files) and all(
            zm[f].dtype == zd[f].dtype and np.array_equal(zm[f], zd[f]) for f in zd.files)
    require(same, "the merged shards equal the unsharded index")

    # in this process, after the earlier profiled phases: late in a process
    # the profiler drops the first kernel records of a window, and the CLI
    # opens its window with a burst of tiny kernels to take them
    # (utils/profiling.py)
    pdir, ptsv = tmp / "profile", tmp / "dist_profiled.tsv"
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["dist", str(db), "-o", str(ptsv), "--profile", str(pdir)])
    profile_s = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    require(rc == 0, "cli dist --profile exit code 0")
    require(ptsv.read_bytes() == dist_tsv.read_bytes(), "--profile leaves the TSV unchanged")
    traces = sorted(pdir.glob("*.json"))
    require(len(traces) == 1, "one trace file")
    events = json.loads(traces[0].read_text())["traceEvents"]
    cats: dict = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    k3_names = [k for k in kernels if "tile_counts_kernel<long>" in k]
    k3 = sum(e.get("cat") == "kernel" and e["name"] in k3_names for e in events)
    # each kernel's start less its launch's (the same correlation id): a
    # negative value is the card's clock mapped behind the host's
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    offsets = [e["ts"] - launch[e["args"]["correlation"]] for e in events
               if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launch]
    # kernel launches on the host whose kernel record is missing, in the
    # warm-up burst and in the command
    traced = {e["args"].get("correlation") for e in events if e.get("cat") == "kernel"}
    warm = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"] == WARMUP_SPAN]
    unmatched = {"warmup": 0, "command": 0}
    for e in events:
        if (e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]
                and e.get("args", {}).get("correlation") not in traced):
            unmatched["warmup" if any(a <= e["ts"] < b for a, b in warm) else "command"] += 1
    line = {"phase": "shards_merge_profile", "shards": 4, "shards_s": shards_s,
            "k1_launches": k1, "shard_bytes": [p.stat().st_size for p in shard_paths],
            "merge_s": merge_s, "merged_equals_unsharded": True,
            "profile_s": profile_s, "k3_kernels_in_trace": k3,
            "launches_without_kernel": unmatched,
            "launch_to_kernel_us": [min(offsets), max(offsets)] if offsets else None,
            "missing_records_warning": "have no device record" in err.getvalue(),
            "trace_bytes": traces[0].stat().st_size,
            "trace_events": len(events), "trace_categories": cats,
            "trace_kernels": [k[:120] for k in kernels[:12]], "card": smi}
    emit(line)
    require(k3_names, "the trace names K3's kernel")
    require(unmatched["command"] == 0,
            "every kernel launch of the profiled command has its device record")
    return line


def equals_symmetrised(full: np.ndarray, upper: np.ndarray, block: int = 1024) -> bool:
    """Whether full == triu(upper) + triu(upper, 1).T, by row blocks (no
    matrix-sized temporaries)."""
    n = full.shape[0]
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        diag = np.triu(upper[r0:r1, r0:r1])
        if not (np.array_equal(full[r0:r1, r1:], upper[r0:r1, r1:])
                and np.array_equal(full[r0:r1, :r0], upper[:r0, r0:r1].T)
                and np.array_equal(full[r0:r1, r0:r1], diag + np.triu(diag, 1).T)):
            return False
    return True


def dist_sharded_10k(dev, smi: str, index, counts: dict, keys, positions: int = 4,
                     tile: int = TILE) -> dict:
    """`parallel.dist_sharded_hostring` over `positions` positions of this
    card on dist_counts_10k's index with its keys (made on the card) as
    device planes: the ring cuts its blocks from them (no host key table:
    index_to_device never runs) and gives the full symmetric matrices,
    equal to dist_counts_matrix's (`counts`) symmetrised.  The blocks' way
    to the positions is timed from the planes and, as before PR 14, from
    the host planes."""
    import torch

    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.ops import cuda_intersect
    from miekki_tpu_torch.parallel import allvsall, dist_sharded_hostring

    n = len(index)
    devices = [dev] * positions
    n_sub = -(-(-(-n // positions)) // tile)
    planes = SketchIndex(index.params, index.names, index.hi, index.lo)
    planes.device_planes = keys
    blocks_s = {}
    for name, idx in (("host_planes", index), ("device_planes", planes)):
        # the key table's way to the positions alone (the ring does the same first)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks = allvsall._hostring_side_blocks(idx, devices, n_sub * tile)
        torch.cuda.synchronize()
        blocks_s[name] = time.perf_counter() - t0
        del blocks
    built, real = [], allvsall.index_to_device
    allvsall.index_to_device = lambda idx, *a, **kw: built.append(idx) or real(idx, *a, **kw)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        got = dist_sharded_hostring(planes, devices, tile=tile)
        seconds = time.perf_counter() - t0
    finally:
        allvsall.index_to_device = real
    launches = cuda_intersect.tile_counts_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    equal = all(equals_symmetrised(got[c], m) for c, m in counts.items())
    check_s = time.perf_counter() - t0
    line = {"phase": "dist_sharded_10k", "genomes": n, "s": index.params.s, "tile": tile,
            "positions": positions, "devices": [str(d) for d in devices],
            "from": "device_planes", "seconds": seconds,
            "pairs": n * n, "pairs_per_s": n * n / seconds, "k3_launches": launches,
            "blocks_to_card_s": blocks_s["device_planes"],
            "blocks_to_card_s_host_planes": blocks_s["host_planes"],
            "host_key_tables_built": len(built), "peak_device_bytes": peak,
            "host_matrix_bytes": int(sum(m.nbytes for m in got.values())),
            "equals_dist_counts_matrix_symmetrised": equal, "check_s": check_s, "card": smi}
    emit(line)
    require(launches == positions * n_sub * n_sub * positions,
            f"{positions * n_sub * n_sub * positions} K3 launches of the host ring")
    require(not built, "the host ring over device planes builds no host key table")
    require(equal, "the host ring's matrices equal dist_counts_matrix's, symmetrised")
    return line


def dist_sharded_config3(dev, smi: str, tmp: Path, indexes: dict, positions: int = 4,
                         tile: int = TILE // 2) -> dict:
    """The host ring over `positions` positions of this card on config 3's
    index, raw (K3) and compact (K4): self and A-vs-B (the first half
    against all), a checkpointed run interrupted after step 1 and resumed,
    `cli dist --distributed` (TSV bytes of the plain `cli dist`) and
    `--distributed --counts` (members of `dist --counts`, whose lower
    triangle is filled only inside diagonal tiles).  indexes as for
    dist_outputs_config3, whose files in tmp it reads."""
    import torch

    from miekki_tpu_torch import cli, engine
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.parallel import allvsall, dist_sharded_hostring

    devices = [dev] * positions
    out = {}
    for tag, (index, tsv_text, kernel) in indexes.items():
        n = len(index)
        half = SketchIndex(index.params, index.names[:n // 2], index.hi[:n // 2],
                           index.lo[:n // 2])
        runs = {}
        for case, (a, b) in (("self", (index, None)), ("rect", (half, index))):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = dist_sharded_hostring(a, devices, tile=tile, index_b=b)
            runs[case] = (time.perf_counter() - t0, kernel.launches)
            want = engine.dist_counts_matrix(a, b, tile=TILE, device=dev)
            if b is None:
                want = {c: np.triu(m) + np.triu(m, 1).T for c, m in want.items()}
            require(all(np.array_equal(got[c], want[c]) for c in want),
                    f"the host ring equals dist_counts_matrix ({tag}, {case})")
            if case == "self":
                full = got

        ckpt, real = tmp / f"hostring_{tag}", allvsall._save_checkpoint

        def die_after_step1(path, t, shared, inter, amb=None):
            real(path, t, shared, inter, amb=amb)
            if t == 1:
                raise _Interrupted

        allvsall._save_checkpoint = die_after_step1
        try:
            dist_sharded_hostring(index, devices, tile=tile, checkpoint=str(ckpt))
            interrupted = False
        except _Interrupted:
            interrupted = True
        finally:
            allvsall._save_checkpoint = real
        require(interrupted and sorted(p.name for p in ckpt.iterdir())
                == ["hostring_step0.npz", "hostring_step1.npz"],
                f"the checkpointed run stopped after step 1 ({tag})")
        reset_counts()
        t0 = time.perf_counter()
        resumed = dist_sharded_hostring(index, devices, tile=tile, checkpoint=str(ckpt))
        resume_s, resume_launches = time.perf_counter() - t0, kernel.launches
        require(all(np.array_equal(resumed[c], full[c]) for c in full),
                f"the resumed run equals the uninterrupted one ({tag})")

        db, dtsv, dcounts = tmp / f"c3_{tag}.npz", tmp / f"c3_{tag}_dist.tsv", \
            tmp / f"c3_{tag}_dcounts.npz"
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["dist", str(db), "--distributed", "-o", str(dtsv), "--tile", str(TILE)])
        cli_s, cli_launches = time.perf_counter() - t0, kernel.launches
        require(rc == 0 and dtsv.read_text() == tsv_text,
                f"cli dist --distributed's TSV equals cli dist's ({tag})")
        t0 = time.perf_counter()
        rc = cli.main(["dist", str(db), "--distributed", "--counts", str(dcounts)])
        counts_s = time.perf_counter() - t0
        with np.load(dcounts) as zd, np.load(tmp / f"c3_{tag}_counts.npz") as zc:
            same = sorted(zd.files) == sorted(zc.files) and all(
                zd[m].dtype == zc[m].dtype
                and (np.array_equal(np.triu(zd[m]), np.triu(zc[m])) if zd[m].ndim == 2
                     else np.array_equal(zd[m], zc[m])) for m in zc.files)
            symmetric = all(np.array_equal(zd[m], zd[m].T) for m in ("shared", "union", "inter"))
        require(rc == 0 and same and symmetric,
                f"--distributed --counts: dist --counts' members, the full symmetric matrices ({tag})")
        out[tag] = {"self_s": runs["self"][0], "launches_self": runs["self"][1],
                    "rect_s": runs["rect"][0], "launches_rect": runs["rect"][1],
                    "resume_s": resume_s, "launches_resumed": resume_launches,
                    "cli_distributed_s": cli_s, "launches_cli": cli_launches,
                    "cli_counts_s": counts_s}
    line = {"phase": "dist_sharded_config3", "genomes": len(next(iter(indexes.values()))[0]),
            "positions": positions, "tile": tile, **out, "card": smi}
    emit(line)
    return line


def _long_tail_tile(dev, s: int = S, tile: int = TILE, seed: int = SEED + 14):
    """A tile whose stream ends in one pair's values only: row 0 and column
    0 hold near-identical full sketches of large values (1 % replaced), the
    other rows and columns 10 small values each, so a chunk of the tail
    holds ~tile runs of that pair (m_in > 256, beyond bfloat16)."""
    import torch

    from miekki_tpu_torch.ops import u64

    rng = np.random.default_rng(seed)
    inf = np.uint64(0xFFFFFFFFFFFFFFFF)

    def table(first):
        t = np.full((tile, s), inf, np.uint64)
        t[0] = np.sort(first)
        for i in range(1, tile):
            t[i, :10] = np.sort(rng.choice(1 << 40, size=10, replace=False).astype(np.uint64))
        return torch.from_numpy(u64.keys_from_u64(t)).to(dev)

    big = np.unique(rng.integers(1 << 62, 1 << 63, size=2 * s, dtype=np.uint64))[:s]
    near = big.copy()
    swap = rng.choice(s, size=s // 100, replace=False)
    near[swap] = rng.integers(1 << 61, 1 << 62, size=swap.size, dtype=np.uint64)
    near = np.unique(near)
    return table(big), table(near)


def _max_pair_matches(rows, cols) -> int:
    """The largest per-chunk match count of pair (0, 0) in the stream pass
    of a tile: runs (row 0, column 0) inside one chunk of ti + tj."""
    import torch

    from miekki_tpu_torch.ops import mxu_intersect as mxu

    vals, pay = mxu._merge(mxu.sketch_stream(rows, False), mxu.sketch_stream(cols, True))
    chunk = rows.shape[0] + cols.shape[0]
    both = (pay[:-1] == 0) & (pay[1:] == mxu.COL_TAG) & (vals[:-1] == vals[1:])
    p = torch.nonzero(both).flatten()
    p = p[p // chunk == (p + 1) // chunk]  # both elements in one chunk
    return int(torch.bincount(p // chunk).max()) if p.numel() else 0


def mxu_route(dev, smi: str, tmp: Path, indexes: dict, positions: int = 4,
              tile: int = TILE) -> dict:
    """MIEKKI_INTERSECT=mxu (the stream pass, ops/mxu_intersect.py) on the
    config-3 index, raw and compact: `cli dist` (TSV bytes of the K3/K4
    run), dist_counts_matrix with resolution deferred over the sweep
    (members of `dist --counts`), and the host ring over `positions`
    positions of this card (dist_counts_matrix symmetrised), launching no
    K3/K4; then one 512 x 512 tile at s = 10,000 timed raw and compact
    (`cuda_ms`), its bound, the batched matmuls' share, its ambiguous
    pairs and their native resolve, and a long-shared-tail tile held
    exactly to K3.  indexes as for dist_outputs_config3, whose files in
    tmp it reads."""
    import torch

    from miekki_tpu_torch import cli, engine
    from miekki_tpu_torch.ops import intersect, mxu_intersect as mxu
    from miekki_tpu_torch.parallel import dist_sharded_hostring

    out = {}
    with _env(MIEKKI_INTERSECT="mxu"):
        for tag, (index, tsv_text, kernel) in indexes.items():
            db = tmp / f"c3_{tag}.npz"
            with np.load(tmp / f"c3_{tag}_counts.npz") as z:
                want = {c: z[c] for c in ("shared", "union", "inter")}
            runs = {}
            reset_counts()
            mxu.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["dist", str(db), "-o", str(tmp / f"c3_{tag}_mxu.tsv"),
                           "--tile", str(tile)])
            runs["cli_dist"] = {"seconds": time.perf_counter() - t0, **mxu.PASS_COUNTS,
                                "k3_k4_launches": kernel.launches}
            require(rc == 0 and (tmp / f"c3_{tag}_mxu.tsv").read_text() == tsv_text,
                    f"mxu cli dist's TSV equals the {kernel.__name__} run's ({tag})")
            reset_counts()
            mxu.reset_counts()
            t0 = time.perf_counter()
            got = engine.dist_counts_matrix(index, tile=tile, device=dev)
            runs["counts_deferred"] = {"seconds": time.perf_counter() - t0, **mxu.PASS_COUNTS,
                                       "k3_k4_launches": kernel.launches}
            require(all(np.array_equal(got[c], want[c]) for c in want),
                    f"mxu dist_counts_matrix equals dist --counts' matrices ({tag})")
            reset_counts()
            mxu.reset_counts()
            t0 = time.perf_counter()
            ring = dist_sharded_hostring(index, [dev] * positions, tile=MXU_RING_TILE)
            runs["host_ring"] = {"seconds": time.perf_counter() - t0, **mxu.PASS_COUNTS,
                                 "k3_k4_launches": kernel.launches}
            sym = {c: np.triu(m) + np.triu(m, 1).T for c, m in want.items()}
            require(all(np.array_equal(ring[c], sym[c]) for c in sym),
                    f"the mxu host ring equals dist_counts_matrix ({tag})")
            for name, run in runs.items():
                require(run["k3_k4_launches"] == 0 and run["full"] > 0 and run["band"] == 0,
                        f"{name} ran the full stream pass and no {kernel.__name__} ({tag})")
            out[tag] = runs

    # one tile at s = 10,000 (config 3's blocks 0 and 1, lane-padded as dist
    # forms them), raw and compact
    tiles = {}
    for tag, (index, _, _) in indexes.items():
        blocks = engine._KeyBlocks(index, None, tile, dev, ())
        rows, cols = blocks.get(("a", 0)), blocks.get(("a", 1))  # waits on the copy stream
        compact = rows.dtype == torch.int32
        stream = mxu.sketch_stream32 if compact else mxu.sketch_stream
        start = mxu.tile_counts_mxu_start32 if compact else mxu.tile_counts_mxu_start
        rs, cs = stream(rows, False), stream(cols, True)
        sort_ms = cuda_ms(lambda: mxu._merge(rs, cs), reps=5)
        ms = cuda_ms(lambda: start(rows, cols, index.params.s, row_stream=rs,
                                   col_stream=cs), reps=3, warm=1)
        res, ai, aj = mxu.tile_counts_mxu_finish_deferred(
            start(rows, cols, index.params.s, row_stream=rs, col_stream=cs))
        t0 = time.perf_counter()
        res["shared_in_x"][ai, aj] = mxu.resolve_pairs_host(
            (index.hi, index.lo), (index.hi, index.lo), ai, aj + tile,
            index.params.s, device=dev)
        resolve_s = time.perf_counter() - t0
        exact = (intersect.tile_counts_compact if compact else intersect.tile_counts)(
            rows, cols, index.params.s)
        equal = all(np.array_equal(res[k], exact[k].cpu().numpy())
                    for k in ("shared_in_x", "union_size", "inter_full"))
        require(equal, f"the 512 x 512 tile's resolved counts equal K3/K4's ({tag})")
        ti, tj = rows.shape[0], cols.shape[0]
        chunk = ti + tj
        n_chunks = -(-(rows.numel() + cols.numel()) // chunk)
        batch = mxu._batch_chunks(ti, tj)
        R = (torch.rand((batch, ti, chunk), device=dev) < 0.001).half()
        C = (torch.rand((batch, chunk, tj), device=dev) < 0.001).half()
        bmm_ms = cuda_ms(lambda: torch.bmm(R, C), reps=5) * n_chunks / batch
        del R, C
        flops = n_chunks * 2 * ti * chunk * tj
        # the function's own bytes: both blocks and both streams read once,
        # lb, ub, inter and union written once
        nbytes = sum(x.numel() * x.element_size() for x in (rows, cols, *rs, *cs)) \
            + 4 * 4 * ti * tj
        bound = {"operations": flops / FP16_DENSE_FLOPS * 1e3,
                 "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
        # what this unfused implementation moves besides: the count state's
        # planes through device memory every chunk (a cost, not a bound)
        state_ms = n_chunks * MXU_COUNT_PLANES * 4 * ti * tj / HBM_BYTES_PER_S * 1e3
        tiles[tag] = {"ms": ms, "merge_sort_ms": sort_ms, "matmul_ms": bmm_ms,
                      "matmul_share": bmm_ms / ms, "chunks": n_chunks, "batch_chunks": batch,
                      "matmul_dtype": str(mxu._matmul_dtype(chunk)),
                      "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get),
                      "bound_parts_ms": bound, "state_traffic_ms": state_ms,
                      "ambiguous_pairs": int(ai.size),
                      "resolve_s": resolve_s, "equal_k3_k4": equal}

    s = next(iter(indexes.values()))[0].params.s
    rows, cols = _long_tail_tile(dev, s, tile)
    peak = _max_pair_matches(rows, cols)
    got = mxu.tile_counts_mxu_exact(intersect._pad_lane(rows), intersect._pad_lane(cols), s)
    exact = intersect.tile_counts(rows, cols, s)
    tail_equal = all(np.array_equal(got[k], exact[k].cpu().numpy())
                     for k in ("shared_in_x", "union_size", "inter_full"))
    line = {"phase": "mxu_route", "genomes": len(next(iter(indexes.values()))[0]),
            "tile": tile, "ring_positions": positions, "ring_tile": MXU_RING_TILE, **out,
            "tile_512": tiles, "long_tail": {"max_m_in": peak, "equal_k3": tail_equal},
            "card": smi}
    emit(line)
    require(peak > 256, "the long-tail tile has a chunk with m_in > 256")
    require(tail_equal, "the long-tail tile equals K3")
    return line


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for a block, restoring them after it."""
    old = {name: os.environ.get(name) for name in values}
    os.environ.update({name: str(v) for name, v in values.items()})
    try:
        yield
    finally:
        for name, v in old.items():
            if v is None:
                del os.environ[name]
            else:
                os.environ[name] = v


SCREEN_ROUTE_CHUNK = 999  # MIEKKI_SCREEN_CHUNK of reference_routes' screens


def reference_routes(dev, smi: str, tmp: Path, paths, sketch64: dict, dist64: dict,
                     config3: dict, screen4: dict, counts10k: tuple,
                     tile: int = TILE) -> dict:
    """The reference's selectable routes on the data the smoke built, each
    run with the counters reset just before it and held to the default
    route's output:
      - sketch-64 (`cli sketch`) under MIEKKI_MERGE=threshold and sort, and
        under tree at MIEKKI_PIPELINE=0 and 1 and at MIEKKI_TREE_CAP0=8 and
        32 (the default is 16): index members equal tree's;
      - dist-64 and dist-64-compact (`cli dist`) under
        MIEKKI_INTERSECT=bitonic and searchsorted: TSV bytes equal, no
        K3/K4 launch;
      - one 512 x 512 tile of config 3 (raw and compact) timed alone on
        each route beside K3/K4;
      - screen-config4 (`cli screen`) under MIEKKI_SCREEN_JOIN=merge and
        searchsorted at MIEKKI_SCREEN_CHUNK=999: rows equal, one K1 launch
        a batch; each join's peak device bytes on one batch against the
        DB, per DB value and per joined value (the merge join's checked
        against utils.hbm's budget);
      - dist-counts-10k at MIEKKI_PIPELINE=1 and at dist_counts_matrix's
        default 8: matrices equal, 210 K3 launches each.
    sketch64: {"db", "index"}; dist64: {"raw": (db, tsv), "compact": ...};
    config3: {"raw": index, "compact": index}; screen4: {"db", "index",
    "reads", "tsv"}; counts10k: (index, matrices)."""
    import torch

    from miekki_tpu_torch import cli, engine
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.ops import cuda_hash, cuda_intersect, cuda_intersect32, intersect
    from miekki_tpu_torch.utils import hbm

    def k3_k4():
        return cuda_intersect.tile_counts_cuda.launches + cuda_intersect32.tile_counts32_cuda.launches

    line = {"phase": "reference_routes", "card": smi}
    tree = sketch64["index"]
    sketch_runs = {}
    for tag, knobs in (("threshold", {"MIEKKI_MERGE": "threshold"}),
                       ("sort", {"MIEKKI_MERGE": "sort"}),
                       ("tree_pipeline0", {"MIEKKI_PIPELINE": 0}),
                       ("tree_pipeline1", {"MIEKKI_PIPELINE": 1}),
                       ("tree_cap0_8", {"MIEKKI_TREE_CAP0": 8}),
                       ("tree_cap0_32", {"MIEKKI_TREE_CAP0": 32})):
        out = tmp / f"routes_{tag}.npz"
        with _env(**knobs):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["sketch", *paths, "-o", str(out), "-k", str(K), "-s", str(S)])
            seconds = time.perf_counter() - t0
        got = SketchIndex.load(out)
        equal = (rc == 0 and got.names == tree.names and np.array_equal(got.hi, tree.hi)
                 and np.array_equal(got.lo, tree.lo))
        sketch_runs[tag] = {"seconds": seconds, "equal": equal,
                            "k1_launches": cuda_hash.hash_windows_cuda.launches}
        require(equal, f"sketch-64 under {knobs} equals the tree index")
        require(sketch_runs[tag]["k1_launches"] > 0, f"K1 launched on sketch-64 under {knobs}")
    line["sketch64"] = sketch_runs

    dist_runs = {}
    for kind, (db, tsv_text) in dist64.items():
        for impl in ("bitonic", "searchsorted"):
            out = tmp / f"routes_dist64_{kind}_{impl}.tsv"
            with _env(MIEKKI_INTERSECT=impl):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = cli.main(["dist", str(db), "-o", str(out)])
                seconds = time.perf_counter() - t0
            equal = rc == 0 and out.read_text() == tsv_text
            dist_runs[f"{kind}_{impl}"] = {"seconds": seconds, "equal": equal,
                                           "k3_k4_launches": k3_k4()}
            require(equal, f"dist-64 ({kind}) under {impl}: TSV bytes equal")
            require(k3_k4() == 0, f"dist-64 ({kind}) under {impl} launches no K3/K4")
    line["dist64"] = dist_runs

    tiles = {}
    for kind, index in config3.items():
        blocks = engine._KeyBlocks(index, None, tile, dev, ())
        rows, cols = blocks.get(("a", 0)), blocks.get(("a", 1))
        fn = intersect.tile_counts_compact if kind == "compact" else intersect.tile_counts
        want = fn(rows, cols, S)
        runs = {}
        for impl in ("pallas", "bitonic", "searchsorted"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = fn(rows, cols, S, impl)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            equal = all(torch.equal(got[c], want[c]) for c in got)
            reps = 5 if impl == "pallas" else 1
            runs[impl] = {"ms": cuda_ms(lambda: fn(rows, cols, S, impl), reps=reps, warm=1),
                          "equal": equal, "peak_device_bytes": peak}
            require(equal, f"the {impl} route equals K3/K4 on a 512 x 512 tile ({kind})")
            del got
        tiles[kind] = runs
        del blocks, rows, cols, want
    line["tile_512"] = tiles

    # screen-config4: the whole `cli screen` per join
    screen_runs = {}
    for join in ("merge", "searchsorted"):
        out, met = tmp / f"routes_screen_{join}.tsv", tmp / f"routes_screen_{join}.jsonl"
        with _env(MIEKKI_SCREEN_JOIN=join, MIEKKI_SCREEN_CHUNK=SCREEN_ROUTE_CHUNK):
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = cli.main(["screen", str(screen4["db"]), str(screen4["reads"]), "-o", str(out),
                           "--metrics", str(met)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        stats = json.loads(met.read_text().splitlines()[-1])
        equal = rc == 0 and out.read_bytes() == screen4["tsv"]
        screen_runs[join] = {"seconds": seconds, "equal": equal,
                             "k1_launches": cuda_hash.hash_windows_cuda.launches,
                             "n_batches": stats["n_batches"],
                             "peak_device_bytes": torch.cuda.max_memory_allocated()}
        require(equal, f"screen-config4 under the {join} join: rows equal")
        require(screen_runs[join]["k1_launches"] == stats["n_batches"],
                f"one K1 launch a batch under the {join} join")
    # each join's device peak on one batch of 2^22 bases against the flat DB
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    db_t, _, _ = engine._flatten_db(screen4["index"], dev)
    packed = engine._packed_read_batches(str(screen4["reads"]), K, engine.DEFAULT_READ_FLAT)
    batch = engine._batch_to_device(next(packed), dev)
    packed.close()
    h = engine._hash_batch(batch, K)
    m, n = int(db_t.shape[0]), int(h.shape[0])
    for join in ("merge", "searchsorted"):
        acc = torch.zeros(m + 1, dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if join == "merge":
            engine._screen_join_merge(acc, db_t, h)
        else:
            engine._screen_join_sorted(acc, db_t, db_t[-1], torch.sort(h).values,
                                       SCREEN_ROUTE_CHUNK)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        screen_runs[join].update(join_peak_bytes=peak, db_values=m, batch_values=n,
                                 join_peak_per_db_value=peak / m,
                                 join_peak_per_joined_value=peak / (m + n))
        del acc
    del db_t, batch, h
    screen_runs["merge_budget_per_joined_value"] = hbm.SCREEN_MERGE_JOIN_BYTES_PER_VALUE
    line["screen_config4"] = screen_runs
    require(screen_runs["merge"]["join_peak_per_joined_value"]
            <= hbm.SCREEN_MERGE_JOIN_BYTES_PER_VALUE,
            "the merge join peaks within utils.hbm's bytes per joined value")

    index10k, matrices10k = counts10k
    n_blocks = -(-len(index10k) // tile)
    count_runs = {}
    for depth in (1, 8):
        with _env(MIEKKI_PIPELINE=depth):
            reset_counts()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = engine.dist_counts_matrix(index10k, tile=tile, device=dev)
            seconds = time.perf_counter() - t0
        equal = all(np.array_equal(got[c], matrices10k[c]) for c in matrices10k)
        count_runs[f"pipeline{depth}"] = {
            "seconds": seconds, "equal": equal,
            "k3_launches": cuda_intersect.tile_counts_cuda.launches,
            "peak_device_bytes_over_start": torch.cuda.max_memory_allocated() - base}
        del got
        require(equal, f"dist-counts-10k at MIEKKI_PIPELINE={depth}: matrices equal")
        require(count_runs[f"pipeline{depth}"]["k3_launches"] == n_blocks * (n_blocks + 1) // 2,
                f"{n_blocks * (n_blocks + 1) // 2} K3 launches at MIEKKI_PIPELINE={depth}")
    line["dist_counts_10k"] = count_runs
    emit(line)
    return line


def _ring_start(*argv, timeout: int = 240) -> dict:
    """Start `python -m miekki_tpu_torch.tools.multiprocess_ring` in a
    session of its own (so that _ring_stop also ends its ranks), its output
    to files."""
    out = tempfile.TemporaryFile("w+")
    err = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "miekki_tpu_torch.tools.multiprocess_ring", *argv,
         "--timeout", str(timeout)],
        stdout=out, stderr=err, text=True, start_new_session=True,
        cwd=Path(__file__).resolve().parent)
    return {"proc": proc, "out": out, "err": err, "argv": argv, "timeout": timeout,
            "t0": time.perf_counter()}


def _ring_stop(run: dict) -> None:
    """Kill the tool's session if it still runs."""
    if run["proc"].poll() is None:
        os.killpg(run["proc"].pid, 9)
        run["proc"].wait()


def _ring_finish(run: dict) -> tuple:
    """Wait for a started tool and return (its JSON lines, wall seconds);
    fails unless every rank passed."""
    try:
        rc = run["proc"].wait(timeout=2 * run["timeout"] + 60)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        _ring_stop(run)
    wall = time.perf_counter() - run["t0"]
    run["out"].seek(0)
    run["err"].seek(0)
    stdout, stderr = run["out"].read(), run["err"].read()
    run["out"].close()
    run["err"].close()
    require(rc == 0 and "ALL RANKS OK" in stdout,
            f"multiprocess_ring {' '.join(run['argv'])}: rc {rc}\n"
            f"{stdout[-3000:]}\n{stderr[-3000:]}")
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")], wall


def ring_two_process(smi: str, genomes: int = CONFIG3_GENOMES, s: int = S) -> dict:
    """Two gloo ranks in processes of their own, both computing with K3 on
    this card (blocks staged through host buffers), on a config-3-size
    index, in one run of the tool: rank 1 dies after its first chunk of the
    chunked ring, the ranks resume and finish it, then run the square
    ring; each rank holds its results against one device."""
    lines, wall = _ring_finish(_ring_start(
        "--genomes", str(genomes), "-s", str(s), "--ranks", "2", "--backend", "gloo",
        "--die-after", "1", "--modes", "square"))
    chunks = [ln for ln in lines if ln.get("mode") == "chunks"]
    require(len(chunks) == 2 and all(ln["equal"] for ln in chunks),
            "the resumed chunked ring equals one device")
    ranks = [ln for ln in lines if ln.get("mode") == "square"]
    require(len(ranks) == 2 and all(ln["equal"] for ln in ranks), "both ranks equal one device")
    ready = [ln["at_s"] for ln in lines if "backend" in ln]
    loaded = [ln["at_s"] for ln in lines if "index_loaded" in ln]
    fault = next(ln for ln in lines if "fault_run" in ln)
    line = {"phase": "ring_two_process", "genomes": genomes, "s": s, "ranks": 2,
            "backend": "gloo", "devices": sorted({ln["device"] for ln in lines if "device" in ln}),
            "seconds": wall, "ring_seconds": [ln["seconds"] for ln in ranks],
            "ranks_spawned_at_s": fault["started_at_s"], "fault_run_ended_at_s": fault["at_s"],
            "rank_ready_at_s": {"fault_run": ready[:2], "resumed": ready[2:]},
            "index_loaded_at_s": {"fault_run": loaded[:2], "resumed": loaded[2:]},
            "chunk_committed_at_s": [[ln["chunk_committed"], ln["rank"], ln["at_s"]]
                                     for ln in lines if "chunk_committed" in ln],
            "resumed_chunks_done_at_s": [ln["at_s"] for ln in chunks],
            "rank_done_at_s": [ln["at_s"] for ln in ranks],
            "k3_launches_per_rank": [ln["launches"]["k3"] for ln in ranks],
            "fault_run": fault["fault_run"],
            "resume_at": sorted(ln["resume_at_chunk"] for ln in lines if "resume_at_chunk" in ln),
            "card": smi}
    emit(line)
    require(all(n > 0 for n in line["k3_launches_per_rank"]), "K3 launched on each rank")
    return line


def nccl_start() -> dict:
    """Start the one-rank NCCL group (the tool's default backend on cuda);
    it runs beside ring_two_process."""
    return _ring_start("--ranks", "1", "--modes", "square,compact,screen,mxu_square,mxu_compact",
                       "--genomes", str(NCCL_GENOMES), "-s", str(S))


def nccl_one_rank(smi: str, run: dict) -> dict:
    """A one-rank NCCL group in a process of its own: dist_sharded through
    the collective ring code (raw and compact), through the collective
    stream-pass ring under MIEKKI_INTERSECT=mxu (forced on one rank; no
    K3/K4), and screen_sharded through its all_reduce merges, each equal
    to one device's result."""
    lines, wall = _ring_finish(run)
    modes = {ln["mode"]: ln for ln in lines if "mode" in ln}
    require(set(modes) == {"square", "compact", "screen_plain", "screen_winner",
                           "screen_p_values", "screen_files", "mxu_square", "mxu_compact"}
            and all(ln["equal"] for ln in modes.values()),
            "every NCCL mode equals one device")
    require(all(modes[m]["launches"]["k3"] + modes[m]["launches"]["k4"] == 0
                and modes[m]["launches"]["mxu_passes"] > 0 for m in ("mxu_square", "mxu_compact")),
            "the NCCL mxu ring ran the stream pass and no K3/K4")
    line = {"phase": "nccl_one_rank", "genomes": NCCL_GENOMES, "s": S, "ranks": 1,
            "backend": next(ln["backend"] for ln in lines if "backend" in ln),
            "seconds": wall, "beside": "ring_two_process",
            "rank_ready_at_s": next(ln["at_s"] for ln in lines if "backend" in ln),
            "mxu_ambiguous": next(ln["mxu_ambiguous"] for ln in lines if "mxu_ambiguous" in ln),
            "modes": {m: {"seconds": ln["seconds"], "launches": ln["launches"],
                          "at_s": ln["at_s"]} for m, ln in modes.items()}, "card": smi}
    emit(line)
    require(line["backend"] == "nccl", "the group's backend is NCCL")
    return line


def screen_sharded_config4(dev, smi: str, tmp: Path, index, db: Path, reads_fq: Path,
                           small_fq: Path, full: dict, small: dict, positions: int = 4) -> dict:
    """`parallel.screen_sharded` over `positions` positions of this card on
    screen-config4: plain on the 1 M reads (rows and window counters equal
    `cli screen`'s), -w and -p, and a 2 x 2 (data, db) mesh on the check
    reads; `cli screen --distributed` byte-equal to `cli screen`.  full,
    small: the screen_config4 phases' runs by mode."""
    import torch

    from miekki_tpu_torch import cli, engine
    from miekki_tpu_torch.ops import cuda_hash
    from miekki_tpu_torch.parallel import local_mesh, screen_sharded
    from miekki_tpu_torch.parallel.mesh import DATA_AXIS, DB_AXIS

    modes = {"plain": {}, "winner": {"winner": True}, "p_values": {"p_values": True}}
    flags = {"plain": [], "winner": ["-w"], "p_values": ["-p"]}

    def tsv(rows, mode):
        cols = ("reference", "hits", "sketch_size", "containment", "containment_lo",
                "containment_hi", "ani") + (("p_value",) if mode == "p_values" else ())
        return engine.rows_to_tsv(rows, columns=cols).encode()

    mesh = local_mesh(axis_names=(DATA_AXIS,), devices=[dev] * positions)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    rows = screen_sharded(index, str(reads_fq), mesh, stats=stats)
    seconds = time.perf_counter() - t0
    k1 = cuda_hash.hash_windows_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    want = full["plain"]["stats"]
    require(tsv(rows, "plain") == full["plain"]["tsv"],
            "screen_sharded's rows equal cli screen's on the 1 M reads")
    require((stats["n_windows"], stats["n_survivors"]) == (want["n_windows"], want["n_survivors"]),
            "screen_sharded's window counters equal engine.screen's")
    require(k1 == stats["n_batches"] * positions, "one K1 launch per batch per position")
    checks = {}
    mesh2d = local_mesh(shape=(2, 2), axis_names=(DATA_AXIS, DB_AXIS), devices=[dev] * 4)
    for mode, kw in modes.items():
        t0 = time.perf_counter()
        if mode != "plain":
            require(tsv(screen_sharded(index, str(small_fq), mesh, **kw), mode)
                    == small[mode]["tsv"], f"screen_sharded equals cli screen ({mode})")
        require(tsv(screen_sharded(index, str(small_fq), mesh2d, db_axis=DB_AXIS, **kw), mode)
                == small[mode]["tsv"], f"the 2 x 2 (data, db) screen equals cli screen ({mode})")
        out = tmp / f"screen_distributed_{mode}.tsv"
        reset_counts()
        rc = cli.main(["screen", str(db), str(small_fq), "-o", str(out), "--distributed",
                       *flags[mode]])
        require(rc == 0 and out.read_bytes() == small[mode]["tsv"],
                f"cli screen --distributed equals cli screen ({mode})")
        checks[mode] = {"seconds": time.perf_counter() - t0,
                        "cli_k1_launches": cuda_hash.hash_windows_cuda.launches}
    line = {"phase": "screen_sharded_config4", "positions": positions,
            "devices": [str(dev)] * positions, "reads": SCREEN_READS, "seconds": seconds,
            "reads_per_s": SCREEN_READS / seconds, "screen_config4_plain_s": full["plain"]["wall"],
            "n_batches": stats["n_batches"], "n_windows": stats["n_windows"],
            "k1_launches": k1, "peak_device_bytes": peak, "check_reads": SCREEN_CHECK_READS,
            "checks": checks, "card": smi}
    emit(line)
    return line


def device_planes(dev, smi: str, paths, index10k, keys10k, matrices10k, line10k: dict,
                  tile: int = TILE) -> dict:
    """The device-resident index: (a) the sketch-64 index built with
    MIEKKI_KEEP_DEV=1 keeps device planes equal to index_to_device of its
    host planes; (b) dist-counts-10k's index with its keys (made on the
    card) attached as device planes: dist_counts_matrix slices its blocks
    there (K3), equal to the host path's matrices."""
    import torch

    from miekki_tpu_torch import engine
    from miekki_tpu_torch.index.store import index_to_device
    from miekki_tpu_torch.ops import cuda_hash, cuda_intersect
    from miekki_tpu_torch.params import SketchParams

    os.environ["MIEKKI_KEEP_DEV"] = "1"
    try:
        reset_counts()
        t0 = time.perf_counter()
        idx64 = engine.build_index(paths, SketchParams(k=K, s=S), device=dev)
        build_s = time.perf_counter() - t0
    finally:
        del os.environ["MIEKKI_KEEP_DEV"]
    k1 = cuda_hash.hash_windows_cuda.launches
    planes_equal = (idx64.device_planes is not None
                    and bool(torch.equal(idx64.device_planes, index_to_device(idx64, dev))))
    require(planes_equal, "the sketch-64 index's planes equal index_to_device of its table")
    del idx64

    index10k.device_planes = keys10k
    reset_counts()
    engine.reset_block_counts()
    at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts = engine.dist_counts_matrix(index10k, tile=tile, device=dev)
    seconds = time.perf_counter() - t0
    launches = cuda_intersect.tile_counts_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    blocks = dict(engine.BLOCK_COUNTS)
    index10k.device_planes = None
    equal = all(np.array_equal(counts[c], matrices10k[c]) for c in counts)
    pairs = line10k["pairs"]
    line = {"phase": "device_planes",
            "sketch64": {"genomes": len(paths), "keep_dev": "1", "seconds": build_s,
                         "k1_launches": k1, "planes_equal_index_to_device": planes_equal},
            "dist_counts_10k": {
                "genomes": line10k["genomes"], "pairs": pairs, "k3_launches": launches,
                "matrices_equal_host_path": equal,
                "planes": {"blocks": blocks, "seconds": seconds,
                           "pairs_per_s": pairs / seconds, "peak_device_bytes": peak,
                           "device_bytes_at_start": at_start},
                "host": {key: line10k[key] for key in (
                    "blocks", "seconds", "pairs_per_s", "peak_device_bytes",
                    "device_bytes_at_start")}},
            "card": smi}
    emit(line)
    require(equal, "dist-counts-10k through device planes equals the host path")
    require(blocks["bytes_uploaded"] == 0, "no key block comes from the host planes")
    require(launches == line10k["k3_launches"], "the same K3 launches with planes")
    return line


SCALE_TIMEOUT_S = 600


SCALE_CACHE_MB = 1024  # MIEKKI_COL_CACHE_MB of scale100k's --dist-u64 run


def scale100k(smi: str, tmp: Path) -> dict:
    """tools/scale100k at its default sizes (102,400 genomes, s = 10,000)
    with --dist-u64, in a process of its own, so its device and host peaks
    are its own: the DB made on the card, 256 queries against it on the
    compact device planes (K4), spot and bias checks (K3), the same
    queries against the raw DB from its host planes, key blocks streamed
    under a 1 GiB block cache (K3, 64 cells against the oracle), the
    grouped screen of 90,000 reads (K1).  Every check of its report is
    required, and a grouped screen."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "miekki_tpu_torch.tools.scale100k", "--dist-u64",
         "--workdir", str(tmp / "scale100k")],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, text=True,
        timeout=SCALE_TIMEOUT_S, env={**os.environ, "MIEKKI_COL_CACHE_MB": str(SCALE_CACHE_MB)})
    wall = time.perf_counter() - t0
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    stats = report["screen_stats"]
    line = {"phase": "scale100k", "rc": proc.returncode, "wall_s": wall,
            "genomes": report["genomes"], "s": report["s"], "db_bytes": report["db_bytes"],
            "db_bytes_compact": report["db_bytes_compact"], "checks": report["checks"],
            "pass": report["pass"], "real_sketch_s": report["real_sketch_seconds"],
            "synth_s": report["synth_seconds"], "dist_pairs": report["dist_pairs"],
            "dist_s": report["dist_seconds"], "dist_pairs_per_s": report["dist_pairs_per_s"],
            "dist_u64": {"cache_mb": SCALE_CACHE_MB, "seconds": report["dist_u64_seconds"],
                         "pairs_per_s": report["dist_u64_pairs_per_s"],
                         "blocks": report["dist_u64_blocks"],
                         "peak_over_start_bytes": (report["dist_u64_peak_device_bytes"]
                                                   - report["dist_u64_device_bytes_at_start"]),
                         "device_bytes_at_start": report["dist_u64_device_bytes_at_start"]},
            "compact_bias_max_shared_delta": report["compact_bias_max_shared_delta"],
            "compact_bias_mean_shared_delta": report["compact_bias_mean_shared_delta"],
            "screen_reads": report["n_reads"], "screen_s": report["screen_seconds"],
            "screen_reads_per_s": report["screen_reads_per_s"], "n_slabs": stats.get("n_slabs"),
            "survivor_rate": stats.get("survivor_rate"),
            "phase_seconds": stats.get("phase_seconds"),
            "screen_db_values": report["screen_db_values"],
            "screen_value_budgets": report["screen_value_budgets"],
            "screen_top5": report["screen_top5"],
            "screen_others_max_containment": report["screen_others_max_containment"],
            "launches": {"real_sketch": report["real_sketch_launches"],
                         "dist": report["dist_launches"], "spots": report["spot_launches"],
                         "dist_u64": report["dist_u64_launches"],
                         "screen": report["screen_launches"]},
            "peak_device_bytes": {"synth": report["synth_peak_device_bytes"],
                                  "dist": report["dist_peak_device_bytes"],
                                  "screen": report["screen_peak_device_bytes"]},
            "peak_host_rss_bytes": report["peak_host_rss_bytes"],
            "host_memory_at_start": report["host_memory_at_start"],
            "total_s": report["total_seconds"], "card": smi}
    emit(line)
    require(proc.returncode == 0 and report["pass"] and all(report["checks"].values()),
            f"scale100k checks {report['checks']}")
    require(len(report["checks"]) == 7, "scale100k ran phases A (with --dist-u64) and B")
    require((line["n_slabs"] or 1) >= 2, "the 102,400-genome screen runs in groups")
    n_q = report["dist_pairs"] // report["genomes"]
    require(report["dist_launches"]["k4"] == -(-report["genomes"] // 256) * -(-n_q // 256),
            "one K4 launch per 256 x 256 tile of phase A")
    require(report["spot_launches"]["k3"] == 4, "K3 on the four bias blocks")
    require(report["dist_u64_launches"]["k3"] == report["dist_launches"]["k4"],
            "one K3 launch per 256 x 256 tile of the raw phase A")
    block_bytes = 256 * 10_112 * 8
    require(line["dist_u64"]["peak_over_start_bytes"]
            <= (SCALE_CACHE_MB << 20) + 3 * block_bytes + (16 << 20),
            "the raw phase A's device memory within its block cache's bound")
    require(report["screen_launches"]["k1"] > 0 and report["real_sketch_launches"]["k1"] > 0,
            "K1 on the real genomes' sketch and the screen")
    return line


def acceptance(dev, smi: str, tmp: Path) -> dict:
    """tools/acceptance at CI size on the card: BASELINE configs 1-5, the
    fifth over a mesh of 8 positions of the card."""
    from miekki_tpu_torch.tools import acceptance as tool

    t0 = time.perf_counter()
    rows = tool.run(False, tmp / "acceptance", dev)
    line = {"phase": "acceptance", "size": "ci", "seconds": time.perf_counter() - t0,
            "all_pass": all(r["pass"] for r in rows), "configs": rows,
            "k1_launches": sum(r["launches"]["k1"] for r in rows),
            "k3_launches": sum(r["launches"]["k3"] for r in rows), "card": smi}
    emit(line)
    require(line["all_pass"], "acceptance configs 1-5 pass on the card")
    require(line["k1_launches"] > 0 and line["k3_launches"] > 0,
            "acceptance launched K1 and K3")
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs one CUDA card", file=sys.stderr)
        return 1

    from miekki_tpu_torch import cli, engine
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.io import native, reader
    from miekki_tpu_torch.ops import _build, compact, cuda_hash, cuda_intersect
    from miekki_tpu_torch.ops import cuda_intersect32, cuda_sketch, fused_sketch
    from miekki_tpu_torch.ops import hash as plain_hash
    from miekki_tpu_torch.ops import intersect, u64
    from miekki_tpu_torch.oracle import compare as oracle_compare
    from miekki_tpu_torch.oracle import nthash as oracle_nthash
    from miekki_tpu_torch.oracle import sketch as oracle_sketch
    from miekki_tpu_torch.params import SketchParams
    from miekki_tpu_torch.utils import hbm
    from miekki_tpu_torch.utils.profiling import warm_up_window

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    # int32 compares and adds issue on the INT32 lanes only
    int32_ops_per_s = sm_count * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "sm_count": sm_count,
          "int32_lanes_per_sm": INT32_LANES_PER_SM, "max_sm_clock_mhz": max_sm_mhz,
          "int32_ops_per_s": int32_ops_per_s})

    # ---- 2. build (one nvcc per source, all started together)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.sources()}
    emit({"phase": "build", "seconds": build_s, "built": sorted(built),
          "ptxas": ptxas})

    # ---- 3. K1 vs plain, at the sketch path's step shape.  "ms" is the time
    # per call of back-to-back wrapper calls, as for every kernel; "graph_ms"
    # the device time of one call (graph replay)
    k1 = {}
    rows_k1 = engine.MAX_GENOME_BATCH * (1 << 19) // engine.DEFAULT_CHUNK
    k1_kernel = cuda_hash.kernel_info()
    k1_kernel["ptxas"] = sorted(ptxas_usage(_build.build_log("hash_windows")).values())
    for k in (21, 31, 63):
        w = engine.DEFAULT_CHUNK + k - 1
        codes = rng.integers(0, 4, size=(rows_k1, w), dtype=np.uint8)
        codes[rng.random(codes.shape) < 0.01] = 4
        x = torch.from_numpy(codes).to(dev)
        got = cuda_hash.hash_windows_cuda(x, k)
        want = plain_hash.hash_windows(x, k)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = max_abs_err(got, want)
        oh, ov = oracle_nthash.hash_kmers(codes[7], k)
        oracle_ok = bool(np.array_equal(
            got[7].cpu().numpy(), u64.keys_from_u64(np.where(ov, oh, oracle_nthash.UINT64_MAX))))
        ms = cuda_ms(lambda: cuda_hash.hash_windows_cuda(x, k), reps=20)
        dev_ms = graph_ms(lambda: cuda_hash.hash_windows_cuda(x, k), reps=50)
        plain_ms = cuda_ms(lambda: plain_hash.hash_windows(x, k), reps=3, warm=1)
        n = w - k + 1
        nbytes = rows_k1 * w + 8 * rows_k1 * n
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = rows_k1 * n * K1_OPS_PER_WINDOW / int32_ops_per_s * 1e3
        line = {"phase": "k1_vs_plain", "k": k, "shape": [rows_k1, w], "equal": equal,
                "max_abs_err": err, "oracle_row_equal": oracle_ok, "ms": ms,
                "graph_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "bytes": nbytes,
                "gbytes_per_s": nbytes / dev_ms / 1e6, "kernel": k1_kernel, "card": smi}
        emit(line)
        require(equal and oracle_ok, f"K1 equals plain and oracle at k={k}")
        k1[k] = line
        del x, got, want

    # K1 at the screen's shape: one packed read batch, a single row of
    # DEFAULT_READ_FLAT + k - 1 codes.  The screen's data comes from a
    # generator of its own, so the other phases see the same bytes as
    # before it was added
    scr_rng = np.random.default_rng(SEED + 7)
    w = engine.DEFAULT_READ_FLAT + K - 1
    codes = scr_rng.integers(0, 4, size=(1, w), dtype=np.uint8)
    codes[scr_rng.random(codes.shape) < 0.01] = 4
    x = torch.from_numpy(codes).to(dev)
    got = cuda_hash.hash_windows_cuda(x, K)
    want = plain_hash.hash_windows(x, K)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    n = w - K + 1
    nbytes = w + 8 * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * K1_OPS_PER_WINDOW / int32_ops_per_s * 1e3
    dev_ms = graph_ms(lambda: cuda_hash.hash_windows_cuda(x, K), reps=50)
    k1_screen = {"phase": "k1_vs_plain", "path": "screen", "k": K, "shape": [1, w],
                 "equal": equal, "max_abs_err": max_abs_err(got, want),
                 "ms": cuda_ms(lambda: cuda_hash.hash_windows_cuda(x, K), reps=20),
                 "graph_ms": dev_ms,
                 "plain_ms": cuda_ms(lambda: plain_hash.hash_windows(x, K), reps=3, warm=1),
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "bytes": nbytes,
                 "gbytes_per_s": nbytes / dev_ms / 1e6, "card": smi}
    emit(k1_screen)
    require(equal, "K1 equals plain at the screen's [1, 2^22 + 30] shape")
    del x, got, want

    # ---- 4. K3 vs plain (and the K3/K4 kernel's registers, shared memory
    # and occupancy)
    merge_usage = ptxas_usage(_build.build_log("tile_counts_merge"))

    def merge_kernel(key_bytes):
        tag = "tile_counts_kernelIlE" if key_bytes == 8 else "tile_counts_kernelIiE"
        info = cuda_intersect.kernel_info(key_bytes)
        info["ptxas"] = [v for k, v in merge_usage.items() if tag in k]
        return info

    def sketch_table(n_rows, s, pool_hi):
        """[n_rows, s] sorted distinct INF-padded u64 sketches drawn from a
        shared pool (so pairs overlap), some rows short, value 0 present."""
        pool = np.unique(np.concatenate(
            [[0], rng.integers(0, pool_hi, size=3 * s, dtype=np.uint64)]))
        tab = np.full((n_rows, s), oracle_nthash.UINT64_MAX, np.uint64)
        for i in range(n_rows):
            m = s if i % 4 else int(rng.integers(s // 2, s + 1))
            tab[i, :m] = np.sort(rng.choice(pool, size=m, replace=False))
        return tab

    for s in (1000, 10_000):
        keys = intersect._pad_lane(torch.from_numpy(
            u64.keys_from_u64(sketch_table(64, s, 2 ** 63)))).to(dev)
        rows, cols = keys[:32].contiguous(), keys[32:].contiguous()
        got = cuda_intersect.tile_counts_cuda(rows, cols, s)
        want = intersect.tile_counts_plain(rows, cols, s)
        torch.cuda.synchronize()
        equal = all(torch.equal(got[c], want[c]) for c in got)
        emit({"phase": "k3_vs_plain", "s": s, "tile": [32, 32], "equal": equal})
        require(equal, f"K3 equals plain on a 32 x 32 tile at s={s}")

    keys = intersect._pad_lane(torch.from_numpy(
        u64.keys_from_u64(sketch_table(2 * TILE, S, 2 ** 63)))).to(dev)
    rows, cols = keys[:TILE].contiguous(), keys[TILE:].contiguous()
    got = cuda_intersect.tile_counts_cuda(rows, cols, S)
    want = intersect.tile_counts_plain(rows, cols, S)
    torch.cuda.synchronize()
    k3_equal = all(torch.equal(got[c], want[c]) for c in got)
    k3_err = max(max_abs_err(got[c], want[c]) for c in got)
    k3_ms = cuda_ms(lambda: cuda_intersect.tile_counts_cuda(rows, cols, S), reps=5)
    k3_plain_ms = cuda_ms(lambda: intersect.tile_counts_plain(rows, cols, S), reps=1, warm=1)
    sp = rows.shape[1]
    n_a = got["n_a"].to(torch.int64)
    n_b = got["n_b"].to(torch.int64)
    merge_compares = int(n_a.sum()) * TILE + int(n_b.sum()) * TILE  # sum of na+nb
    k3_ops_ms = 2 * merge_compares / int32_ops_per_s * 1e3
    k3_bytes = 2 * TILE * sp * 8 + 3 * TILE * TILE * 4
    k3_bytes_ms = k3_bytes / HBM_BYTES_PER_S * 1e3
    k3 = {"phase": "k3_vs_plain", "s": S, "tile": [TILE, TILE], "sp": sp,
          "equal": k3_equal, "max_abs_err": k3_err, "ms": k3_ms,
          "plain_ms": k3_plain_ms, "bound_ms": max(k3_ops_ms, k3_bytes_ms),
          "bound_by": "operations" if k3_ops_ms >= k3_bytes_ms else "bytes",
          "ops_bound_ms": k3_ops_ms, "bytes_bound_ms": k3_bytes_ms,
          "pairs_per_s": TILE * TILE / k3_ms * 1e3, "kernel": merge_kernel(8), "card": smi}
    emit(k3)
    require(k3_equal, "K3 equals plain on the dist path's 512 x 512 tile")
    del keys, rows, cols, got, want

    # ---- 4b. K2 vs plain, at the fused sketch step's shape: 16 genomes of
    # 64 rows, one threshold per genome (cold INF, a loose quantile that
    # overflows, and the s-th minimum of one 2^19-window step, the steady
    # state of the main path), after levels 0 (hash, threshold and the store
    # of every key, no reduction).  "ms" is the time per call of back-to-back
    # wrapper calls, as for every kernel; "graph_ms" the device time of one
    # wrapper call (graph replay: the kernel and the memset of its counts),
    # which back-to-back calls exceed when the host's work per call
    # outlasts it
    k2 = {}
    g_rows = rows_k1 // engine.MAX_GENOME_BATCH
    w = engine.DEFAULT_CHUNK + K - 1
    codes = rng.integers(0, 4, size=(rows_k1, w), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    x = torch.from_numpy(codes).to(dev)
    h = plain_hash.hash_windows(x, K)
    finite = h[h != u64.INF_KEY].double()[: 1 << 24]
    n = w - K + 1
    k2_kernel = cuda_sketch.kernel_info()
    k2_kernel["ptxas"] = sorted(ptxas_usage(_build.build_log("hash_reduce")).values())
    thr = torch.full((engine.MAX_GENOME_BATCH,), u64.INF_KEY, dtype=torch.int64, device=dev)
    got = cuda_sketch.hash_reduce_cuda(x, K, thr, 0)
    want = fused_sketch.hash_reduce_plain(x, K, thr, 0)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    ms = cuda_ms(lambda: cuda_sketch.hash_reduce_cuda(x, K, thr, 0), reps=20)
    dev_ms = graph_ms(lambda: cuda_sketch.hash_reduce_cuda(x, K, thr, 0), reps=50)
    nbytes = rows_k1 * w + 8 * rows_k1 * n + 12 * rows_k1
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = rows_k1 * n * K2_OPS_PER_WINDOW / int32_ops_per_s * 1e3
    k2["levels0"] = {
        "phase": "k2_levels0", "threshold": "inf", "k": K, "levels": 0,
        "shape": [rows_k1, w], "equal": equal, "max_abs_err": max_abs_err(got[0], want[0]),
        "ms": ms, "graph_ms": dev_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "kernel": k2_kernel, "card": smi}
    emit(k2["levels0"])
    require(equal, "K2 equals plain at levels 0")
    for name, q in (("inf", None), ("mid", 0.2), ("tight", S / (1 << 19))):
        if q is None:
            thr = torch.full((engine.MAX_GENOME_BATCH,), u64.INF_KEY, dtype=torch.int64,
                             device=dev)
        else:
            qs = torch.tensor([q * (1 + 0.02 * gi) for gi in range(engine.MAX_GENOME_BATCH)],
                              dtype=torch.float64, device=dev)
            thr = torch.quantile(finite, qs).to(torch.int64)
        got = cuda_sketch.hash_reduce_cuda(x, K, thr, FUSED_LEVELS)
        want = fused_sketch.hash_reduce_plain(x, K, thr, FUSED_LEVELS)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        ms = cuda_ms(lambda: cuda_sketch.hash_reduce_cuda(x, K, thr, FUSED_LEVELS), reps=20)
        dev_ms = graph_ms(lambda: cuda_sketch.hash_reduce_cuda(x, K, thr, FUSED_LEVELS),
                          reps=50)
        plain_ms = cuda_ms(lambda: fused_sketch.hash_reduce_plain(x, K, thr, FUSED_LEVELS),
                           reps=3, warm=1)
        nbytes = rows_k1 * w + 8 * rows_k1 * (n >> (2 * FUSED_LEVELS)) + 12 * rows_k1
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = rows_k1 * n * K2_OPS_PER_WINDOW / int32_ops_per_s * 1e3
        line = {"phase": "k2_vs_plain", "threshold": name, "k": K, "levels": FUSED_LEVELS,
                "shape": [rows_k1, w], "genomes": engine.MAX_GENOME_BATCH,
                "rows_per_genome": g_rows, "equal": equal, "max_abs_err": err,
                "overflowing_genomes": int((got[1].reshape(-1, g_rows).amax(-1)
                                            > fused_sketch.GROUP_CAP).sum()),
                "ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "kernel": k2_kernel,
                "card": smi}
        emit(line)
        require(equal, f"K2 equals plain at threshold {name}")
        k2[name] = line
    del x, h, finite, got, want

    # ---- 4c. K4 vs plain: compact code keys made on the card (compact_rows)
    def compact_keys(n_rows, s):
        keys64 = torch.from_numpy(u64.keys_from_u64(sketch_table(n_rows, s, 2 ** 63))).to(dev)
        return intersect._pad_lane(compact.compact_rows(keys64))

    for s in (1000, 10_000):
        keys = compact_keys(64, s)
        rows, cols = keys[:32].contiguous(), keys[32:].contiguous()
        got = cuda_intersect32.tile_counts32_cuda(rows, cols, s)
        want = intersect.tile_counts_compact_plain(rows, cols, s)
        torch.cuda.synchronize()
        equal = all(torch.equal(got[c], want[c]) for c in got)
        emit({"phase": "k4_vs_plain", "s": s, "tile": [32, 32], "equal": equal})
        require(equal, f"K4 equals plain on a 32 x 32 tile at s={s}")

    keys = compact_keys(2 * TILE, S)
    rows, cols = keys[:TILE].contiguous(), keys[TILE:].contiguous()
    got = cuda_intersect32.tile_counts32_cuda(rows, cols, S)
    want = intersect.tile_counts_compact_plain(rows, cols, S)
    torch.cuda.synchronize()
    k4_equal = all(torch.equal(got[c], want[c]) for c in got)
    k4_err = max(max_abs_err(got[c], want[c]) for c in got)
    k4_ms = cuda_ms(lambda: cuda_intersect32.tile_counts32_cuda(rows, cols, S), reps=5)
    k4_plain_ms = cuda_ms(lambda: intersect.tile_counts_compact_plain(rows, cols, S),
                          reps=1, warm=1)
    sp = rows.shape[1]
    merge_compares = (int(got["n_a"].to(torch.int64).sum()) * TILE
                      + int(got["n_b"].to(torch.int64).sum()) * TILE)
    k4_ops_ms = merge_compares / int32_ops_per_s * 1e3
    k4_bytes_ms = (2 * TILE * sp * 4 + 3 * TILE * TILE * 4) / HBM_BYTES_PER_S * 1e3
    k4 = {"phase": "k4_vs_plain", "s": S, "tile": [TILE, TILE], "sp": sp,
          "equal": k4_equal, "max_abs_err": k4_err, "ms": k4_ms,
          "plain_ms": k4_plain_ms, "bound_ms": max(k4_ops_ms, k4_bytes_ms),
          "bound_by": "operations" if k4_ops_ms >= k4_bytes_ms else "bytes",
          "ops_bound_ms": k4_ops_ms, "bytes_bound_ms": k4_bytes_ms,
          "pairs_per_s": TILE * TILE / k4_ms * 1e3, "kernel": merge_kernel(4), "card": smi}
    emit(k4)
    require(k4_equal, "K4 equals plain on the compact dist path's 512 x 512 tile")
    del keys, rows, cols, got, want

    with tempfile.TemporaryDirectory(prefix="miekki_smoke_") as tmp:
        tmp = Path(tmp)

        # ---- synthetic genomes: 8 families of 8, substitution 0.5-5 %
        t0 = time.perf_counter()
        ascii_lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        rates = np.linspace(0.005, 0.05, PER_FAMILY)
        paths, codes_of, read_sources = [], {}, []
        for f in range(FAMILIES):
            root_codes = rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
            for m in range(PER_FAMILY):
                c = root_codes.copy()
                hit = np.flatnonzero(rng.random(GENOME_LEN) < rates[m])
                c[hit] = (c[hit] + rng.integers(1, 4, size=hit.size, dtype=np.uint8)) % 4
                name = f"fam{f}_g{m}"
                lines = ascii_lut[c].reshape(-1, 80)
                body = np.concatenate(
                    [lines, np.full((lines.shape[0], 1), ord("\n"), np.uint8)], axis=1)
                p = tmp / f"{name}.fa"
                p.write_bytes(f">{name}\n".encode() + body.tobytes())
                paths.append(str(p))
                if m in (0, PER_FAMILY - 1) and f in (0, FAMILIES - 1):
                    codes_of[len(paths) - 1] = c
                if m == 0:
                    read_sources.append((len(paths) - 1, c))
        gen_s = time.perf_counter() - t0
        native_reader = native.available()

        # ---- 5 + 6. the main path: sketch, then dist, through the CLI
        reset_counts()
        db, tsv, met = tmp / "db.npz", tmp / "dist.tsv", tmp / "metrics.jsonl"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["sketch", *paths, "-o", str(db), "-k", str(K), "-s", str(S),
                       "--metrics", str(met)])
        sketch_s = time.perf_counter() - t0
        require(rc == 0, "cli sketch exit code 0")
        sketch_k1 = cuda_hash.hash_windows_cuda.launches
        index = SketchIndex.load(db)
        require(len(index) == len(paths) and index.params.s == S, "index shape")
        sketch_ok = {}
        for i, c in codes_of.items():
            sketch_ok[Path(index.names[i]).name] = bool(np.array_equal(
                index.sketch_u64(i), oracle_sketch.sketch_codes(c, K, S)))
        emit({"phase": "sketch", "genomes": len(paths), "gbase": len(paths) * GENOME_LEN / 1e9,
              "generate_s": gen_s, "seconds": sketch_s,
              "gbase_per_s": len(paths) * GENOME_LEN / sketch_s / 1e9,
              "fasta_reader": "native" if native_reader else "python",
              "k1_launches": sketch_k1, "oracle_equal": sketch_ok, "card": smi})
        require(sketch_k1 > 0, "K1 launched on the sketch path")
        require(all(sketch_ok.values()), "sampled sketches equal the oracle")

        t0 = time.perf_counter()
        rc = cli.main(["dist", str(db), "-o", str(tsv), "--metrics", str(met)])
        dist_s = time.perf_counter() - t0
        require(rc == 0, "cli dist exit code 0")
        launches = {"hash_windows": cuda_hash.hash_windows_cuda.launches,
                    "tile_counts": cuda_intersect.tile_counts_cuda.launches}
        require(cuda_sketch.hash_reduce_cuda.launches == 0
                and cuda_intersect32.tile_counts32_cuda.launches == 0,
                "the default path launches neither K2 nor K4")
        lines = tsv.read_text().splitlines()
        n_pairs = len(paths) * (len(paths) - 1) // 2
        require(len(lines) == 1 + n_pairs, f"{n_pairs} dist rows")
        by_pair = {}
        for ln in lines[1:]:
            cells = ln.split("\t")
            require(len(cells) == 8, "8 TSV columns")
            by_pair[(cells[0], cells[1])] = cells
        name_ix = {n: i for i, n in enumerate(index.names)}
        sample = rng.choice(n_pairs, size=64, replace=False)
        keys_sorted = sorted(by_pair)
        mismatches = 0
        same_fam, cross_fam = [], []
        for q in sample:
            a, b = keys_sorted[q]
            cells = by_pair[(a, b)]
            sh, un, j = oracle_compare.mash_jaccard(
                index.sketch_u64(name_ix[a]), index.sketch_u64(name_ix[b]), S)
            mismatches += (int(cells[2]), int(cells[3]), cells[4]) != (sh, un, f"{j:.10g}")
        for (a, b), cells in by_pair.items():
            require(all(np.isfinite(float(x)) for x in cells[4:8]), "finite estimates")
            fam_a, fam_b = (Path(x).stem.split("_")[0] for x in (a, b))
            (same_fam if fam_a == fam_b else cross_fam).append(float(cells[6]))
        emit({"phase": "dist", "pairs": n_pairs, "seconds": dist_s,
              "pairs_per_s": n_pairs / dist_s, "k3_launches": launches["tile_counts"],
              "sampled_pairs": len(sample), "oracle_mismatches": mismatches,
              "mean_ani_same_family": float(np.mean(same_fam)),
              "mean_ani_cross_family": float(np.mean(cross_fam)), "card": smi})
        require(mismatches == 0, "sampled pairs equal the oracle")
        require(min(same_fam) > max(cross_fam), "families separate by ANI")
        for name, n in launches.items():
            require(n > 0, f"{name} launched on the main path")

        # device-only sketch rate: one batch of MAX_GENOME_BATCH genomes
        from miekki_tpu_torch.io import encode as _encode
        from miekki_tpu_torch.ops import sketch as _sketch

        batch = np.stack([
            _sketch.bucketed_chunk_codes(_encode.pack_records([c], K), K, engine.DEFAULT_CHUNK)
            for c in list(codes_of.values()) * (engine.MAX_GENOME_BATCH // len(codes_of))])
        up = torch.from_numpy(batch).to(dev)
        batch_ms = cuda_ms(lambda: _sketch.sketch_chunked(up, K, S), reps=3, warm=1)
        gbase = batch.shape[0] * GENOME_LEN / 1e9
        emit({"phase": "sketch_device", "strategy": "tree", "genomes": batch.shape[0],
              "rows_per_genome": batch.shape[1], "ms": batch_ms,
              "gbase_per_s": gbase / batch_ms * 1e3,
              "note": "device part of one sketch batch, codes already on the card",
              "card": smi})
        fused_ms = cuda_ms(lambda: _sketch.sketch_chunked(up, K, S, strategy="fused"),
                           reps=3, warm=1)
        emit({"phase": "sketch_device", "strategy": "fused", "genomes": batch.shape[0],
              "rows_per_genome": batch.shape[1], "ms": fused_ms,
              "gbase_per_s": gbase / fused_ms * 1e3,
              "note": "device part of one sketch batch, codes already on the card",
              "card": smi})
        # one traced batch of each strategy: the card's busy time and idle
        # share, and what the host ran while the card waited
        from torch.profiler import ProfilerActivity, profile, record_function

        for strategy, untraced_ms in (("tree", batch_ms), ("fused", fused_ms)):
            _sketch.sketch_chunked(up, K, S, strategy=strategy)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                warm_up_window()
                with record_function("sketch_batch"):
                    _sketch.sketch_chunked(up, K, S, strategy=strategy)
                    torch.cuda.synchronize()
            trace = tmp / f"sketch_batch_{strategy}.json"
            prof.export_chrome_trace(str(trace))
            emit({"phase": "sketch_device_trace", "strategy": strategy,
                  "untraced_ms": untraced_ms, **trace_summary(trace, "sketch_batch"),
                  "card": smi})
        del up

        # ---- 6b. the fused sketch path: the same `cli sketch`, MIEKKI_MERGE=fused
        fused_db = tmp / "fused.npz"
        reset_counts()
        with _env(MIEKKI_MERGE="fused"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["sketch", *paths, "-o", str(fused_db), "-k", str(K),
                           "-s", str(S), "--metrics", str(met)])
            fused_s = time.perf_counter() - t0
        require(rc == 0, "fused cli sketch exit code 0")
        launches["hash_reduce"] = cuda_sketch.hash_reduce_cuda.launches
        fused_k1 = cuda_hash.hash_windows_cuda.launches
        fused_index = SketchIndex.load(fused_db)
        same = (fused_index.names == index.names and np.array_equal(fused_index.hi, index.hi)
                and np.array_equal(fused_index.lo, index.lo))
        emit({"phase": "sketch_fused", "genomes": len(paths), "seconds": fused_s,
              "gbase_per_s": len(paths) * GENOME_LEN / fused_s / 1e9,
              "k2_launches": launches["hash_reduce"], "k1_fallback_launches": fused_k1,
              "equals_tree_index": same, "card": smi})
        require(launches["hash_reduce"] > 0, "K2 launched on the fused sketch path")
        require(same, "the fused index equals the tree index")

        # ---- 6c. the compact path: `cli compress`, then `cli dist` of it
        db32, tsv32 = tmp / "db32.npz", tmp / "dist32.tsv"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        require(cli.main(["compress", str(db), "-o", str(db32)]) == 0, "cli compress exit code 0")
        compress_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = cli.main(["dist", str(db32), "-o", str(tsv32), "--metrics", str(met)])
        dist32_s = time.perf_counter() - t0
        require(rc == 0, "compact cli dist exit code 0")
        launches["tile_counts32"] = cuda_intersect32.tile_counts32_cuda.launches
        index32 = SketchIndex.load(db32)
        lines32 = tsv32.read_text().splitlines()
        require(len(lines32) == 1 + n_pairs, f"{n_pairs} compact dist rows")
        rows32 = {tuple(ln.split("\t")[:2]): ln.split("\t") for ln in lines32[1:]}
        mism32 = 0
        for q in rng.choice(n_pairs, size=64, replace=False):
            a, b = keys_sorted[q]
            cells = rows32[(a, b)]
            sh, un, j = oracle_compare.mash_jaccard(
                index32.sketch_u64(name_ix[a]), index32.sketch_u64(name_ix[b]), S)
            mism32 += (int(cells[2]), int(cells[3]), cells[4]) != (sh, un, f"{j:.10g}")
        emit({"phase": "dist_compact", "pairs": n_pairs, "compress_s": compress_s,
              "seconds": dist32_s, "pairs_per_s": n_pairs / dist32_s,
              "index_bytes": db.stat().st_size, "compact_index_bytes": db32.stat().st_size,
              "k4_launches": launches["tile_counts32"], "sampled_pairs": 64,
              "oracle_mismatches": mism32, "card": smi})
        require(launches["tile_counts32"] > 0, "K4 launched on the compact dist path")
        require(mism32 == 0, "sampled compact pairs equal the oracle")

        # ---- 7. dist at config-3 scale: synthetic sketches, planted families
        t0 = time.perf_counter()
        sketches, names = [], []
        for f in range(CONFIG3_GENOMES // PER_FAMILY):
            base = rng.integers(0, 2 ** 64 - 1, size=3 * S, dtype=np.uint64)
            for m in range(PER_FAMILY):
                keep = base[rng.random(base.size) >= rates[m] * 10]
                fresh = rng.integers(0, 2 ** 64 - 1, size=3 * S - keep.size, dtype=np.uint64)
                sketches.append(np.unique(np.concatenate([keep, fresh]))[:S])
                names.append(f"syn{f}_{m}")
        big = SketchIndex.from_sketches(sketches, names, SketchParams(k=K, s=S))
        make_s = time.perf_counter() - t0
        cuda_intersect.tile_counts_cuda.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        big_tsv, big32_tsv = tmp / "config3.tsv", tmp / "config3_compact.tsv"
        t0 = time.perf_counter()
        with open(big_tsv, "w") as fh:
            n_rows = engine.dist_tsv_write(fh, big, tile=TILE, device=dev)
        big_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        big_launches = cuda_intersect.tile_counts_cuda.launches
        t0 = time.perf_counter()
        n_tile_pairs = sum(len(t[2]) for t in engine.dist_tiles(big, tile=TILE, device=dev))
        tiles_s = time.perf_counter() - t0
        n_big = CONFIG3_GENOMES * (CONFIG3_GENOMES - 1) // 2
        require(n_rows == n_big == n_tile_pairs, f"{n_big} config-3 pairs")
        with open(big_tsv) as fh:
            big_lines = fh.read().splitlines()
        mism = 0
        for q in rng.choice(n_big, size=64, replace=False):
            i = int(np.searchsorted(
                np.cumsum(np.arange(CONFIG3_GENOMES - 1, 0, -1)), q, side="right"))
            start = i * CONFIG3_GENOMES - i * (i + 1) // 2
            j = i + 1 + int(q - start)
            cells = big_lines[1 + q].split("\t")
            sh, un, jac = oracle_compare.mash_jaccard(sketches[i], sketches[j], S)
            mism += (cells[0], cells[1], int(cells[2]), int(cells[3]), cells[4]) != (
                names[i], names[j], sh, un, f"{jac:.10g}")
        emit({"phase": "dist_config3", "genomes": CONFIG3_GENOMES, "pairs": n_big,
              "tile": TILE, "synthetic_sketches": True,
              "why_synthetic": "5 Gbase of FASTA does not fit a smoke run",
              "make_s": make_s, "seconds": big_s, "pairs_per_s": n_big / big_s,
              "tiles_only_seconds": tiles_s, "tiles_only_pairs_per_s": n_big / tiles_s,
              "k3_launches": big_launches, "peak_device_bytes": peak,
              "sampled_pairs": 64, "oracle_mismatches": mism, "card": smi})
        require(big_launches > 0, "K3 launched at config-3 scale")
        require(mism == 0, "config-3 sampled pairs equal the oracle")

        # ---- 8. the same all-vs-all on the compact index (K4)
        t0 = time.perf_counter()
        big32 = big.to_compact()
        compact_s = time.perf_counter() - t0
        cuda_intersect32.tile_counts32_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with open(big32_tsv, "w") as fh:
            n_rows = engine.dist_tsv_write(fh, big32, tile=TILE, device=dev)
        big32_s = time.perf_counter() - t0
        big32_launches = cuda_intersect32.tile_counts32_cuda.launches
        t0 = time.perf_counter()
        n_tile_pairs = sum(len(t[2]) for t in engine.dist_tiles(big32, tile=TILE, device=dev))
        tiles32_s = time.perf_counter() - t0
        require(n_rows == n_big == n_tile_pairs, f"{n_big} compact config-3 pairs")
        with open(big32_tsv) as fh:
            big_lines = fh.read().splitlines()
        mism = 0
        for q in rng.choice(n_big, size=64, replace=False):
            i = int(np.searchsorted(
                np.cumsum(np.arange(CONFIG3_GENOMES - 1, 0, -1)), q, side="right"))
            j = i + 1 + int(q - (i * CONFIG3_GENOMES - i * (i + 1) // 2))
            cells = big_lines[1 + q].split("\t")
            sh, un, jac = oracle_compare.mash_jaccard(big32.sketch_u64(i), big32.sketch_u64(j), S)
            mism += (cells[0], cells[1], int(cells[2]), int(cells[3]), cells[4]) != (
                names[i], names[j], sh, un, f"{jac:.10g}")
        emit({"phase": "dist_config3_compact", "genomes": CONFIG3_GENOMES, "pairs": n_big,
              "tile": TILE, "to_compact_s": compact_s, "seconds": big32_s,
              "pairs_per_s": n_big / big32_s, "tiles_only_seconds": tiles32_s,
              "tiles_only_pairs_per_s": n_big / tiles32_s, "k4_launches": big32_launches,
              "sampled_pairs": 64, "oracle_mismatches": mism, "card": smi})
        require(big32_launches == 3, "3 K4 launches at config-3 scale")
        require(mism == 0, "compact config-3 sampled pairs equal the oracle")

        # ---- 9. BASELINE config 4, read screening (`cli screen`), cut to
        # 1 M of its 10 M reads: a 1,024-genome DB at s = 10,000 (the 64
        # real sketches of sketch-64 and 960 synthetic ones made as for
        # config 3), reads of 150 bases drawn from one genome of each family
        # at 1 % substitution, half of them reverse-complemented
        t0 = time.perf_counter()
        n_real = len(index)
        scr_sketches = ([index.sketch_u64(i) for i in range(n_real)]
                        + sketches[:SCREEN_GENOMES - n_real])
        scr_index = SketchIndex.from_sketches(
            scr_sketches, list(index.names) + names[:SCREEN_GENOMES - n_real],
            SketchParams(k=K, s=S))
        scr_db = tmp / "screen_db.npz"
        scr_index.save(scr_db)
        src = np.stack([c for _, c in read_sources])
        rec = 10 + 2 * (READ_LEN + 1) + 2  # "@r0000000\n" seq "\n+\n" qual "\n"

        def fastq_records(i0, n):
            g = scr_rng.integers(0, len(read_sources), size=n)
            start = scr_rng.integers(0, GENOME_LEN - READ_LEN + 1, size=n)
            c = src[g[:, None], start[:, None] + np.arange(READ_LEN)]
            hit = scr_rng.random((n, READ_LEN), dtype=np.float32) < READ_SUB
            c[hit] = (c[hit] + scr_rng.integers(1, 4, size=int(hit.sum()), dtype=np.uint8)) % 4
            rc = scr_rng.random(n) < 0.5
            c[rc] = 3 - c[rc, ::-1]
            out = np.empty((n, rec), np.uint8)
            out[:, :2] = np.frombuffer(b"@r", np.uint8)
            ids = i0 + np.arange(n)
            for p in range(7):
                out[:, 2 + p] = ord("0") + (ids // 10 ** (6 - p)) % 10
            out[:, 9] = ord("\n")
            out[:, 10:10 + READ_LEN] = ascii_lut[c]
            out[:, 10 + READ_LEN:13 + READ_LEN] = np.frombuffer(b"\n+\n", np.uint8)
            out[:, 13 + READ_LEN:-1] = ord("I")
            out[:, -1] = ord("\n")
            return out.tobytes()

        reads_fq = tmp / "reads.fq"
        with open(reads_fq, "wb") as fh:
            for i0 in range(0, SCREEN_READS, 100_000):
                fh.write(fastq_records(i0, min(100_000, SCREEN_READS - i0)))
        with open(reads_fq, "rb") as fh:
            head = fh.read(SCREEN_CHECK_READS * rec)
        small_fq = tmp / "reads_head.fq"
        small_fq.write_bytes(head)
        make_s = time.perf_counter() - t0

        def run_screen(tag, reads, extra, device="cuda"):
            out, met = tmp / f"screen_{tag}.tsv", tmp / f"screen_{tag}.jsonl"
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = cli.main(["screen", str(scr_db), str(reads), "-o", str(out),
                           "--metrics", str(met), "--device", device, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            require(rc == 0, f"cli screen {tag} exit code 0")
            stats = json.loads(met.read_text().splitlines()[-1])
            launches_k1 = cuda_hash.hash_windows_cuda.launches
            require(launches_k1 == (stats["n_batches"] * stats.get("n_slabs", 1)
                                    if device == "cuda" else 0),
                    f"(d) K1 launches equal the batch count per pass ({tag})")
            return {"tsv": out.read_bytes(), "stats": stats, "wall": wall,
                    "k1_launches": launches_k1, "peak": torch.cuda.max_memory_allocated()}

        modes = {"plain": [], "winner": ["-w"], "p_values": ["-p"]}
        full = {}
        mbase = SCREEN_READS * READ_LEN / 1e6
        for mode, extra in modes.items():
            r = full[mode] = run_screen(mode, reads_fq, extra)
            emit({"phase": "screen_config4", "mode": mode, "genomes": SCREEN_GENOMES,
                  "real_sketches": n_real, "reads": SCREEN_READS, "read_len": READ_LEN,
                  "reduced": {"reads": [SCREEN_READS, 10_000_000]}, "make_s": make_s,
                  "seconds": r["wall"], "screen_seconds": r["stats"]["seconds"],
                  "reads_per_s": SCREEN_READS / r["wall"], "mbase_per_s": mbase / r["wall"],
                  "n_batches": r["stats"]["n_batches"], "n_windows": r["stats"]["n_windows"],
                  "survivor_rate": r["stats"]["survivor_rate"],
                  "k1_launches": r["k1_launches"], "peak_device_bytes": r["peak"],
                  "card": smi})
        launches["hash_windows_screen"] = full["plain"]["k1_launches"]

        # (a) plain hits of every genome against an independent count: the
        # plain torch hash of the same packed batches on the card,
        # torch.unique, then np.isin against the flat DB on the host
        t0 = time.perf_counter()
        thr = max(int(sk.max()) for sk in scr_sketches if len(sk))
        thr_key = int(u64.keys_from_u64(np.array([thr], np.uint64))[0])
        uniq = []
        for batch in engine._packed_read_batches(str(reads_fq), K, engine.DEFAULT_READ_FLAT):
            h = plain_hash.hash_windows(torch.from_numpy(batch).to(dev).view(1, -1), K)[0]
            uniq.append(torch.unique(h[h <= thr_key]))
        read_vals = u64.u64_from_keys(torch.unique(torch.cat(uniq)))
        hash_unique_s = time.perf_counter() - t0
        # np.isin of the flat DB in the sorted distinct read hashes, by
        # np.searchsorted of the sorted DB (np.isin itself took ~60 s here)
        flat_db = np.concatenate(scr_sketches)
        flat_gid = np.repeat(np.arange(SCREEN_GENOMES), [len(x) for x in scr_sketches])
        order = np.argsort(flat_db, kind="stable")
        sorted_db = flat_db[order]
        at = np.minimum(np.searchsorted(read_vals, sorted_db), read_vals.size - 1)
        member = read_vals[at] == sorted_db
        indep = np.bincount(flat_gid[order][member], minlength=SCREEN_GENOMES)

        def tsv_rows(text):
            return [ln.split("\t") for ln in text.decode().splitlines()[1:]]

        got_hits = np.array([int(r[1]) for r in tsv_rows(full["plain"]["tsv"])])
        indep_s = time.perf_counter() - t0
        require(np.array_equal(got_hits, indep),
                "(a) plain hits of all genomes equal the independent count")

        # (b) on the first reads: the card's TSV equals the CPU's, and sampled
        # containments equal the numpy oracle; (c) a forced grouped run equals
        # the one-pass TSV
        small, cpu_s = {}, {}
        for mode, extra in modes.items():
            small[mode] = run_screen(f"{mode}_head", small_fq, extra)
            t0 = time.perf_counter()
            cpu = run_screen(f"{mode}_head_cpu", small_fq, extra, device="cpu")
            cpu_s[mode] = time.perf_counter() - t0
            require(small[mode]["tsv"] == cpu["tsv"],
                    f"(b) card TSV equals --device cpu on {SCREEN_CHECK_READS} reads ({mode})")
        codes = [c for _, c in reader.read_encoded(small_fq)]
        joined = np.concatenate([np.append(c, 4) for c in codes]).astype(np.int64)
        read_hashes = oracle_nthash.canonical_hashes(joined, K)
        sample = [i for i, _ in read_sources[:4]] + [int(g) for g in scr_rng.choice(
            np.arange(n_real, SCREEN_GENOMES), size=4, replace=False)]
        rows_small = tsv_rows(small["plain"]["tsv"])
        oracle_rows = {}
        for g in sample:
            sk = scr_index.sketch_u64(g)
            c = oracle_compare.containment(sk, read_hashes)
            shared = int(np.isin(sk, read_hashes).sum())
            oracle_rows[scr_index.names[g]] = [shared, f"{c:.10g}"]
            require([int(rows_small[g][1]), rows_small[g][3]] == [shared, f"{c:.10g}"],
                    f"(b) containment of genome {g} equals the numpy oracle")
        with _env(MIEKKI_SCREEN_DB_VALS=SCREEN_GROUP_VALS):
            grouped = {mode: run_screen(f"{mode}_grouped", small_fq, extra)
                       for mode, extra in modes.items()}
        for mode in modes:
            require(grouped[mode]["tsv"] == small[mode]["tsv"],
                    f"(c) the grouped screen's TSV equals one pass ({mode})")
        n_groups = grouped["plain"]["stats"]["n_slabs"]
        require(n_groups == 6, "(c) 6 groups at MIEKKI_SCREEN_DB_VALS=2000000")
        emit({"phase": "screen_config4_checks", "independent_count_s": indep_s,
              "independent_hash_unique_s": hash_unique_s,
              "distinct_read_hashes_at_or_below_thr": int(read_vals.size),
              "hits_equal_independent": True, "check_reads": SCREEN_CHECK_READS,
              "card_equals_cpu": True, "cpu_seconds": cpu_s,
              "card_seconds": {m: r["wall"] for m, r in small.items()},
              "oracle_sample": oracle_rows, "grouped_equal_one_pass": True,
              "groups": n_groups,
              "grouped_seconds": {m: r["wall"] for m, r in grouped.items()},
              "grouped_k1_launches": {m: r["k1_launches"] for m, r in grouped.items()},
              "k1_launches_equal_batches": True, "card": smi})

        # ---- 10. two batches of the plain screen, traced
        trace_fq = tmp / "reads_trace.fq"
        with open(reads_fq, "rb") as fh:
            trace_fq.write_bytes(fh.read(SCREEN_TRACE_READS * rec))
        st = {}
        engine.screen(scr_index, str(trace_fq), device=dev, stats=st)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm_up_window()
            with record_function("screen_batches"):
                engine.screen(scr_index, str(trace_fq), device=dev)
                torch.cuda.synchronize()
        trace = tmp / "screen_batches.json"
        prof.export_chrome_trace(str(trace))
        # the host parts of the same screen, timed alone; the flat DB's
        # device bytes per value, at its build's peak and held after it,
        # against the budget of utils.hbm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        parts, t0 = {}, time.perf_counter()
        db_t, flat_v, flat_g = engine._flatten_db(scr_index, dev)
        torch.cuda.synchronize()
        parts["flatten_db"], t0 = time.perf_counter() - t0, time.perf_counter()
        n_vals = int(db_t.shape[0])
        flatten_bytes = {
            "values": n_vals,
            "peak_per_value": (torch.cuda.max_memory_allocated() - base) / n_vals,
            "held_per_value": (torch.cuda.memory_allocated() - base) / n_vals,
            "budget_per_value": hbm.SCREEN_FLATTEN_BYTES_PER_VALUE,
            "bytes_limit": hbm.bytes_limit(dev),
            "one_pass_and_group_values": engine._screen_db_value_budgets(dev)}
        n_packed = sum(1 for _ in engine._packed_read_batches(
            str(trace_fq), K, engine.DEFAULT_READ_FLAT))
        parts["parse_and_pack"], t0 = time.perf_counter() - t0, time.perf_counter()
        acc_np = engine._pull_bitmap(torch.zeros(db_t.shape[0] + 1, dtype=torch.bool,
                                                 device=dev))
        parts["bitmap_pull"], t0 = time.perf_counter() - t0, time.perf_counter()
        engine._hits_from_bitmap(flat_v, flat_g, acc_np, len(scr_index))
        parts["hits_from_bitmap"] = time.perf_counter() - t0
        require(n_packed == st["n_batches"], "the traced screen's batch count")
        emit({"phase": "screen_trace", "reads": SCREEN_TRACE_READS,
              "n_batches": st["n_batches"], **trace_summary(trace, "screen_batches"),
              "host_parts_ms": {p: v * 1e3 for p, v in parts.items()},
              "flat_db_device_bytes": flatten_bytes, "card": smi})
        require(flatten_bytes["peak_per_value"] <= hbm.SCREEN_FLATTEN_BYTES_PER_VALUE,
                "the flat DB's build peaks within its budget per value")
        del db_t

        # ---- 11. the 10,240-genome count matrices (K3), from device
        # planes and with the key blocks streamed; 12. the config-3
        # outputs: --counts, --matrix, triangle, --manifest resumed (K3, K4);
        # 13. sketch -m of the screen's reads (K1); 14. --shards, merge,
        # --profile.  Each phase resets the counters just before its path
        counts10k, index10k, matrices10k, keys10k = dist_counts_10k(dev, smi)
        launches["tile_counts_10k"] = counts10k["k3_launches"]
        streamed = dist_streamed_10k(dev, smi, index10k, matrices10k)
        launches["tile_counts_streamed_10k"] = [run["k3_launches"]
                                                for run in streamed["runs"].values()]
        planes = device_planes(dev, smi, paths, index10k, keys10k, matrices10k, counts10k)
        launches["hash_windows_keep_dev"] = planes["sketch64"]["k1_launches"]
        launches["tile_counts_planes_10k"] = planes["dist_counts_10k"]["k3_launches"]
        outputs = dist_outputs_config3(dev, smi, tmp, {
            "raw": (big, big_tsv.read_text(), cuda_intersect.tile_counts_cuda),
            "compact": (big32, big32_tsv.read_text(), cuda_intersect32.tile_counts32_cuda)})
        launches["tile_counts_counts"] = outputs["raw"]["launches"]
        launches["tile_counts32_counts"] = outputs["compact"]["launches"]
        mxu_route(dev, smi, tmp, {
            "raw": (big, big_tsv.read_text(), cuda_intersect.tile_counts_cuda),
            "compact": (big32, big32_tsv.read_text(), cuda_intersect32.tile_counts32_cuda)})
        routes = reference_routes(
            dev, smi, tmp, paths, {"db": db, "index": index},
            {"raw": (db, tsv.read_text()), "compact": (db32, tsv32.read_text())},
            {"raw": big, "compact": big32},
            {"db": scr_db, "index": scr_index, "reads": reads_fq,
             "tsv": full["plain"]["tsv"]},
            (index10k, matrices10k))
        launches["hash_windows_routes"] = {
            tag: run["k1_launches"] for tag, run in routes["sketch64"].items()}
        launches["hash_windows_routes"].update(
            {f"screen_{join}": routes["screen_config4"][join]["k1_launches"]
             for join in ("merge", "searchsorted")})
        launches["tile_counts_routes"] = {
            tag: run["k3_launches"] for tag, run in routes["dist_counts_10k"].items()}
        mcopies = sketch_min_copies(dev, smi, tmp, reads_fq, small_fq, mbase)
        launches["hash_windows_min_copies"] = mcopies["k1_launches"]
        shards = shards_merge_profile(dev, smi, tmp, paths, db, tsv)
        launches["hash_windows_shards"] = shards["k1_launches"]
        launches["tile_counts_profile_trace"] = shards["k3_kernels_in_trace"]

        # ---- 15. the multi-device paths: the host ring over four positions
        # of this card at 10,240 and 1,024 genomes (K3, K4), two gloo ranks
        # and, beside them, a one-rank NCCL group in processes of their own,
        # and the data-parallel screen (K1).  Each phase resets the counters
        # just before its path
        t_multi = time.perf_counter()
        card0 = torch.device("cuda", torch.cuda.current_device())
        sharded10k = dist_sharded_10k(card0, smi, index10k, matrices10k, keys10k)
        launches["tile_counts_sharded_10k"] = sharded10k["k3_launches"]
        del index10k, matrices10k, keys10k
        sharded = dist_sharded_config3(card0, smi, tmp, {
            "raw": (big, big_tsv.read_text(), cuda_intersect.tile_counts_cuda),
            "compact": (big32, big32_tsv.read_text(), cuda_intersect32.tile_counts32_cuda)})
        launches["tile_counts_sharded"] = sharded["raw"]["launches_self"]
        launches["tile_counts32_sharded"] = sharded["compact"]["launches_self"]
        nccl_run = nccl_start()
        try:
            ring2 = ring_two_process(smi)
            nccl_one_rank(smi, nccl_run)
        finally:
            _ring_stop(nccl_run)
        launches["tile_counts_ring_per_rank"] = ring2["k3_launches_per_rank"]
        screen_sh = screen_sharded_config4(card0, smi, tmp, scr_index, scr_db, reads_fq,
                                           small_fq, full, small)
        launches["hash_windows_screen_sharded"] = screen_sh["k1_launches"]
        emit({"phase": "multi_device_total", "seconds": time.perf_counter() - t_multi,
              "card": smi})

        # ---- 16. the full-scale tools: scale100k at its default sizes with
        # --dist-u64 in a process of its own (K1, K3, K4), then acceptance at CI size (K1,
        # K3).  Each resets the counters just before each of its phases
        torch.cuda.empty_cache()
        scale = scale100k(smi, tmp)
        launches["scale100k"] = scale["launches"]
        accept = acceptance(dev, smi, tmp)
        launches["acceptance"] = {key: accept[f"{key}_launches"] for key in ("k1", "k3")}

    # ---- 17. kernels
    emit({"kernels": [
        {"name": "hash_windows", "route": "cuda",
         "source": "miekki_tpu_torch/csrc/hash_windows.cu",
         "replaces": "miekki_tpu/ops/pallas_hash.py:42",
         "launches": launches["hash_windows"], "equal": True, "tolerance": 0,
         "max_abs_err": k1[K]["max_abs_err"], "ms": k1[K]["ms"],
         "graph_ms": k1[K]["graph_ms"], "plain_ms": k1[K]["plain_ms"], "bound_ms": k1[K]["bound_ms"],
         "bound_by": k1[K]["bound_by"], "library_ms": None,
         "launches_screen": launches["hash_windows_screen"], "screen_shape": k1_screen["shape"],
         "screen_ms": k1_screen["ms"], "screen_graph_ms": k1_screen["graph_ms"],
         "screen_plain_ms": k1_screen["plain_ms"], "screen_bound_ms": k1_screen["bound_ms"],
         "launches_min_copies": launches["hash_windows_min_copies"],
         "launches_shards": launches["hash_windows_shards"],
         "launches_screen_sharded": launches["hash_windows_screen_sharded"],
         "launches_keep_dev_sketch": launches["hash_windows_keep_dev"],
         "launches_scale100k_real_sketch": launches["scale100k"]["real_sketch"]["k1"],
         "launches_scale100k_screen": launches["scale100k"]["screen"]["k1"],
         "launches_acceptance": launches["acceptance"]["k1"],
         "launches_reference_routes": launches["hash_windows_routes"]},
        {"name": "tile_counts", "route": "cuda",
         "source": "miekki_tpu_torch/csrc/tile_counts_merge.cu",
         "replaces": "miekki_tpu/ops/pallas_intersect.py:265",
         "launches": launches["tile_counts"], "equal": True, "tolerance": 0,
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "launches_counts": launches["tile_counts_counts"],
         "launches_counts_10k": launches["tile_counts_10k"],
         "launches_in_profile_trace": launches["tile_counts_profile_trace"],
         "launches_sharded_10k": launches["tile_counts_sharded_10k"],
         "launches_sharded": launches["tile_counts_sharded"],
         "launches_ring_per_rank": launches["tile_counts_ring_per_rank"],
         "launches_planes_10k": launches["tile_counts_planes_10k"],
         "launches_streamed_10k": launches["tile_counts_streamed_10k"],
         "launches_scale100k_dist_u64": launches["scale100k"]["dist_u64"]["k3"],
         "launches_scale100k_spots": launches["scale100k"]["spots"]["k3"],
         "launches_acceptance": launches["acceptance"]["k3"],
         "launches_reference_routes": launches["tile_counts_routes"]},
        {"name": "hash_reduce", "route": "cuda",
         "source": "miekki_tpu_torch/csrc/hash_reduce.cu",
         "replaces": "miekki_tpu/ops/pallas_sketch.py:140",
         "launches": launches["hash_reduce"], "equal": True, "tolerance": 0,
         "max_abs_err": max(v["max_abs_err"] for v in k2.values()),
         "ms": k2["tight"]["ms"], "graph_ms": k2["tight"]["graph_ms"],
         "plain_ms": k2["tight"]["plain_ms"],
         "bound_ms": k2["tight"]["bound_ms"], "bound_by": k2["tight"]["bound_by"],
         "library_ms": None},
        {"name": "tile_counts32", "route": "cuda",
         "source": "miekki_tpu_torch/csrc/tile_counts_merge.cu",
         "replaces": "miekki_tpu/ops/pallas_intersect.py:463",
         "launches": launches["tile_counts32"], "equal": True, "tolerance": 0,
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "launches_counts": launches["tile_counts32_counts"],
         "launches_sharded": launches["tile_counts32_sharded"],
         "launches_scale100k_dist": launches["scale100k"]["dist"]["k4"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
