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
all-vs-all at config-3 scale (1,024 sketches), raw and compact.  Kernels
are held to their plain versions with tolerance 0 (`torch.equal`): every
output is an integer.  Every phase prints one JSON line; any failed check
raises, so the exit code is non-zero.  The last three lines are the
`kernels` summary, the card's name and power limit, and
`{"ok": true, "device": {...}}`.  Exits non-zero with no result when
torch sees no CUDA card.  Nothing here imports JAX.
"""

from __future__ import annotations

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

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs one CUDA card", file=sys.stderr)
        return 1

    from miekki_tpu_torch import cli, engine
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.io import native
    from miekki_tpu_torch.ops import _build, compact, cuda_hash, cuda_intersect
    from miekki_tpu_torch.ops import cuda_intersect32, cuda_sketch, fused_sketch
    from miekki_tpu_torch.ops import hash as plain_hash
    from miekki_tpu_torch.ops import intersect, u64
    from miekki_tpu_torch.oracle import compare as oracle_compare
    from miekki_tpu_torch.oracle import nthash as oracle_nthash
    from miekki_tpu_torch.oracle import sketch as oracle_sketch
    from miekki_tpu_torch.params import SketchParams

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
        paths, codes_of = [], {}
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
        gen_s = time.perf_counter() - t0
        native_reader = native.available()

        def reset_counts():
            for fn in (cuda_hash.hash_windows_cuda, cuda_intersect.tile_counts_cuda,
                       cuda_sketch.hash_reduce_cuda, cuda_intersect32.tile_counts32_cuda):
                fn.launches = 0

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
        os.environ["MIEKKI_MERGE"] = "fused"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["sketch", *paths, "-o", str(fused_db), "-k", str(K),
                           "-s", str(S), "--metrics", str(met)])
            fused_s = time.perf_counter() - t0
        finally:
            del os.environ["MIEKKI_MERGE"]
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
        big_tsv = tmp / "config3.tsv"
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
        with open(big_tsv, "w") as fh:
            n_rows = engine.dist_tsv_write(fh, big32, tile=TILE, device=dev)
        big32_s = time.perf_counter() - t0
        big32_launches = cuda_intersect32.tile_counts32_cuda.launches
        t0 = time.perf_counter()
        n_tile_pairs = sum(len(t[2]) for t in engine.dist_tiles(big32, tile=TILE, device=dev))
        tiles32_s = time.perf_counter() - t0
        require(n_rows == n_big == n_tile_pairs, f"{n_big} compact config-3 pairs")
        with open(big_tsv) as fh:
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

    # ---- 9. kernels
    emit({"kernels": [
        {"name": "hash_windows", "route": "cuda",
         "source": "miekki_tpu_torch/csrc/hash_windows.cu",
         "replaces": "miekki_tpu/ops/pallas_hash.py:42",
         "launches": launches["hash_windows"], "equal": True, "tolerance": 0,
         "max_abs_err": k1[K]["max_abs_err"], "ms": k1[K]["ms"],
         "graph_ms": k1[K]["graph_ms"], "plain_ms": k1[K]["plain_ms"], "bound_ms": k1[K]["bound_ms"],
         "bound_by": k1[K]["bound_by"], "library_ms": None},
        {"name": "tile_counts", "route": "cuda",
         "source": "miekki_tpu_torch/csrc/tile_counts_merge.cu",
         "replaces": "miekki_tpu/ops/pallas_intersect.py:265",
         "launches": launches["tile_counts"], "equal": True, "tolerance": 0,
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
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
         "bound_by": k4["bound_by"], "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
