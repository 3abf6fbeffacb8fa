"""Device time of variants of kernel K1 (csrc/hash_windows.cu) on one card.

    python -m miekki_tpu_torch.tools.k1_attribution [--split SOURCE.cu] [--yardstick]
        [LABEL=SOURCE.cu ...]

Each SOURCE is a CUDA file that exports K1's C entry point
(`miekki_hash_windows`).  It is built with the port's nvcc flags into
build/k1_attribution/, run on the sketch path's step shape (uint8 codes
[1024, 8222], 1 % invalid, k = 31), held bitwise to ops.hash.hash_windows,
and timed two ways: `graph_ms`, one launch captured in a CUDA graph and
replayed between CUDA events (the device time of a launch), and `ms`,
back-to-back ctypes launches between CUDA events.

--split takes a K1 source, either the block-per-tile design (one block
per 2,048 windows: load, barrier, hash, barrier, store) or the persistent
one, and builds three scratch variants of it by rewriting its text: `hash_only`
(keys computed, none stored), `store_only` (a constant key per window
stored, no hash) and `load_only` (neither), so that its time splits into
load, hash and store.  Those variants are not checked against the plain
version.  --yardstick adds the time of torch's fill_ of a tensor of the
keys' size (a store-only stream of the same bytes).

Prints one JSON line per source, then the card's name and power limit.
Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import hash as plain_hash

OUT_DIR = _build.BUILD_DIR.parent / "k1_attribution"
ROWS, CHUNK, K = 1024, 8192, 31
SEED = 20261016
HBM_BYTES_PER_S = 3.35e12

# (text of the source, its replacement) per scratch variant, per design
_NO_STORE = {
    "tile": [("if (g < n) dst[g] = (int64_t)(sk[i + i / RUN] ^ SIGN);",
             "if (g < n && sk[i + i / RUN] == 0x0123456789ABCDEFull) dst[g] = 0;")],
    "persistent": [("store_keys(rows, out + cur.row * n + cur.lo, cur.cnt, lane);",
                    "if (rows[lane] == 0x0123456789ABCDEFull) out[lane] = 0;")]}
_NO_HASH = {
    "tile": [("mine[j] = bad ? INF : h;", "mine[j] = (uint64_t)j;")],
    "persistent": [("my_row[0] = key(f, r, bad < 0);", "my_row[0] = 0;"),
                   ("my_row[j] = key(f, r, bad < j);", "my_row[j] = j;")]}


def split_variants(text: str) -> dict:
    """{variant: source text} of the hash_only/store_only/load_only edits."""
    design = "persistent" if "store_keys(" in text else "tile"
    edits = {"hash_only": _NO_STORE[design], "store_only": _NO_HASH[design],
             "load_only": _NO_STORE[design] + _NO_HASH[design]}
    out = {}
    for name, pairs in edits.items():
        t = text
        for old, new in pairs:
            if t.count(old) != 1:
                raise ValueError(f"expected one {old!r} in the {design} source")
            t = t.replace(old, new)
        out[name] = t
    return out


def build(label: str, text: str) -> ctypes.CDLL:
    """Compile `text` as build/k1_attribution/<label>.so (ptxas log and
    SASS beside it) and load it."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / f"{label}.cu"
    src.write_text(text)
    lib = OUT_DIR / f"{label}.so"
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    (OUT_DIR / f"{label}.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {label} failed:\n{res.stdout}{res.stderr}")
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True)
        (OUT_DIR / f"{label}.sass").write_text(sass.stdout)
    dll = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    dll.miekki_hash_windows.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    dll.miekki_hash_windows.restype = ctypes.c_int
    return dll


def events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(label: str, dll: ctypes.CDLL, x: torch.Tensor, want, check: bool) -> dict:
    rows, w = x.shape
    out = torch.empty((rows, w - K + 1), dtype=torch.int64, device=x.device)

    def launch():
        rc = dll.miekki_hash_windows(x.data_ptr(), out.data_ptr(), rows, w, K,
                                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{label}: launch failed, CUDA error {rc}")

    launch()
    torch.cuda.synchronize()
    equal = bool(torch.equal(out, want)) if check else None
    ms = events_ms(launch, 50)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    graph.replay()
    torch.cuda.synchronize()
    graph_ms = events_ms(graph.replay, 100)
    log = (OUT_DIR / f"{label}.log").read_text()
    usage = [ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "registers" in ln]
    info = {}
    if hasattr(dll, "miekki_hash_windows_info"):
        vals = [ctypes.c_int() for _ in range(4)]
        dll.miekki_hash_windows_info.argtypes = [ctypes.c_void_p] * 4
        if dll.miekki_hash_windows_info(*(ctypes.byref(v) for v in vals)) == 0:
            info = dict(zip(("threads_per_block", "blocks_per_sm", "threads_per_sm", "sms"),
                            (v.value for v in vals)))
    nbytes = rows * w + 8 * out.numel()
    return {"variant": label, "equal": equal, "graph_ms": graph_ms, "ms": ms,
            "graph_gbytes_per_s": nbytes / graph_ms / 1e6,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ptxas": usage, **info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", help="LABEL=PATH of a K1 CUDA source")
    ap.add_argument("--split", help="a K1 source, to time its load/hash/store variants")
    ap.add_argument("--yardstick", action="store_true",
                    help="also time torch's fill_ of the keys' bytes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_attribution: needs a CUDA card", file=sys.stderr)
        return 1
    todo = []
    if args.split:
        text = Path(args.split).read_text()
        todo.append(("whole", text, True))
        todo += [(name, t, False) for name, t in split_variants(text).items()]
    for spec in args.sources:
        label, _, path = spec.partition("=")
        if not re.fullmatch(r"[\w.-]+", label) or not path:
            raise ValueError(f"expected LABEL=PATH, got {spec!r}")
        todo.append((label, Path(path).read_text(), True))

    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, 4, size=(ROWS, CHUNK + K - 1), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    x = torch.from_numpy(codes).cuda()
    want = plain_hash.hash_windows(x, K)
    libs, failed = [], False
    for label, text, check in todo:
        try:
            libs.append((label, build(label, text), check))
        except RuntimeError as e:  # report it, time the others
            print(json.dumps({"variant": label, "build_error": str(e)[-600:]}), flush=True)
            failed = True
    if args.yardstick:
        keys = torch.empty((ROWS, CHUNK), dtype=torch.int64, device=x.device)
        keys.fill_(1)
        fill_ms = events_ms(lambda: keys.fill_(1), 100)
        print(json.dumps({"variant": "torch_fill", "ms": fill_ms,
                          "gbytes_per_s": keys.numel() * 8 / fill_ms / 1e6}), flush=True)
        del keys
    for label, dll, check in libs:
        line = measure(label, dll, x, want, check)
        failed |= line["equal"] is False
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
