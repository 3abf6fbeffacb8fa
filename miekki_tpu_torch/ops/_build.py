"""Build the port's CUDA sources (csrc/*.cu) with nvcc and load them.

Each source is compiled on its own, at first use, into a shared library
with a plain C interface under ``build/miekki_tpu_torch/`` at the repo
root, then loaded with ctypes.  The library's file name carries a hash of
the source and the flags, so an edited source is rebuilt.  All missing
libraries are built together: one nvcc process per source, all started at
once.  A missing nvcc or a failed build raises with the compiler's output;
nothing falls back to the plain torch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "miekki_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, $CUDA_HOME/bin or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Build every source whose library is missing; returns {name: seconds}
    for the sources built by this call (wall time of the parallel build)."""
    todo = {name: src for name, src in sources().items()
            if not target(src).exists()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, src in todo.items():
        out = target(src)
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    seconds = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {todo[name].name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last build of csrc/<name>.cu."""
    return target(sources()[name]).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all sources first if
    any library is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(target(sources()[name])))
            _libs[name] = lib
        return lib
