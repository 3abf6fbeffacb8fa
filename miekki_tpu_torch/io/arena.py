"""Parse plain FASTA files straight into a caller's buffer: ctypes bindings
for csrc/fasta_arena.cpp (the port's own host code; not a copy of the JAX
package's io/).

`parse_into(path, dst, k)` writes the bytes of
`encode.pack_records(reader.read_genome_codes(path), k)` (as the native
reader gives them) into `dst`, a uint8 array at least the file's size, and
returns how many it wrote, or None where it declined the file: gzip, FASTQ,
anything else that is not plain FASTA, a file larger than `dst`, or codes
that do not fit in place.  A declined file is read by io.reader as before.

The source is built at first use with the host C++ compiler ($CXX, default
g++) into ``build/miekki_tpu_torch/`` at the repo root, under a name that
carries a hash of the source and the flags.  Without a compiler, or where
the build fails, `available()` is False.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fasta_arena.cpp"
CXXFLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_checked = False


def target(cxx: str) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join((cxx,) + CXXFLAGS).encode())
    return BUILD_DIR / f"{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> bool:
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        log = proc.stderr or proc.stdout
        ok = proc.returncode == 0
    except (OSError, subprocess.TimeoutExpired) as e:
        log, ok = str(e), False
    if ok:
        os.replace(tmp, out)
        return True
    tmp.unlink(missing_ok=True)
    logging.getLogger("miekki_tpu").warning(
        "FASTA arena parser build failed (%s %s): FASTA files take the "
        "general reader.\n%s", cxx, SOURCE.name, log[-2000:])
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _checked
    if _checked:
        return _lib
    with _lock:
        if not _checked:
            cxx = shutil.which(os.environ.get("CXX", "g++"))
            out = target(cxx) if cxx else None
            if out is not None and (out.exists() or _build(cxx, out)):
                lib = ctypes.CDLL(str(out))
                lib.fa_parse_into.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                              ctypes.c_uint64, ctypes.c_int32]
                lib.fa_parse_into.restype = ctypes.c_int64
                _lib = lib
            _checked = True  # after _lib: threads may call this at once
        return _lib


def available() -> bool:
    return _load() is not None


def parse_into(path, dst: np.ndarray, k: int) -> Optional[int]:
    """Parse the FASTA file at `path` into `dst` (uint8, contiguous); the
    number of codes written, or None if the file was declined."""
    if dst.dtype != np.uint8 or not dst.flags.c_contiguous:
        raise ValueError("dst must be a contiguous uint8 array")
    lib = _load()
    if lib is None:
        raise RuntimeError("the FASTA arena parser is not built (no C++ compiler?)")
    n = lib.fa_parse_into(os.fsencode(path), dst.ctypes.data, dst.size, k)
    return n if n >= 0 else None
