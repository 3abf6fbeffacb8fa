"""Pack a read set's records into separator-joined rows in one native pass:
ctypes bindings for csrc/read_pack.cpp (the port's own host code; the JAX
package's native/miekki_io.cpp is not used).

`rows(path, k, flat, pin)` reads a FASTQ or FASTA file, plain or gzip, in
chunks of whole records (about CHUNK_BYTES of text each).  A chunk's records
become one stream, their codes joined by k - 1 INVALID separators, cut into
overlapping rows of flat + k - 1 codes at a stride of flat, the last row
INVALID-padded; chunks are packed apart, which keeps the exact set of valid
k-mer windows.  The stream is written straight into one uint8 tensor a
chunk (pinned with `pin`, for a non-blocking copy to a card) and every row
is a view of it: (row, reads whose first base lies in the row's first flat
codes, bases there).  Records and errors are the native stream reader's
(io.native), whose messages a malformed file raises as ValueError.

The source is built at first use with the host C++ compiler ($CXX, default
g++) and zlib into ``build/miekki_tpu_torch/`` at the repo root, under a
name that carries a hash of the source and the flags.  Without a compiler,
or where the build fails, `available()` is False.

READ_PACK_COUNTS sums, until `reset_read_pack_counts()`, the rows packed by
the pass (`native_batches`) and by the Python packer (`fallback_batches`,
counted by its caller), the pass's chunks, their text bytes (inflated) and
its pinned allocations (`pinned_allocs`).
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
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops._build import BUILD_DIR
from .native import _ERRORS

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "read_pack.cpp"
CXXFLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared")
LIBS = ("-lz",)
CHUNK_BYTES = 32 << 20  # text a chunk, as the native stream reader batches

READ_PACK_COUNTS: dict = {}
_counts_lock = threading.Lock()


def reset_read_pack_counts() -> None:
    READ_PACK_COUNTS.update(native_batches=0, fallback_batches=0, chunks=0, text_bytes=0,
                            pinned_allocs=0)


reset_read_pack_counts()


def count(**counts) -> None:
    with _counts_lock:
        for key, v in counts.items():
            READ_PACK_COUNTS[key] += v


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_checked = False


def target(cxx: str) -> Path:
    flags = " ".join((cxx,) + CXXFLAGS + LIBS)
    digest = hashlib.sha256(SOURCE.read_bytes() + flags.encode())
    return BUILD_DIR / f"{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> bool:
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
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
        "read pack build failed (%s %s): reads are packed by Python.\n%s",
        cxx, SOURCE.name, log[-2000:])
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
                i64p = ctypes.POINTER(ctypes.c_int64)
                lib.rp_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)]
                lib.rp_open.restype = ctypes.c_void_p
                lib.rp_next.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32,
                                        ctypes.c_int64, i64p, i64p]
                lib.rp_next.restype = ctypes.c_int32
                lib.rp_fill.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p, ctypes.c_void_p]
                lib.rp_fill.restype = ctypes.c_int32
                lib.rp_close.argtypes = [ctypes.c_void_p]
                lib.rp_close.restype = None
                _lib = lib
            _checked = True  # after _lib: threads may call this at once
        return _lib


def available() -> bool:
    return _load() is not None


def _error(rc: int, path) -> ValueError:
    return ValueError(f"{_ERRORS.get(rc, f'error {rc}')}: {path}")


def rows(path, k: int, flat: int, pin: bool = False,
         chunk_bytes: int = CHUNK_BYTES) -> Iterator[Tuple[torch.Tensor, int, int]]:
    """Every packed row of the file at `path`: (uint8 row of flat + k - 1
    codes, reads starting in it, bases it adds)."""
    if k < 1 or flat < 1 or chunk_bytes < 1:
        raise ValueError(f"k, flat and chunk_bytes must be positive: {k}, {flat}, {chunk_bytes}")
    lib = _load()
    if lib is None:
        raise RuntimeError("the read pack pass is not built (no C++ compiler?)")
    err = ctypes.c_int32(0)
    handle = lib.rp_open(os.fsencode(path), ctypes.byref(err))
    if not handle:
        raise _error(err.value, path)
    gap, width = k - 1, flat + k - 1
    n_rows, text = ctypes.c_int64(0), ctypes.c_int64(0)
    try:
        while True:
            rc = lib.rp_next(handle, chunk_bytes, k, flat, ctypes.byref(n_rows),
                             ctypes.byref(text))
            if rc == 0:
                return
            if rc < 0:
                raise _error(rc, path)
            count(chunks=1, text_bytes=text.value)
            n = n_rows.value
            if n == 0:  # records with no bases
                continue
            stream = torch.empty(n * flat + gap, dtype=torch.uint8, pin_memory=pin)
            count(pinned_allocs=int(pin))
            per_row = np.empty((2, n), dtype=np.int64)
            if lib.rp_fill(handle, stream.data_ptr(), stream.numel(),
                           per_row[0].ctypes.data, per_row[1].ctypes.data) != 0:
                raise RuntimeError(f"the read pack pass refused a buffer of {stream.numel()}")
            count(native_batches=n)
            for r, (n_reads, n_bases) in enumerate(zip(*per_row.tolist())):
                yield stream[r * flat:r * flat + width], n_reads, n_bases
    finally:
        lib.rp_close(handle)
