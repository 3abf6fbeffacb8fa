"""Join pre-formatted TSV cells into row text in one native pass: ctypes
bindings for csrc/tsv_join.cpp (the port's own host code).

A column is a table of its distinct cells and a per-row index into it.
`cell_table(cells)` encodes a column's cells as UTF-8: (the bytes, int64
offsets).  `join(columns, nrows)` gives the rows' text: each row's cells
joined by a tab and ended by a newline.  It sizes one buffer from the
cells' lengths, has the native pass fill it and decodes it once: no Python
object a row.  Where the library is not built (no compiler, or a failed
build) it joins the same columns with numpy's `np.char.add`, to the same
text.

The source is built at first use with the host C++ compiler ($CXX, default
g++) into ``build/miekki_tpu_torch/`` at the repo root, under a name that
carries a hash of the source and the flags.  Without a compiler, or where
the build fails, `available()` is False.

TSV_JOIN_COUNTS sums, until `reset_join_counts()`, the rows joined by the
native pass (`native_rows`) and by numpy (`fallback_rows`).
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
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tsv_join.cpp"
CXXFLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared")
# strings that Python holds (a name decoded with surrogateescape) survive the
# round trip through bytes unchanged
_ERRORS = "surrogatepass"

# (cell bytes uint8, offsets int64 [cells + 1], per-row index into the cells)
Column = Tuple[np.ndarray, np.ndarray, np.ndarray]

TSV_JOIN_COUNTS: dict = {}
_counts_lock = threading.Lock()


def reset_join_counts() -> None:
    TSV_JOIN_COUNTS.update(native_rows=0, fallback_rows=0)


reset_join_counts()

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
        "TSV join build failed (%s %s): TSV rows are joined by numpy.\n%s",
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
                ptrs = ctypes.POINTER(ctypes.c_void_p)
                lib.tj_join.argtypes = [ctypes.c_int32, ctypes.c_int64, ptrs, ptrs,
                                        ctypes.c_void_p, ptrs, ctypes.c_void_p,
                                        ctypes.c_int64]
                lib.tj_join.restype = ctypes.c_int64
                _lib = lib
            _checked = True  # after _lib: threads may call this at once
        return _lib


def available() -> bool:
    return _load() is not None


def cell_table(cells: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(the cells' UTF-8 bytes as uint8, int64 offsets of each cell's start
    and of the end)."""
    encoded = [c.encode("utf-8", _ERRORS) for c in cells]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    return np.frombuffer(b"".join(encoded), dtype=np.uint8), offsets


def _count(key: str, rows: int) -> None:
    with _counts_lock:
        TSV_JOIN_COUNTS[key] += rows


def join(columns: Sequence[Column], nrows: int) -> str:
    """The text of `nrows` rows: row r holds each column's cell index[r],
    the cells joined by tabs, the row ended by a newline."""
    if not columns:
        raise ValueError("a TSV row needs at least one column")
    cols = [(data, offsets, np.ascontiguousarray(index, dtype=np.int64))
            for data, offsets, index in columns]
    for _, _, index in cols:
        if index.shape != (nrows,):
            raise ValueError(f"a column's index has shape {index.shape}, not ({nrows},)")
    if nrows == 0:
        return ""
    if not available():
        _count("fallback_rows", nrows)
        return _join_numpy(cols)
    lib = _load()
    # one gather of the cells' lengths a column sizes the text exactly: the
    # cells, plus a tab or the newline after each
    size = nrows * len(cols) + sum(int(np.diff(offsets)[index].sum())
                                   for _, offsets, index in cols)
    out = np.empty(size, dtype=np.uint8)
    ptrs = ctypes.c_void_p * len(cols)
    ncells = np.asarray([offsets.size - 1 for _, offsets, _ in cols], dtype=np.int64)
    wrote = lib.tj_join(len(cols), nrows,
                        ptrs(*[data.ctypes.data for data, _, _ in cols]),
                        ptrs(*[offsets.ctypes.data for _, offsets, _ in cols]),
                        ncells.ctypes.data,
                        ptrs(*[index.ctypes.data for _, _, index in cols]),
                        out.ctypes.data, size)
    if wrote == -2:
        raise IndexError("a TSV column's index lies outside its cells")
    if wrote != size:
        raise RuntimeError(f"the TSV join wrote {wrote} bytes of {size}")
    _count("native_rows", nrows)
    return str(out, "utf-8", _ERRORS)


def _join_numpy(cols) -> str:
    """The join by numpy: each column's cells gathered as a str array and
    the columns added in turn."""
    parts = None
    for data, offsets, index in cols:
        raw = data.tobytes()
        cells = np.asarray([raw[a:b].decode("utf-8", _ERRORS)
                            for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())],
                           dtype=np.str_)
        parts = cells[index] if parts is None else np.char.add(
            np.char.add(parts, "\t"), cells[index])
    return "\n".join(parts.tolist()) + "\n"
