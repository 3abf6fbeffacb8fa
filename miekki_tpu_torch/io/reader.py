"""Streaming FASTA/FASTQ reader (component C1 — SURVEY.md §2; layer L0 §1).

Reads .fa/.fasta/.fna/.fq/.fastq, plain or gzip-compressed (detected by magic
bytes, not extension).  Yields (name, sequence_bytes) records; multi-line
FASTA sequences are joined.  This is the host-side feed for the device
pipeline; a native C++ fast path lives in miekki_tpu.io.native with this
module as the always-available fallback.  (Reference source unavailable —
SURVEY.md §0 — format support mandated by BASELINE.json north_star.)
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, Tuple

import numpy as np

from . import encode as _encode

Record = Tuple[str, bytes]

_GZIP_MAGIC = b"\x1f\x8b"


def _open_maybe_gzip(path: str | os.PathLike) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else b""
    if magic == _GZIP_MAGIC:
        return io.BufferedReader(gzip.GzipFile(fileobj=f))  # type: ignore[arg-type]
    return f


def sniff_format(first_byte: bytes) -> str:
    if first_byte.startswith(b">"):
        return "fasta"
    if first_byte.startswith(b"@"):
        return "fastq"
    raise ValueError(f"unrecognized sequence file (starts with {first_byte[:1]!r})")


def iter_fasta(stream: io.BufferedReader) -> Iterator[Record]:
    name = None
    chunks: list[bytes] = []
    for raw in stream:
        line = raw.rstrip(b"\r\n")
        if line.startswith(b">"):
            if name is not None:
                yield name, b"".join(chunks)
            name = line[1:].split()[0].decode("utf-8", "replace") if len(line) > 1 else ""
            chunks = []
        elif line:
            chunks.append(line)
    if name is not None:
        yield name, b"".join(chunks)


def iter_fastq(stream: io.BufferedReader) -> Iterator[Record]:
    while True:
        header = stream.readline()
        if not header:
            return
        header = header.rstrip(b"\r\n")
        if not header:
            continue
        if not header.startswith(b"@"):
            raise ValueError(f"malformed FASTQ header: {header[:40]!r}")
        seq = stream.readline().rstrip(b"\r\n")
        plus = stream.readline()
        if not plus.startswith(b"+"):
            raise ValueError("malformed FASTQ record: missing '+' line")
        qual = stream.readline().rstrip(b"\r\n")
        if len(qual) != len(seq):
            raise ValueError("malformed FASTQ record: qual/seq length mismatch")
        name = header[1:].split()[0].decode("utf-8", "replace") if len(header) > 1 else ""
        yield name, seq


def read_records(path: str | os.PathLike) -> Iterator[Record]:
    """Yield (name, sequence_bytes) from a FASTA/FASTQ(.gz) file."""
    stream = _open_maybe_gzip(path)
    try:
        first = stream.peek(1)[:1]
        fmt = sniff_format(first)
        it = iter_fasta(stream) if fmt == "fasta" else iter_fastq(stream)
        yield from it
    finally:
        stream.close()


def read_encoded(path: str | os.PathLike) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, uint8 code array) records.

    Uses the native C++ parser (io.native) when built; the pure-Python path
    below is the fallback and the behavioral spec.
    """
    from . import native as _native

    if _native.available():
        yield from _native.read_encoded_native(path)
        return
    _native.warn_python_fallback("read_encoded")
    for name, seq in read_records(path):
        yield name, _encode.encode(seq)


def read_genome_codes(path: str | os.PathLike) -> list[np.ndarray]:
    """All records of one genome file as a list of code arrays."""
    return [codes for _, codes in read_encoded(path)]
