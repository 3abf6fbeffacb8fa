"""Seeded synthetic genomes and reads for the port's tools: random ACGT
sequences, substituted copies, families of them, reads sampled from a
genome, and FASTA/FASTQ writers.  The same generator calls as the test
fixtures (`tests/fixtures.py`), so one seed gives the same bytes."""

from __future__ import annotations

from pathlib import Path

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_seq(rng: np.random.Generator, length: int) -> bytes:
    """`length` uniform random ACGT bases."""
    return BASES[rng.integers(0, 4, size=length)].tobytes()


def mutate(rng: np.random.Generator, seq: bytes, sub_rate: float) -> bytes:
    """Substitute bases at `sub_rate` (always to a different base)."""
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    acgt = np.isin(arr, BASES)
    hit = acgt & (rng.random(len(arr)) < sub_rate)
    idx = np.where(hit)[0]
    code = np.searchsorted(BASES, arr[idx])  # BASES is sorted (A<C<G<T)
    arr[idx] = BASES[(code + rng.integers(1, 4, size=len(idx))) % 4]
    return arr.tobytes()


def make_genome_family(rng: np.random.Generator, n: int, length: int,
                       sub_rate: float = 0.02) -> list:
    """n related genomes: one ancestor and n - 1 substituted copies."""
    root = random_seq(rng, length)
    return [root] + [mutate(rng, root, sub_rate) for _ in range(n - 1)]


def reads_from_genome(rng: np.random.Generator, genome: bytes, n_reads: int,
                      read_len: int) -> list:
    """n_reads exact substrings of `read_len` bases at uniform starts."""
    starts = rng.integers(0, max(1, len(genome) - read_len), size=n_reads)
    return [genome[s : s + read_len] for s in starts]


def write_fasta(path: Path, records, line_width: int = 70) -> Path:
    """(name, sequence) records as FASTA, `line_width` bases a line."""
    out = bytearray()
    for name, seq in records:
        out += b">" + name.encode() + b"\n"
        for i in range(0, len(seq), line_width):
            out += seq[i : i + line_width] + b"\n"
    Path(path).write_bytes(bytes(out))
    return Path(path)


def write_fastq(path: Path, records) -> Path:
    """(name, sequence) records as FASTQ with constant qualities."""
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n"
                    + b"I" * len(seq) + b"\n")
    return Path(path)
