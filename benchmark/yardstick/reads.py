"""The read set of a screen cell, simulated on the device in bulk from the
seed, and its FASTQ file.  Nothing here imports the program.

Reads are [n, read_length] uint8 base codes (A=0, C=1, G=2, T=3, N=4),
drawn on a generator of their own stream (their source genomes on
data.py's), so the judge can make the same reads again after the window:

- sources: members 0 .. source_members - 1 of families 0 ..
  source_families - 1 of the configuration's genomes (data.family_genomes,
  the genomes the DB is sketched from).  Source i is family i //
  source_members, member i % source_members; it gets a share of the
  source_share * n source reads proportional to abundance_ratio^i
  (rounded by largest remainder), each read from a uniform start.
- unrelated: the other reads, uniform random bases: organisms the DB does
  not hold (a 31-mer of them is in a DB genome only by chance).
- errors and strand: the reads shuffled, each base substituted (always to
  another base) with chance `substitution`, each read reverse-complemented
  with chance `reverse_share`, then each base made an N with chance
  `n_rate`.

The FASTQ file holds one record of four lines a read, as Illumina writes
it: `@r<index>` (the index zero-padded to one width), the bases, `+`, and
Phred+33 qualities drawn uniform in `quality` (an N at Q2, `#`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import data

READS = 11          # stream number (data.py's are 1 and 3)
N_CODE = 4
WRITE_CHUNK = 1 << 18  # reads formatted a step


def source_counts(n: int, sources: int, ratio: float) -> np.ndarray:
    """n reads shared over `sources` sources in proportion to ratio^i, by
    largest remainder (ties to the lower i)."""
    w = float(ratio) ** np.arange(sources, dtype=np.float64)
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    order = np.argsort(-(exact - counts), kind="stable")
    counts[order[: n - int(counts.sum())]] += 1
    return counts


def read_set(seed: int, cfg: dict, wl: dict, device) -> torch.Tensor:
    """The cell's reads as [n, read_length] uint8 codes on `device`."""
    n, length = wl["reads"], wl["read_length"]
    fams, members = wl["source_families"], wl["source_members"]
    n_src = round(n * wl["source_share"])
    counts = source_counts(n_src, fams * members, wl["abundance_ratio"]).tolist()
    g = data.generator(seed, READS, 0, device)
    offsets = torch.arange(length, device=device)
    rates = data.member_rates(cfg)
    parts = []
    for f in range(fams):
        genomes = data.family_genomes(seed, f, cfg["genome_bases"], rates, device)
        for m in range(members):
            starts = torch.randint(0, cfg["genome_bases"] - length + 1,
                                   (counts[f * members + m],), generator=g, device=device)
            parts.append(genomes[m][starts[:, None] + offsets])
        del genomes
    parts.append(torch.randint(0, 4, (n - n_src, length), generator=g, device=device,
                               dtype=torch.uint8))
    reads = torch.cat(parts)[torch.randperm(n, generator=g, device=device)]
    del parts
    sub = torch.rand(reads.shape, generator=g, device=device) < wl["substitution"]
    shift = torch.randint(1, 4, reads.shape, generator=g, device=device, dtype=torch.uint8)
    reads = torch.where(sub, (reads + shift) % 4, reads)
    del sub, shift
    rev = torch.rand((n, 1), generator=g, device=device) < wl["reverse_share"]
    reads = torch.where(rev, 3 - reads.flip(1), reads)
    unknown = torch.rand(reads.shape, generator=g, device=device) < wl["n_rate"]
    return reads.masked_fill_(unknown, N_CODE)


def write_fastq(path: Path, reads: torch.Tensor, seed: int, quality) -> Path:
    """The reads as one FASTQ file, formatted on their device."""
    dev = reads.device
    n, length = reads.shape
    width = len(str(max(n - 1, 0)))
    lut = torch.tensor(list(b"ACGTN"), dtype=torch.uint8, device=dev)
    place = 10 ** torch.arange(width - 1, -1, -1, device=dev)
    g = data.generator(seed, READS, 1, dev)
    lo, hi = quality

    def const(text: bytes, m: int) -> torch.Tensor:
        return torch.tensor(list(text), dtype=torch.uint8, device=dev).expand(m, -1)

    with open(path, "wb") as f:
        for a in range(0, n, WRITE_CHUNK):
            r = reads[a:a + WRITE_CHUNK]
            m = r.shape[0]
            index = torch.arange(a, a + m, device=dev)[:, None]
            name = (index // place % 10 + ord("0")).to(torch.uint8)
            qual = torch.randint(lo + 33, hi + 34, r.shape, generator=g, device=dev,
                                 dtype=torch.uint8).masked_fill_(r == N_CODE, ord("#"))
            rec = torch.cat([const(b"@r", m), name, const(b"\n", m), lut[r.long()],
                             const(b"\n+\n", m), qual, const(b"\n", m)], dim=1)
            f.write(rec.cpu().numpy().tobytes())
    return Path(path)
