"""Seeded inputs of the benchmark's cells, made on the device in bulk.

Every input is drawn from `--seed` and a stream number of its own, so a
cell's set-up and its reference after the window can each make the same
bytes again without keeping them.  Nothing here imports the program.

- Genomes: families of related genomes, as the smoke run of the port made
  them: per family one uniform random ancestor, and each member a copy of
  it with substitutions at its own rate (always to a different base).
- Family sketches: bottom-s sketches drawn directly as sorted distinct
  64-bit values (no sequence behind them): per family a pool of 3 s
  values, each member keeping a pool value or drawing a fresh one at its
  own rate, then its s smallest distinct values.
- Files: FASTA (80 bases a line); the sketch index file format version 1
  (an npz of a JSON header and the hi and lo uint32 planes of the
  INF-padded [N, s] table) is read back for the judge.

Sketch values travel as int64 order keys (the u64 value with its top bit
flipped), so a signed sort orders them as unsigned; INF_KEY is the key of
the padding value 2**64 - 1.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

INF_KEY = (1 << 63) - 1
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)  # the value of INF_KEY
SIGN = -(1 << 63)
FASTA_LINE = 80
VALUE_SPAN = 1 << 56  # family sketch values are drawn from [0, VALUE_SPAN)
POOL_FACTOR = 3       # a family's pool holds POOL_FACTOR * s values
FAMILY_BATCH = 16     # families drawn per call

# stream numbers: one generator each, so any input can be made alone
GENOMES, SKETCHES = 1, 3


def generator(seed: int, stream: int, part: int, device) -> torch.Generator:
    """A torch generator on `device` for (seed, stream, part)."""
    g = torch.Generator(device=device)
    mixed = np.random.SeedSequence([int(seed) % (1 << 64), stream, part])
    g.manual_seed(int(mixed.generate_state(1, np.uint64)[0]) >> 1)
    return g


def member_rates(cfg: dict) -> np.ndarray:
    lo, hi = cfg["family_substitution"]
    return np.linspace(lo, hi, cfg["family_size"])


def family_genomes(seed: int, family: int, length: int, rates, device):
    """The members of one family as uint8 code tensors (A=0, C=1, G=2,
    T=3) of `length` bases."""
    g = generator(seed, GENOMES, family, device)
    root = torch.randint(0, 4, (length,), generator=g, device=device, dtype=torch.uint8)
    out = []
    for rate in rates:
        hit = torch.rand(length, generator=g, device=device) < float(rate)
        shift = torch.randint(1, 4, (length,), generator=g, device=device, dtype=torch.uint8)
        out.append(torch.where(hit, (root + shift) % 4, root))
    return out


def family_sketch_keys(seed: int, n: int, s: int, family_size: int, rates, device,
                       part: int = 0) -> torch.Tensor:
    """[n, s] int64 order keys of n synthetic sketches in families of
    `family_size` (n a multiple of it): sorted, distinct, INF-padded."""
    if n % family_size:
        raise ValueError(f"{n} sketches are not whole families of {family_size}")
    g = generator(seed, SKETCHES, part, device)
    keep_drop = torch.tensor(np.asarray(rates, dtype=np.float64) * 10, device=device)
    fams, rows = n // family_size, []
    width = POOL_FACTOR * s
    for f0 in range(0, fams, FAMILY_BATCH):
        nf = min(FAMILY_BATCH, fams - f0)
        pool = torch.randint(0, VALUE_SPAN, (nf, 1, width), generator=g, device=device)
        fresh = torch.randint(0, VALUE_SPAN, (nf, family_size, width), generator=g,
                              device=device)
        dropped = torch.rand((nf, family_size, width), generator=g, device=device) \
            < keep_drop[:, None]
        v = torch.sort(torch.where(dropped, fresh, pool).reshape(-1, width), dim=1).values
        dup = torch.zeros_like(v, dtype=torch.bool)
        dup[:, 1:] = v[:, 1:] == v[:, :-1]
        v = (v ^ SIGN).masked_fill_(dup, INF_KEY)
        rows.append(torch.sort(v, dim=1).values[:, :s])
    return torch.cat(rows)


def ascii_of(codes: torch.Tensor) -> torch.Tensor:
    lut = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=codes.device)
    return lut[codes.long()]


def write_fasta(path: Path, name: str, codes: torch.Tensor) -> Path:
    """One record, FASTA_LINE bases a line."""
    seq = ascii_of(codes)
    n_full = seq.shape[0] // FASTA_LINE
    body = seq[: n_full * FASTA_LINE].view(n_full, FASTA_LINE)
    nl = torch.full((n_full, 1), ord("\n"), dtype=torch.uint8, device=seq.device)
    text = torch.cat([body, nl], dim=1).flatten()
    tail = seq[n_full * FASTA_LINE:]
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(text.cpu().numpy().tobytes())
        if tail.numel():
            f.write(tail.cpu().numpy().tobytes() + b"\n")
    return Path(path)


def u64_table(keys: torch.Tensor) -> np.ndarray:
    """int64 order keys → numpy uint64 values (INF_KEY → 2**64 - 1)."""
    return (keys ^ SIGN).cpu().numpy().view(np.uint64)


def read_index(path: Path):
    """(names, [N, s] numpy uint64 table) of an index file (format 1)."""
    with np.load(path) as z:
        header = json.loads(bytes(z["header"]).decode())
        table = (z["hi"].astype(np.uint64) << np.uint64(32)) | z["lo"].astype(np.uint64)
    return header["names"], table
