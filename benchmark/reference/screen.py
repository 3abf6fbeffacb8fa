"""Every row that `screen -p` writes for a read set against a table of
bottom-s sketches, in plain torch and float64, from the benchmark's own
inputs.  Imports nothing of the program.

For a read set (reads as base codes: A=0, C=1, G=2, T=3, anything else
invalid) and each sketch S_g, row g of an INF-padded [N, s] table of
64-bit order keys (the u64 value with its top bit flipped), of k-mers of
length k:

  H             the distinct canonical hashes of every valid k-window of
                every read (nthash.canonical_keys); no window spans two reads
  hits          |S_g ∩ H|
  sketch_size   |S_g|
  containment   c = hits / sketch_size (0 where the sketch is empty)
  interval      the 95 % Wilson score interval of c as a proportion of n =
                sketch_size draws: (c + z^2/2n ± z sqrt(c(1 - c)/n +
                z^2/4n^2)) / (1 + z^2/n), clamped to [0, 1]; (0, 1) at n = 0
  ani           1 + ln(c) / k, clamped to [0, 1]; 0 at c = 0
  cardinality   the KMV estimate of |H| from its KMV_S0 smallest values
                (mash.cardinalities: |H| itself below KMV_S0)
  p_value       P(X >= hits) for X ~ Binomial(sketch_size, q), with q =
                cardinality / 4^k clamped to [0, 1], the chance that a value
                of an unrelated genome's sketch lies in H when H's k-mers are
                uniform over the 4^k space: I_q(hits, sketch_size - hits + 1)
                (mash.betainc); 1 at hits = 0, 0 where q <= 0, 1 where q >= 1

Departures from `mash screen` (Ondov et al. 2019, Genome Biology 20:232):
no median-multiplicity column and no winner-takes-all; the identity is
ANI from containment, 1 + ln(c)/k (the Mash distance of c), where mash
screen prints c^(1/k); the p-value is the binomial formulation above (the
program's `oracle/compare.screen_p_value_vec`), not Mash's own.  And z is
not the exact 0.975 normal quantile (1.959963984540054) but Acklam's
rational approximation of it (1.959963986120195), which the program and
the JAX package it ports both use: the exact z moves about one interval
bound in five at the 10th digit.

Floats are written at %.10g and integers with str, one row a sketch in
table order under the header.
"""

from __future__ import annotations

import math

import torch

from . import mash, nthash

COLUMNS = ("reference", "hits", "sketch_size", "containment", "containment_lo",
           "containment_hi", "ani", "p_value")
KMV_S0 = 4096       # the read set's bottom-s0, as the program keeps it
CONFIDENCE = 0.95
# Acklam (2003): the inverse normal CDF on its central region
# 0.02425 <= p <= 0.97575, as a rational function of r = (p - 1/2)^2
ACKLAM_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
            1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
ACKLAM_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
            6.680131188771972e+01, -1.328068155288572e+01)


def acklam_z(p: float) -> float:
    """Acklam's approximation of the standard normal quantile at p, on the
    central region (the interval's p = 0.975 lies in it)."""
    if not 0.02425 <= p <= 0.97575:
        raise ValueError(f"p = {p} lies outside the central region")
    a, b = ACKLAM_A, ACKLAM_B
    q = p - 0.5
    r = q * q
    return ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q
            / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1))


def distinct_hashes(reads, k: int, cut: bool = False) -> torch.Tensor:
    """H as sorted order keys.  `reads` is an iterable of uint8 code
    tensors, each one read [L] or a batch of reads of one length [n, L];
    cut: every hash cut to its top 32 bits (the control's precision)."""
    parts = []
    for r in reads:
        keys = nthash.canonical_keys(r, k)
        if cut:
            keys = nthash.to_codes32(keys)
        parts.append(torch.unique(keys[keys != nthash.INF_KEY]))
    if not parts:
        return torch.empty(0, dtype=torch.int64)
    return torch.unique(torch.cat(parts))


def cardinality(h: torch.Tensor) -> float:
    """The KMV estimate of |H| from its KMV_S0 smallest values."""
    row = torch.full((1, KMV_S0), nthash.INF_KEY, dtype=torch.int64, device=h.device)
    low = h[:KMV_S0]
    row[0, : low.shape[0]] = low
    return mash.cardinalities(row, KMV_S0)[0]


def hit_counts(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """|S_g ∩ H| of every row of the table."""
    h = h.to(table.device)
    if h.shape[0] == 0:
        return torch.zeros(table.shape[0], dtype=torch.int64, device=table.device)
    at = torch.searchsorted(h, table).clamp_(max=h.shape[0] - 1)
    return ((h[at] == table) & (table != nthash.INF_KEY)).sum(1)


def p_values(hits: torch.Tensor, sizes: torch.Tensor, card: float, k: int) -> torch.Tensor:
    """P(X >= hits), X ~ Binomial(sizes, card / 4^k), in float64."""
    hits, sizes = hits.double(), sizes.double()
    q = min(max(card / 4.0 ** k, 0.0), 1.0)
    p = torch.ones_like(hits)
    live = hits > 0
    if q <= 0.0:
        p[live] = 0.0
    elif q < 1.0 and bool(live.any()):
        h, n = hits[live], sizes[live]
        p[live] = torch.clamp(mash.betainc(h, n - h + 1.0, torch.full_like(h, q)), 0.0, 1.0)
    return p


def wilson(hits: int, n: int, z: float):
    """The Wilson score interval of hits / n, clamped to [0, 1]."""
    if n <= 0:
        return 0.0, 1.0
    c = hits / n
    denom = 1.0 + z * z / n
    center = (c + z * z / (2 * n)) / denom
    half = (z / denom) * math.sqrt(c * (1 - c) / n + z * z / (4 * n * n))
    return max(0.0, center - half), min(1.0, center + half)


def ani(c: float, k: int) -> float:
    return 0.0 if c <= 0.0 else min(max(1.0 + math.log(c) / k, 0.0), 1.0)


def tsv(table: torch.Tensor, names, h: torch.Tensor, k: int, p_value: bool = True) -> str:
    """The TSV that `screen` (with -p: `p_value`) writes for the sketches of
    `table` against the read set of distinct hashes `h`."""
    hits = hit_counts(table, h).cpu()
    sizes = (table != nthash.INF_KEY).sum(1).cpu()
    cols = COLUMNS if p_value else COLUMNS[:-1]
    pv = p_values(hits, sizes, cardinality(h), k).tolist() if p_value else None
    z = acklam_z(0.5 + CONFIDENCE / 2.0)
    lines = ["#" + "\t".join(cols) + "\n"]
    for g, (hi, n) in enumerate(zip(hits.tolist(), sizes.tolist())):
        c = hi / n if n > 0 else 0.0
        lo, up = wilson(hi, n, z)
        cells = [names[g], str(hi), str(n), f"{c:.10g}", f"{lo:.10g}", f"{up:.10g}",
                 f"{ani(c, k):.10g}"]
        if pv is not None:
            cells.append(f"{pv[g]:.10g}")
        lines.append("\t".join(cells) + "\n")
    return "".join(lines)
