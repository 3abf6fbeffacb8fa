"""Every row that `dist` writes for a table of bottom-s sketches, in plain
torch and float64, from the benchmark's own inputs.  Imports nothing of the
program.

For sketches A and B, rows of an INF-padded [N, s] table of 64-bit order
keys (the u64 value with its top bit flipped), each of k-mers of length k:

  shared, union  compare.pair_counts (the bottom-s of A ∪ B)
  jaccard        j = shared / union (0 where union = 0)
  mash_distance  d = -ln(2j / (1 + j)) / k, clamped to [0, 1]; 1 at j = 0,
                 0 at j = 1 (Mash paper, Ondov et al. 2016, Eq. 4)
  ani            clamp(1 - d, 0, 1)
  cardinality    the KMV estimate of a sketch's distinct k-mers: its n
                 values where n < s, else s / (2q - q^2) - 1 with q the s-th
                 smallest value over 2^64 (a canonical hash is the least of
                 two uniform ones, so its CDF at q is 2q - q^2)
  p_value        the chance of `shared` or more between two unrelated
                 genomes of cardinalities n1, n2: k-mers uniform over the
                 4^k space, m = n1 n2 / 4^k shared by chance, a union slot
                 shared with q = m / (n1 + n2 - m) (0 where that
                 denominator is <= 0, clamped to [0, 1]), and
                 P(X >= shared) for X ~ Binomial(union, q), which is the
                 regularized incomplete beta I_q(shared, union - shared + 1);
                 1 where shared = 0, 0 where q <= 0, 1 where q >= 1

Departure from Mash: the p-value is the binomial formulation that the
program documents (`oracle/compare.chance_p_value`) over Mash's null
model, because Mash's exact formula was unavailable (SURVEY.md §0).  It is
not the number Mash itself prints.

Floats are written at %.10g and integers with str.  A self comparison
writes the pairs i < j, and a query table against a reference table every
pair (i, j), both in (i, j) order, under HEADER.
"""

from __future__ import annotations

import torch

from . import compare
from .nthash import INF_KEY

COLUMNS = ("query", "reference", "shared", "union", "jaccard", "mash_distance", "ani",
           "p_value")
HEADER = "#" + "\t".join(COLUMNS) + "\n"
MASK64 = (1 << 64) - 1
SIGN = -(1 << 63)
TINY = 1e-300        # Lentz's stand-in for a zero denominator
CF_EPS = 1e-15       # a fraction has converged once a step changes it less
CF_MAX_STEPS = 100_000


def cardinalities(table: torch.Tensor, s: int) -> list:
    """KMV estimate of each row's distinct k-mers, as Python floats."""
    n_valid = (table != INF_KEY).sum(1)
    last = table[torch.arange(table.shape[0], device=table.device),
                 torch.clamp(n_valid - 1, min=0)]
    out = []
    for n, key in zip(n_valid.tolist(), last.tolist()):
        if n < s:
            out.append(float(n))
            continue
        q = float((key ^ SIGN) & MASK64) / 2.0 ** 64
        out.append(s / max(2.0 * q - q * q, TINY) - 1.0)
    return out


def _fraction(a, b, x):
    """The continued fraction 1 / (1 + d1 / (1 + d2 / (1 + ...))) of
    I_x(a, b), with d(2m+1) = -(a + m)(a + b + m) x / ((a + 2m)(a + 2m + 1))
    and d(2m) = m (b - m) x / ((a + 2m - 1)(a + 2m)), by Lentz's method."""
    f = torch.full_like(x, TINY)
    c, d = f.clone(), torch.zeros_like(x)
    done = torch.zeros_like(x, dtype=torch.bool)
    for n in range(CF_MAX_STEPS):
        m = n // 2
        if n == 0:
            coef = torch.ones_like(x)
        elif n % 2:
            coef = -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
        else:
            coef = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        d = 1.0 + coef * d
        d = torch.where(d.abs() < TINY, TINY, d)
        c = 1.0 + coef / c
        c = torch.where(c.abs() < TINY, TINY, c)
        d = 1.0 / d
        delta = c * d
        f = torch.where(done, f, f * delta)
        done |= (delta - 1.0).abs() < CF_EPS
        if bool(done.all()):
            return f
    raise ArithmeticError(f"the incomplete beta's fraction did not converge in "
                          f"{CF_MAX_STEPS} steps")


def betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The regularized incomplete beta I_x(a, b) for 0 < x < 1 (float64):
    x^a (1 - x)^b / (a B(a, b)) times its continued fraction, or, where x
    lies above (a + 1) / (a + b + 2) and the fraction converges slowly,
    1 - I_(1-x)(b, a)."""
    flip = x >= (a + 1.0) / (a + b + 2.0)
    a, b, x = torch.where(flip, b, a), torch.where(flip, a, b), torch.where(flip, 1.0 - x, x)
    log_front = (torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
                 + a * torch.log(x) + b * torch.log1p(-x))
    v = torch.exp(log_front) * _fraction(a, b, x) / a
    return torch.where(flip, 1.0 - v, v)


def p_values(shared, union, n1, n2, k: int) -> torch.Tensor:
    """P(X >= shared), X ~ Binomial(union, q), under the null model above."""
    m = n1 * n2 / 4.0 ** k
    denom = n1 + n2 - m
    q = torch.where(denom <= 0, 0.0, torch.clamp(m / torch.where(denom <= 0, 1.0, denom),
                                                 0.0, 1.0))
    p = torch.ones_like(q)
    live = shared > 0
    p[live & (q <= 0.0)] = 0.0
    cf = live & (q > 0.0) & (q < 1.0)
    if bool(cf.any()):
        sh, un = shared[cf], union[cf]
        p[cf] = torch.clamp(betainc(sh, un - sh + 1.0, q[cf]), 0.0, 1.0)
    return p


def tsv(table_a: torch.Tensor, names_a, k: int, s: int, table_b=None, names_b=None) -> str:
    """The TSV that `dist` writes for the sketches of table_a against
    themselves, or against those of table_b."""
    na = table_a.shape[0]
    if table_b is None:
        gi, gj = torch.triu_indices(na, na, 1)
        table, off, names_b = table_a, 0, names_a
    else:
        nb = table_b.shape[0]
        gi = torch.arange(na).repeat_interleave(nb)
        gj = torch.arange(nb).repeat(na)
        table, off = torch.cat([table_a, table_b.to(table_a.device)]), na
    shared, union, _ = compare.pair_counts(table, gi.numpy(), gj.numpy() + off, s)
    shared = torch.from_numpy(shared).double()
    union = torch.from_numpy(union).double()
    cards = torch.tensor(cardinalities(table, s), dtype=torch.float64)

    j = torch.where(union > 0, shared / torch.where(union > 0, union, 1.0), 0.0)
    d = torch.clamp(-torch.log(2.0 * j / (1.0 + j)) / k, 0.0, 1.0)
    d = torch.where(j <= 0.0, 1.0, torch.where(j >= 1.0, 0.0, d))
    ani = torch.clamp(1.0 - d, 0.0, 1.0)
    p = p_values(shared, union, cards[gi], cards[gj + off], k)

    lines = [HEADER]
    for i, jj, sh, un, jac, dist, an, pv in zip(
            gi.tolist(), gj.tolist(), shared.long().tolist(), union.long().tolist(),
            j.tolist(), d.tolist(), ani.tolist(), p.tolist()):
        lines.append(f"{names_a[i]}\t{names_b[jj]}\t{sh}\t{un}\t{jac:.10g}\t{dist:.10g}\t"
                     f"{an:.10g}\t{pv:.10g}\n")
    return "".join(lines)
