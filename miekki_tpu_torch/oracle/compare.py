"""Pure-numpy oracle for sketch comparison and distance estimation.

Contract: SURVEY.md §2.1 (components C7, C8; reference source unavailable —
SURVEY.md §0).  Estimators follow the Mash paper (Ondov et al. 2016):

  * Jaccard from two bottom-s sketches: let X = bottom_s(S(A) ∪ S(B));
    j_hat = |X ∩ S(A) ∩ S(B)| / |X|.
  * Mash distance: D = -(1/k) * ln(2 j / (1 + j)); D = 1 when j = 0.
  * ANI = 1 - D (clamped to [0, 1]).
  * Containment of a sketch in a hash set: c = |S(A) ∩ H| / |S(A)|.
"""

from __future__ import annotations

import math

import numpy as np

from . import nthash


def intersection_size(a: np.ndarray, b: np.ndarray) -> int:
    """|A ∩ B| for two sorted-distinct uint64 arrays (sentinel excluded)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    common = np.intersect1d(a, b, assume_unique=True)
    return int(np.count_nonzero(common != nthash.UINT64_MAX))


def mash_jaccard(a: np.ndarray, b: np.ndarray, s: int):
    """(shared, union_size, j_hat) via the Mash bottom-s-of-union estimator.

    a, b: sorted distinct uint64 sketches (no sentinel entries).
    union_size = |X| = min(s, |A ∪ B|); shared = |X ∩ A ∩ B|.
    """
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    union = np.union1d(a, b)  # sorted distinct
    x = union[:s]
    if len(x) == 0:
        return 0, 0, 0.0
    common = np.intersect1d(a, b, assume_unique=True)
    shared = int(np.count_nonzero(np.isin(x, common, assume_unique=True)))
    return shared, len(x), shared / len(x)


def mash_distance_vec(j: np.ndarray, k: int) -> np.ndarray:
    """Vectorized Mash distance (Mash paper Eq. 4) — the primitive behind
    mash_distance; float64 in/out, same clamps as the scalar contract."""
    j = np.asarray(j, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = -np.log(2.0 * j / (1.0 + j)) / k
    d = np.clip(d, 0.0, 1.0)
    return np.where(j <= 0.0, 1.0, np.where(j >= 1.0, 0.0, d))


def mash_distance(j: float, k: int) -> float:
    """Mash distance from a Jaccard estimate (Mash paper Eq. 4)."""
    return float(mash_distance_vec(np.float64(j), k))


def ani_from_distance_vec(d: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.asarray(d, dtype=np.float64), 0.0, 1.0)


def ani_from_distance(d: float) -> float:
    return float(ani_from_distance_vec(np.float64(d)))


def containment(query_sketch: np.ndarray, target_hashes: np.ndarray) -> float:
    """c = |S(query) ∩ H(target)| / |S(query)| (0.0 for an empty sketch)."""
    q = np.asarray(query_sketch, dtype=np.uint64)
    q = q[q != nthash.UINT64_MAX]
    if len(q) == 0:
        return 0.0
    t = np.unique(np.asarray(target_hashes, dtype=np.uint64))
    shared = int(np.count_nonzero(np.isin(q, t, assume_unique=True)))
    return shared / len(q)


def ani_from_containment_vec(c: np.ndarray, k: int) -> np.ndarray:
    """Vectorized containment → ANI (1 + ln(c)/k, clamped)."""
    c = np.asarray(c, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.clip(1.0 + np.log(c) / k, 0.0, 1.0)
    return np.where(c <= 0.0, 0.0, a)


def ani_from_containment(c: float, k: int) -> float:
    """ANI estimate from containment: 1 + ln(c)/k, clamped (SURVEY.md §2.1)."""
    return float(ani_from_containment_vec(np.float64(c), k))


def chance_p_value_vec(shared, union, n1, n2, k: int,
                       counts: dict | None = None) -> np.ndarray:
    """Vectorized chance_p_value — same null model and clamps, elementwise
    identical to the scalar wrapper (the scalar delegates here).  A
    `counts` dict gets `betainc`: the pairs whose p-value went through the
    incomplete beta (shared > 0 and 0 < q < 1)."""
    shared = np.asarray(shared, dtype=np.float64)
    union = np.asarray(union, dtype=np.float64)
    n1 = np.asarray(n1, dtype=np.float64)
    n2 = np.asarray(n2, dtype=np.float64)
    shape = np.broadcast_shapes(shared.shape, union.shape, n1.shape, n2.shape)
    shared, union, n1, n2 = (np.broadcast_to(x, shape).ravel()
                             for x in (shared, union, n1, n2))
    space = 4.0 ** min(k, 200)
    m = (n1 * n2) / space
    denom = n1 + n2 - m
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(denom <= 0, 0.0, np.clip(m / np.where(denom <= 0, 1.0, denom),
                                              0.0, 1.0))
    sh = np.minimum(shared, union)
    out = np.ones(shared.shape, dtype=np.float64)
    live = shared > 0  # shared <= 0 → 1.0
    out[live & (q <= 0.0)] = 0.0
    # q >= 1 → 1.0 (already there)
    cf = live & (q > 0.0) & (q < 1.0)
    if counts is not None:
        counts["betainc"] = int(np.count_nonzero(cf))
    if np.any(cf):
        out[cf] = np.clip(
            betainc_vec(sh[cf], union[cf] - sh[cf] + 1.0, q[cf]), 0.0, 1.0
        )
    return out.reshape(shape)


def chance_p_value(shared: int, union: int, n1: float, n2: float, k: int) -> float:
    """Mash-style p-value: probability of observing >= `shared` common
    hashes among `union` bottom-s union slots by CHANCE between two
    unrelated random genomes of (estimated) distinct-k-mer cardinalities
    n1, n2 (Mash paper, Ondov et al. 2016, reports the analogous statistic;
    exact reference formula unavailable — SURVEY.md §0 — so this is a
    documented binomial formulation over the same null model).

    Null model: k-mers are uniform over the 4^k canonical space, so the
    expected chance-shared distinct k-mers are m = n1*n2/4^k and a random
    element of the union is shared with probability q = m/(n1 + n2 - m).
    X ~ Binomial(union, q); p = P(X >= shared) = I_q(shared, union-shared+1)
    via the regularized incomplete beta (O(1) per pair — the earlier exact
    summation was O(shared) host-side Python per pair, a hidden wall at
    10k-genome scale; ADVICE r1).
    """
    return float(chance_p_value_vec(shared, union, n1, n2, k))


def screen_p_value_vec(hits, sizes, read_card: float, k: int) -> np.ndarray:
    """Chance p-value for screen rows (the `mash screen` p-value analog;
    reference formula unavailable — SURVEY.md §0 — so this is the dist
    chance_p_value's null model specialized to containment).

    Null model: the read set holds `read_card` distinct k-mers, uniform
    over the 4^k space, so an UNRELATED genome's sketch hash appears in it
    with probability q = read_card/4^k.  X ~ Binomial(sketch_size, q);
    p = P(X >= hits) = I_q(hits, size - hits + 1) — same regularized
    incomplete beta machinery (betainc_vec) as the dist column, so screen
    and dist p-values share one numerical family."""
    hits = np.asarray(hits, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.float64)
    shape = np.broadcast_shapes(hits.shape, sizes.shape)
    hits, sizes = (np.broadcast_to(x, shape).ravel() for x in (hits, sizes))
    q = min(max(float(read_card) / 4.0 ** min(k, 200), 0.0), 1.0)
    h = np.minimum(hits, sizes)
    out = np.ones(hits.shape, dtype=np.float64)
    live = hits > 0  # hits == 0 → p = 1.0
    if q <= 0.0:
        out[live] = 0.0
    elif q < 1.0:
        if np.any(live):
            out[live] = np.clip(
                betainc_vec(h[live], sizes[live] - h[live] + 1.0,
                            np.full(int(live.sum()), q)), 0.0, 1.0)
    return out.reshape(shape)


def betainc_vec(a: np.ndarray, b: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Regularized incomplete beta I_x(a, b), elementwise, via the standard
    Lentz continued fraction (Numerical Recipes 6.4 formulation; |rel err|
    ~1e-14 — cross-checked against exact binomial summation in tests).

    Vectorized with per-element convergence freezing, so each element's
    iterate sequence matches a scalar early-breaking loop exactly."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    shape = np.broadcast_shapes(a.shape, b.shape, x.shape)
    a, b, x = (np.broadcast_to(v, shape).ravel().copy() for v in (a, b, x))
    out = np.empty(a.shape, dtype=np.float64)
    out[x <= 0.0] = 0.0
    out[x >= 1.0] = 1.0
    mid = (x > 0.0) & (x < 1.0)
    if np.any(mid):
        out[mid] = _betainc_mid(a[mid], b[mid], x[mid])
    return out.reshape(shape)


def _betainc_mid(a, b, x):
    from scipy.special import gammaln as _lgamma_vec  # C-loop lgamma
    ln_front = (_lgamma_vec(a + b) - _lgamma_vec(a) - _lgamma_vec(b)
                + a * np.log(x) + b * np.log1p(-x))
    front = np.exp(ln_front)
    direct = x < (a + 1.0) / (a + b + 2.0)
    out = np.empty(a.shape, dtype=np.float64)
    if np.any(direct):
        sel = direct
        out[sel] = front[sel] * _betacf_vec(a[sel], b[sel], x[sel]) / a[sel]
    if np.any(~direct):
        sel = ~direct
        out[sel] = 1.0 - front[sel] * _betacf_vec(b[sel], a[sel],
                                                  1.0 - x[sel]) / b[sel]
    return out


def _betacf_vec(a, b, x):
    """Continued fraction for the incomplete beta (modified Lentz),
    vectorized with convergence freezing per element."""
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = np.ones(a.shape, dtype=np.float64)
    d = 1.0 - qab * x / qap
    d = np.where(np.abs(d) < tiny, tiny, d)
    d = 1.0 / d
    h = d.copy()
    active = np.ones(a.shape, dtype=bool)
    for m in range(1, 300):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        dn = 1.0 + aa * d
        dn = np.where(np.abs(dn) < tiny, tiny, dn)
        cn = 1.0 + aa / c
        cn = np.where(np.abs(cn) < tiny, tiny, cn)
        dn = 1.0 / dn
        hn = h * dn * cn
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d2 = 1.0 + aa * dn
        d2 = np.where(np.abs(d2) < tiny, tiny, d2)
        c2 = 1.0 + aa / cn
        c2 = np.where(np.abs(c2) < tiny, tiny, c2)
        d2 = 1.0 / d2
        delta = d2 * c2
        h2 = hn * delta
        # freeze converged elements (exact scalar early-break semantics)
        h = np.where(active, h2, h)
        d = np.where(active, d2, d)
        c = np.where(active, c2, c)
        active = active & (np.abs(delta - 1.0) >= 1e-15)
        if not np.any(active):
            break
    return h


def _betainc(a: float, b: float, x: float) -> float:
    """Scalar wrapper over betainc_vec (kept for tests / call sites)."""
    return float(betainc_vec(np.float64(a), np.float64(b), np.float64(x)))


def jaccard_ci_vec(shared, union, conf: float = 0.95):
    """Vectorized Wilson score interval — the primitive behind jaccard_ci.
    Returns (lo, hi) float64 arrays; union <= 0 → (0, 1)."""
    shared = np.asarray(shared, dtype=np.float64)
    union = np.asarray(union, dtype=np.float64)
    z = _probit(0.5 + conf / 2.0)
    n = np.where(union <= 0, 1.0, union)
    p = shared / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = (z / denom) * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    lo = np.maximum(0.0, center - half)
    hi = np.minimum(1.0, center + half)
    bad = union <= 0
    return np.where(bad, 0.0, lo), np.where(bad, 1.0, hi)


def jaccard_ci(shared: int, union: int, conf: float = 0.95):
    """Wilson score interval for the Jaccard estimate (the `mash bounds`
    analog): treats shared ~ Binomial(union, j).  Returns (lo, hi).  The z
    quantile uses the Acklam probit approximation (|eps| < 1.2e-9)."""
    lo, hi = jaccard_ci_vec(np.float64(shared), np.float64(union), conf)
    return float(lo), float(hi)


def distance_ci_vec(shared, union, k: int, conf: float = 0.95):
    """Vectorized Mash-distance interval (d decreasing in j → bounds swap)."""
    j_lo, j_hi = jaccard_ci_vec(shared, union, conf)
    return mash_distance_vec(j_hi, k), mash_distance_vec(j_lo, k)


def distance_ci(shared: int, union: int, k: int, conf: float = 0.95):
    """Mash-distance interval from the Jaccard interval (d is decreasing in
    j, so the bounds swap)."""
    lo, hi = distance_ci_vec(np.float64(shared), np.float64(union), k, conf)
    return float(lo), float(hi)


def _probit(p: float) -> float:
    """Inverse standard-normal CDF (Acklam 2003 rational approximation)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    p_low, p_high = 0.02425, 1 - 0.02425
    if p < p_low:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0]*q+c[1])*q+c[2])*q+c[3])*q+c[4])*q+c[5]) / \
               ((((d[0]*q+d[1])*q+d[2])*q+d[3])*q+1)
    if p > p_high:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0]*q+c[1])*q+c[2])*q+c[3])*q+c[4])*q+c[5]) / \
               ((((d[0]*q+d[1])*q+d[2])*q+d[3])*q+1)
    q = p - 0.5
    r = q * q
    return (((((a[0]*r+a[1])*r+a[2])*r+a[3])*r+a[4])*r+a[5])*q / \
           (((((b[0]*r+b[1])*r+b[2])*r+b[3])*r+b[4])*r+1)


def kmv_cardinality(sketch: np.ndarray, s: int) -> float:
    """Distinct-canonical-k-mer estimate from a bottom-s sketch.

    The canonical hash is min(forward, reverse) of two ~iid uniforms, so
    its CDF at quantile q = v/2^64 is 2q - q²; with v_s the s-th smallest:
    solve 2q - q² = s/(n+1) → n̂ = s/(2q - q²) - 1.  Exact (=len) when the
    genome has fewer than s distinct k-mers.  This is THE cardinality
    estimator — index.store.SketchIndex.cardinalities delegates here so
    engine and oracle p-values agree bitwise."""
    sk = np.asarray(sketch, dtype=np.uint64)
    sk = sk[sk != nthash.UINT64_MAX]
    if len(sk) < s:
        return float(len(sk))
    q = float(sk[-1]) / 2.0**64
    return s / max(2.0 * q - q * q, 1e-300) - 1.0


def compare_sketches(a: np.ndarray, b: np.ndarray, k: int, s: int) -> dict:
    """Full pairwise record (matches one TSV row of the `dist` command)."""
    shared, union_size, j = mash_jaccard(a, b, s)
    d = mash_distance(j, k)
    return {
        "shared": shared,
        "union": union_size,
        "jaccard": j,
        "distance": d,
        "ani": ani_from_distance(d),
        "p_value": chance_p_value(
            shared, union_size, kmv_cardinality(a, s), kmv_cardinality(b, s), k
        ),
    }


def all_vs_all(sketches, k: int, s: int):
    """Upper-triangle pairwise comparison of a list of sketches (oracle)."""
    n = len(sketches)
    rows = []
    for i in range(n):
        for jdx in range(i + 1, n):
            rec = compare_sketches(sketches[i], sketches[jdx], k, s)
            rec["i"], rec["j"] = i, jdx
            rows.append(rec)
    return rows
