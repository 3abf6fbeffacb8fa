"""The plain reference against cases worked by hand."""

import numpy as np
import pytest
import torch

import tiny  # noqa: F401
from benchmark.reference import compare, nthash

MASK = (1 << 64) - 1


def _rol(v, r):
    r %= 64
    return ((v << r) | (v >> (64 - r))) & MASK if r else v


def _rolling(seq, k):
    """The ntHash recurrence, one base at a time, on Python ints."""
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    c = [code[b] for b in seq]
    out = []
    fh = rh = 0
    for i in range(k):
        fh = _rol(fh, 1) ^ nthash.SEEDS[c[i]]
        rh ^= _rol(nthash.SEEDS[3 - c[i]], i)
    out.append(min(fh, rh))
    for p in range(1, len(c) - k + 1):
        o, n = c[p - 1], c[p + k - 1]
        fh = _rol(fh, 1) ^ _rol(nthash.SEEDS[o], k) ^ nthash.SEEDS[n]
        rh = _rol(rh ^ nthash.SEEDS[3 - o], 63) ^ _rol(nthash.SEEDS[3 - n], k - 1)
        out.append(min(fh, rh))
    return out


def _codes(seq):
    return torch.tensor([{"A": 0, "C": 1, "G": 2, "T": 3}.get(b, 4) for b in seq],
                        dtype=torch.uint8)


def test_hash_of_one_kmer_by_hand():
    # k = 2, "AC": F = rol(SEED_A, 1) ^ SEED_C; R (of "GT") = SEED_G ^ rol(SEED_T, 1)
    a, c, g, t = nthash.SEEDS
    want = min(_rol(a, 1) ^ c, g ^ _rol(t, 1))
    assert nthash.u64(nthash.canonical_keys(_codes("AC"), 2)).tolist() == [want]


@pytest.mark.parametrize("k", [3, 21, 31])
def test_hash_follows_the_rolling_recurrence(k):
    rng = np.random.default_rng(k)
    seq = "".join(rng.choice(list("ACGT"), 200))
    got = nthash.u64(nthash.canonical_keys(_codes(seq), k)).tolist()
    assert got == _rolling(seq, k)
    # a sequence and its reverse complement have the same canonical k-mers
    rc = seq[::-1].translate(str.maketrans("ACGT", "TGCA"))
    assert sorted(got) == sorted(nthash.u64(nthash.canonical_keys(_codes(rc), k)).tolist())


def test_invalid_bases_end_windows_and_sketch_is_bottom_s():
    keys = nthash.canonical_keys(_codes("ACGTNACGTA"), 3)
    assert (keys == nthash.INF_KEY).tolist() == [False, False, True, True, True,
                                                 False, False, False]
    sk = nthash.bottom_s(torch.tensor([5, 3, nthash.INF_KEY, 3, 9, 1]), 3)
    assert sk.tolist() == [1, 3, 5]


def test_cut_to_32_bits():
    v = torch.tensor([(0x1234567890ABCDEF ^ (1 << 63)) - (1 << 64), nthash.INF_KEY])
    got = nthash.u64(nthash.to_codes32(v)).tolist()
    assert got == [0x1234567800000000, MASK]


def _table(rows, s):
    return nthash.sketch_table([torch.tensor(r) for r in rows], s)


def test_pair_counts_by_hand():
    # A = {1, 2, 3}, B = {2, 3, 4}, s = 3: X = {1, 2, 3}, shared {2, 3}
    t = _table([[1, 2, 3], [2, 3, 4], [10, 11], [1, 2, 3]], 3)
    sh, un, it = compare.pair_counts(t, [0, 0, 0, 2], [1, 2, 3, 2], 3)
    assert sh.tolist() == [2, 0, 3, 2]
    assert un.tolist() == [3, 3, 3, 2]
    assert it.tolist() == [2, 0, 3, 2]
    # s = 2: X = {1, 2}, shared {2}; the intersection keeps both
    sh, un, it = compare.pair_counts(_table([[1, 2], [2, 3]], 2), [0], [1], 2)
    assert (sh.tolist(), un.tolist(), it.tolist()) == ([1], [2], [1])
