"""Port parity: canonical k-mer hashing (miekki_tpu_torch.ops.hash and the
K1 wrapper ops.cuda_hash) against the JAX package's XLA and Pallas hash
and the numpy oracle.  Tolerance: none — every output is a 64-bit integer
and must be bitwise equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miekki_tpu.ops import hash as JH
from miekki_tpu.ops import pallas_hash as JPH
from miekki_tpu.oracle import nthash as O
from miekki_tpu_torch.ops import cuda_hash as TCH
from miekki_tpu_torch.ops import hash as TH
from miekki_tpu_torch.ops import u64 as tu64


def _jax_keys(planes):
    return tu64.keys_from_planes(np.asarray(planes[0]), np.asarray(planes[1]))


# shapes of tests/test_pallas_kernels.py:20-75 (rows, window starts, code range)
@pytest.mark.parametrize("k,rows,width,hi", [
    (31, 16, 512, 5),   # invalid codes (4) mixed in
    (21, 5, 256, 4),    # row count not a multiple of the kernel's row block
    (15, 8, 256, 5),
    (33, 8, 256, 5),
    (63, 8, 256, 5),
])
def test_plain_hash_matches_jax_and_pallas(k, rows, width, hi):
    rng = np.random.default_rng(k * 10 + rows)
    codes = rng.integers(0, hi, size=(rows, width + k - 1), dtype=np.int64)
    got = TH.hash_windows(torch.from_numpy(codes), k).numpy()
    (h0, l0), v0 = JH.hash_windows(jnp.asarray(codes, jnp.int32), k)
    assert np.array_equal(got, _jax_keys((h0, l0)))
    assert np.array_equal(got != tu64.INF_KEY, np.asarray(v0))
    ph, _ = JPH.hash_windows_pallas(jnp.asarray(codes, jnp.int32), k, interpret=True)
    assert np.array_equal(got, _jax_keys(ph))


@pytest.mark.parametrize("k", [15, 21, 31, 33, 63])
def test_plain_hash_matches_oracle_with_padding(k):
    """uint8 rows laid out like chunk_codes: INVALID padding at the tail."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(3, 300 + k - 1)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    codes[-1, 120:] = 4  # padded tail
    got = TH.hash_windows(torch.from_numpy(codes), k).numpy()
    for r in range(codes.shape[0]):
        oh, ov = O.hash_kmers(codes[r], k)
        want = tu64.keys_from_u64(np.where(ov, oh, O.UINT64_MAX))
        assert np.array_equal(got[r], want), r


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(rng.integers(0, 5, size=(4, 200)).astype(np.uint8))
    before = TCH.hash_windows_cuda.launches
    got = TCH.hash_windows_cuda(codes, 21)
    assert TCH.hash_windows_cuda.launches == before
    assert torch.equal(got, TH.hash_windows(codes, 21))


def test_wrapper_checks_its_inputs():
    with pytest.raises(ValueError):
        TCH.hash_windows_cuda(torch.zeros((2, 40), dtype=torch.int32), 21)
    with pytest.raises(ValueError):
        TCH.hash_windows_cuda(torch.zeros((40,), dtype=torch.uint8), 21)
    with pytest.raises(ValueError):
        TCH.hash_windows_cuda(torch.zeros((2, 10), dtype=torch.uint8), 21)
    with pytest.raises(ValueError):
        TCH.hash_windows_cuda(torch.zeros((2, 100), dtype=torch.uint8), 65)


def test_short_sequence_raises():
    with pytest.raises(ValueError):
        TH.hash_windows(torch.zeros((1, 5), dtype=torch.uint8), 21)



# ---- A CPU model of kernel K1's decomposition (csrc/hash_windows.cu):
# persistent blocks walking (row, span) work items, each warp staging its
# 1,024 windows' codes from the 16-byte boundary below the first code,
# lanes reading runs of 32 windows as aligned words shifted by the offset,
# seeding from the table of rotated seeds, rolling with the (outgoing,
# incoming) pair table, and each warp storing its keys 16 bytes at a time
# with a lone first key where the row's keys start 8 bytes off a 16-byte
# boundary.  Change it together with the kernel.

RUN, WARPS = 32, 4
WARP_SPAN = 32 * RUN
SPAN = WARPS * WARP_SPAN
STAGE = 1120  # bytes of a warp's code buffer
_SIGN = np.uint64(1 << 63)
_INF_KEY = np.uint64(tu64.INF_KEY)
_M32 = np.uint64(0xFFFFFFFF)


def _tables(k):
    """seed_tab [64 * 4, 2] ((F, R) part of code c at offset i of a window)
    and roll_tab [16, 2] ((co, ci) pair) as the kernel builds them."""
    sf, sr = O.SEEDS, O.SEEDS[::-1]
    i, c = np.divmod(np.arange(4 * k), 4)
    seed_tab = np.stack([O.rol64(sf[c], k - 1 - i), O.rol64(sr[c], i)], 1)
    co, ci = np.divmod(np.arange(16), 4)
    roll_tab = np.stack([O.rol64(sf[co], k) ^ sf[ci],
                         O.rol64(sr[co], 63) ^ O.rol64(sr[ci], k - 1)], 1)
    return seed_tab, roll_tab


def _load_codes(words, wi, sh, q_count):
    """load_codes: words [q, q + q_count] of each lane from word index wi,
    funnel-shifted down by sh bits → uint64 [32, q_count] (low 32 bits)."""
    raw = words[wi[:, None] + np.arange(q_count + 1)].astype(np.uint64)
    return ((raw[:, :-1] | (raw[:, 1:] << np.uint64(32))) >> sh[:, None]) & _M32


def _byte(c, pos):
    return (c[:, pos >> 2] >> np.uint64(8 * (pos & 3))) & np.uint64(0xFF)


def _hash_warp(buf, off, k, seed_tab, roll_tab):
    """hash_run of the warp's 32 lanes on a staged buffer → u64 keys
    [32 lanes, 32 windows] (sign-flipped, INF_KEY where invalid)."""
    words = buf.view("<u4")
    b = off + RUN * np.arange(32)
    sh = (8 * (b & 3)).astype(np.uint64)
    o = _load_codes(words, b >> 2, sh, 16)  # codes 0..63
    f = np.zeros(32, np.uint64)
    r = np.zeros(32, np.uint64)
    bad = np.full(32, -1)
    for pos in range(k):
        code = _byte(o, pos)
        bad = np.where(code > 3, pos, bad)
        e = seed_tab[pos * 4 + (code & np.uint64(3)).astype(np.int64)]
        f ^= e[:, 0]
        r ^= e[:, 1]
    keys = np.empty((32, RUN), np.uint64)
    keys[:, 0] = np.where(bad < 0, np.minimum(f, r) ^ _SIGN, _INF_KEY)
    bi = b + k
    inc = _load_codes(words, bi >> 2, (8 * (bi & 3)).astype(np.uint64), 8)
    pair = ((o[:, :8] & np.uint64(0x03030303)) << np.uint64(6)) | (
        (inc & np.uint64(0x03030303)) << np.uint64(4))
    inv = inc & np.uint64(0xFCFCFCFC)
    for j in range(1, RUN):
        bad = np.where(_byte(inv, j - 1) != 0, j - 1 + k, bad)
        s = roll_tab[(_byte(pair, j - 1) // np.uint64(16)).astype(np.int64)]
        f = O.rol64(f, 1) ^ s[:, 0]
        r = O.rol64(r, 63) ^ s[:, 1]
        keys[:, j] = np.where(bad < j, np.minimum(f, r) ^ _SIGN, _INF_KEY)
    return keys


def _model_k1(codes, k, grid, storage_offset, rng):
    """The kernel on codes [R, W] held at byte `storage_offset` of a
    16-byte aligned allocation → int64 keys [R, n]; checks that every key is
    written once, every pair store is 16-byte aligned and every staged
    chunk holds a code of the work item."""
    rows, w = codes.shape
    n = w - k + 1
    spans = -(-n // SPAN)
    items = rows * spans
    mem = np.zeros(-(-(storage_offset + rows * w) // 16) * 16, np.uint8)
    mem[storage_offset:storage_offset + rows * w] = codes.reshape(-1)
    out = np.zeros(rows * n, np.uint64)
    writes = np.zeros(rows * n, np.int64)
    seed_tab, roll_tab = _tables(k)
    for block in range(min(grid, items)):
        for item in range(block, items, grid):
            row, span = divmod(item, spans)
            for warp in range(WARPS):
                lo = span * SPAN + warp * WARP_SPAN
                cnt = min(WARP_SPAN, n - lo)
                if cnt <= 0:
                    continue
                src = storage_offset + row * w + lo
                off = src % 16
                chunks = (off + cnt + k - 1 + 15) // 16
                assert src - off + 16 * (chunks - 1) <= src + cnt + k - 2  # last code
                buf = rng.integers(0, 256, size=STAGE, dtype=np.uint8)  # stale bytes
                buf[:16 * chunks] = mem[src - off:src - off + 16 * chunks]
                keys = _hash_warp(buf, off, k, seed_tab, roll_tab).reshape(-1)
                e0 = row * n + lo  # out is 16-byte aligned: element e at byte 8 e
                first = e0 & 1
                if first:
                    out[e0] = keys[0]
                    writes[e0] += 1
                for x in range(first, cnt, 2):
                    width = 2 if x + 1 < cnt else 1
                    assert width == 1 or (8 * (e0 + x)) % 16 == 0
                    out[e0 + x:e0 + x + width] = keys[x:x + width]
                    writes[e0 + x:e0 + x + width] += 1
    assert (writes == 1).all()
    return out.view(np.int64).reshape(rows, n)


# (rows, n, grid, storage offset): odd n (rows start 8 bytes off 16-byte
# alignment), n below one warp's 1,024 windows, n not a multiple of the
# span, an exact span, more work items than blocks, a misaligned base
K1_MODEL_CASES = {
    "odd_n": (3, 2 * SPAN + 777, 2, 0),
    "even_n_offset": (3, SPAN + 2 * WARP_SPAN + 10, 4, 5),
    "short_rows": (4, 700, 3, 13),
    "exact_span": (2, SPAN, 1, 1),
}


@pytest.mark.parametrize("case", sorted(K1_MODEL_CASES))
@pytest.mark.parametrize("k", [1, 2, 21, 31, 33, 63, 64])
def test_k1_decomposition_matches_plain(k, case):
    rows, n, grid, storage_offset = K1_MODEL_CASES[case]
    rng = np.random.default_rng(k * 7 + len(case))
    w = n + k - 1
    codes = rng.integers(0, 4, size=(rows, w)).astype(np.uint8)
    flip = rng.random(codes.shape) < 0.01
    codes[flip] = rng.choice(np.array([4, 5, 255], np.uint8), size=int(flip.sum()))
    # invalid codes at run, warp and span boundaries, as 4, 5 and 255
    edges = [p for p in (RUN - 1, RUN, WARP_SPAN - 1, WARP_SPAN, SPAN - 1, SPAN, w - 1) if p < w]
    for i, p in enumerate(edges):
        codes[i % rows, p] = (4, 5, 255)[i % 3]
    codes[-1] = 255 if rows > 2 else codes[-1]  # an all-invalid row
    got = _model_k1(codes, k, grid, storage_offset, rng)
    want = TH.hash_windows(torch.from_numpy(codes), k).numpy()
    assert np.array_equal(got, want)
