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

