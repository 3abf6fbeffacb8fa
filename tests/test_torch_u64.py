"""Port parity: the order-key layer (miekki_tpu_torch.ops.u64) against the
JAX package's (hi, lo) u64 layer and the numpy oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miekki_tpu.ops import u64 as ju64
from miekki_tpu.oracle import nthash as O
from miekki_tpu_torch.ops import u64 as tu64

EDGES = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1,
                  2**64 - 2, 2**64 - 1], dtype=np.uint64)


def _values(seed, n=2000):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2**64 - 1, size=n,
                                               dtype=np.uint64)])


def test_keys_round_trip_and_order():
    v = _values(0)
    keys = tu64.keys_from_u64(v)
    assert keys.dtype == np.int64
    assert np.array_equal(tu64.u64_from_keys(keys), v)
    assert np.array_equal(tu64.u64_from_keys(torch.from_numpy(keys)), v)
    # signed order of keys == unsigned order of values
    assert np.array_equal(np.argsort(keys, kind="stable"),
                          np.argsort(v, kind="stable"))
    sorted_keys = torch.sort(torch.from_numpy(keys)).values.numpy()
    assert np.array_equal(tu64.u64_from_keys(sorted_keys), np.sort(v))
    assert tu64.keys_from_u64(O.UINT64_MAX) == tu64.INF_KEY


def test_planes_round_trip_matches_reference_split():
    v = _values(1)
    hi, lo = tu64.planes_from_keys(tu64.keys_from_u64(v))
    jhi, jlo = ju64.split(v)
    assert hi.dtype == np.uint32 and lo.dtype == np.uint32
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)
    assert np.array_equal(tu64.keys_from_planes(jhi, jlo), tu64.keys_from_u64(v))
    assert np.array_equal(tu64.join(*tu64.split(v)), ju64.join(jhi, jlo))


@pytest.mark.parametrize("r", [0, 1, 5, 31, 32, 33, 63, 64, 65, 127, -1, -33])
def test_rotations_match_reference_and_oracle(r):
    v = _values(2 + r % 64)
    raw = torch.from_numpy(v.view(np.int64))
    got_l = tu64.rol(raw, r).numpy().view(np.uint64)
    got_r = tu64.ror(raw, r).numpy().view(np.uint64)
    assert np.array_equal(got_l, O.rol64(v, r))
    assert np.array_equal(got_r, O.ror64(v, r))
    pair = tuple(jnp.asarray(x) for x in ju64.split(v))
    assert np.array_equal(got_l, ju64.join(*(np.asarray(x) for x in ju64.rol(pair, r))))
    assert np.array_equal(got_r, ju64.join(*(np.asarray(x) for x in ju64.ror(pair, r))))


def test_tensor_rotation_amounts_match_oracle():
    v = _values(3)
    rng = np.random.default_rng(3)
    r = rng.integers(-200, 200, size=v.shape)
    raw = torch.from_numpy(v.view(np.int64))
    rt = torch.from_numpy(r)
    assert np.array_equal(tu64.rol(raw, rt).numpy().view(np.uint64), O.rol64(v, r))
    assert np.array_equal(tu64.ror(raw, rt).numpy().view(np.uint64), O.ror64(v, r))


def test_less_equal_minimum_match_reference():
    a, b = _values(4), _values(5)
    ra = torch.from_numpy(a.view(np.int64))
    rb = torch.from_numpy(b.view(np.int64))
    pa = tuple(jnp.asarray(x) for x in ju64.split(a))
    pb = tuple(jnp.asarray(x) for x in ju64.split(b))
    assert np.array_equal(tu64.less(ra, rb).numpy(), np.asarray(ju64.less(pa, pb)))
    assert np.array_equal(tu64.equal(ra, ra).numpy(), np.asarray(ju64.equal(pa, pa)))
    got_min = tu64.minimum(ra, rb).numpy().view(np.uint64)
    assert np.array_equal(got_min, np.minimum(a, b))
    assert np.array_equal(
        tu64.is_inf(torch.from_numpy(tu64.keys_from_u64(a))).numpy(),
        np.asarray(ju64.is_inf(pa)))
    assert torch.equal(tu64.to_keys(ra), torch.from_numpy(tu64.keys_from_u64(a)))
