"""Port parity of the device-resident index: SketchIndex.device_planes,
the index build's retention under MIEKKI_KEEP_DEV (engine._keep_device_planes)
and engine.dist_tiles' blocks sliced from the planes.  With and without
planes every output is bitwise equal to the other and to the JAX
package's (`device="cpu"`: the planes are CPU tensors and the kernels'
plain versions count).  Tolerance: none."""

import io

import numpy as np
import pytest
import torch

from miekki_tpu import engine as J
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu.utils import hbm as JH
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.index.store import index_to_device
from miekki_tpu_torch.ops import u64
from miekki_tpu_torch.params import SketchParams

from fixtures import make_genome_family, write_fasta

K, S = 21, 300


def _pair(idx: TIndex) -> JIndex:
    """The same host table as a JAX-package SketchIndex."""
    return JIndex(JParams.from_dict(idx.params.to_dict()), idx.names, idx.hi, idx.lo)


def _host_only(idx: TIndex) -> TIndex:
    return TIndex(idx.params, idx.names, idx.hi, idx.lo)


def _with_planes(idx: TIndex) -> TIndex:
    out = _host_only(idx)
    out.device_planes = index_to_device(idx, "cpu").clone()
    return out


def _codes(seed=1):
    """13 genomes of 9,000 random bases, one of 5 (shorter than k)."""
    rng = np.random.default_rng(seed)
    codes = [rng.integers(0, 4, 9000).astype(np.uint8) for _ in range(13)]
    codes.append(rng.integers(0, 4, 5).astype(np.uint8))
    return codes


def _assert_counts_equal(a: dict, b: dict):
    for key in ("shared", "union", "inter"):
        assert np.array_equal(a[key], b[key]), key


@pytest.fixture(scope="module")
def built():
    """The index built from _codes() with MIEKKI_KEEP_DEV=1 (batches of
    4, chunk 2048, so several batches and a genome shorter than k), and
    the JAX package's of the same codes under the same setting."""
    names = [f"g{i}" for i in range(14)]
    mp = pytest.MonkeyPatch()
    mp.setenv("MIEKKI_KEEP_DEV", "1")
    try:
        t = T._build_index_from_codes(_codes(), names, SketchParams(k=K, s=S), chunk=2048,
                                      batch=4, device="cpu")
        j = J._build_index_from_codes(_codes(), names, JParams(k=K, s=S), chunk=2048, batch=4)
    finally:
        mp.undo()
    return t, j


@pytest.fixture(scope="module")
def genome_paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("planes")
    rng = np.random.default_rng(61)
    seqs = make_genome_family(rng, 9, 3_000, sub_rate=0.05)
    return [str(write_fasta(tmp / f"g{i}.fa", [(f"g{i}", g)])) for i, g in enumerate(seqs)]


def test_builder_planes_equal_host_table_and_reference(built):
    t, j = built
    assert t.device_planes is not None and t.device_planes.dtype == torch.int64
    assert np.array_equal(t.hi, j.hi) and np.array_equal(t.lo, j.lo)
    assert torch.equal(t.device_planes, index_to_device(t, "cpu"))
    ref = u64.keys_from_planes(np.asarray(j.device_planes[0]), np.asarray(j.device_planes[1]))
    assert np.array_equal(t.device_planes.numpy(), ref)
    assert torch.equal(t.device_planes[13], u64.inf_like((S,)))  # shorter than k


def test_counts_through_builder_planes_equal_host_and_reference(built):
    t, j = built
    before = t.device_planes.clone()
    got = T.dist_counts_matrix(t, tile=4, device="cpu")
    assert torch.equal(t.device_planes, before)  # nothing writes into a block
    _assert_counts_equal(got, T.dist_counts_matrix(_host_only(t), tile=4, device="cpu"))
    _assert_counts_equal(got, J.dist_counts_matrix(_pair(t), tile=4))


def test_compact_planes_counts():
    """Counterpart of tests/test_compact.py::test_compact_device_planes_dist:
    a compact index with int32 code-key planes."""
    rng = np.random.default_rng(21)
    n, s = 12, 96
    pool = np.unique(rng.integers(0, 2**60, size=4 * s, dtype=np.uint64))
    sk = np.stack([np.sort(rng.choice(pool, size=s, replace=False)) for _ in range(n)])
    idx = TIndex.from_sketches(list(sk), [f"g{i}" for i in range(n)],
                               SketchParams(k=31, s=s)).to_compact()
    ref = T.dist_counts_matrix(idx, tile=5, device="cpu")
    with_planes = _with_planes(idx)
    assert with_planes.device_planes.dtype == torch.int32
    _assert_counts_equal(T.dist_counts_matrix(with_planes, tile=5, device="cpu"), ref)
    _assert_counts_equal(J.dist_counts_matrix(_pair(idx), tile=5), ref)


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_keep_dev_env(monkeypatch, env):
    """The builder keeps planes iff MIEKKI_KEEP_DEV says so (never on the
    CPU when unset), and _keep_device_planes decides as the reference's
    for the same sizes on the CPU."""
    if env is None:
        monkeypatch.delenv("MIEKKI_KEEP_DEV", raising=False)
    else:
        monkeypatch.setenv("MIEKKI_KEEP_DEV", env)
    idx = T._build_index_from_codes(_codes()[:5], [f"g{i}" for i in range(5)],
                                    SketchParams(k=K, s=64), chunk=2048, batch=4, device="cpu")
    assert (idx.device_planes is not None) == (env == "1")
    for n, s in ((1, 1), (14, 300), (102_400, 10_000), (10**7, 10**4)):
        assert T._keep_device_planes(n, s, "cpu") == J._keep_device_planes(n, s)


@pytest.mark.parametrize("n,s", [(10, 10), (12, 10), (13, 10), (100, 1000)])
def test_keep_dev_budget_on_a_card(monkeypatch, n, s):
    """Unset, a card keeps the planes while n * s * 8 bytes fit the planes
    budget: the reference's keep_planes_ok under the same MIEKKI_HBM_LIMIT
    (1,000 x 4 bytes of limit: 1,000 bytes of planes)."""
    monkeypatch.delenv("MIEKKI_KEEP_DEV", raising=False)
    monkeypatch.setenv("MIEKKI_HBM_LIMIT", "4000")
    want = JH.keep_planes_ok(n * s * 8)
    assert T._keep_device_planes(n, s, torch.device("cuda")) == want
    assert want == (n * s * 8 <= 1000)


def test_unbatched_and_counted_builds_keep_nothing(monkeypatch):
    monkeypatch.setenv("MIEKKI_KEEP_DEV", "1")
    codes, names = _codes()[:3], ["a", "b", "c"]
    for kw in ({"batch": 1}, {"batch": 4, "min_copies": 2}):
        idx = T._build_index_from_codes(codes, names, SketchParams(k=K, s=64), chunk=2048,
                                        device="cpu", **kw)
        assert idx.device_planes is None, kw


@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_dist_tsv_with_and_without_planes_equal_reference(genome_paths, monkeypatch, compact):
    monkeypatch.setenv("MIEKKI_KEEP_DEV", "1")
    idx = T.build_index(genome_paths, SketchParams(k=K, s=S), device="cpu")
    assert idx.device_planes is not None
    if compact:
        idx = _with_planes(idx.to_compact())
    texts = []
    for t in (idx, _host_only(idx)):
        out = io.StringIO()
        T.dist_tsv_write(out, t, tile=4, device="cpu")
        texts.append(out.getvalue())
    want = io.StringIO()
    J.dist_tsv_write(want, _pair(idx), tile=4)
    assert texts[0] == texts[1] == want.getvalue()


@pytest.mark.parametrize("side", ["a", "b", "both"])
def test_rect_with_planes_on_one_side(built, side):
    """A-vs-B compares where one side (or both) has planes, and the other
    side's table is uploaded: the tile of 4 leaves edge blocks of 1 and 2
    rows."""
    t, _ = built
    a, b = (TIndex(t.params, t.names[:5], t.hi[:5], t.lo[:5]),
            TIndex(t.params, t.names[5:], t.hi[5:], t.lo[5:]))
    if side in ("a", "both"):
        a = _with_planes(a)
    if side in ("b", "both"):
        b = _with_planes(b)
    got = T.dist_counts_matrix(a, b, tile=4, device="cpu")
    _assert_counts_equal(got, T.dist_counts_matrix(_host_only(a), _host_only(b), tile=4,
                                                   device="cpu"))
    _assert_counts_equal(got, J.dist_counts_matrix(_pair(a), _pair(b), tile=4))


def test_edge_tile_rectangles_equal_host_path(built):
    """raw dist_tiles through planes: every tile is a full [tile, tile]
    rectangle, the edge block INF-padded on the device, equal to the host
    path's (14 genomes, tile 4: the last block holds 2)."""
    t, _ = built
    planes = list(T.dist_tiles(t, tile=4, device="cpu", raw=True))
    host = list(T.dist_tiles(_host_only(t), tile=4, device="cpu", raw=True))
    assert [x[:2] for x in planes] == [x[:2] for x in host] and len(planes) == 10
    for p, h in zip(planes, host):
        for a, b in zip(p[4:], h[4:]):
            assert a.shape == (4, 4) and np.array_equal(a, b)


def test_planes_on_another_device_are_not_used(built, monkeypatch):
    """A side whose planes live elsewhere than the requested device takes
    the host path."""
    t, _ = built
    meta = _host_only(t)
    meta.device_planes = torch.empty((len(t), S), dtype=torch.int64, device="meta")
    assert T._planes_on(meta, torch.device("cpu")) is None
    _assert_counts_equal(T.dist_counts_matrix(meta, tile=4, device="cpu"),
                         T.dist_counts_matrix(t, tile=4, device="cpu"))


@pytest.mark.parametrize("output", ["dist", "matrix", "triangle", "resumable"])
def test_dist_outputs_through_planes(built, tmp_path, output):
    """Everything built on dist_tiles gives the same bytes with planes."""
    t, _ = built

    def make(idx, tag):
        if output == "dist":
            return T.rows_to_tsv(T.dist(idx, tile=4, device="cpu"))
        if output == "matrix":
            return T.dist_matrix_text(idx, tile=4, device="cpu")
        if output == "triangle":
            return T.dist_triangle_text(idx, tile=4, device="cpu")
        out, man = tmp_path / f"{tag}.tsv", tmp_path / f"{tag}.manifest"
        T.dist_resumable(idx, out, man, tile=4, device="cpu")
        return out.read_text()

    assert make(t, "planes") == make(_host_only(t), "host")


def test_load_to_compact_and_slices_drop_planes(built, tmp_path):
    t, _ = built
    path = tmp_path / "db.npz"
    t.save(path)
    assert TIndex.load(path).device_planes is None
    assert t.to_compact().device_planes is None
    assert TIndex.load_sharded(t.save_sharded(str(tmp_path / "db"), 2)).device_planes is None
    assert TIndex(t.params, t.names[:3], t.hi[:3], t.lo[:3]).device_planes is None


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided", "numpy"])
def test_setter_refuses_what_does_not_fit(built, bad):
    t, _ = built
    idx = _host_only(t)
    good = index_to_device(idx, "cpu")
    planes = {"shape": good[:-1], "dtype": good.to(torch.int32),
              "strided": torch.cat([good, good], 1)[:, ::2], "numpy": good.numpy()}[bad]
    with pytest.raises(ValueError, match="device planes"):
        idx.device_planes = planes
    assert idx.device_planes is None
    idx.device_planes = good
    idx.device_planes = None
    assert idx.device_planes is None
    compact = t.to_compact()
    with pytest.raises(ValueError, match="int32"):
        compact.device_planes = good  # a compact index takes int32 code keys
