"""Port parity of the dist paths under MIEKKI_INTERSECT=mxu (the stream
pass): `cli dist` (TSV, --counts, --manifest interrupted and resumed,
--matrix, triangle), engine.dist_counts_matrix with its deferred resolve
and dist_tiles' block cache, raw and compact, against miekki_tpu's CLI and
engine under the same variable on the CPU: texts byte for byte, npz files
member for member, matrices bitwise.  Inputs: 13 family sketches at s = 64
(heavy sharing, some short), so tiles hold ambiguous pairs; tiles of 4."""

import json

import numpy as np
import pytest

from miekki_tpu import cli as jcli
from miekki_tpu import engine as J
from miekki_tpu.index.store import SketchIndex as JIndex
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu_torch import cli as tcli
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.index.store import SketchIndex as TIndex
from miekki_tpu_torch.ops import intersect as TI
from miekki_tpu_torch.ops import mxu_intersect as TM
from miekki_tpu_torch.params import SketchParams

S, N, TILE = 64, 13, 4


@pytest.fixture(scope="module")
def family():
    rng = np.random.default_rng(41)
    pool = np.unique(rng.integers(1, 2 ** 63, size=8 * S, dtype=np.uint64))[:3 * S]
    sketches = []
    for i in range(N):
        sk = np.unique(pool[rng.choice(3 * S, size=S + 16, replace=False)])[:S]
        sketches.append(sk[:S // 3] if i % 5 == 4 else sk)
    return TIndex.from_sketches(sketches, [f"g{i}" for i in range(N)], SketchParams(k=21, s=S))


@pytest.fixture(scope="module")
def dbs(family, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mxu_dist")
    out = {}
    for tag, idx in (("raw", family), ("compact", family.to_compact())):
        out[tag] = str(tmp / f"{tag}.npz")
        idx.save(out[tag])
    return out


@pytest.fixture
def mxu(monkeypatch):
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    TM.reset_counts()
    return TM.PASS_COUNTS


def _j(idx: TIndex) -> JIndex:
    return JIndex(JParams.from_dict(idx.params.to_dict()), idx.names, idx.hi, idx.lo)


def _members(path) -> dict:
    with np.load(path) as z:
        return {m: z[m] for m in z.files}


@pytest.mark.parametrize("tag", ["raw", "compact"])
def test_cli_outputs_equal_reference(dbs, tag, tmp_path, mxu):
    """TSV (with containment columns), --counts, --matrix and triangle:
    the reference CLI's bytes under the same variable, and the stream pass
    really ran and resolved ambiguous pairs."""
    db = dbs[tag]
    for name, argv in (("tsv", ["dist", db, "--containment", "-o"]),
                       ("matrix", ["dist", db, "--matrix", "-o"]),
                       ("triangle", ["triangle", db, "-o"])):
        jout, tout = tmp_path / f"j.{name}", tmp_path / f"t.{name}"
        assert jcli.main([*argv, str(jout), "--tile", str(TILE)]) == 0
        assert tcli.main([*argv, str(tout), "--tile", str(TILE), "--device", "cpu"]) == 0
        assert tout.read_bytes() == jout.read_bytes(), name
    jc, tc = tmp_path / "j_counts.npz", tmp_path / "t_counts.npz"
    assert jcli.main(["dist", db, "--counts", str(jc), "--tile", str(TILE)]) == 0
    assert tcli.main(["dist", db, "--counts", str(tc), "--tile", str(TILE),
                      "--device", "cpu"]) == 0
    want, got = _members(jc), _members(tc)
    assert sorted(got) == sorted(want)
    for m in want:
        assert got[m].dtype == want[m].dtype and np.array_equal(got[m], want[m]), m
    assert mxu["full"] > 0 and mxu["resolved"] > 0 and mxu["band"] == 0


@pytest.mark.parametrize("tag", ["raw", "compact"])
def test_cli_manifest_interrupted_then_resumed_equals_reference(dbs, tag, tmp_path, mxu,
                                                                monkeypatch):
    """Both CLIs die after their first tile and resume: the same file and
    manifest bytes, each tile once."""
    outs = {}
    for name, mod, eng, extra in (("j", jcli, J, []), ("t", tcli, T, ["--device", "cpu"])):
        out, mani = tmp_path / f"{name}.tsv", tmp_path / f"{name}.manifest"
        argv = ["dist", dbs[tag], "-o", str(out), "--manifest", str(mani),
                "--tile", str(TILE), *extra]
        real = eng.dist_tiles

        def one_tile(*a, _real=real, **kw):
            gen = _real(*a, **kw)
            yield next(gen)
            raise KeyboardInterrupt

        monkeypatch.setattr(eng, "dist_tiles", one_tile)
        with pytest.raises(KeyboardInterrupt):
            mod.main(argv)
        monkeypatch.setattr(eng, "dist_tiles", real)
        assert len(mani.read_text().splitlines()) == 1
        assert mod.main(argv) == 0
        outs[name] = (out.read_bytes(), mani.read_bytes())
    assert outs["t"] == outs["j"]
    tiles = [tuple(json.loads(ln).values()) for ln in outs["t"][1].decode().splitlines()]
    assert len(tiles) == len(set(tiles)) == 10  # 4 blocks of 4: 10 upper tiles


@pytest.mark.parametrize("kind", ["self", "rect", "compact", "compact_rect"])
@pytest.mark.parametrize("tile", [3, 4, 16])
def test_dist_counts_matrix_deferred_equals_reference(family, kind, tile, mxu):
    """Slim pulls, union from the sizes and one resolve at the end:
    bitwise equal to the reference's deferred route and to K3/K4's plain
    version (MIEKKI_INTERSECT unset)."""
    t = family.to_compact() if kind.startswith("compact") else family
    args = (t, None) if not kind.endswith("rect") else (
        TIndex(t.params, t.names[:5], t.hi[:5], t.lo[:5]), t)
    got = T.dist_counts_matrix(*args, tile=tile, device="cpu")
    want = J.dist_counts_matrix(*(None if a is None else _j(a) for a in args), tile=tile)
    for c in ("shared", "union", "inter"):
        assert got[c].dtype == np.int32 and np.array_equal(got[c], want[c]), c
    assert mxu["resolved"] > 0
    passes = mxu["full"]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MIEKKI_INTERSECT")
        plain = T.dist_counts_matrix(*args, tile=tile, device="cpu")
    assert mxu["full"] == passes  # unset: no stream pass
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], plain[c]), c


def test_dist_tiles_deferred_list_and_slim_pull(family, mxu):
    """_amb_out collects every in-bounds ambiguous pair of raw tiles, whose
    `shared` holds the lower bracket and whose union is None (slim); the
    non-raw form resolves each tile as it is pulled."""
    amb: list = []
    tiles = list(T.dist_tiles(family, tile=TILE, device="cpu", raw=True, _amb_out=amb))
    assert all(t[5] is None for t in tiles)
    ai = np.concatenate([a for a, _ in amb])
    aj = np.concatenate([b for _, b in amb])
    assert ai.size and (ai < N).all() and (aj < N).all()
    exact = TI.tile_counts_plain(TI._pad_lane(T.index_to_device(family, "cpu")),
                                 TI._pad_lane(T.index_to_device(family, "cpu")), S)
    lb = np.zeros((N, N), np.int32)
    for bi, bj, _, _, sh, _, _ in tiles:
        r1, c1 = min((bi + 1) * TILE, N), min((bj + 1) * TILE, N)
        lb[bi * TILE:r1, bj * TILE:c1] = sh[:r1 - bi * TILE, :c1 - bj * TILE]
    shared = exact["shared_in_x"].numpy()
    assert (lb[ai, aj] <= shared[ai, aj]).all() and (lb[ai, aj] != shared[ai, aj]).any()
    rows = T.dist(family, tile=TILE, device="cpu")
    assert all(r["shared"] == shared[r["i"], r["j"]] for r in rows)
    jrows = J.dist(_j(family), tile=TILE)
    assert rows == jrows


@pytest.mark.parametrize("tag", ["raw", "compact"])
def test_block_cache_keeps_streams_within_its_budget(family, tag, mxu, monkeypatch):
    """Under mxu a block's bytes count its two streams (12 B a value each,
    8 B compact) beside its keys; a cap of 2 blocks evicts streams with
    their blocks and the sweep still equals the reference's."""
    idx = family if tag == "raw" else family.to_compact()
    lane = TI.lane_width(S)
    per_value = (8 + 24) if tag == "raw" else (4 + 16)
    monkeypatch.setenv("MIEKKI_COL_CACHE_MB", "1")
    blocks = T._KeyBlocks(idx, None, TILE, T._device.resolve("cpu"), (), mxu=True)
    assert blocks.cap == max(2, (1 << 20) // (TILE * lane * per_value))
    blk, row_stream = blocks.stream(("a", 0), col=False)
    _, col_stream = blocks.stream(("a", 0), col=True)
    assert row_stream[0] is col_stream[0]  # the column role shares the sorted values
    assert (col_stream[1] == (row_stream[1] | TM.COL_TAG)).all()
    monkeypatch.setenv("MIEKKI_COL_CACHE_MB", "0")
    T.reset_block_counts()
    got = T.dist_counts_matrix(idx, tile=TILE, device="cpu")
    assert T.BLOCK_COUNTS["cap"] == 2 and T.BLOCK_COUNTS["evictions"] > 0
    want = J.dist_counts_matrix(_j(idx), tile=TILE)
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], want[c]), c
