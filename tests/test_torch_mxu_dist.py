"""Port parity of the dist paths under MIEKKI_INTERSECT=mxu, which the port
runs on K3/K4 (their plain versions here) as under auto, while the
reference runs its stream pass: `cli dist` (TSV, --counts, --manifest
interrupted and resumed, --matrix, triangle), engine.dist_counts_matrix and
dist_tiles' block cache, raw and compact, against miekki_tpu's CLI and
engine under the same variable on the CPU: texts byte for byte, npz files
member for member, matrices bitwise.  The tile functions are counted: the
variable calls them once a tile, as auto does.  Inputs: 13 family sketches
at s = 64 (heavy sharing, some short), so the reference's tiles hold
ambiguous pairs; tiles of 4."""

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
from miekki_tpu_torch.parallel import dist_sharded_hostring
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


def _count_tiles(monkeypatch) -> list:
    """Wrap the tile functions (K3 and K4's entry points) with a counter;
    returns the list each call appends to."""
    calls = []
    for name in ("tile_counts", "tile_counts_compact"):
        real = getattr(TI, name)
        monkeypatch.setattr(TI, name, lambda *a, real=real, **kw: calls.append(1) or
                            real(*a, **kw))
    return calls


@pytest.fixture
def mxu(monkeypatch):
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    return _count_tiles(monkeypatch)


def _n_tiles(n_a, n_b, tile, self_compare):
    t = min(tile, max(n_a, n_b, 1))
    nb_a, nb_b = -(-n_a // t), -(-n_b // t)
    return nb_a * (nb_a + 1) // 2 if self_compare else nb_a * nb_b


def _j(idx: TIndex) -> JIndex:
    return JIndex(JParams.from_dict(idx.params.to_dict()), idx.names, idx.hi, idx.lo)


def _members(path) -> dict:
    with np.load(path) as z:
        return {m: z[m] for m in z.files}


@pytest.mark.parametrize("tag", ["raw", "compact"])
def test_cli_outputs_equal_reference(dbs, tag, tmp_path, mxu):
    """TSV (with containment columns), --counts, --matrix and triangle:
    the reference CLI's bytes under the same variable, the tile functions
    counting every tile."""
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
    # dist, --matrix, --counts: one sweep of 10 tiles each (triangle reads the TSV)
    assert len(mxu) >= 3 * _n_tiles(N, N, TILE, True)


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
    """Under mxu: bitwise equal to the reference's deferred route (slim
    pulls, union from the sizes, one resolve at the end) and to the run
    with MIEKKI_INTERSECT unset, the tile functions called once a tile
    under both."""
    t = family.to_compact() if kind.startswith("compact") else family
    args = (t, None) if not kind.endswith("rect") else (
        TIndex(t.params, t.names[:5], t.hi[:5], t.lo[:5]), t)
    got = T.dist_counts_matrix(*args, tile=tile, device="cpu")
    want = J.dist_counts_matrix(*(None if a is None else _j(a) for a in args), tile=tile)
    for c in ("shared", "union", "inter"):
        assert got[c].dtype == np.int32 and np.array_equal(got[c], want[c]), c
    n_b = len(args[0]) if args[1] is None else len(args[1])
    tiles = _n_tiles(len(args[0]), n_b, tile, args[1] is None)
    assert len(mxu) == tiles
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MIEKKI_INTERSECT")
        plain = T.dist_counts_matrix(*args, tile=tile, device="cpu")
    assert len(mxu) == 2 * tiles
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], plain[c]), c


def _dist_tiles(idx):
    tiles = list(T.dist_tiles(idx, tile=TILE, device="cpu"))
    return {"tiles": [t[:2] for t in tiles]} | {
        c: np.concatenate([t[k] for t in tiles]) for k, c in
        ((2, "gi"), (3, "gj"), (4, "shared"), (5, "union"), (6, "inter"))}


@pytest.mark.parametrize("kind", ["raw", "compact"])
@pytest.mark.parametrize("fn", ["dist_tiles", "dist_counts_matrix", "dist_sharded_hostring"])
def test_mxu_value_takes_the_tile_kernels(family, fn, kind, monkeypatch):
    """dist_tiles, dist_counts_matrix and the host ring over 3 CPU
    positions under mxu call the tile functions (K3/K4 on a card) exactly
    as under auto, once a tile, and return the same arrays; the reference's
    dist_counts_matrix under mxu gives the same counts."""
    idx = family.to_compact() if kind == "compact" else family
    run = {"dist_tiles": _dist_tiles,
           "dist_counts_matrix": lambda i: T.dist_counts_matrix(i, tile=TILE, device="cpu"),
           "dist_sharded_hostring": lambda i: dist_sharded_hostring(i, ["cpu"] * 3,
                                                                    tile=TILE)}[fn]
    calls = _count_tiles(monkeypatch)
    results = {}
    for impl in ("auto", "mxu"):
        monkeypatch.setenv("MIEKKI_INTERSECT", impl)
        before = len(calls)
        results[impl] = (run(idx), len(calls) - before)
    (auto, n_auto), (got, n_mxu) = results["auto"], results["mxu"]
    # the host ring: 3 steps x 3 positions x 2 x 2 sub-tile pairs (5 rows a position)
    want_calls = 36 if fn == "dist_sharded_hostring" else _n_tiles(N, N, TILE, True)
    assert n_mxu == n_auto == want_calls
    assert sorted(got) == sorted(auto)
    for key in got:
        assert np.array_equal(got[key], auto[key]), key
    if fn != "dist_tiles":
        want = J.dist_counts_matrix(_j(idx), tile=TILE)
        for c in ("shared", "union", "inter"):
            m = got[c] if fn == "dist_counts_matrix" else np.triu(got[c])
            assert np.array_equal(m, want[c] if fn == "dist_counts_matrix"
                                  else np.triu(want[c])), c


@pytest.mark.parametrize("tag", ["raw", "compact"])
def test_block_cache_cap_ignores_the_route(family, tag, monkeypatch):
    """A block's bytes count its keys alone (8 B a value, 4 B compact), so
    MIEKKI_COL_CACHE_MB gives the same cap under mxu and auto; at a cap of
    2 blocks the sweep's loads, hits and evictions are the same under
    both, and its counts the reference's under mxu."""
    idx = family if tag == "raw" else family.to_compact()
    lane = TI.lane_width(S)
    runs = {}
    for impl in ("auto", "mxu"):
        monkeypatch.setenv("MIEKKI_INTERSECT", impl)
        monkeypatch.setenv("MIEKKI_COL_CACHE_MB", "1")
        blocks = T._KeyBlocks(idx, None, TILE, T._device.resolve("cpu"), ())
        assert blocks.cap == (1 << 20) // (TILE * lane * (8 if tag == "raw" else 4))
        monkeypatch.setenv("MIEKKI_COL_CACHE_MB", "0")
        T.reset_block_counts()
        got = T.dist_counts_matrix(idx, tile=TILE, device="cpu")
        runs[impl] = {k: T.BLOCK_COUNTS[k] for k in ("loads", "hits", "evictions", "cap")}
    assert runs["mxu"] == runs["auto"]
    assert runs["mxu"]["cap"] == 2 and runs["mxu"]["evictions"] > 0
    want = J.dist_counts_matrix(_j(idx), tile=TILE)
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], want[c]), c
