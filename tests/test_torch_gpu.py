"""Card-only tests of the port: each CUDA kernel against its plain torch
version on the same device tensors, and the main path on the card against
the CPU path and the numpy oracle.  Tolerance: none — every output is an
integer or a byte string.

This file imports neither jax nor miekki_tpu, so it runs on a machine
without JAX; the tests skip (inside the `cuda_device` fixture) where torch
sees no card.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import io

import numpy as np
import pytest
import torch

from miekki_tpu_torch import cli, engine
from miekki_tpu_torch.ops import compact as TC
from miekki_tpu_torch.ops import cuda_hash as TCH
from miekki_tpu_torch.ops import cuda_intersect as TCI
from miekki_tpu_torch.ops import cuda_intersect32 as TCI32
from miekki_tpu_torch.ops import cuda_sketch as TCS
from miekki_tpu_torch.ops import fused_sketch as TF
from miekki_tpu_torch.ops import hash as TH
from miekki_tpu_torch.ops import intersect as TI
from miekki_tpu_torch.ops import sketch as TS
from miekki_tpu_torch.ops import u64
from miekki_tpu_torch.oracle import nthash as O
from miekki_tpu_torch.params import SketchParams

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run "
                    "`python -m pytest --noconftest -m gpu tests/test_torch_gpu.py` on the card")
    return torch.device("cuda")


def _table(rng, n_rows, s, pool_hi, full_every=4):
    """[n_rows, s] u64 table of sorted distinct INF-padded sketches holding
    the value 0 in some rows; every `full_every`-th row is full."""
    pool = np.unique(np.concatenate(
        [[0], rng.integers(0, pool_hi, size=6 * s, dtype=np.uint64)]))
    tab = np.full((n_rows, s), O.UINT64_MAX, np.uint64)
    for i in range(n_rows):
        n = s if i % full_every == 0 else int(rng.integers(0, s + 1))
        tab[i, :n] = np.sort(rng.choice(pool, size=n, replace=False))
    return tab


@pytest.mark.parametrize("k", [1, 15, 21, 31, 33, 63, 64])
def test_k1_kernel_matches_plain(cuda_device, k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(37, 4096 + k - 1)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[-1, 1000:] = 4
    dev = torch.from_numpy(codes).to(cuda_device)
    before = TCH.hash_windows_cuda.launches
    got = TCH.hash_windows_cuda(dev, k)
    torch.cuda.synchronize()
    assert TCH.hash_windows_cuda.launches == before + 1
    assert torch.equal(got, TH.hash_windows(dev, k))
    assert torch.equal(got.cpu(), TH.hash_windows(torch.from_numpy(codes), k))
    oh, ov = O.hash_kmers(codes[0], k)
    assert np.array_equal(got[0].cpu().numpy(),
                          u64.keys_from_u64(np.where(ov, oh, O.UINT64_MAX)))


def test_k1_short_rows(cuda_device):
    """Rows narrower than one block, and a single window per row."""
    rng = np.random.default_rng(4)
    for w, k in ((21, 21), (100, 31), (2100, 63)):
        codes = rng.integers(0, 5, size=(5, w)).astype(np.uint8)
        got = TCH.hash_windows_cuda(torch.from_numpy(codes).to(cuda_device), k)
        assert torch.equal(got.cpu(), TH.hash_windows(torch.from_numpy(codes), k))


K1_SPAN = 4096  # windows per work item of the persistent kernel


def _k1_case(rng, case, k, grid):
    """(codes [R, W] uint8 numpy, storage offset) for a K1 layout case."""
    n, rows, offset = {"odd_n": (K1_SPAN + 1001, 7, 0),
                       "storage_offset": (2 * K1_SPAN + 300, 5, 11),
                       "beyond_grid": (2 * K1_SPAN - 3, grid // 2 + 9, 0),
                       "invalid_edges": (2 * K1_SPAN + 64, 6, 0)}[case]
    codes = rng.integers(0, 4, size=(rows, n + k - 1)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    if case == "invalid_edges":
        codes[1] = 4                            # all-invalid rows
        codes[2] = 255
        codes[3, K1_SPAN + k - 2] = 5           # last code of span 0
        codes[4, K1_SPAN - 1] = 255             # last window's first code
        codes[5, 2 * K1_SPAN + k - 2] = 4       # last code of span 1
        codes[0, -1] = 5                        # the row's last code
    return codes, offset


@pytest.mark.parametrize("case", ["odd_n", "storage_offset", "beyond_grid", "invalid_edges"])
@pytest.mark.parametrize("k", [1, 31, 64])
def test_k1_layouts(cuda_device, k, case):
    """Rows whose keys start 8 bytes off a 16-byte boundary (odd n), codes
    at a storage offset of 11 bytes, more work items than the persistent
    grid has blocks, all-invalid rows and invalid codes (4, 5, 255) ending
    a span; one launch per call, bitwise equal to the plain version on the
    card and on the CPU and to the oracle."""
    rng = np.random.default_rng(k + len(case))
    codes, offset = _k1_case(rng, case, k, TCH.kernel_info()["grid"])
    rows, w = codes.shape
    flat = torch.zeros(offset + rows * w, dtype=torch.uint8)
    flat[offset:] = torch.from_numpy(codes.reshape(-1))
    x = flat.to(cuda_device)[offset:].view(rows, w)
    assert x.is_contiguous() and x.storage_offset() == offset
    if case == "beyond_grid":
        assert rows * -(-(w - k + 1) // K1_SPAN) > TCH.kernel_info()["grid"]
    before = TCH.hash_windows_cuda.launches
    got = TCH.hash_windows_cuda(x, k)
    torch.cuda.synchronize()
    assert TCH.hash_windows_cuda.launches == before + 1
    assert torch.equal(got, TH.hash_windows(x, k))
    assert torch.equal(got.cpu(), TH.hash_windows(torch.from_numpy(codes), k))
    for r in (0, rows - 1):
        oh, ov = O.hash_kmers(codes[r], k)
        assert np.array_equal(got[r].cpu().numpy(),
                              u64.keys_from_u64(np.where(ov, oh, O.UINT64_MAX)))


TILE_CASES = [(17, 3, 9, "random"), (1000, 12, 33, "random"), (10_000, 8, 20, "random"),
              (30_000, 2, 3, "random"), (1000, 33, 65, "ragged"), (1000, 40, 24, "padding"),
              (10_000, 32, 32, "diagonal"), (1000, 9, 11, "edges"), (30_000, 33, 5, "edges")]


def _shape_case(tab, case, ti, inf, top):
    """Apply a tile case to a [ti + tj, sp] table: "padding" empties row 1
    and turns trailing rows of both sides all-INF (as engine._pad_rows
    does); "edges" ends three rows with the largest finite value `top`."""
    if case == "padding":
        tab[1] = inf
        tab[ti - 4:ti] = inf
        tab[-5:] = inf
    elif case == "edges":
        for r in (0, ti, ti + 1):
            n = int((tab[r] != inf).sum())
            tab[r, max(n - 1, 0)] = top
    return tab


def _tile_sides(keys, ti, case):
    rows = keys[:ti].contiguous()
    return rows, (rows if case == "diagonal" else keys[ti:].contiguous())


@pytest.mark.parametrize("s,ti,tj,case", TILE_CASES)
def test_k3_kernel_matches_plain(cuda_device, s, ti, tj, case):
    """Ragged tiles against the kernel's 32 x 32 blocks, an empty row and
    all-INF padding rows, a diagonal tile (rows == cols), the largest
    finite key next to INF, s from 17 to 30,000; one launch per call."""
    rng = np.random.default_rng(s + ti)
    tab = _shape_case(_table(rng, ti + tj, s, 8 * s), case, ti, O.UINT64_MAX,
                      O.UINT64_MAX - np.uint64(1))
    keys = TI._pad_lane(torch.from_numpy(u64.keys_from_u64(tab))).to(cuda_device)
    rows, cols = _tile_sides(keys, ti, case)
    before = TCI.tile_counts_cuda.launches
    got = TCI.tile_counts_cuda(rows, cols, s)
    torch.cuda.synchronize()
    assert TCI.tile_counts_cuda.launches == before + 1
    want = TI.tile_counts_plain(rows, cols, s)
    for key in ("shared_in_x", "union_size", "inter_full", "n_a", "n_b"):
        assert torch.equal(got[key], want[key]), key


def test_k3_zero_head_ties(cuda_device):
    s = 300
    rng = np.random.default_rng(5)
    a = np.unique(np.concatenate([[0], rng.integers(0, 1000, 280, dtype=np.uint64)]))[:s]
    b = np.unique(np.concatenate([[0, 1], rng.integers(0, 1000, 280, dtype=np.uint64)]))[:s]
    tab = np.full((2, s), O.UINT64_MAX, np.uint64)
    tab[0, :len(a)] = a
    tab[1, :len(b)] = b
    keys = torch.from_numpy(u64.keys_from_u64(tab))
    got = TI.tile_counts(keys[:1].to(cuda_device), keys[1:].to(cuda_device), s)
    want = TI.tile_counts(keys[:1], keys[1:], s)
    for key in ("shared_in_x", "union_size", "inter_full"):
        assert torch.equal(got[key].cpu(), want[key]), key


def test_k3_wrapper_refuses_bad_inputs(cuda_device):
    keys = torch.full((4, 128), u64.INF_KEY, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        TCI.tile_counts_cuda(keys[:, ::2], keys[:, ::2], 10)  # not contiguous
    with pytest.raises(ValueError):
        TCI.tile_counts_cuda(keys, keys.cpu(), 10)  # two devices


def test_sketch_on_card_matches_oracle(cuda_device):
    rng = np.random.default_rng(21)
    k, s = 31, 1000
    codes = rng.integers(0, 4, size=1_500_000).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.001] = 4
    got = TS.sketch_codes_device(codes, k, s, device=cuda_device)
    h = np.unique(O.canonical_hashes(codes.astype(np.int64), k))
    assert np.array_equal(got, h[h != O.UINT64_MAX][:s])


def test_main_path_on_card_equals_cpu(cuda_device, tmp_path):
    """build_index + dist_tsv_write on the card write the same index and the
    same TSV bytes as on the CPU, through both kernels."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, size=200_000)
    paths = []
    for g in range(6):
        seq = base.copy()
        flip = rng.random(seq.shape) < 0.01 * g
        seq[flip] = rng.integers(0, 4, size=int(flip.sum()))
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n" + "".join("ACGT"[c] for c in seq) + "\n")
        paths.append(str(p))
    params = SketchParams(k=21, s=500)
    h0, t0 = TCH.hash_windows_cuda.launches, TCI.tile_counts_cuda.launches
    on_card = engine.build_index(paths, params, device=cuda_device)
    on_cpu = engine.build_index(paths, params, device="cpu")
    assert np.array_equal(on_card.hi, on_cpu.hi)
    assert np.array_equal(on_card.lo, on_cpu.lo)
    texts = []
    for dev in (cuda_device, "cpu"):
        buf = io.StringIO()
        engine.dist_tsv_write(buf, on_card, tile=4,
                              columns=engine.select_columns(True, True), device=dev)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert TCH.hash_windows_cuda.launches > h0
    assert TCI.tile_counts_cuda.launches > t0
    assert len(texts[0].splitlines()) == 1 + 15


def _code_table(rng, n_rows, sp, pool_size, full_every=4):
    """[n_rows, sp] uint32 compact code table: sorted distinct codes from a
    shared pool, code 0 present, sentinel-padded; every `full_every`-th row
    is full."""
    pool = np.unique(np.concatenate(
        [[0], rng.choice(0xFFFFFFFE, size=pool_size, replace=False)])).astype(np.uint32)
    tab = np.full((n_rows, sp), np.uint32(0xFFFFFFFF), np.uint32)
    for i in range(n_rows):
        n = sp if i % full_every == 0 else int(rng.integers(0, sp + 1))
        tab[i, :n] = np.sort(rng.choice(pool, size=n, replace=False))
    return tab


@pytest.mark.parametrize("s,ti,tj,case", TILE_CASES + [(10_000, 37, 5, "random"),
                                                   (70_000, 2, 3, "random")])
def test_k4_kernel_matches_plain(cuda_device, s, ti, tj, case):
    """K3's cases on compact code keys, plus s = 70,000 (a width the first
    design could not stage) and another ragged tile."""
    rng = np.random.default_rng(s + ti)
    tab = _shape_case(_code_table(rng, ti + tj, s, 4 * s), case, ti, np.uint32(0xFFFFFFFF),
                      np.uint32(0xFFFFFFFE))
    keys = TI._pad_lane(torch.from_numpy(TC.keys32_from_codes(tab))).to(cuda_device)
    rows, cols = _tile_sides(keys, ti, case)
    before = TCI32.tile_counts32_cuda.launches
    got = TCI32.tile_counts32_cuda(rows, cols, s)
    torch.cuda.synchronize()
    assert TCI32.tile_counts32_cuda.launches == before + 1
    want = TI.tile_counts_compact_plain(rows, cols, s)
    for key in ("shared_in_x", "union_size", "inter_full", "n_a", "n_b"):
        assert torch.equal(got[key], want[key]), key


def test_k4_zero_head_ties(cuda_device):
    s = 300
    rng = np.random.default_rng(5)
    a = np.unique(np.concatenate([[0], rng.integers(0, 1000, 280)])).astype(np.uint32)[:s]
    b = np.unique(np.concatenate([[0, 1], rng.integers(0, 1000, 280)])).astype(np.uint32)[:s]
    tab = np.full((2, s), np.uint32(0xFFFFFFFF), np.uint32)
    tab[0, :len(a)] = a
    tab[1, :len(b)] = b
    keys = torch.from_numpy(TC.keys32_from_codes(tab))
    got = TI.tile_counts_compact(keys[:1].to(cuda_device), keys[1:].to(cuda_device), s)
    want = TI.tile_counts_compact(keys[:1], keys[1:], s)
    for key in ("shared_in_x", "union_size", "inter_full"):
        assert torch.equal(got[key].cpu(), want[key]), key


def _thresholds(h, genomes, quantile):
    """One threshold key per genome: INF, or a quantile of the block's
    finite hashes, nudged differently per genome."""
    if quantile is None:
        return torch.full((genomes,), u64.INF_KEY, dtype=torch.int64, device=h.device)
    finite = h[h != u64.INF_KEY].double()
    qs = torch.tensor([quantile * (1 + 0.1 * g) for g in range(genomes)],
                      dtype=torch.float64, device=h.device)
    return torch.quantile(finite[:1 << 24], qs).to(torch.int64)


def _k2_inputs(rng, case, k, genomes, g, device):
    """Code rows [genomes * g, 8192 + k - 1] and per-row threshold keys for
    a K2 case: a quantile of the block (per genome, None = INF), or
    "group32" / "group33": row 0's level-1 group 1 keeps exactly 32 / 33
    finite values (the edge of the 32-wide selection); "level2_over_32":
    row 0's first level-2 group gathers 40 from level-1 groups of <= 32;
    "ties": repetitive rows (all-A with 10 % invalid codes, and a 37-base
    motif) whose groups hold tied hashes; "invalid_rows": every fifth row
    all invalid."""
    rows = genomes * g
    codes = rng.integers(0, 4, size=(rows, 8192 + k - 1)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.005] = 4
    half = rows // 2
    if case == "ties":
        codes[:half] = np.where(rng.random((half, codes.shape[1])) < 0.1, 4, 0)
        codes[half:] = np.resize(rng.integers(0, 4, size=37), codes.shape[1])
    elif case == "invalid_rows":
        codes[::5] = 4
    x = torch.from_numpy(codes).to(device)
    h = TH.hash_windows(x, k)
    if case in ("group32", "group33", "level2_over_32"):
        (lo, hi), keep = {"group32": ((128, 256), 32), "group33": ((128, 256), 33),
                          "level2_over_32": ((0, 512), 40)}[case]
        vals = torch.sort(h[0, lo:hi]).values
        thr = torch.full((rows,), int(vals[keep - 1]) + 1, dtype=torch.int64, device=device)
        assert int((h[0, lo:hi] < thr[0]).sum()) == keep
        if case == "level2_over_32":
            assert int((h[0, :512] < thr[0]).reshape(4, 128).sum(-1).max()) <= TF.GROUP_CAP
        return x, thr
    if case == "ties":
        thr = torch.empty(rows, dtype=torch.int64, device=device)
        thr[:half] = int(h[0][h[0] != u64.INF_KEY][0]) + 1
        thr[half:] = _thresholds(h[half:], 1, 0.1)
        return x, thr
    return x, _thresholds(h, genomes, 0.002 if case == "invalid_rows" else case)


@pytest.mark.parametrize("levels", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("case", [None, 0.3, 0.002, "group32", "group33", "level2_over_32",
                                  "ties", "invalid_rows"])
def test_k2_kernel_matches_plain(cuda_device, levels, case):
    """Per-genome thresholds that differ (4 genomes of 32 rows), and the
    boundary cases of the kernel's two group paths (32-wide selection up
    to 32 finite values, the 128-value network above); candidates and
    per-row counts equal bitwise.  Levels 4 runs the extra pass."""
    rng = np.random.default_rng(levels)
    k, genomes, g = 31, 4, 32
    x, thr = _k2_inputs(rng, case, k, genomes, g, cuda_device)
    if levels % 2:  # a strided view, as the fused step passes sketch[:, s - 1]
        thr = torch.stack([thr, torch.zeros_like(thr)], 1)[:, 0]
    before = TCS.hash_reduce_cuda.launches
    got, cmax = TCS.hash_reduce_cuda(x, k, thr, levels)
    torch.cuda.synchronize()
    assert TCS.hash_reduce_cuda.launches == before + 1 + (levels == 4)
    want, want_max = TF.hash_reduce_plain(x, k, thr, levels)
    assert torch.equal(got, want)
    assert torch.equal(cmax, want_max)
    if case == 0.002 and levels:
        assert int(cmax.max()) <= TF.GROUP_CAP
    if case in ("group33", "level2_over_32") and levels >= 1 + (case != "group33"):
        assert int(cmax[0]) > TF.GROUP_CAP
    if case == "invalid_rows":
        assert not bool(cmax[::5].any()) and bool((got[::5] == u64.INF_KEY).all())


def test_k2_odd_widths_and_k(cuda_device):
    """Widths that are not a multiple of the block's span of 4,096 windows
    (levels 0 to 3), and k at its extremes."""
    rng = np.random.default_rng(9)
    for k, n, levels in ((1, 640, 1), (64, 2048 + 128, 1), (21, 96, 0), (64, 2048, 3),
                         (31, 4096 + 640, 0), (64, 8192 + 96, 0), (21, 4096 + 512, 2),
                         (33, 6144, 3), (1, 2048, 3)):
        codes = rng.integers(0, 5, size=(5, n + k - 1)).astype(np.uint8)
        x = torch.from_numpy(codes).to(cuda_device)
        for thr_key in (u64.INF_KEY, 1 << 60):
            thr = torch.full((5,), thr_key, dtype=torch.int64, device=cuda_device)
            got = TCS.hash_reduce_cuda(x, k, thr, levels)
            want = TF.hash_reduce_plain(x, k, thr, levels)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (k, n)


def test_k2_and_k4_wrappers_refuse_bad_inputs(cuda_device):
    codes = torch.zeros((4, 2048 + 20), dtype=torch.uint8, device=cuda_device)
    thr = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        TCS.hash_reduce_cuda(codes[:, ::2], 21, thr, 1)  # not contiguous
    with pytest.raises(ValueError):
        TCS.hash_reduce_cuda(codes, 21, thr.cpu(), 1)  # two devices
    with pytest.raises(ValueError, match="incompatible"):
        TCS.hash_reduce_cuda(codes, 21, thr, 5)
    keys = torch.full((4, 128), TC.INF_KEY32, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        TCI32.tile_counts32_cuda(keys[:, ::2], keys[:, ::2], 10)
    with pytest.raises(ValueError):
        TCI32.tile_counts32_cuda(keys, keys.cpu(), 10)
    with pytest.raises(ValueError):
        TCI32.tile_counts32_cuda(keys.to(torch.int64), keys.to(torch.int64), 10)


def test_fused_and_compact_cli_on_card_equal_cpu(cuda_device, tmp_path, monkeypatch):
    """MIEKKI_MERGE=fused `cli sketch`, `cli compress` and `cli dist` of the
    compact index write the same files on the card as on the CPU, through
    K2 and K4; the fused index equals the tree index."""
    rng = np.random.default_rng(13)
    base = rng.integers(0, 4, size=300_000)
    paths = []
    for g in range(5):
        seq = base.copy()
        flip = rng.random(seq.shape) < 0.01 * g
        seq[flip] = rng.integers(0, 4, size=int(flip.sum()))
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n" + "".join("ACGT"[c] for c in seq) + "\n")
        paths.append(str(p))
    common = ["-k", "21", "-s", "500"]
    assert cli.main(["sketch", *paths, "-o", str(tmp_path / "tree.npz"), *common]) == 0
    monkeypatch.setenv("MIEKKI_MERGE", "fused")
    k2 = TCS.hash_reduce_cuda.launches
    out = {}
    for dev in ("cuda", "cpu"):
        db, db32 = tmp_path / f"{dev}.npz", tmp_path / f"{dev}32.npz"
        tsv = tmp_path / f"{dev}.tsv"
        assert cli.main(["sketch", *paths, "-o", str(db), *common, "--device", dev]) == 0
        assert cli.main(["compress", str(db), "-o", str(db32)]) == 0
        k4 = TCI32.tile_counts32_cuda.launches
        assert cli.main(["dist", str(db32), "-o", str(tsv), "--tile", "2",
                         "--containment", "--device", dev]) == 0
        if dev == "cuda":
            assert TCI32.tile_counts32_cuda.launches > k4
        out[dev] = [_npz(db), _npz(db32), tsv.read_bytes()]
    assert TCS.hash_reduce_cuda.launches > k2
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0] == _npz(tmp_path / "tree.npz")


def _npz(path):
    """An index file's members as bytes (the zip itself carries times)."""
    with np.load(path) as z:
        return {name: z[name].tobytes() for name in z.files}
