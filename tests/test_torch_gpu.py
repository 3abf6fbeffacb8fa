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
    and turns trailing rows of both sides all-INF (as a partial edge
    block's padding does); "edges" ends three rows with the largest finite value `top`."""
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


@pytest.mark.parametrize("flat", [1 << 22, 6000])
def test_k1_at_the_screen_shape(cuda_device, flat):
    """One packed read batch: a single row of flat + k - 1 codes."""
    rng = np.random.default_rng(flat)
    k = 31
    codes = rng.integers(0, 4, size=(1, flat + k - 1)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    dev = torch.from_numpy(codes).to(cuda_device)
    got = TCH.hash_windows_cuda(dev, k)
    assert got.shape == (1, flat)
    assert torch.equal(got, TH.hash_windows(dev, k))


def _screen_inputs(tmp_path):
    """5 related 40 kb genomes, their index (k = 21, s = 500), and two
    FASTQ files of 150-base reads from genomes 0 and 3, a quarter of them
    reverse-complemented."""
    rng = np.random.default_rng(23)
    base = rng.integers(0, 4, size=40_000)
    seqs, paths = [], []
    for g in range(5):
        seq = base.copy()
        flip = rng.random(seq.shape) < 0.02 * g
        seq[flip] = rng.integers(0, 4, size=int(flip.sum()))
        seqs.append(seq)
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n" + "".join("ACGT"[c] for c in seq) + "\n")
        paths.append(str(p))
    index = engine.build_index(paths, SketchParams(k=21, s=500), device="cpu")
    reads = []
    for f, g in enumerate((0, 3)):
        lines = []
        for r in range(400):
            a = int(rng.integers(0, 40_000 - 150))
            read = seqs[g][a:a + 150]
            if r % 4 == 0:
                read = 3 - read[::-1]
            s = "".join("ACGT"[c] for c in read)
            lines.append(f"@r{f}_{r}\n{s}\n+\n{'I' * 150}\n")
        p = tmp_path / f"reads{f}.fq"
        p.write_text("".join(lines))
        reads.append(str(p))
    return index, reads


@pytest.mark.parametrize("groups", [None, "1200"], ids=["one_pass", "grouped"])
@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_screen_on_card_equals_cpu(cuda_device, tmp_path, monkeypatch, compact, groups):
    """engine.screen on the card gives the CPU's rows and stats in plain,
    winner and p-value modes, one-pass and in forced groups, and K1 runs
    once per batch."""
    index, reads = _screen_inputs(tmp_path)
    if compact:
        index = index.to_compact()
    if groups:
        monkeypatch.setenv("MIEKKI_SCREEN_DB_VALS", groups)
    for kw in ({}, {"winner": True}, {"p_values": True}):
        stats = {}
        before = TCH.hash_windows_cuda.launches
        got = engine.screen(index, reads, flat=8192, stats=stats, device=cuda_device, **kw)
        launches = TCH.hash_windows_cuda.launches - before
        cpu_stats = {}
        want = engine.screen(index, reads, flat=8192, stats=cpu_stats, device="cpu", **kw)
        assert got == want, kw
        stats.pop("phase_seconds", None), cpu_stats.pop("phase_seconds", None)
        assert stats == cpu_stats
        assert launches == stats["n_batches"] * stats.get("n_slabs", 1)
        assert got[0]["hits"] > 0 and got[3]["hits"] > 0
        assert (stats.get("n_slabs", 1) > 1) == bool(groups)


def test_packed_rows_are_pinned_and_uploaded_in_place(cuda_device, tmp_path, monkeypatch):
    """For a card the native read pack pass stages each chunk's rows in one
    pinned tensor: a row handed to _batch_to_device is pinned already, is
    not pinned again, and its copy to the card reads it where it lies."""
    _, reads = _screen_inputs(tmp_path)
    assert engine._native.available() and engine._read_pack.available()
    rows = list(engine._packed_read_rows(reads[0], 21, 8192, pin=True))
    assert len(rows) > 1 and all(native for *_, native in rows)
    chunk = rows[0][0].untyped_storage().data_ptr()
    assert all(row.untyped_storage().data_ptr() == chunk for row, *_ in rows)
    sources = []
    to = torch.Tensor.to

    def recording_to(self, *args, **kw):
        sources.append(self.data_ptr())
        return to(self, *args, **kw)

    def no_pin(self, *args, **kw):
        raise AssertionError("a staged row was pinned again")

    monkeypatch.setattr(torch.Tensor, "to", recording_to)
    monkeypatch.setattr(torch.Tensor, "pin_memory", no_pin)
    for row, *_ in rows:
        assert row.is_pinned()
        on_card = engine._batch_to_device(row, cuda_device)
        assert sources[-1] == row.data_ptr()
        torch.cuda.synchronize()
        assert torch.equal(on_card.cpu(), row)


@pytest.mark.parametrize("rect", [False, True], ids=["self", "rect"])
@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_dist_counts_matrix_on_card_equals_cpu(cuda_device, compact, rect):
    """dist_counts_matrix on the card (K3, or K4 on a compact index) gives
    the CPU's matrices at a tiling that does not divide the genome count."""
    from miekki_tpu_torch.index.store import SketchIndex

    rng = np.random.default_rng(8)
    s = 2000
    tab = _table(rng, 45, s, 2 ** 63)
    index = SketchIndex.from_sketches([r[r != O.UINT64_MAX] for r in tab],
                                      [f"g{i}" for i in range(45)], SketchParams(k=31, s=s))
    if compact:
        index = index.to_compact()
    parts = ((SketchIndex(index.params, index.names[:17], index.hi[:17], index.lo[:17]),
              SketchIndex(index.params, index.names[17:], index.hi[17:], index.lo[17:]))
             if rect else (index, None))
    kernel = TCI32.tile_counts32_cuda if compact else TCI.tile_counts_cuda
    before = kernel.launches
    got = engine.dist_counts_matrix(*parts, tile=16, device=cuda_device)
    assert kernel.launches - before == (2 * 2 if rect else 3 * 4 // 2)
    want = engine.dist_counts_matrix(*parts, tile=16, device="cpu")
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], want[c]), c


def test_builder_planes_on_card_equal_host_table(cuda_device, monkeypatch):
    """Unset MIEKKI_KEEP_DEV keeps a small table on the card: the index build's
    device_planes equal index_to_device of its host planes (several
    batches, a genome shorter than k)."""
    from miekki_tpu_torch.index.store import index_to_device

    monkeypatch.delenv("MIEKKI_KEEP_DEV", raising=False)
    rng = np.random.default_rng(1)
    codes = [rng.integers(0, 4, 9000).astype(np.uint8) for _ in range(13)]
    codes.append(rng.integers(0, 4, 5).astype(np.uint8))
    idx = engine._build_index_from_codes(codes, [f"g{i}" for i in range(14)],
                                         SketchParams(k=21, s=300), chunk=2048, batch=4,
                                         device=cuda_device)
    assert idx.device_planes is not None and idx.device_planes.is_cuda
    assert torch.equal(idx.device_planes, index_to_device(idx, cuda_device))


@pytest.mark.parametrize("rect", [False, True], ids=["self", "rect"])
@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_dist_tiles_through_planes_on_card(cuda_device, compact, rect):
    """dist_counts_matrix with device planes on the card (blocks sliced
    from them, edge blocks padded per block) equals the host path on the
    card and the CPU's, with the same launches."""
    from miekki_tpu_torch.index.store import SketchIndex, index_to_device

    rng = np.random.default_rng(8)
    s = 2000
    tab = _table(rng, 45, s, 2 ** 63)
    index = SketchIndex.from_sketches([r[r != O.UINT64_MAX] for r in tab],
                                      [f"g{i}" for i in range(45)], SketchParams(k=31, s=s))
    if compact:
        index = index.to_compact()
    parts = ((SketchIndex(index.params, index.names[:17], index.hi[:17], index.lo[:17]),
              SketchIndex(index.params, index.names[17:], index.hi[17:], index.lo[17:]))
             if rect else (index,))
    host = engine.dist_counts_matrix(*parts, tile=16, device=cuda_device)
    for p in parts:
        p.device_planes = index_to_device(p, cuda_device)
    before = [p.device_planes.clone() for p in parts]
    kernel = TCI32.tile_counts32_cuda if compact else TCI.tile_counts_cuda
    launches = kernel.launches
    got = engine.dist_counts_matrix(*parts, tile=16, device=cuda_device)
    assert kernel.launches - launches == (2 * 2 if rect else 3 * 4 // 2)
    want = engine.dist_counts_matrix(*parts, tile=16, device="cpu")
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], host[c]) and np.array_equal(got[c], want[c]), c
    assert all(torch.equal(p.device_planes, b) for p, b in zip(parts, before))


def _family_index(rng, n: int, s: int, compact: bool):
    """n sketches of s values in families of 8 (each row its family's base
    with ~10 % of the values replaced), every seventh row cut short."""
    from miekki_tpu_torch.index.store import SketchIndex

    rows = []
    for f in range(-(-n // 8)):
        base = rng.integers(0, 2 ** 63, size=s, dtype=np.uint64)
        for _ in range(min(8, n - 8 * f)):
            row = np.where(rng.random(s) < 0.1,
                           rng.integers(0, 2 ** 63, size=s, dtype=np.uint64), base)
            row = np.unique(row)
            rows.append(row[:s // 3] if len(rows) % 7 == 3 else row)
    index = SketchIndex.from_sketches(rows, [f"g{i}" for i in range(n)], SketchParams(k=31, s=s))
    return index.to_compact() if compact else index


@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_streamed_blocks_on_card_equal_the_padded_table(cuda_device, compact):
    """Each block formed on the card from the host planes (staged through
    pinned memory, uploaded and formed on the copy stream), the partial
    edge block included, equals the matching rows of index_to_device
    padded to the lane width and to whole tiles."""
    from miekki_tpu_torch.index.store import index_to_device

    n, s, tile = 300, 1000, 64
    index = _family_index(np.random.default_rng(3), n, s, compact)
    table = TI._pad_lane(index_to_device(index, cuda_device))
    n_blocks = -(-n // tile)
    pad = table.new_full((n_blocks * tile - n, table.shape[1]), TI.inf_key(table.dtype))
    table = torch.cat([table, pad])
    engine.reset_block_counts()
    blocks = engine._KeyBlocks(index, None, tile, torch.device("cuda", torch.cuda.current_device()),
                               ())
    for b in range(n_blocks):
        blk = blocks.get(("a", b))
        assert blk.shape == (tile, TI.lane_width(s)) and blk.dtype == table.dtype
        assert torch.equal(blk, table[b * tile:(b + 1) * tile]), b
    assert engine.BLOCK_COUNTS["loads"] == n_blocks
    assert engine.BLOCK_COUNTS["bytes_uploaded"] == index.hi.nbytes * (1 if compact else 2)


@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_capped_sweep_on_card_equals_uncapped_within_its_bound(cuda_device, monkeypatch,
                                                               compact):
    """A self-comparison of 36 tiles (8 blocks of 128 genomes, the last of
    88) under a cap of 2 blocks evicts blocks that the tile in flight still
    reads, and gives the uncapped sweep's matrices; its device memory over
    the start stays within cache + 3 blocks + 16 MiB."""
    n, s, tile = 984, 10_000, 128
    index = _family_index(np.random.default_rng(4), n, s, compact)
    kernel = TCI32.tile_counts32_cuda if compact else TCI.tile_counts_cuda
    monkeypatch.delenv("MIEKKI_COL_CACHE_MB", raising=False)
    want = engine.dist_counts_matrix(index, tile=tile, device=cuda_device)
    block_bytes = tile * TI.lane_width(s) * (4 if compact else 8)
    cache_mb = -(-2 * block_bytes // (1 << 20))
    monkeypatch.setenv("MIEKKI_COL_CACHE_MB", str(cache_mb))
    engine.reset_block_counts()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = kernel.launches
    got = engine.dist_counts_matrix(index, tile=tile, device=cuda_device)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    assert kernel.launches - launches == 36
    counts = engine.BLOCK_COUNTS
    assert counts["cap"] == 2 and counts["evictions"] > 0 and counts["loads"] > 8
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], want[c]), c
    assert peak <= (cache_mb << 20) + 3 * block_bytes + (16 << 20), peak


def test_chunked_upload_and_pull_on_card(cuda_device, monkeypatch):
    """index_to_device in chunks of rows and _to_host through a small
    pinned buffer give the unchunked bytes."""
    from miekki_tpu_torch.index import store
    from miekki_tpu_torch.index.store import SketchIndex

    rng = np.random.default_rng(2)
    tab = _table(rng, 37, 300, 2 ** 64 - 1)
    index = SketchIndex.from_sketches([r[r != O.UINT64_MAX] for r in tab],
                                      [f"g{i}" for i in range(37)], SketchParams(k=31, s=300))
    for idx in (index, index.to_compact()):
        whole = store.index_to_device(idx, cuda_device)
        monkeypatch.setattr(store, "UPLOAD_CHUNK_VALUES", 1000)
        assert torch.equal(store.index_to_device(idx, cuda_device), whole)
        monkeypatch.setattr(engine, "PULL_CHUNK_BYTES", 4000)
        assert np.array_equal(engine._to_host(whole), whole.cpu().numpy())
        monkeypatch.undo()


def test_scale_tool_on_card_tiny(cuda_device, monkeypatch, tmp_path):
    """tools/scale100k at a tiny size on the card (K1, K3, K4), its screen
    in 3 groups: every check passes."""
    import json

    from miekki_tpu_torch.tools import scale100k

    monkeypatch.setenv("MIEKKI_SCREEN_DB_VALS", "12000")
    out = tmp_path / "report.json"
    assert scale100k.main(["--genomes", "96", "--real", "8", "--s", "256",
                           "--genome-len", "5000", "--queries", "16", "--tile", "16",
                           "--reads-per-genome", "300", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["pass"] and report["screen_stats"]["n_slabs"] >= 2
    assert report["dist_launches"]["k4"] == 96 // 16 and report["spot_launches"]["k3"] == 4
    assert report["screen_launches"]["k1"] >= 2


@pytest.mark.parametrize("cap", [0, 1024])
def test_counted_sketch_on_card_equals_oracle(cuda_device, cap, monkeypatch):
    """sketch_codes_device_counted on the card (K1 every step) equals the
    numpy oracle on a seeded read set: 1 % substitutions, ~8x coverage;
    cap 1024 forces doubled-cap retries (at least 1024, then 2048)."""
    from miekki_tpu_torch.io import encode
    from miekki_tpu_torch.ops import sketch_counted as TSC
    from miekki_tpu_torch.oracle import sketch as OS

    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, size=100_000).astype(np.uint8)
    starts = rng.integers(0, genome.size - 150, size=5_000)
    reads = genome[starts[:, None] + np.arange(150)]
    hit = rng.random(reads.shape) < 0.01
    reads[hit] = (reads[hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
    k, s, m = 31, 1000, 2
    codes = encode.pack_records(list(reads.astype(np.uint8)), k)
    caps = []
    real = TSC._sketch_chunked_counted

    def spy(rows, k_, cap_):
        caps.append(cap_)
        return real(rows, k_, cap_)

    monkeypatch.setattr(TSC, "_sketch_chunked_counted", spy)
    before = TCH.hash_windows_cuda.launches
    got = TSC.sketch_codes_device_counted(codes, k, s, m, cap=cap, device=cuda_device)
    assert TCH.hash_windows_cuda.launches > before
    assert caps[:2] == ([1024, 2048] if cap else [4096])
    want = OS.bottom_s_min_copies(O.canonical_hashes(codes.astype(np.int64), k), s, m)
    assert len(want) == s
    assert np.array_equal(got, want)


def test_profile_on_card_keeps_every_kernel(cuda_device, tmp_path):
    """`dist --profile` on the card: the trace opens with the warm-up burst,
    names K3's kernel, and every kernel the command launched has its device
    record (no warning on stderr); the TSV equals the unprofiled one."""
    import contextlib
    import json

    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.utils import profiling

    rng = np.random.default_rng(9)
    tab = _table(rng, 24, 1000, 2 ** 63)
    db = tmp_path / "db.npz"
    SketchIndex.from_sketches([r[r != O.UINT64_MAX] for r in tab],
                              [f"g{i}" for i in range(24)], SketchParams(k=31, s=1000)).save(db)
    assert cli.main(["dist", str(db), "-o", str(tmp_path / "plain.tsv")]) == 0
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(["dist", str(db), "-o", str(tmp_path / "prof.tsv"),
                         "--profile", str(tmp_path / "prof")]) == 0
    assert "no device record" not in err.getvalue()
    assert (tmp_path / "prof.tsv").read_bytes() == (tmp_path / "plain.tsv").read_bytes()
    (trace,) = (tmp_path / "prof").glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == profiling.WARMUP_SPAN for e in events)
    assert any(e.get("cat") == "kernel" and "tile_counts_kernel<long>" in e["name"]
               for e in events)


def _launches_inside(events, kernel, span_name):
    """(launches of kernels whose name holds `kernel`, how many of them lie
    inside a `span_name` span) in a chrome trace's events: the host's
    launch call, matched to its kernel by correlation id."""
    corr = {e["args"]["correlation"] for e in events if e.get("cat") == "kernel"
            and kernel in e["name"] and "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e["name"] and e.get("args", {}).get("correlation") in corr]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == span_name]
    inside = sum(any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in spans)
                 for e in launches)
    return len(launches), inside


@pytest.mark.parametrize("command", ["sketch", "dist"])
def test_profile_spans_hold_their_kernel_launches_on_card(cuda_device, tmp_path, command):
    """`--profile` on the card: every K1 launch of `sketch` lies inside a
    `sketch.merge` span and every K3 launch of `dist --counts` inside a
    `dist.dispatch` span (the spans share the device records' clock), and
    each span's stderr line carries the card's idle seconds under it."""
    import contextlib
    import json

    from miekki_tpu_torch.index.store import SketchIndex

    rng = np.random.default_rng(12)
    if command == "sketch":
        paths = []
        for i in range(6):
            codes = rng.integers(0, 4, size=60_000 + 5_000 * i)
            path = tmp_path / f"g{i}.fa"
            path.write_bytes(b">g\n" + np.frombuffer(b"ACGT", np.uint8)[codes].tobytes() + b"\n")
            paths.append(str(path))
        argv = ["sketch", *paths, "-o", str(tmp_path / "db.npz"), "-s", "1000"]
        kernel, span_name = "hash_windows_kernel", "sketch.merge"
    else:
        tab = _table(rng, 40, 1000, 2 ** 63)
        db = tmp_path / "db.npz"
        SketchIndex.from_sketches([r[r != O.UINT64_MAX] for r in tab],
                                  [f"g{i}" for i in range(40)],
                                  SketchParams(k=31, s=1000)).save(db)
        argv = ["dist", str(db), "--counts", str(tmp_path / "c.npz"), "--tile", "16"]
        kernel, span_name = "tile_counts_kernel<long>", "dist.dispatch"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main([*argv, "--profile", str(tmp_path / "prof")]) == 0
    (trace,) = (tmp_path / "prof").glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    n, inside = _launches_inside(events, kernel, span_name)
    assert n >= 1 and inside == n, (n, inside)
    if command == "dist":
        assert n == 6  # 3 blocks of 16: 6 tiles
    lines = [ln for ln in err.getvalue().splitlines() if f"{command}: span " in ln]
    assert any(f"span {span_name}: " in ln for ln in lines)
    assert lines and all("idle_s None" not in ln and "idle_s " in ln for ln in lines)


@pytest.mark.parametrize("rect", [False, True], ids=["self", "rect"])
@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_hostring_on_four_card_positions_equals_dist_counts_matrix(cuda_device, compact, rect):
    """dist_sharded_hostring over [cuda:0] * 4 (four positions sharing the
    card) equals dist_counts_matrix on the card, symmetrised for a
    self-comparison; K3 (K4) launches = steps x sub-tile pairs x positions."""
    from miekki_tpu_torch.index.store import SketchIndex
    from miekki_tpu_torch.parallel import dist_sharded_hostring

    rng = np.random.default_rng(10)
    s = 2000
    tab = _table(rng, 45, s, 2 ** 63)
    index = SketchIndex.from_sketches([r[r != O.UINT64_MAX] for r in tab],
                                      [f"g{i}" for i in range(45)], SketchParams(k=31, s=s))
    if compact:
        index = index.to_compact()
    a, b = ((SketchIndex(index.params, index.names[:17], index.hi[:17], index.lo[:17]), index)
            if rect else (index, None))
    kernel = TCI32.tile_counts32_cuda if compact else TCI.tile_counts_cuda
    before = kernel.launches
    got = dist_sharded_hostring(a, [cuda_device] * 4, tile=8, index_b=b)
    n_sub_a = -(-(-(-len(a) // 4)) // 8)
    n_sub_b = n_sub_a if b is None else -(-(-(-len(b) // 4)) // 8)
    assert kernel.launches - before == 4 * n_sub_a * n_sub_b * 4
    want = engine.dist_counts_matrix(a, b, tile=16, device=cuda_device)
    for c in ("shared", "union", "inter"):
        m = want[c] if rect else np.triu(want[c]) + np.triu(want[c], 1).T
        assert np.array_equal(got[c], m), c


def _ring_tool(*argv, timeout=300):
    import subprocess
    import sys
    from pathlib import Path

    res = subprocess.run([sys.executable, "-m", "miekki_tpu_torch.tools.multiprocess_ring",
                          *argv, "--timeout", str(timeout - 30)],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "ALL RANKS OK" in res.stdout
    return res.stdout


def test_two_gloo_ranks_computing_on_the_card(cuda_device):
    """Two gloo ranks on the card (blocks staged through host buffers): the
    rings (K3, K4) and the merged screen equal one device's."""
    out = _ring_tool("--ranks", "2", "--backend", "gloo", "--modes",
                     "square,rect,compact,screen", "--genomes", "48", "-s", "500")
    assert '"device": "cuda:0"' in out


def test_one_rank_nccl_group(cuda_device):
    """A one-rank NCCL group: dist_sharded through the collective ring code
    and screen_sharded through its all_reduce merges equal one device's."""
    out = _ring_tool("--ranks", "1", "--modes", "square,compact,screen", "--genomes", "48",
                     "-s", "500")
    assert '"backend": "nccl"' in out


# ------------------------------------------ MIEKKI_INTERSECT=mxu: K3/K4 as auto


@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_mxu_dist_on_card_launches_k3_k4_as_auto(cuda_device, monkeypatch, compact,
                                                 tmp_path):
    """Under MIEKKI_INTERSECT=mxu, dist_counts_matrix, `cli dist` and the
    host ring over [cuda:0] * 4 on the card launch K3 (K4) exactly as under
    auto, once a tile, with the same results."""
    from miekki_tpu_torch.parallel import dist_sharded_hostring

    index = _family_index(np.random.default_rng(13), 45, 2000, compact)
    kernel = TCI32.tile_counts32_cuda if compact else TCI.tile_counts_cuda
    db = tmp_path / "db.npz"
    index.save(db)
    runs = {}
    for impl in ("auto", "mxu"):
        monkeypatch.setenv("MIEKKI_INTERSECT", impl)
        before = kernel.launches
        counts = engine.dist_counts_matrix(index, tile=16, device=cuda_device)
        assert cli.main(["dist", str(db), "-o", str(tmp_path / f"{impl}.tsv"),
                         "--tile", "16"]) == 0
        ring = dist_sharded_hostring(index, [cuda_device] * 4, tile=8)
        runs[impl] = (counts, ring, kernel.launches - before)
    # 6 tiles twice; the ring: 4 steps x 2 x 2 sub-tile pairs x 4 positions
    assert runs["mxu"][2] == runs["auto"][2] == 6 + 6 + 4 * 2 * 2 * 4
    assert (tmp_path / "mxu.tsv").read_bytes() == (tmp_path / "auto.tsv").read_bytes()
    want = runs["auto"][0]
    for c in ("shared", "union", "inter"):
        assert np.array_equal(runs["mxu"][0][c], want[c]), c
        assert np.array_equal(runs["mxu"][1][c], runs["auto"][1][c]), c
        assert np.array_equal(runs["mxu"][1][c], np.triu(want[c]) + np.triu(want[c], 1).T), c


@pytest.mark.parametrize("mxu", [False, True], ids=["k3", "mxu"])
def test_hostring_from_card_planes_builds_no_host_table(cuda_device, monkeypatch, mxu):
    """A raw index with device planes on the card: the host ring cuts its
    blocks there (index_to_device never runs) and equals the host-planes
    run."""
    from miekki_tpu_torch.index.store import SketchIndex, index_to_device
    from miekki_tpu_torch.parallel import allvsall, dist_sharded_hostring

    if mxu:
        monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    index = _family_index(np.random.default_rng(14), 45, 2000, False)
    want = dist_sharded_hostring(index, [cuda_device] * 4, tile=8)
    planes = SketchIndex(index.params, index.names, index.hi, index.lo)
    planes.device_planes = index_to_device(index, cuda_device)
    built = []
    monkeypatch.setattr(allvsall, "index_to_device",
                        lambda idx, *a, **kw: built.append(idx) or index_to_device(idx, *a, **kw))
    got = dist_sharded_hostring(planes, [cuda_device] * 4, tile=8)
    assert built == []
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], want[c]), c


def test_mxu_ring_one_rank_nccl_and_two_gloo_ranks(cuda_device):
    """The tool's mxu modes (MIEKKI_INTERSECT=mxu) on a one-rank NCCL group
    and over two gloo ranks on the card: the collective ring launches K3
    (K4 on the compact index) and equals one device."""
    import json

    for argv in (("--ranks", "1", "--modes", "mxu_square,mxu_compact"),
                 ("--ranks", "2", "--backend", "gloo", "--modes",
                  "mxu_square,mxu_rect,mxu_compact")):
        out = _ring_tool(*argv, "--genomes", "48", "-s", "500")
        lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        modes = [ln for ln in lines if ln.get("mode", "").startswith("mxu_")]
        assert modes and all(ln["equal"] for ln in modes)
        assert all(ln["launches"]["k4" if ln["mode"] == "mxu_compact" else "k3"] > 0
                   for ln in modes)
        assert ('"backend": "nccl"' if argv[1] == "1" else '"device": "cuda:0"') in out


# ---- the reference's selectable routes on the card


@pytest.mark.parametrize("strategy", ["threshold", "sort"])
def test_merge_strategies_on_card_equal_tree(cuda_device, strategy):
    """MIEKKI_MERGE=threshold|sort on the card: K1 every step, the same
    sketches as tree on the card and as the CPU path (16 genomes of 600 kb
    at 2^17-window steps, so threshold compacts and falls back per genome)."""
    rng = np.random.default_rng(21)
    genomes = [rng.integers(0, 4, size=600_000).astype(np.uint8) for _ in range(4)]
    rows = torch.from_numpy(np.stack([TS.chunk_codes(g, 31, 8192) for g in genomes]))
    want = TS.sketch_chunked(rows.to(cuda_device), 31, 1000, group=16, strategy="tree")
    before = TCH.hash_windows_cuda.launches
    got = TS.sketch_chunked(rows.to(cuda_device), 31, 1000, group=16, strategy=strategy)
    assert TCH.hash_windows_cuda.launches - before == -(-rows.shape[1] // 16)
    assert torch.equal(got, want)
    cpu = TS.sketch_chunked(rows, 31, 1000, group=16, strategy=strategy)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("impl", ["bitonic", "searchsorted"])
@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_tile_routes_on_card_equal_k3_and_launch_none(cuda_device, monkeypatch, impl,
                                                      compact):
    """MIEKKI_INTERSECT=bitonic|searchsorted on the card: dist_counts_matrix
    and the host ring over [cuda:0] * 3 equal the K3/K4 run's, with no
    K3/K4 launch."""
    from miekki_tpu_torch.parallel import dist_sharded_hostring

    index = _family_index(np.random.default_rng(14), 45, 2000, compact)
    kernel = TCI32.tile_counts32_cuda if compact else TCI.tile_counts_cuda
    want = engine.dist_counts_matrix(index, tile=16, device=cuda_device)
    monkeypatch.setenv("MIEKKI_INTERSECT", impl)
    before = kernel.launches
    got = engine.dist_counts_matrix(index, tile=16, device=cuda_device)
    ring = dist_sharded_hostring(index, [cuda_device] * 3, tile=8)
    assert kernel.launches == before
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], want[c]), c
        assert np.array_equal(ring[c], np.triu(want[c]) + np.triu(want[c], 1).T), c


@pytest.mark.parametrize("depth", ["0", "1", "3", "8"])
def test_pipeline_depths_on_card_equal_cpu(cuda_device, monkeypatch, depth):
    """MIEKKI_PIPELINE on the card: dist_tiles' yields, the count matrices
    (K3 once a tile) and under mxu (with MIEKKI_PULL_GROUP and
    MIEKKI_PRESORT set, which act on nothing) equal the CPU's."""
    index = _family_index(np.random.default_rng(15), 45, 2000, False)
    want_tiles = list(engine.dist_tiles(index, tile=16, device="cpu"))
    want = engine.dist_counts_matrix(index, tile=16, device="cpu")
    monkeypatch.setenv("MIEKKI_PIPELINE", depth)
    before = TCI.tile_counts_cuda.launches
    got_tiles = list(engine.dist_tiles(index, tile=16, device=cuda_device))
    got = engine.dist_counts_matrix(index, tile=16, device=cuda_device)
    assert TCI.tile_counts_cuda.launches - before == 12
    assert [t[:2] for t in got_tiles] == [t[:2] for t in want_tiles]
    for a, b in zip(got_tiles, want_tiles):
        assert all(np.array_equal(x, y) for x, y in zip(a[2:], b[2:]))
    monkeypatch.setenv("MIEKKI_INTERSECT", "mxu")
    monkeypatch.setenv("MIEKKI_PULL_GROUP", "3")
    monkeypatch.setenv("MIEKKI_PRESORT", "1")
    mxu = engine.dist_counts_matrix(index, tile=16, device=cuda_device)
    for c in ("shared", "union", "inter"):
        assert np.array_equal(got[c], want[c]), c
        assert np.array_equal(mxu[c], want[c]), c


@pytest.mark.parametrize("join", ["merge", "searchsorted"])
def test_screen_joins_on_card_equal_cpu(cuda_device, tmp_path, monkeypatch, join):
    """MIEKKI_SCREEN_JOIN=merge|searchsorted with MIEKKI_SCREEN_CHUNK=999 on
    the card: the CPU's rows in plain and winner modes, K1 once a batch."""
    index, reads = _screen_inputs(tmp_path)
    monkeypatch.setenv("MIEKKI_SCREEN_JOIN", join)
    monkeypatch.setenv("MIEKKI_SCREEN_CHUNK", "999")
    for kw in ({}, {"winner": True}):
        stats = {}
        before = TCH.hash_windows_cuda.launches
        got = engine.screen(index, reads, flat=8192, stats=stats, device=cuda_device, **kw)
        assert TCH.hash_windows_cuda.launches - before == stats["n_batches"]
        assert got == engine.screen(index, reads, flat=8192, device="cpu", **kw), kw


@pytest.mark.parametrize("depth", ["0", "1", "8"])
def test_back_to_back_builds_on_card_reuse_their_pinned_staging(cuda_device, monkeypatch,
                                                                depth):
    """Two builds in one process at MIEKKI_PIPELINE 0, 1 and 8 give the
    CPU's sketches (12 batches, so the depth + 1 slots of the staging ring
    are rewritten within a build, each only after its copies), and the
    second allocates no staging buffer: the ring's pinned buffers outlive
    a build."""
    monkeypatch.setenv("MIEKKI_PIPELINE", depth)
    rng = np.random.default_rng(41)
    codes = [rng.integers(0, 4, n).astype(np.uint8)
             for n in [100_000] * 40 + [9_000] * 8]
    names = [f"g{i}" for i in range(len(codes))]
    params = SketchParams(k=31, s=1000)

    def build(dev):
        return engine._build_index_from_codes(codes, names, params, chunk=8192, batch=4,
                                              device=dev)

    want = build("cpu")
    staging = engine.code_staging(True)
    first = build(cuda_device)
    allocs = staging.allocs
    second = build(cuda_device)
    assert staging.allocs == allocs
    assert len(staging.slots) >= int(depth) + 1
    assert all(buf.is_pinned() for buf, _ in staging.slots[:int(depth) + 1])
    for idx in (first, second):
        assert np.array_equal(idx.hi, want.hi) and np.array_equal(idx.lo, want.lo)


def test_stripe_against_a_compact_db_on_card_planes_launches_k4_200_times(cuda_device):
    """A job of the benchmark's stripe cell at its sizes: rows [512, 1024) of
    a 102,400 x 10,000 compact DB held on the card as device planes, against
    the whole DB at tile 512, launches K4 200 times; every block is a
    lane-padded copy of the planes (lanes of 10,112) and nothing is
    uploaded; four 64 x 64 blocks of the matrices equal K4's plain version."""
    from miekki_tpu_torch.index.store import SketchIndex

    n, s, rows, tile = 102_400, 10_000, 512, 512
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(20)
    table = torch.empty((n, s), dtype=torch.int32, device=cuda_device)
    for o in range(0, n, 4096):
        v = torch.randint(0, 1 << 24, (4096, s), generator=gen, device=cuda_device)
        table[o:o + 4096] = TC.compact_rows(u64.to_keys(torch.sort(v, dim=1).values))
    codes = TC.codes_from_keys32(table)
    params = SketchParams(k=31, s=s, compact=True)
    db = SketchIndex(params, [f"g{i}" for i in range(n)], codes, TC.lo_plane_np(codes))
    db.device_planes = table
    part = slice(rows, 2 * rows)
    stripe = SketchIndex(params, db.names[part], db.hi[part], db.lo[part])
    stripe.device_planes = table[part]
    engine.reset_block_counts()
    before = TCI32.tile_counts32_cuda.launches
    counts = engine.dist_counts_matrix(stripe, db, tile=tile, device=cuda_device)
    torch.cuda.synchronize()
    assert TCI32.tile_counts32_cuda.launches == before + n // tile
    blocks = engine.BLOCK_COUNTS
    assert blocks["plane_loads"] == blocks["loads"] == 1 + n // tile
    assert blocks["plane_bytes"] == (1 + n // tile) * tile * s * 4
    assert blocks["bytes_uploaded"] == 0
    for c0 in (0, 512, 51_200, n - 64):
        want = TI.tile_counts_compact_plain(TI._pad_lane(table[rows:rows + 64]),
                                            TI._pad_lane(table[c0:c0 + 64]), s)
        for key, name in (("shared_in_x", "shared"), ("union_size", "union"),
                          ("inter_full", "inter")):
            assert np.array_equal(want[key].cpu().numpy(), counts[name][:64, c0:c0 + 64])
    assert np.array_equal(np.diagonal(counts["inter"][:, rows:2 * rows]), stripe.sizes())
