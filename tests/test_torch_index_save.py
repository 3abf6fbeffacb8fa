"""SketchIndex.save through the port's pieced zip writer (index.npz), on the
CPU at tiny sizes.

Parity is of the members: the zip entries carry their write times, so no
two saves of one index are byte-identical, with either writer.  For each
index (empty, one genome, members under one piece, members of many pieces
with a short tail or none, the zip64 records forced by a low limit), in
the raw and the compact format, the file's member names, order, dtypes and
bytes are np.savez_compressed's, the zip tests clean, every local header
carries a zip64 extra as numpy's do, both packages load the same index, and
the file is within 1 % of np.savez_compressed's.  A `cli sketch` counts
its pieces in SAVE_COUNTS and in its `index.save` span, and an index of
one piece a member deflates on the calling thread alone.  Saves from many
threads at once share the pool, and a write that fails raises."""

import io
import json
import math
import struct
import sys
import threading
import zipfile
import zlib

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from miekki_tpu.index.store import SketchIndex as JaxSketchIndex
from miekki_tpu_torch import cli
from miekki_tpu_torch.index import npz
from miekki_tpu_torch.index.store import SketchIndex
from miekki_tpu_torch.params import SketchParams
from miekki_tpu_torch.utils import profiling
from miekki_tpu_torch.utils.profiling import SPANS

from fixtures import make_genome_family, write_fasta

# name: (genomes, s, piece bytes or None for the default, zip64 limit or None)
CASES = {
    "empty": (0, 64, None, None),
    "one_genome": (1, 64, None, None),
    "under_one_piece": (8, 200, None, None),
    # hi and lo members of 128 + 16 * 4100 * 4 bytes: 16 whole pieces and 384
    "pieces_short_tail": (16, 4100, 16384, None),
    # 128 + 16 * 4094 * 4 = 16 * 16384 bytes: no tail
    "pieces_no_tail": (16, 4094, 16384, None),
    "zip64_records": (16, 4100, 16384, 1000),
}


def _index(n, s, compact, seed=5):
    rng = np.random.default_rng(seed)
    sketches = []
    for i in range(n):
        pool = np.unique(rng.integers(0, 2 ** 64 - 1, size=2 * s, dtype=np.uint64))
        sketches.append(np.sort(rng.choice(pool, size=s - i % 3, replace=False)))
    index = SketchIndex.from_sketches(sketches, [f"genome_{i}" for i in range(n)],
                                      SketchParams(k=21, s=s))
    return index.to_compact() if compact else index


def _members(path):
    with np.load(path) as z:
        return [(name, z[name].dtype.str, z[name].tobytes()) for name in z.files]


def _extras(extra):
    """{header id: data} of a zip extra field."""
    out = {}
    while extra:
        tag, size = struct.unpack("<HH", extra[:4])
        out[tag] = extra[4:4 + size]
        extra = extra[4 + size:]
    return out


def _local_headers_agree(path):
    """Whether every entry's local header holds a zip64 extra with the
    entry's sizes and the entry's CRC, as the central directory has them,
    and its data inflates as one raw-deflate stream that ends (a final
    block) exactly at the entry's end."""
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            f.seek(info.header_offset)
            head = f.read(30)
            crc, name_len, extra_len = struct.unpack("<L8xHH", head[14:30])
            f.seek(name_len, 1)
            zip64 = _extras(f.read(extra_len)).get(1)
            d = zlib.decompressobj(-15)
            raw = d.decompress(f.read(info.compress_size)) + d.flush()
            if (head[:4] != b"PK\x03\x04" or crc != info.CRC or zip64 is None
                    or struct.unpack("<QQ", zip64) != (info.file_size, info.compress_size)
                    or not d.eof or d.unused_data or len(raw) != info.file_size):
                return False
    return True


def _central_zip64(path):
    """Each entry's zip64 extra in the central directory, its length, and
    whether the zip64 end records precede the end record (22 bytes, no
    comment)."""
    with zipfile.ZipFile(path) as zf:
        extras = [len(_extras(i.extra).get(1, b"")) for i in zf.infolist()]
    with open(path, "rb") as f:
        f.seek(-42, 2)
        return extras, f.read(4) == b"PK\x06\x07"


@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
@pytest.mark.parametrize("case", list(CASES))
def test_save_matches_savez_compressed(tmp_path, monkeypatch, case, compact):
    n, s, piece, limit = CASES[case]
    if piece is not None:
        monkeypatch.setattr(npz, "PIECE_BYTES", piece)
    if limit is not None:  # both writers move what passes it into zip64 records
        monkeypatch.setattr(zipfile, "ZIP64_LIMIT", limit)
    index = _index(n, s, compact)
    path = tmp_path / "index.npz"
    npz.reset_save_counts()
    index.save(path)

    ref = tmp_path / "reference.npz"
    arrays = {"header": np.frombuffer(json.dumps(index._header()).encode(), dtype=np.uint8),
              "hi": index.hi}
    if not compact:
        arrays["lo"] = index.lo
    with open(ref, "wb") as f:
        np.savez_compressed(f, **arrays)

    members = _members(path)
    assert [m[0] for m in members] == (["header", "hi"] if compact else ["header", "hi", "lo"])
    assert members == _members(ref)
    with zipfile.ZipFile(path) as zf:
        assert zf.testzip() is None
        infos = zf.infolist()
        sizes = [i.file_size for i in infos]
    assert _local_headers_agree(path) and _local_headers_agree(ref)
    assert _central_zip64(path) == _central_zip64(ref)
    assert _central_zip64(path)[1] == any(_central_zip64(path)[0]) == (limit is not None)

    pieces = sum(math.ceil(b / npz.PIECE_BYTES) for b in sizes)
    assert npz.SAVE_COUNTS["members"] == len(infos)
    assert npz.SAVE_COUNTS["pieces"] == pieces
    assert npz.SAVE_COUNTS["raw_bytes"] == sum(sizes)
    if piece is not None:
        assert pieces > 2 * len(infos)  # the planes are cut

    port, jax = SketchIndex.load(path), JaxSketchIndex.load(path)
    for loaded in (port, jax):
        assert loaded.names == index.names
        assert loaded.params.to_dict() == index.params.to_dict()
        np.testing.assert_array_equal(loaded.hi, index.hi)
        np.testing.assert_array_equal(loaded.lo, index.lo)
    assert abs(path.stat().st_size / ref.stat().st_size - 1) < 0.01


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("save_genomes")
    rng = np.random.default_rng(23)
    return [str(write_fasta(tmp / f"g{i}.fa", [(f"g{i}", seq)]))
            for i, seq in enumerate(make_genome_family(rng, 4, 5000))]


def _sketch_traced(genomes, out):
    profiling.reset_spans()
    npz.reset_save_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.main(["sketch", *genomes, "-o", str(out), "-k", "21", "-s", "200",
                         "--device", "cpu"]) == 0
    spans = {name: dict(rec) for name, rec in SPANS.items()}
    profiling.reset_spans()
    with zipfile.ZipFile(out) as zf:
        sizes = [i.file_size for i in zf.infolist()]
    return spans["index.save"], sizes


@pytest.mark.parametrize("piece", [None, 1024], ids=["one_piece_a_member", "cut"])
def test_sketch_counts_its_pieces(tmp_path, monkeypatch, genomes, piece):
    if piece is None:
        def no_pool():
            raise AssertionError("a file of one piece a member started the pool")
        monkeypatch.setattr(npz, "_deflate_pool", no_pool)
    else:
        monkeypatch.setattr(npz, "PIECE_BYTES", piece)
    out = tmp_path / "index.npz"
    save, sizes = _sketch_traced(genomes, out)
    pieces = sum(math.ceil(b / npz.PIECE_BYTES) for b in sizes)
    assert pieces == (3 if piece is None else 9)  # hi and lo: 128 + 3,200 bytes
    assert save["pieces"] == npz.SAVE_COUNTS["pieces"] == pieces
    assert save["bytes"] == out.stat().st_size
    assert npz.SAVE_COUNTS["members"] == len(sizes) == 3
    assert npz.SAVE_COUNTS["raw_bytes"] == sum(sizes)
    with zipfile.ZipFile(out) as zf:
        assert npz.SAVE_COUNTS["deflated_bytes"] == sum(i.compress_size for i in zf.infolist())


def test_concurrent_saves_share_the_pool(tmp_path, monkeypatch):
    """More saving threads than cores, each cutting its planes into many
    pieces on the one pool, with the interpreter switching threads often:
    every file holds its own index and the counts add up."""
    monkeypatch.setattr(npz, "PIECE_BYTES", 4096)
    indexes = [_index(4, 1000 + 37 * i, compact=i % 2 == 1, seed=i) for i in range(12)]
    paths = [tmp_path / f"index{i}.npz" for i in range(len(indexes))]
    npz.reset_save_counts()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ix.save, args=(p,)) for ix, p in zip(indexes, paths)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    sizes = []
    for ix, p in zip(indexes, paths):
        loaded = SketchIndex.load(p)
        assert loaded.names == ix.names
        np.testing.assert_array_equal(loaded.hi, ix.hi)
        np.testing.assert_array_equal(loaded.lo, ix.lo)
        with zipfile.ZipFile(p) as zf:
            sizes += [i.file_size for i in zf.infolist()]
    assert npz.SAVE_COUNTS["members"] == len(sizes) == 30
    assert npz.SAVE_COUNTS["pieces"] == sum(math.ceil(b / 4096) for b in sizes)
    assert npz.SAVE_COUNTS["raw_bytes"] == sum(sizes)


class _FullDisk(io.BytesIO):
    def write(self, data):
        if self.tell() + len(data) > 20000:
            raise OSError(28, "No space left on device")
        return super().write(data)


def test_a_failed_write_raises_and_leaves_the_pool_working(tmp_path, monkeypatch):
    monkeypatch.setattr(npz, "PIECE_BYTES", 4096)
    index = _index(8, 2000, compact=False)
    with pytest.raises(OSError):
        npz.write_npz(_FullDisk(), {"hi": index.hi, "lo": index.lo})
    index.save(tmp_path / "index.npz")
    np.testing.assert_array_equal(SketchIndex.load(tmp_path / "index.npz").lo, index.lo)
