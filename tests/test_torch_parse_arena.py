"""The FASTA arena parse (io.arena, csrc/fasta_arena.cpp) and build_index's
parse arena (engine._ParseArena) on the CPU.

A plain FASTA file parsed into a buffer of its own size gives the bytes of
encode.pack_records(reader.read_genome_codes(path), k), writing nothing
past the buffer; gzip, FASTQ and files whose codes do not fit in place are
declined and take the general reader.  build_index over every kind of file
saves the JAX package's index byte for byte, with the native reader on and
off and with no arena parser built (no compiler, a failing one); bad files
raise the general reader's errors; back-to-back builds on one thread reuse
the arena."""

import gzip
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from miekki_tpu import engine as jengine
from miekki_tpu.params import SketchParams as JParams
from miekki_tpu_torch import engine as tengine
from miekki_tpu_torch.io import arena, encode, native, reader
from miekki_tpu_torch.params import SketchParams as TParams
from miekki_tpu_torch.utils import profiling

from fixtures import random_seq

S = 200
KS = [16, 21, 31]
GUARD = 64  # bytes past the file's slice that the parser must leave alone


def _lines(seq: bytes, width: int, eol: bytes = b"\n") -> bytes:
    return b"".join(seq[i:i + width] + eol for i in range(0, len(seq), width))


def _cases():
    """{name: (file bytes, taken by the arena parser)}"""
    rng = np.random.default_rng(21)
    g = [random_seq(rng, n) for n in (3000, 5000, 2500, 1_000_017)]
    iupac = bytes(rng.choice(list(b"ACGTacgtNRYKMSWBDHVn-"), 4000).tolist())
    return {
        "single-80": (b">g0 one record\n" + _lines(g[0], 80), True),
        "multi-60-empty-record": (
            b">contig_1 first record of three\n" + _lines(g[1], 60)
            + b">contig_2 an empty record\n"
            + b">contig_3 last record\n" + _lines(g[2], 60), True),
        "header-only": (b">nothing here\n", True),
        "crlf-lower-iupac": (
            b">mixed case and IUPAC codes\r\n" + _lines(iupac, 70, b"\r\n")
            + b">lower\r\n" + _lines(g[0].lower(), 70, b"\r\n"), True),
        "all-n": (b">all N\n" + _lines(b"N" * 3000, 80), True),
        "line-1000000": (b">long line\n" + _lines(g[3], 1_000_000), True),
        "no-final-newline": (b">g\n" + _lines(g[2], 80)[:-1], True),
        "tiny-records": (b"".join(b">%d\n%s\n" % (i % 10, g[0][i:i + 3])
                                  for i in range(400)), False),
        "gzip": (gzip.compress(b">gz\n" + _lines(g[1], 80)), False),
        "fastq": (b"".join(b"@r%d\n%s\n+\n%s\n" % (i, g[0][i:i + 150], b"I" * 150)
                           for i in range(0, 2800, 150)), False),
    }


CASES = _cases()
BAD = {"empty": b"", "bad-first-byte": b"ACGT\n>g\nACGT\n"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("arena")
    out = {}
    for name, (data, _) in {**CASES, **{n: (d, False) for n, d in BAD.items()}}.items():
        out[name] = tmp / f"{name}.fa"
        out[name].write_bytes(data)
    return out


@pytest.fixture(scope="module")
def reference(files):
    """The JAX package's index of every good file, at each k."""
    paths = [str(files[name]) for name in CASES]
    return {k: jengine.build_index(paths, JParams(k=k, s=S)) for k in KS}


def _same_index(got, want, tmp, tag):
    assert got.names == want.names
    got.save(tmp / f"t-{tag}.npz")
    want.save(tmp / f"j-{tag}.npz")
    with np.load(tmp / f"t-{tag}.npz") as a, np.load(tmp / f"j-{tag}.npz") as b:
        assert set(a.files) == set(b.files) == {"header", "hi", "lo"}
        for m in b.files:
            assert a[m].dtype == b[m].dtype and a[m].tobytes() == b[m].tobytes(), m


def _traced_build(paths, k):
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        index = tengine.build_index(paths, TParams(k=k, s=S), device="cpu")
    parse = dict(profiling.SPANS["sketch.parse"])
    profiling.reset_spans()
    return index, parse


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", list(CASES))
def test_arena_parse_equals_the_reader(files, case, k):
    assert arena.available() and native.available()
    path = files[case]
    size = path.stat().st_size
    buf = np.full(size + GUARD, 0xEE, dtype=np.uint8)
    n = arena.parse_into(path, buf[:size], k)
    want = encode.pack_records(reader.read_genome_codes(path), k)
    taken = CASES[case][1]
    assert (n is not None) == taken
    if taken:
        assert n == len(want)
        assert buf[:n].tobytes() == want.tobytes()
    assert (buf[size:] == 0xEE).all()


@pytest.mark.parametrize("k", KS)
def test_arena_parse_declines_a_short_buffer(files, k):
    path = files["single-80"]
    buf = np.zeros(path.stat().st_size - 1, dtype=np.uint8)
    assert arena.parse_into(path, buf, k) is None


# how build_index may find the parsers: {route: (MIEKKI_NATIVE_IO, $CXX)}
ROUTES = {"arena": ("1", None), "native-off": ("0", None),
          "no-compiler": ("1", "no-such-compiler"), "build-fails": ("1", "false")}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("k", KS)
def test_build_index_saves_the_reference_index(files, reference, tmp_path, monkeypatch,
                                              k, route):
    """Every case in one build (more than 4 files: the threaded parse), the
    arena taking the files it takes; with the native reader off
    (MIEKKI_NATIVE_IO=0) or no arena parser to build, none."""
    native_io, cxx = ROUTES[route]
    monkeypatch.setenv("MIEKKI_NATIVE_IO", native_io)
    monkeypatch.setattr(native, "_lib", native._lib)
    monkeypatch.setattr(native, "_lib_checked", False)
    if cxx is not None:
        monkeypatch.setenv("CXX", cxx)
        monkeypatch.setattr(arena, "_lib", None)
        monkeypatch.setattr(arena, "_checked", False)
    paths = [str(files[name]) for name in CASES]
    index, parse = _traced_build(paths, k)
    assert arena.available() == (cxx is None)
    _same_index(index, reference[k], tmp_path, f"{k}-{route}")
    taken = sum(t for _, t in CASES.values())
    assert parse["arena_files"] == (taken if route == "arena" else 0)
    assert parse["bases"] == sum(len(encode.pack_records(reader.read_genome_codes(p), k))
                                 for p in paths)


@pytest.mark.parametrize("case", list(BAD) + ["missing"])
def test_bad_files_raise_the_readers_errors(files, tmp_path, case):
    path = files[case] if case in BAD else tmp_path / "missing.fa"
    with pytest.raises(Exception) as want:
        reader.read_genome_codes(path)
    good = [str(files[name]) for name in ("single-80", "all-n")]
    for paths in ([str(path)], good + [str(path)] + good):  # serial and threaded
        with pytest.raises(type(want.value)) as got:
            tengine.build_index(paths, TParams(k=21, s=S), device="cpu")
        assert str(got.value) == str(want.value)


def test_back_to_back_builds_reuse_the_arena(files, reference, tmp_path):
    """On a fresh thread: the first build allocates the arena, a second
    over the same files allocates nothing, a larger third grows it once;
    every index is the reference's."""
    small = [str(files[name]) for name in CASES if name != "line-1000000"]
    every = [str(files[name]) for name in CASES]
    want_small = jengine.build_index(small, JParams(k=31, s=S))
    seen = []

    def builds():
        ar = tengine.parse_arena()
        for paths in (small, small, every):
            index = tengine.build_index(paths, TParams(k=31, s=S), device="cpu")
            seen.append((index, ar.allocs, ar.buf.size))

    t = threading.Thread(target=builds)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and len(seen) == 3
    assert [allocs for _, allocs, _ in seen] == [1, 1, 2]
    sizes = [sum(files[n].stat().st_size for n in CASES if str(files[n]) in p)
             for p in (small, small, every)]
    assert [size for _, _, size in seen] == sizes
    for i, (index, _, _) in enumerate(seen):
        _same_index(index, want_small if i < 2 else reference[31], tmp_path, f"reuse{i}")
