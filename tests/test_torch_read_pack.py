"""The native read pack pass (io.read_pack, csrc/read_pack.cpp) on the CPU.

On files of one chunk its rows, with each row's reads and bases, equal a
plain model of the layout (each chunk's records joined by k - 1 INVALID
separators and cut into overlapping rows of flat + k - 1 at a stride of
flat), built from the pure-Python reader's records; the rows equal the
reference's native packer's (miekki_tpu.engine._packed_read_batches), and,
where the whole file fits in one row, the port's Python packer's rows and
counts.  On files of many chunks the reads, the bases and the sorted valid
k-mer keys of all rows equal the Python packer's.  Malformed files raise the
native stream reader's errors, with its messages."""

import gzip
import zlib

import numpy as np
import pytest
import torch

from miekki_tpu import engine as J
from miekki_tpu.io import native as j_native
from miekki_tpu_torch import engine as T
from miekki_tpu_torch.io import encode, read_pack, reader
from miekki_tpu_torch.ops import u64

K = 21
SMALL_FLAT = 256  # rows of 256 + 20 codes: most files take many
ONE_ROW = 1 << 20  # every one-chunk file here fits in one row


def _seq(rng, n, alphabet=b"ACGT"):
    return bytes(rng.choice(list(alphabet), size=n).astype(np.uint8))


def _fastq(records, eol=b"\n", blank_every=0):
    out = []
    for i, (name, seq) in enumerate(records):
        out.append(b"@" + name + eol + seq + eol + b"+" + eol + b"I" * len(seq) + eol)
        if blank_every and i % blank_every == 0:
            out.append(b"\n")
    return b"".join(out)


def _fasta(records, width=0, eol=b"\n", blank_every=0):
    out = []
    for name, seq in records:
        out.append(b">" + name + eol)
        lines = [seq[a:a + width] for a in range(0, len(seq), width)] if width else [seq]
        for j, line in enumerate(lines):
            out.append(line + eol)
            if blank_every and j % blank_every == 0:
                out.append(eol)
    return b"".join(out)


def _reads(rng, n, lo, hi):
    return [(b"r%d some description" % i, _seq(rng, int(rng.integers(lo, hi))))
            for i in range(n)]


def _case(name):
    """The bytes of a one-chunk test file."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "fastq":
        return _fastq(_reads(rng, 60, 40, 220))
    if name == "fasta":
        return _fasta(_reads(rng, 12, 100, 900))
    if name == "fasta_multiline":
        return _fasta(_reads(rng, 8, 50, 700), width=60, blank_every=5)
    if name == "fastq_crlf_blank":
        return _fastq(_reads(rng, 40, 30, 200), eol=b"\r\n", blank_every=7)
    if name == "fasta_crlf_blank":
        return _fasta(_reads(rng, 8, 30, 500), width=70, eol=b"\r\n", blank_every=3)
    if name == "iupac":
        return _fastq([(b"r%d" % i, _seq(rng, int(rng.integers(30, 200)),
                                         b"ACGTacgtNNRYKMSWBDHVn-.*"))
                       for i in range(50)])
    if name == "every_byte":  # each byte value but the newline, inside a line
        body = bytes(b for b in range(256) if b != ord("\n"))
        return _fasta([(b"a", b"AC" + body + b"GT"), (b"b", body[::-1] + b"acgt")], width=50)
    if name == "shorter_than_k":
        lengths = [150] + [int(x) for x in rng.integers(0, K, size=40)] + [K, K - 1, 150]
        return _fastq([(b"r%d" % i, _seq(rng, n)) for i, n in enumerate(lengths)])
    if name == "longer_than_flat":
        recs = _reads(rng, 6, 50, 200)
        recs.insert(3, (b"long", _seq(rng, 5000)))
        return _fasta(recs, width=80)
    if name == "gzip":
        return gzip.compress(_fastq(_reads(rng, 60, 40, 220)))
    if name == "gzip_two_members":
        return (gzip.compress(_fastq(_reads(rng, 30, 40, 220)))
                + gzip.compress(_fastq(_reads(rng, 30, 40, 220))))
    raise KeyError(name)


CASES = ["fastq", "fasta", "fasta_multiline", "fastq_crlf_blank", "fasta_crlf_blank", "iupac",
         "every_byte", "shorter_than_k", "longer_than_flat", "gzip", "gzip_two_members"]


def _model_rows(path, k, flat):
    """(row, reads, bases) of the one-chunk layout, from the Python reader."""
    codes = [encode.encode(seq) for _, seq in reader.read_records(path)]
    gap = k - 1
    firsts, pos = [], 0
    for i, c in enumerate(codes):
        pos += gap if i else 0
        firsts.append(pos)
        pos += len(c)
    if sum(len(c) for c in codes) == 0:
        return []
    n_rows = -(-pos // flat)
    stream = np.full(n_rows * flat + gap, encode.INVALID_CODE, np.uint8)
    is_base = np.zeros(n_rows * flat, bool)
    for first, c in zip(firsts, codes):
        stream[first:first + len(c)] = c
        is_base[first:first + len(c)] = True
    reads = np.bincount(np.minimum(np.asarray(firsts) // flat, n_rows - 1), minlength=n_rows)
    bases = is_base.reshape(n_rows, flat).sum(1)
    return [(stream[r * flat:r * flat + flat + gap], int(reads[r]), int(bases[r]))
            for r in range(n_rows)]


def _python_rows(path, k, flat):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(read_pack, "available", lambda: False)
        rows = list(T._packed_read_rows(path, k, flat))
    assert not any(native for *_, native in rows)
    return [(row.numpy(), n, b) for row, n, b, _ in rows]


def _pass_rows(path, k, flat, **kw):
    return [(row.numpy(), n, b) for row, n, b in read_pack.rows(path, k, flat, **kw)]


def _same_rows(got, want):
    assert len(got) == len(want)
    for (a, n, b), (x, m, c) in zip(got, want):
        assert a.dtype == x.dtype == np.uint8
        assert np.array_equal(a, x) and (n, b) == (m, c)


def _valid_keys(rows, k):
    keys = [T._hash_batch(torch.from_numpy(row), k).numpy() for row, _, _ in rows]
    keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    return np.sort(keys[keys != u64.INF_KEY])


@pytest.fixture(autouse=True)
def _built():
    assert read_pack.available() and j_native.available()
    read_pack.reset_read_pack_counts()


@pytest.mark.parametrize("flat", [SMALL_FLAT, ONE_ROW], ids=["rows", "one_row"])
@pytest.mark.parametrize("case", CASES)
def test_one_chunk_rows_equal_the_model_and_the_reference(tmp_path, case, flat):
    path = tmp_path / f"{case}.seq"
    path.write_bytes(_case(case))
    got = _pass_rows(path, K, flat)
    _same_rows(got, _model_rows(path, K, flat))
    assert len(got) >= (1 if flat == ONE_ROW else 2)
    want = list(J._packed_read_batches(str(path), K, flat))
    assert len(want) == len(got)
    assert all(np.array_equal(a, w) for (a, _, _), w in zip(got, want))
    if flat == ONE_ROW:
        _same_rows(got, _python_rows(path, K, flat))
    else:
        assert np.array_equal(_valid_keys(got, K), _valid_keys(_python_rows(path, K, flat), K))
    counts = read_pack.READ_PACK_COUNTS
    assert counts["chunks"] == 1 and counts["native_batches"] == len(got)
    assert counts["text_bytes"] == len(gzip.decompress(path.read_bytes())
                                       if case.startswith("gzip") else path.read_bytes())
    assert counts["pinned_allocs"] == 0


def _many_chunks(name, tmp_path):
    rng = np.random.default_rng(7)
    if name == "fastq":
        data = _fastq(_reads(rng, 1500, 0, 300), blank_every=97)
    elif name == "fastq_gzip_members":
        data = b"".join(gzip.compress(_fastq(_reads(rng, 500, 60, 250), eol=b"\r\n"))
                        for _ in range(3))
    else:  # FASTA with a record far longer than a chunk
        recs = _reads(rng, 200, 100, 2000)
        recs.insert(150, (b"long", _seq(rng, 60_000, b"ACGTN")))
        data = _fasta(recs, width=61)
    path = tmp_path / f"{name}.seq"
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("name", ["fastq", "fastq_gzip_members", "fasta_long_record"])
def test_many_chunks_keep_every_read_base_and_window(tmp_path, name):
    path = _many_chunks(name, tmp_path)
    got = _pass_rows(path, K, 4096, chunk_bytes=20_000)
    want = _python_rows(path, K, 4096)
    assert read_pack.READ_PACK_COUNTS["chunks"] > 5
    assert sum(n for _, n, _ in got) == sum(n for _, n, _ in want) > 0
    assert sum(b for _, _, b in got) == sum(b for _, _, b in want) > 0
    assert np.array_equal(_valid_keys(got, K), _valid_keys(want, K))
    text = path.read_bytes()
    text = gzip.decompress(text) if name.endswith("members") else text
    assert read_pack.READ_PACK_COUNTS["text_bytes"] == len(text)


GOOD = b"@r1\nACGT\n+\nIIII\n@r2\nACGTACGT\n+\nIIIIIIII\n"
BAD = {
    "truncated_fastq": GOOD + b"@r3\nACG",
    "quality_length": GOOD + b"@r3\nACGT\n+\nIII\n",
    "missing_plus": GOOD + b"@r3\nACGT\nIIII\n",
    "empty": b"",
    "not_a_sequence_file": b"hello\n",
    "crlf_blank_line": b"@r1\r\nACGT\r\n+\r\nIIII\r\n\r\n@r2\r\nAC\r\n+\r\nII\r\n",
    "truncated_gzip": gzip.compress(GOOD * 100)[:-20],
    "late_quality_length": GOOD * 3000 + b"@r3\nACGT\n+\nIIIII\n" + GOOD,
}


@pytest.mark.parametrize("case", [*BAD, "missing_file"])
def test_malformed_files_raise_the_stream_readers_errors(tmp_path, case):
    path = tmp_path / "bad.fq"
    if case != "missing_file":
        path.write_bytes(BAD[case])
    with pytest.raises(ValueError) as want:
        list(j_native.stream_encoded_native(path))
    with pytest.raises(ValueError) as got:
        list(read_pack.rows(path, K, SMALL_FLAT, chunk_bytes=4096))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as whole:
        list(T._packed_read_rows(path, K, SMALL_FLAT))
    assert str(whole.value) == str(want.value)


def test_a_gzip_file_cut_inside_its_second_member_raises(tmp_path):
    """The data of a member that ends early is an error, never a short
    stream, as the pure-Python reader's EOFError."""
    second = gzip.compress(GOOD * 50)
    path = tmp_path / "cut.fq.gz"
    path.write_bytes(gzip.compress(GOOD) + second[:len(second) // 2])
    with pytest.raises(ValueError, match="gzip decompression failed"):
        list(read_pack.rows(path, K, SMALL_FLAT))
    with pytest.raises(EOFError):
        list(reader.read_records(path))


def test_arguments_are_checked(tmp_path):
    path = tmp_path / "r.fq"
    path.write_bytes(GOOD)
    for k, flat, chunk in ((0, 64, 10), (K, 0, 10), (K, 64, 0)):
        with pytest.raises(ValueError, match="must be positive"):
            list(read_pack.rows(path, k, flat, chunk_bytes=chunk))
    assert read_pack.READ_PACK_COUNTS["chunks"] == 0
