"""`cli screen` of a saved sketch index against FASTQ read sets, on the CPU,
with and without -p, against the benchmark's plain reference
(benchmark/reference/screen.py): every column equal as text, and each
p-value equal as text or within the benchmark judge's relative tolerance.
Seeded genomes in families (reads drawn from some members, the others
related or unrelated), genomes short enough that their sketches fall
short of s (one of them empty), reads with substitutions, runs of N,
reverse complements and one empty record, split over a plain and a
gzipped file, and k small enough that the read set's k-mers fill a share
of the 4^k space, so some p-values fall strictly between 0 and 1."""

import numpy as np
import pytest
import torch

from benchmark.jobs import screen as screen_job
from benchmark.reference import nthash
from benchmark.reference import screen as ref
from benchmark.yardstick import data
from miekki_tpu_torch import cli
from miekki_tpu_torch.index.store import SketchIndex
from miekki_tpu_torch.params import SketchParams

from fixtures import make_genome_family, mutate, reads_from_genome, write_fastq

CODE = np.full(256, 4, np.uint8)
CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
COMPLEMENT = bytes.maketrans(b"ACGTN", b"TGCAN")


def _codes(seq: bytes) -> torch.Tensor:
    return torch.from_numpy(CODE[np.frombuffer(seq, np.uint8)].copy())


def _genomes(rng):
    """Two families of 4 at 3 % substitution and 4 unrelated genomes, all
    of 3,000 bases, then genomes of 40 and 8 bases (a sketch short of s
    and an empty one)."""
    out = make_genome_family(rng, 4, 3000, 0.03) + make_genome_family(rng, 4, 3000, 0.03)
    out += [make_genome_family(rng, 1, 3000)[0] for _ in range(4)]
    return out + [make_genome_family(rng, 1, n)[0] for n in (40, 8)]


def _reads(rng, genomes):
    """Reads of 150 and 90 bases from members 0 and 1 of the first family
    and member 0 of the second, and random reads; then substitutions at
    1 %, an N run in every seventh read, every other read reverse
    complemented, and one empty record."""
    reads = (reads_from_genome(rng, genomes[0], 120, 150)
             + reads_from_genome(rng, genomes[1], 40, 90)
             + reads_from_genome(rng, genomes[4], 60, 150)
             + [make_genome_family(rng, 1, 150)[0] for _ in range(60)])
    out = []
    for i, r in enumerate(reads):
        r = bytearray(mutate(rng, r, 0.01))
        if i % 7 == 0:
            a, n = int(rng.integers(0, len(r) - 20)), int(rng.integers(3, 20))
            r[a:a + n] = b"N" * n
        r = bytes(r)
        out.append(r.translate(COMPLEMENT)[::-1] if i % 2 else r)
    return out[:100] + [b""] + out[100:]


@pytest.fixture(scope="module", params=[(2 ** 31 + 3, 9, 64), (977, 11, 128), (41, 13, 48)],
                ids=["k9", "k11", "k13"])
def case(request, tmp_path_factory):
    seed, k, s = request.param
    tmp = tmp_path_factory.mktemp(f"screen_ref_{k}")
    rng = np.random.default_rng(seed)
    genomes = _genomes(rng)
    names = [f"g{i}" for i in range(len(genomes))]
    table = nthash.sketch_table(
        [nthash.bottom_s(nthash.canonical_keys(_codes(g), k), s) for g in genomes], s)
    values = data.u64_table(table)
    db = tmp / "db.npz"
    SketchIndex(SketchParams(k=k, s=s), names, (values >> np.uint64(32)).astype(np.uint32),
                (values & np.uint64(0xFFFFFFFF)).astype(np.uint32)).save(db)
    reads = _reads(rng, genomes)
    half = len(reads) // 2
    files = [str(write_fastq(tmp / "a.fq", [(f"r{i}", r) for i, r in enumerate(reads[:half])])),
             str(write_fastq(tmp / "b.fq.gz", [(f"s{i}", r) for i, r in enumerate(reads[half:])],
                             gz=True))]
    h = ref.distinct_hashes([_codes(r) for r in reads], k)
    return {"tmp": tmp, "k": k, "s": s, "db": str(db), "files": files, "names": names,
            "table": table, "h": h}


def _screen(case, *extra):
    out = case["tmp"] / f"screen{'-'.join(extra)}.tsv"
    assert cli.main(["screen", case["db"], *case["files"], *extra, "-o", str(out),
                     "--device", "cpu"]) == 0
    return out.read_bytes()


def test_the_inputs_cover_the_cases(case):
    sizes = (case["table"] != nthash.INF_KEY).sum(1).tolist()
    assert sizes[-1] == 0 and 0 < sizes[-2] < case["s"] and max(sizes) == case["s"]
    assert case["h"].shape[0] > ref.KMV_S0  # the KMV estimate, not an exact count
    want = ref.tsv(case["table"], case["names"], case["h"], case["k"])
    p = [float(line.split("\t")[-1]) for line in want.split("\n")[1:-1]]
    assert sum(0 < x < 1 for x in p) >= 2, p


@pytest.mark.parametrize("flat", ["4194304", "2048"])
def test_screen_with_p_values_equals_the_reference(case, flat):
    got = _screen(case, "-p", "--flat", flat)
    want = ref.tsv(case["table"], case["names"], case["h"], case["k"]).encode()
    assert screen_job.rows_wrong(got, want) == 0


def test_screen_without_p_values_equals_the_reference(case):
    got = _screen(case)
    want = ref.tsv(case["table"], case["names"], case["h"], case["k"], p_value=False)
    assert got == want.encode()


def test_a_p_value_off_by_1e8_reads_wrong(case):
    want = ref.tsv(case["table"], case["names"], case["h"], case["k"])
    lines = want.split("\n")
    i = next(i for i, line in enumerate(lines[1:-1], 1) if 0 < float(line.split("\t")[-1]) < 1)
    cols = lines[i].split("\t")
    cols[-1] = repr(float(cols[-1]) * (1 + 1e-8))
    lines[i] = "\t".join(cols)
    assert screen_job.rows_wrong("\n".join(lines).encode(), want.encode()) == 1
