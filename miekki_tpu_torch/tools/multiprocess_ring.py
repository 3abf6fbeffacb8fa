"""Multi-process runs of the port's distributed paths, one torch.distributed
rank per mesh position.

    python -m miekki_tpu_torch.tools.multiprocess_ring --ranks 2
        [--device cuda|cpu] [--backend nccl|gloo]
        [--modes square,rect,compact,screen,mxu_square,mxu_rect,mxu_compact]
        [--genomes 64] [-s 128] [--mxu-tile 512] [--die-after C] [--out DIR]
        [--timeout 120]

The orchestrator takes a free port (it binds port 0), spawns --ranks rank
processes of this module and waits for each under --timeout.  While the
ranks start, it builds a sketch index from one seed (numpy: families of
sketches, some rows short) and writes it to index.npz in the working
directory; every rank joins the group, loads the index and runs each
mode, holding the result bitwise against one device.  Ranks compute on the cards by default (rank
r on card r mod the cards; without a card the orchestrator raises), in an
NCCL group that moves blocks card to card; `--backend gloo` makes them a
gloo group whose blocks are staged through host buffers, and `--device
cpu` runs gloo ranks on the CPU.  Modes:

  square   parallel.dist_sharded self-comparison (the collective ring) vs
           engine.dist_counts_matrix, symmetrised;
  rect     the first half of the genomes against all of them;
  compact  the compact index's self-comparison (ring_rect_counts32, K4);
  screen   parallel.screen_sharded (merges by all_reduce) in plain, -w and
           -p modes vs engine.screen, over reads drawn from genomes that
           the orchestrator writes as FASTA/FASTQ, and in plain mode over
           the same reads cut into 4 files, which are dealt to the ranks
           (variant "files");
  mxu_square, mxu_rect, mxu_compact
           square, rect and compact under MIEKKI_INTERSECT=mxu: the
           collective stream-pass ring (ring_rect_counts_mxu, sub-tile
           --mxu-tile; forced on a one-rank group) and one resolve of its
           ambiguous pairs, vs the same one-device matrices; mxu_square
           also keeps the ring's (lb, ub, inter) brackets
           (mxu_brackets.npz with --out).

--die-after C first runs the chunked ring (ring_chunk_counts, one step a
chunk): each rank commits its rows of every chunk to
chunk{t}_rank{r}.npz, rank 1 exits with code 17 after committing its C-th
chunk, and once every rank has committed chunk C - 1 the orchestrator
kills the other ranks and starts them all again.  They resume at the
first chunk missing on any rank (all_reduce MIN), rank 0 checks that the
unrotated chunks of all ranks equal the one-device matrix, and then the
resumed ranks run --modes as above.

Each rank prints one JSON line per mode (K3/K4/K1 launches of its ring or
screen on a card; for the mxu modes also its stream passes and the pairs
it resolved); the orchestrator prints "ALL RANKS OK" and exits 0 when
every rank passed.  With --out (then the working directory), rank 0 also
writes the count matrices (counts_<mode>.npz) and the screen rows
(screen_<variant>.json) there, beside the index, the FASTA/FASTQ of the
screen and the chunk files.  GLOO_SOCKET_IFNAME defaults to lo, and
OMP_NUM_THREADS to 1 for CPU ranks.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_T0 = time.monotonic()  # this process's start, near enough: torch is imported later

K = 21
PER_FAMILY = 8
SEED = 20261017
FLAT = 4096   # packed read bases per screen batch: several batches per rank
DIE_CODE = 17
INDEX = "index.npz"
READ_PARTS = 4  # files of the screen's "files" variant


def make_index(n: int, s: int, seed: int, k: int = K):
    """n synthetic sketches at sketch size s in families of PER_FAMILY
    (members keep 95–50 % of a family base), every fourth one cut to 3/4 of
    s: the same index for the same arguments, in any process."""
    from ..index.store import SketchIndex
    from ..params import SketchParams

    rng = np.random.default_rng(seed)
    rates = np.linspace(0.05, 0.5, PER_FAMILY)
    sketches = []
    for f in range(-(-n // PER_FAMILY)):
        base = rng.integers(0, 2 ** 64 - 1, size=3 * s, dtype=np.uint64)
        for m in range(PER_FAMILY):
            keep = base[rng.random(base.size) >= rates[m]]
            fresh = rng.integers(0, 2 ** 64 - 1, size=3 * s - keep.size, dtype=np.uint64)
            sk = np.unique(np.concatenate([keep, fresh]))[:s]
            sketches.append(sk[: 3 * s // 4] if len(sketches) % 4 == 3 else sk)
    sketches = sketches[:n]
    return SketchIndex.from_sketches(sketches, [f"syn{i}" for i in range(n)],
                                     SketchParams(k=k, s=s))


def write_screen_inputs(workdir: Path, seed: int, n_genomes: int = 6,
                        genome_len: int = 20_000, n_reads: int = 400,
                        read_len: int = 100) -> None:
    """genome{g}.fa (FASTA) and reads.fq, reads drawn from the first half of
    the genomes at 1 % substitution, in workdir; the same reads cut in
    READ_PARTS consecutive parts as reads_part{i}.fq."""
    rng = np.random.default_rng(seed + 1)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = []
    for g in range(n_genomes):
        codes = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
        genomes.append(codes)
        (workdir / f"genome{g}.fa").write_bytes(b">genome%d\n" % g + acgt[codes].tobytes()
                                                 + b"\n")
    lines = []
    for i in range(n_reads):
        src = genomes[int(rng.integers(0, max(1, n_genomes // 2)))]
        start = int(rng.integers(0, genome_len - read_len + 1))
        c = src[start:start + read_len].copy()
        hit = rng.random(read_len) < 0.01
        c[hit] = (c[hit] + 1) % 4
        lines.append(b"@r%d\n%s\n+\n%s\n" % (i, acgt[c].tobytes(), b"I" * read_len))
    (workdir / "reads.fq").write_bytes(b"".join(lines))
    cuts = np.linspace(0, n_reads, READ_PARTS + 1).astype(int)
    for i in range(READ_PARTS):
        (workdir / f"reads_part{i}.fq").write_bytes(b"".join(lines[cuts[i]:cuts[i + 1]]))


def _launch_counts() -> dict:
    from ..ops import cuda_hash, cuda_intersect, cuda_intersect32, mxu_intersect

    return {"k3": cuda_intersect.tile_counts_cuda.launches,
            "k4": cuda_intersect32.tile_counts32_cuda.launches,
            "k1": cuda_hash.hash_windows_cuda.launches,
            "mxu_passes": mxu_intersect.PASS_COUNTS["full"],
            "mxu_resolved": mxu_intersect.PASS_COUNTS["resolved"]}


def _mxu_dist_sharded(a, mesh, b, tile: int):
    """parallel.dist_sharded under MIEKKI_INTERSECT=mxu (the collective
    stream-pass ring, forced on a one-rank group), the variable restored
    after."""
    from ..parallel import dist_sharded

    old = os.environ.get("MIEKKI_INTERSECT")
    os.environ["MIEKKI_INTERSECT"] = "mxu"
    try:
        return dist_sharded(a, mesh, index_b=b, tile=tile,
                            _traced_mxu=mesh.shape[next(iter(mesh.shape))] == 1)
    finally:
        if old is None:
            del os.environ["MIEKKI_INTERSECT"]
        else:
            os.environ["MIEKKI_INTERSECT"] = old


def _symmetric(counts: dict) -> dict:
    return {key: np.triu(m) + np.triu(m, 1).T for key, m in counts.items()}


def _emit(obj) -> None:
    """One JSON line in one write, so that lines of ranks sharing the
    orchestrator's stdout do not interleave (unbuffered, print writes the
    newline apart); `at_s` is the seconds since the process started."""
    sys.stdout.write(json.dumps({**obj, "at_s": round(time.monotonic() - _T0, 3)}) + "\n")
    sys.stdout.flush()


def _one_device(a, b, device, wants: dict, key: str) -> dict:
    """engine.dist_counts_matrix of a against b (symmetrised for a
    self-comparison), computed once per key in a rank."""
    from .. import engine

    if key not in wants:
        want = engine.dist_counts_matrix(a, b, device=device)
        wants[key] = _symmetric(want) if b is None else want
    return wants[key]


def _run_modes(args, rank: int, world: int, device, workdir: Path, index, wants: dict) -> bool:
    import torch

    from .. import engine
    from ..index.store import SketchIndex
    from ..params import SketchParams
    from ..parallel import dist_sharded, local_mesh, screen_sharded
    from ..parallel.mesh import DATA_AXIS

    out = Path(args.out) if args.out and rank == 0 else None
    mesh = local_mesh(device=args.device)
    ok = True
    for mode in args.modes.split(","):
        if mode == "screen":
            paths = sorted(str(p) for p in workdir.glob("genome*.fa"))
            db = engine.build_index(paths, SketchParams(k=K, s=args.s), device=device)
            reads = str(workdir / "reads.fq")
            parts = [str(workdir / f"reads_part{i}.fq") for i in range(READ_PARTS)]
            if out:
                db.save(out / "screen_db.npz")
            smesh = local_mesh(axis_names=(DATA_AXIS,), device=args.device)
            for variant, reads, kw in (("plain", reads, {}), ("winner", reads, {"winner": True}),
                                       ("p_values", reads, {"p_values": True}),
                                       ("files", parts, {})):
                before, t0 = _launch_counts(), time.perf_counter()
                got_stats, want_stats = {}, {}
                got = screen_sharded(db, reads, smesh, flat=FLAT, stats=got_stats, **kw)
                seconds = time.perf_counter() - t0
                launches = {k: v - before[k] for k, v in _launch_counts().items()}
                want = engine.screen(db, reads, flat=FLAT, stats=want_stats,
                                     device=device, **kw)
                equal = got == want and all(got_stats[c] == want_stats[c] for c in
                                            ("n_windows", "n_survivors", "survivor_rate"))
                ok &= equal
                if out:
                    (out / f"screen_{variant}.json").write_text(json.dumps(got))
                _emit({"rank": rank, "world": world, "mode": f"screen_{variant}",
                       "equal": equal, "seconds": seconds, "groups": got_stats["n_batches"],
                       "hits": sum(r["hits"] for r in got), "launches": launches})
            continue
        mxu = mode.startswith("mxu_")
        base = mode[4:] if mxu else mode
        a, b = index, None
        if base == "rect":
            half = len(index) // 2
            a = SketchIndex(index.params, index.names[:half], index.hi[:half], index.lo[:half])
            b = index
        elif base == "compact":
            a = index.to_compact()
        elif base != "square":
            raise SystemExit(f"unknown mode {mode!r}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        before, t0 = _launch_counts(), time.perf_counter()
        got = (_mxu_dist_sharded(a, mesh, b, args.mxu_tile) if mxu
               else dist_sharded(a, mesh, index_b=b))
        seconds = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in _launch_counts().items()}
        want = _one_device(a, b, device, wants, base)
        equal = all(got[c].dtype == np.int32 and np.array_equal(got[c], want[c]) for c in want)
        ok &= equal
        if out:
            np.savez(out / f"counts_{mode}.npz", **got)
        _emit({"rank": rank, "world": world, "mode": mode, "equal": equal,
               "shape": list(got["shared"].shape), "seconds": seconds,
               "launches": launches})
        if mode == "mxu_square":
            from ..index.store import index_to_device
            from ..parallel.allvsall import _pad_rows, ring_rect_counts_mxu

            n = len(index)
            table = _pad_rows(index_to_device(index, "cpu"), -(-n // world) * world)
            brackets = [m[:n, :n] for m in ring_rect_counts_mxu(
                table, table, s=index.params.s, mesh=mesh, tile=args.mxu_tile)]
            if out:
                np.savez(out / "mxu_brackets.npz",
                         **{k: m.numpy() for k, m in zip(("lb", "ub", "inter"), brackets)})
            _emit({"rank": rank, "world": world, "mxu_ambiguous":
                   int((brackets[0] != brackets[1]).sum())})
    return ok


def _chunk_path(workdir: Path, t: int, rank: int) -> Path:
    return workdir / f"chunk{t}_rank{rank}.npz"


def _run_chunks(args, rank: int, world: int, device, workdir: Path, index,
                wants: dict) -> bool:
    """The chunked ring with checkpoints; see the module docstring."""
    import torch
    import torch.distributed as dist

    from ..index.store import index_to_device
    from ..parallel import local_mesh
    from ..parallel.allvsall import ring_chunk_counts, unrotate_chunks

    n = len(index)
    if n % world:
        raise SystemExit(f"--genomes {n} must be a multiple of --ranks {world}")
    nl = n // world
    mesh = local_mesh(device=args.device)
    mine = next((t for t in range(world) if not _chunk_path(workdir, t, rank).exists()), world)
    start = torch.tensor([mine])
    if dist.get_backend() == "nccl":
        start = start.to(device)
    dist.all_reduce(start, op=dist.ReduceOp.MIN)
    start = int(start)
    _emit({"rank": rank, "world": world, "resume_at_chunk": start})
    table = index_to_device(index, "cpu")
    done = 0
    for t in range(start, world):
        planes = ring_chunk_counts(table, s=index.params.s, mesh=mesh, t0=t, n_steps=1)
        rows = {key: p[0, rank * nl:(rank + 1) * nl].numpy()
                for key, p in zip(("shared", "union", "inter"), planes)}
        tmp = str(_chunk_path(workdir, t, rank)) + ".tmp.npz"
        np.savez(tmp, **rows)
        os.replace(tmp, _chunk_path(workdir, t, rank))
        _emit({"rank": rank, "world": world, "chunk_committed": t})
        done += 1
        if rank == 1 and done == args.die_after and not args.resume:
            _emit({"rank": rank, "fault_injection": f"exit {DIE_CODE} after chunk {t}"})
            os._exit(DIE_CODE)
    dist.barrier()
    equal = True
    if rank == 0:
        want = _one_device(index, None, device, wants, "square")
        for key in ("shared", "union", "inter"):
            ring = np.zeros((world, n, nl), np.int32)
            for t in range(world):
                for r in range(world):
                    with np.load(_chunk_path(workdir, t, r)) as z:
                        ring[t, r * nl:(r + 1) * nl] = z[key]
            equal &= bool(np.array_equal(unrotate_chunks(ring, D=world), want[key]))
    _emit({"rank": rank, "world": world, "mode": "chunks", "chunks_run": done,
           "equal": equal})
    return equal


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    from ..parallel import initialize_distributed
    from ..parallel.mesh import rank_device

    initialize_distributed(f"tcp://localhost:{args.port}", world_size=args.world,
                           rank=args.rank, backend=args.backend, device=args.device,
                           timeout_s=args.timeout)
    try:
        device = rank_device(args.device, args.rank)
        _emit({"rank": args.rank, "world": args.world, "backend": dist.get_backend(),
               "device": str(device),
               "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None})
        workdir = Path(args.workdir)
        index = _await_index(workdir, args.timeout)
        _emit({"rank": args.rank, "world": args.world, "index_loaded": len(index)})
        ok, wants = True, {}
        if args.die_after is not None:
            ok = _run_chunks(args, args.rank, args.world, device, workdir, index, wants)
        ok &= _run_modes(args, args.rank, args.world, device, workdir, index, wants)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def _await_index(workdir: Path, timeout: float):
    """The orchestrator's index, once its file is there."""
    from ..index.store import SketchIndex

    deadline = time.monotonic() + timeout
    while not (workdir / INDEX).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {INDEX} in {workdir} after {timeout} s")
        time.sleep(0.02)
    return SketchIndex.load(workdir / INDEX)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn(args, workdir: Path, extra=()) -> list:
    """Start the ranks on a free port and, while they start, write the
    run's inputs that are missing: the screen's files, then the index
    (atomically: the ranks wait for it)."""
    port = _free_port()
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if args.device == "cpu":  # ranks share the cores; small ops run best on one thread
        env.setdefault("OMP_NUM_THREADS", "1")
    root = str(Path(__file__).resolve().parents[2])  # the package's parent
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    base = [sys.executable, "-m", __spec__.name, *args.argv, *extra,
            "--world", str(args.ranks), "--port", str(port), "--workdir", str(workdir)]
    procs = [subprocess.Popen(base + ["--rank", str(r)], env=env) for r in range(args.ranks)]
    try:
        if "screen" in args.modes.split(",") and not (workdir / "reads.fq").exists():
            write_screen_inputs(workdir, SEED)
        if not (workdir / INDEX).exists():
            make_index(args.genomes, args.s, SEED).save(workdir / "index.tmp")
            os.replace(workdir / "index.tmp", workdir / INDEX)
    except BaseException:
        _wait_all(procs, 0.0)
        raise
    return procs


def _wait_all(procs, timeout: float) -> list:
    """Exit codes of procs; every process still running at the deadline is
    killed and reported as None."""
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return codes


def _committed(workdir: Path, t: int, ranks: int, grace: float) -> None:
    """Wait until every rank has committed chunk t, for at most `grace`
    seconds."""
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline and not all(
            _chunk_path(workdir, t, r).exists() for r in range(ranks)):
        time.sleep(0.02)


def orchestrate(args) -> int:
    if args.device == "cuda":
        from ..utils.device import resolve

        resolve(args.device)  # raises without a card
    with tempfile.TemporaryDirectory(prefix="miekki_ring_") as tmp:
        workdir = Path(args.out or tmp)
        workdir.mkdir(parents=True, exist_ok=True)
        if args.die_after is None:
            codes = _wait_all(_spawn(args, workdir), args.timeout)
        else:
            if args.ranks < 2 or not 1 <= args.die_after < args.ranks:
                raise SystemExit("--die-after C needs --ranks >= 2 and 1 <= C < ranks")
            started = round(time.monotonic() - _T0, 3)
            procs = _spawn(args, workdir)
            died = _wait_all(procs[1:2], args.timeout)[0]
            # the other ranks wait on rank 1 in the next chunk: the
            # orchestrator plays the failure detector and kills them once
            # they have committed the chunk rank 1 finished
            _committed(workdir, args.die_after - 1, args.ranks, 3.0)
            _wait_all(procs[:1] + procs[2:], 0.0)
            have = sorted(p.name for p in workdir.glob("chunk*_rank1.npz"))
            _emit({"fault_run": {"rank1_exit": died, "rank1_chunks": have},
                   "started_at_s": started})
            if died != DIE_CODE or len(have) != args.die_after:
                print(f"FAILED: expected rank 1 to exit {DIE_CODE} after "
                      f"{args.die_after} chunks", flush=True)
                return 1
            codes = _wait_all(_spawn(args, workdir, ["--resume"]), args.timeout)
    ok = all(c == 0 for c in codes)
    print("ALL RANKS OK" if ok else f"FAILED: rank exit codes {codes}", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cuda, gloo on the CPU")
    ap.add_argument("--modes", default="square",
                    help="comma-separated: square, rect, compact, screen, mxu_square, "
                         "mxu_rect, mxu_compact")
    ap.add_argument("--genomes", type=int, default=64)
    ap.add_argument("-s", type=int, default=128, help="sketch size")
    ap.add_argument("--mxu-tile", type=int, default=512,
                    help="sub-tile edge of the mxu modes' stream-pass ring")
    ap.add_argument("--die-after", type=int, default=None, metavar="C",
                    help="chunked ring first; rank 1 exits after its C-th chunk, then a "
                         "resume that also runs --modes")
    ap.add_argument("--out", default=None,
                    help="working directory: inputs, chunk files and rank 0's results")
    ap.add_argument("--timeout", type=float, default=120.0, help="seconds per run")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    if args.rank is not None:
        return rank_main(args)
    return orchestrate(args)


if __name__ == "__main__":
    sys.exit(main())
