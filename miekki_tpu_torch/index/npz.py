"""Write an `.npz` file with its members deflated in pieces on a thread pool.

The file holds what `np.savez_compressed` writes, member for member: the
same names in the same order, each member the bytes that
`np.lib.format.write_array` writes, ZIP_DEFLATED at zlib's default level,
with a zip64 extra on every local header (numpy forces zip64, so a plane
past 2 GiB still saves).  Only the deflate streams differ.  Each member's
bytes are cut into PIECE_BYTES pieces, and each piece is deflated on its
own.  Every piece ends in a sync flush, except a member's last, which ends
in a finish, so the member's pieces in order are one raw-deflate stream
that inflates to its bytes.  The file comes out within ~0.1 % of the
single-stream size (a flush marker a piece, no match across pieces).

zlib releases the GIL, so the pieces of all members deflate side by side
on one pool of threads, sized to the CPUs the process may run on (at most
MAX_THREADS) and kept across calls.  A member of one piece deflates on the
calling thread, so a small file starts no thread.  The calling thread cuts
the pieces, runs the CRC-32 over them in order and writes the deflated
pieces in order as they finish, with at most IN_FLIGHT_PER_THREAD pieces a
thread in flight: a member is never held whole a second time.  A member's
local header is patched with its sizes and CRC once its last piece is
written.

SAVE_COUNTS sums, over the files written until `reset_save_counts()`:
members, pieces deflated, the members' bytes and their deflated bytes.
"""

from __future__ import annotations

import collections
import os
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import BinaryIO, Mapping

import numpy as np

PIECE_BYTES = 256 << 10
MAX_THREADS = 8
IN_FLIGHT_PER_THREAD = 2

_LOCAL = struct.Struct("<4s2B4HL2L2H")
_CENTRAL = struct.Struct("<4s4B4HL2L5H2L")
_END = struct.Struct("<4s4H2LH")
_END64 = struct.Struct("<4sQ2H2L4Q")
_END64_LOCATOR = struct.Struct("<4sLQL")
_ZIP64_VERSION = 45
_UNIX = 3
_MODE = 0o600 << 16  # ?rw-------, as zipfile writes a member

SAVE_COUNTS: dict = {}
_counts_lock = threading.Lock()


def reset_save_counts() -> None:
    SAVE_COUNTS.update(members=0, pieces=0, raw_bytes=0, deflated_bytes=0)


reset_save_counts()

_pool = None  # (executor, threads), made at the first piece it deflates
_pool_lock = threading.Lock()


def _deflate_pool():
    """(the shared executor, its threads)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                    else os.cpu_count() or 1)
            threads = min(MAX_THREADS, cpus)
            _pool = (ThreadPoolExecutor(max_workers=threads,
                                        thread_name_prefix="npz-deflate"), threads)
        return _pool


def _deflate(piece, last: bool) -> bytes:
    c = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, -15)
    return c.compress(piece) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


class _Member:
    __slots__ = ("name", "dostime", "dosdate", "offset", "crc", "size", "csize", "pieces")

    def __init__(self, name: str):
        self.name = name.encode("ascii")
        y, mo, d, h, mi, s = time.localtime()[:6]
        self.dosdate = (y - 1980) << 9 | mo << 5 | d
        self.dostime = h << 11 | mi << 5 | s // 2
        self.offset = None
        self.crc = self.size = self.csize = self.pieces = 0

    def local_header(self) -> bytes:
        extra = struct.pack("<HHQQ", 1, 16, self.size, self.csize)
        return _LOCAL.pack(b"PK\x03\x04", _ZIP64_VERSION, 0, 0, zipfile.ZIP_DEFLATED,
                           self.dostime, self.dosdate, self.crc, 0xFFFFFFFF,
                           0xFFFFFFFF, len(self.name), len(extra)) + self.name + extra

    def central_header(self) -> bytes:
        """As zipfile writes it: a size or offset past zipfile.ZIP64_LIMIT
        moves into a zip64 extra."""
        limit, big = zipfile.ZIP64_LIMIT, []
        csize, size, offset = self.csize, self.size, self.offset
        if size > limit or csize > limit:
            big += [size, csize]
            size = csize = 0xFFFFFFFF
        if offset > limit:
            big.append(offset)
            offset = 0xFFFFFFFF
        extra = struct.pack(f"<HH{len(big)}Q", 1, 8 * len(big), *big) if big else b""
        return _CENTRAL.pack(b"PK\x01\x02", _ZIP64_VERSION, _UNIX, _ZIP64_VERSION, 0, 0,
                             zipfile.ZIP_DEFLATED, self.dostime, self.dosdate, self.crc,
                             csize, size, len(self.name), len(extra), 0, 0, 0, _MODE,
                             offset) + self.name + extra


class _Writer:
    """Members in, deflated pieces out in file order."""

    def __init__(self, f: BinaryIO):
        self.f = f
        self.members = []
        self.queue = collections.deque()  # (member, last piece?, future), in file order
        self.pool = None
        self.in_flight = IN_FLIGHT_PER_THREAD

    def put(self, member: _Member, piece, last: bool) -> None:
        member.crc = zlib.crc32(piece, member.crc)
        member.size += len(piece)
        member.pieces += 1
        if last and member.pieces == 1:
            fut = Future()
            fut.set_result(_deflate(piece, True))
        else:
            if self.pool is None:
                self.pool, threads = _deflate_pool()
                self.in_flight = IN_FLIGHT_PER_THREAD * threads
            fut = self.pool.submit(_deflate, piece, last)
        self.queue.append((member, last, fut))
        while len(self.queue) > self.in_flight:
            self.write_front()

    def write_front(self) -> None:
        member, last, fut = self.queue.popleft()
        data = fut.result()
        f = self.f
        if member.offset is None:
            member.offset = f.tell()
            f.write(member.local_header())  # sizes and CRC patched below
        f.write(data)
        member.csize += len(data)
        if last:
            end = f.tell()
            f.seek(member.offset)
            f.write(member.local_header())
            f.seek(end)

    def finish(self) -> None:
        while self.queue:
            self.write_front()
        f = self.f
        start = f.tell()
        for m in self.members:
            f.write(m.central_header())
        end = f.tell()
        count, size, limit = len(self.members), end - start, zipfile.ZIP64_LIMIT
        if count > 0xFFFF or start > limit or size > limit:
            f.write(_END64.pack(b"PK\x06\x06", _END64.size - 12, _ZIP64_VERSION,
                                _ZIP64_VERSION, 0, 0, count, count, size, start))
            f.write(_END64_LOCATOR.pack(b"PK\x06\x07", 0, end, 1))
            count, size, start = min(count, 0xFFFF), min(size, 0xFFFFFFFF), min(start, 0xFFFFFFFF)
        f.write(_END.pack(b"PK\x05\x06", 0, 0, count, count, size, start, 0))
        with _counts_lock:
            SAVE_COUNTS["members"] += len(self.members)
            for m in self.members:
                SAVE_COUNTS["pieces"] += m.pieces
                SAVE_COUNTS["raw_bytes"] += m.size
                SAVE_COUNTS["deflated_bytes"] += m.csize


class _MemberSink:
    """The file object np.lib.format.write_array writes one member to: cuts
    its bytes into pieces and hands each on once more bytes follow it, so
    the member's last piece is known at close."""

    def __init__(self, writer: _Writer, member: _Member):
        self.writer, self.member = writer, member
        self.held = bytearray()

    def write(self, data) -> int:
        data = memoryview(data).cast("B")
        n = len(data)
        if len(self.held) + n <= PIECE_BYTES:
            self.held += data
            return n
        off = 0
        if self.held:
            off = PIECE_BYTES - len(self.held)
            self.held += data[:off]
            self.writer.put(self.member, self.held, last=False)
        while n - off > PIECE_BYTES:
            self.writer.put(self.member, data[off:off + PIECE_BYTES], last=False)
            off += PIECE_BYTES
        self.held = bytearray(data[off:])
        return n

    def close(self) -> None:
        self.writer.put(self.member, self.held, last=True)


def write_npz(f: BinaryIO, arrays: Mapping[str, np.ndarray]) -> None:
    """Write `arrays` to the seekable binary file `f` as an `.npz`
    archive, one member `<name>.npy` each, in order."""
    writer = _Writer(f)
    for name, arr in arrays.items():
        member = _Member(name + ".npy")
        writer.members.append(member)
        sink = _MemberSink(writer, member)
        np.lib.format.write_array(sink, np.asanyarray(arr), allow_pickle=False)
        sink.close()
    writer.finish()
