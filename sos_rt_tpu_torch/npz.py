"""The sweep's shard writer: the npz file of ``numpy.savez_compressed``,
deflated in fixed blocks on a pool of host threads.

Each member is one array's ``.npy`` serialisation
(``numpy.lib.format.write_array``), cut every :data:`BLOCK` bytes.  Each
block is deflated by a compressor of its own at the level and window of
``zipfile.ZIP_DEFLATED`` (zlib's default level, a raw 2**15 window), every
block but the last ending in ``Z_FULL_FLUSH`` and the last in ``Z_FINISH``,
so the blocks joined are one valid deflate stream.  zlib releases the
interpreter lock while it deflates, so the blocks, and each member's
CRC-32, run in parallel.  The block size is fixed, so a file's bytes do not
depend on the number of threads.

The container is the one ``numpy.savez_compressed`` writes with this
Python's ``zipfile``: members ``<key>.npy``, method 8 (deflate), the zip64
extra field in every local header, dated 1980-01-01, the zip64 records
wherever ``zipfile`` would write them.  A file whose members each fit in one
block is byte for byte ``numpy.savez_compressed``'s; ``numpy.load`` reads
either and checks each member's CRC.
"""
from __future__ import annotations

import io
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BLOCK = 1 << 20                 # bytes of a member deflated as one block
ZIP64_LIMIT = (1 << 31) - 1     # zipfile's: larger sizes and offsets take zip64 fields

_DOS_DATE = 1 << 5 | 1          # 1980-01-01 (time 0), zipfile's default date
_ZIP64_VERSION = 45             # zipfile writes every zip64 member at version 4.5
_UNIX, _MODE = 3, 0o600 << 16   # create_system, external_attr of zipfile on Linux


def _deflate(block, last: bool) -> bytes:
    z = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, -15)
    return z.compress(block) + z.flush(zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH)


def _local_header(name: bytes, crc: int, size: int, csize: int) -> bytes:
    extra = struct.pack("<HHQQ", 1, 16, size, csize)
    return struct.pack("<4s2B4HL2L2H", b"PK\x03\x04", _ZIP64_VERSION, 0, 0, 8, 0,
                       _DOS_DATE, crc, 0xFFFFFFFF, 0xFFFFFFFF, len(name), len(extra)
                       ) + name + extra


def _central_entry(name: bytes, crc: int, size: int, csize: int, offset: int) -> bytes:
    big = []
    if size > ZIP64_LIMIT or csize > ZIP64_LIMIT:
        big += [size, csize]
        size = csize = 0xFFFFFFFF
    if offset > ZIP64_LIMIT:
        big.append(offset)
        offset = 0xFFFFFFFF
    extra = struct.pack(f"<HH{len(big)}Q", 1, 8 * len(big), *big) if big else b""
    return struct.pack("<4s4B4HL2L5H2L", b"PK\x01\x02", _ZIP64_VERSION, _UNIX,
                       _ZIP64_VERSION, 0, 0, 8, 0, _DOS_DATE, crc, csize, size,
                       len(name), len(extra), 0, 0, 0, _MODE, offset) + name + extra


def _end_records(count: int, start: int, end: int) -> bytes:
    """The end of the central directory at ``start:end``, with the zip64
    record and locator where a count, offset or size needs them."""
    size, out = end - start, b""
    if count > 0xFFFF or start > ZIP64_LIMIT or size > ZIP64_LIMIT:
        out = (struct.pack("<4sQ2H2L4Q", b"PK\x06\x06", 44, _ZIP64_VERSION,
                           _ZIP64_VERSION, 0, 0, count, count, size, start)
               + struct.pack("<4sLQL", b"PK\x06\x07", 0, end, 1))
        count, size, start = min(count, 0xFFFF), min(size, 0xFFFFFFFF), min(start, 0xFFFFFFFF)
    return out + struct.pack("<4s4H2LH", b"PK\x05\x06", 0, 0, count, count, size, start, 0)


class NpzWriter:
    """Writes npz files on a pool of ``threads`` host threads, the cores
    this process may run on (``os.sched_getaffinity``).  The pool starts a
    thread only when a block waits for one, so a file of fewer blocks uses
    fewer threads.  ``blocks`` counts the deflate blocks written.  Close it,
    or use it in a ``with``, to stop the pool."""

    def __init__(self):
        self.threads = len(os.sched_getaffinity(0))
        self.blocks = 0
        self._pool = ThreadPoolExecutor(self.threads, thread_name_prefix="npz")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._pool.shutdown(cancel_futures=True)

    def save(self, path: str, **arrays) -> None:
        """Write ``arrays`` to ``path`` (as given: no ``.npz`` is appended),
        each as the member ``<key>.npy``, in order."""
        members = []
        for key, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asanyarray(arr), allow_pickle=False)
            data = buf.getbuffer()
            # every member is queued before the first is written, so the pool
            # deflates the later members while the earlier ones are written
            crc = self._pool.submit(zlib.crc32, data)
            blocks = [self._pool.submit(_deflate, data[s:s + BLOCK], s + BLOCK >= len(data))
                      for s in range(0, len(data), BLOCK)]
            members.append((f"{key}.npy".encode(), len(data), crc, blocks))
        central = []
        with open(path, "wb") as f:
            for name, size, crc, blocks in members:
                offset, crc = f.tell(), crc.result()
                parts = [b.result() for b in blocks]
                csize = sum(map(len, parts))
                f.write(_local_header(name, crc, size, csize))
                f.writelines(parts)
                central.append(_central_entry(name, crc, size, csize, offset))
                self.blocks += len(parts)
            start = f.tell()
            f.writelines(central)
            f.write(_end_records(len(central), start, f.tell()))
