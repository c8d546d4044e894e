"""In-memory and fd-backed streams mirroring the reference I/O layer.

The reference exposes a vtable-based stream abstraction (include/huffman/io.h:11-21)
with two backends: a growable in-memory buffer (src/io.c:66-170) and a POSIX
fd stream (src/io.c:9-50 — broken there: it stores the address of its own
stack parameter, so only the membuf backend is actually usable; this
implementation provides a working fd stream instead, SURVEY.md §7 item 8).

``MemStream`` reproduces the membuf's exact observable semantics, which the
Python binding's tests rely on (huffmanfile/huffmanfile.py:219-269,
test/io_test.c:12-94): grow-on-write with capacity doubling, cursor-consuming
reads, ``len`` = unread bytes, and rewind-only seek.
"""

from __future__ import annotations

import io
import os

from .errors import InvalidArgumentError, ReadWriteError


class MemStream:
    """Growable in-memory stream with cursor-consume reads.

    Mirrors ``huf_membuf_t`` {buf, offset, length, capacity}: writes append
    at ``length`` doubling capacity as needed (src/io.c:74-107); reads
    consume from ``offset`` (src/io.c:110-128); ``__len__`` is the unread
    byte count (huf_memlen, src/io.c:132-143); ``seek(0)`` rewinds the read
    cursor (huf_memrewind, src/io.c:158-170); ``getvalue`` snapshots the
    whole backing buffer like the binding's MemStream.getvalue
    (huffmanfile.py:244-246).
    """

    __slots__ = ("_buf", "_len", "_off")

    def __init__(self, capacity: int = 0):
        if capacity < 0:
            raise InvalidArgumentError("Failed to allocate memory stream")
        self._buf = bytearray(capacity)
        self._len = 0  # bytes written
        self._off = 0  # bytes consumed by reads

    def write(self, data) -> int:
        data = bytes(data)
        need = self._len + len(data)
        if need > len(self._buf):
            cap = max(len(self._buf), 1)
            while cap < need:
                cap *= 2
            self._buf.extend(bytearray(cap - len(self._buf)))
        self._buf[self._len : self._len + len(data)] = data
        self._len += len(data)
        return len(data)

    def read(self, count: int) -> bytes:
        """Consume up to ``count`` unread bytes (may return fewer, like the
        membuf's available-length clamp, src/io.c:117-121)."""
        avail = self._len - self._off
        take = min(count, max(avail, 0))
        out = bytes(self._buf[self._off : self._off + take])
        self._off += take
        return out

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        """Rewind-only, like huf_memrewind: the sole supported seek is
        (0, SEEK_SET)."""
        if whence != io.SEEK_SET:
            raise ValueError(
                f"MemStream supports io.SEEK_SET only (whence={whence})"
            )
        if offset != 0:
            raise ValueError(
                f"MemStream can only rewind to 0 (offset={offset})"
            )
        self._off = 0
        return 0

    def getvalue(self) -> bytes:
        return bytes(self._buf[: self._len])

    def __len__(self) -> int:
        return self._len - self._off

    @property
    def capacity(self) -> int:
        """huf_memcap (src/io.c:146-155)."""
        return len(self._buf)

    def close(self):
        self._buf = bytearray()
        self._len = self._off = 0


class FdStream:
    """Byte stream over a file descriptor (working replacement for the
    reference's defective ``huf_fdopen``, src/io.c:36-50)."""

    __slots__ = ("_fd", "_close")

    def __init__(self, fd: int, closefd: bool = False):
        self._fd = fd
        self._close = closefd

    def write(self, data) -> int:
        data = bytes(data)
        written = 0
        while written < len(data):
            n = os.write(self._fd, data[written:])
            if n <= 0:
                raise ReadWriteError("Failed to write data to the fd stream")
            written += n
        return written

    def read(self, count: int) -> bytes:
        return os.read(self._fd, count)

    def close(self):
        if self._close:
            os.close(self._fd)
