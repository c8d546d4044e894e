"""huffmanfile-compatible public API.

The port's counterpart of ``libhuffman_tpu.api``: the surface of the
reference Python binding (huffmanfile/huffmanfile.py) - ``HuffmanError``,
``HuffmanFile``, ``HuffmanCompressor``, ``HuffmanDecompressor``,
``compress``, ``decompress``, ``open`` - with the same defaults
(DEFAULT_BLOCK_SIZE=131072, DEFAULT_MEM_LIMIT=262144, huffmanfile.py:26-27),
backed by the port's encode and decode paths.  Every class and function
takes ``device`` (default "cuda"; "cpu" runs the kernels' plain-torch
twins), resolved once where the object is made, so a missing card raises
there and nothing falls back to the CPU.

Deliberate fixes over the reference (as in ``libhuffman_tpu.api``):
  * ``HuffmanCompressor.compress`` after ``flush`` raises ValueError instead
    of crashing on ``encoding()`` (huffmanfile.py:303-305 calls a bytes
    object);
  * ``HuffmanDecompressor`` is incremental: complete blocks are decoded as
    they arrive and partial tails are buffered, where the reference errors
    on the second call; one-shot use is byte-identical;
  * ``HuffmanFile.read`` therefore works for files larger than one gulp.
"""

from __future__ import annotations

import io
import os
from builtins import open as builtin_open

import numpy as np

from . import decode as _decode_mod
from . import encode as _encode_mod
from . import native
from .errors import HuffmanError, ReadWriteError
from .format import (BLOCK_HEADER, DEFAULT_BLOCK_SIZE, DEFAULT_MEM_LIMIT,
                     parse_block_header)
from .ops import hostref
from .parallel.shard import resolve_device
from .streams import MemStream

__all__ = [
    "HuffmanError",
    "HuffmanFile",
    "HuffmanCompressor",
    "HuffmanDecompressor",
    "compress",
    "decompress",
    "open",
]


class HuffmanCompressor:
    """Incremental compressor.

    Buffers input (through ``MemStream``, the membuf analogue the reference
    routes all codec bytes through) and encodes only whole multiples of
    ``blocksize`` per ``compress()`` call - each call is an independent
    encode run emitting self-contained blocks, exactly the reference's
    buffering arithmetic (huffmanfile.py:294-342); ``flush()`` encodes the
    remainder.  ``device`` is where the encode kernels run (see
    :func:`libhuffman_tpu_torch.encode.encode`).
    """

    def __init__(self, blocksize: int = DEFAULT_BLOCK_SIZE, device="cuda"):
        if blocksize <= 0:
            raise ValueError("blocksize must be positive")
        self._blocksize = blocksize
        self._device = resolve_device(device)
        self._flushed = False
        self._stream = MemStream()

    def compress(self, data) -> bytes:
        """Provide data; returns compressed whole blocks when available."""
        if self._flushed:
            raise ValueError("Compressor has been flushed")
        self._stream.write(bytes(data))
        num_blocks = len(self._stream) // self._blocksize
        if num_blocks == 0:
            return b""
        head = self._stream.read(num_blocks * self._blocksize)
        carry = self._stream.read(len(self._stream))
        self._stream = MemStream()  # drop consumed backing storage
        self._stream.write(carry)
        return _encode_mod.encode(head, self._blocksize, device=self._device)

    def flush(self) -> bytes:
        """Encode any buffered remainder and finish; the compressor may not
        be used afterwards (returns b"" if called again - reference
        semantics, huffmanfile.py:350-353)."""
        if self._flushed:
            return b""
        self._flushed = True
        tail = self._stream.read(len(self._stream))
        self._stream.close()
        if not tail:
            return b""
        return _encode_mod.encode(tail, self._blocksize, device=self._device)


class HuffmanDecompressor:
    """Incremental decompressor.

    Decodes every complete block available so far and buffers partial
    tails; one-shot use matches the reference byte for byte
    (huffmanfile.py:385-400, whose own incremental path is broken).  Each
    call that completes a block runs the decode route on the pending
    buffer on ``device``.
    """

    def __init__(self, memlimit: int = DEFAULT_MEM_LIMIT, device="cuda"):
        self._device = resolve_device(device)
        # ``memlimit`` mirrors huf_config_t's reader/writer buffer sizing
        # (huffmanfile.py:375-376): a buffering hint, not an enforced cap -
        # the reference grows its membuf past it rather than erroring - so
        # it is the initial capacity of a sliding-window buffer: a doubling
        # uint8 array with a consumed offset, so a feed costs its own bytes
        # and not the whole buffered stream (byte-drip feeding stays O(n)).
        self._buf = np.empty(max(int(memlimit), 64), np.uint8)
        self._len = 0
        self._off = 0
        self._closed = False
        self._need = 1  # bytes the buffer must reach before the next attempt
        # Measurement-walk cache for the pending (incomplete) head block:
        # (sig, (node, restored, payload_pos)).  Carrying the walk across
        # feeds makes byte-drip decompression O(n) total walk work instead
        # of a full re-walk per feed.
        self._walk_sig = None
        self._walk_state = None

    def _write(self, data: bytes) -> None:
        n = len(data)
        if self._len + n > len(self._buf):
            # Compact the consumed prefix first; double if still short.
            if self._off:
                live = self._len - self._off
                self._buf[:live] = self._buf[self._off:self._len]
                self._len = live
                self._off = 0
            cap = len(self._buf)
            while self._len + n > cap:
                cap *= 2
            if cap != len(self._buf):
                grown = np.empty(cap, np.uint8)
                grown[: self._len] = self._buf[: self._len]
                self._buf = grown
        self._buf[self._len : self._len + n] = np.frombuffer(data, np.uint8)
        self._len += n

    def _pending(self):
        return self._buf[self._off : self._len]

    def decompress(self, data) -> bytes:
        if self._closed:
            raise ValueError("Decompressor has been closed")
        self._write(bytes(data))
        # Skip attempts that cannot complete a block: every symbol consumes
        # >= 1 bit, so the bound below is never late (a completable buffer
        # is always attempted) while byte-drip feeding makes O(code length)
        # attempts per block instead of one per feed.
        if self._len - self._off < self._need:
            return b""
        out, consumed = _decode_mod.decode_prefix(self._pending(),
                                                  device=self._device)
        self._off += consumed
        self._need = self._tail_need()
        return out

    def _tail_need(self) -> int:
        """Bytes the buffer must hold before the pending head block can be
        complete."""
        buf = self._pending()
        if len(buf) < BLOCK_HEADER.size:
            return BLOCK_HEADER.size
        try:
            hdr = parse_block_header(memoryview(buf), 0)
        except ReadWriteError:
            # Header parsed but the serialized tree is still short.
            _, tree_len = BLOCK_HEADER.unpack_from(buf, 0)
            return BLOCK_HEADER.size + 2 * max(tree_len, 0) + 1
        except HuffmanError:
            return len(buf)  # corrupt: next attempt raises it properly
        if hdr.n_sym == 0:
            return len(buf)
        tree = np.asarray(hdr.tree, np.int16)
        use_native = native.available()
        sig = (hdr.n_sym, hdr.payload_off, tree.tobytes(), use_native)
        state = self._walk_state if sig == self._walk_sig else None
        payload = np.frombuffer(buf, np.uint8, offset=hdr.payload_off)
        if use_native:
            restored, state = native.walk_progress_resume(
                tree, payload, hdr.n_sym, state)
        else:
            restored, state = hostref.walk_progress_resume(
                tree, payload, hdr.n_sym, state)
        self._walk_sig, self._walk_state = sig, state
        return len(buf) + max(1, -(-(hdr.n_sym - restored) // 8))

    @property
    def needs_input(self) -> bool:
        return self._len - self._off > 0

    def close(self):
        """Release resources (reference parity, huffmanfile.py:402-406)."""
        self._closed = True
        self._len = self._off = 0


# HuffmanFile mode table: accepted spelling -> (raw-file mode, side).
_FILE_MODES = {
    "": ("rb", "r"), "r": ("rb", "r"), "rb": ("rb", "r"),
    "w": ("wb", "w"), "wb": ("wb", "w"),
    "x": ("xb", "w"), "xb": ("xb", "w"),
    "a": ("ab", "w"), "ab": ("ab", "w"),
}


class HuffmanFile(io.BufferedIOBase):
    """A file object providing transparent Huffman (de)compression.

    Behaviour-compatible with the reference class (huffmanfile.py:45-181):
    binary interface, modes r/w/x/a, path or file object, not seekable;
    ``read(size)`` sizes the *compressed* read from the underlying file;
    ``write`` returns the uncompressed length.  ``device`` is where the
    codec's kernels run.
    """

    def __init__(self, filename, mode="w", blocksize=DEFAULT_BLOCK_SIZE,
                 memlimit=DEFAULT_MEM_LIMIT, device="cuda"):
        self._raw = None
        self._owns_raw = False
        self._side = None  # "r" | "w" | None == closed
        self._codec = None

        try:
            raw_mode, side = _FILE_MODES[mode]
        except KeyError:
            raise ValueError("Invalid mode: %r" % (mode,)) from None
        codec = (HuffmanDecompressor(memlimit, device) if side == "r"
                 else HuffmanCompressor(blocksize, device))

        if isinstance(filename, (str, bytes, os.PathLike)):
            self._raw = builtin_open(filename, raw_mode)
            self._owns_raw = True
        elif hasattr(filename, "read") or hasattr(filename, "write"):
            self._raw = filename
        else:
            raise TypeError(
                "filename must be a str, bytes, file or PathLike object")
        self._side = side
        self._codec = codec

    def close(self):
        """Flush and close; idempotent.  Later operations raise ValueError."""
        if self._side is None:
            return
        side, codec, raw, owns = (self._side, self._codec, self._raw,
                                  self._owns_raw)
        self._side = None
        self._codec = None
        self._raw = None
        self._owns_raw = False
        try:
            if side == "w":
                raw.write(codec.flush())
            else:
                codec.close()
        finally:
            if owns:
                raw.close()

    @property
    def closed(self):
        return self._side is None

    @property
    def _fp(self):
        """Underlying binary file (the reference's internal name, kept:
        callers peek it for EOF)."""
        return self._raw

    def _live_raw(self):
        if self._side is None:
            raise ValueError("I/O operation on closed file")
        return self._raw

    def fileno(self):
        return self._live_raw().fileno()

    def seekable(self):
        return False

    def readable(self):
        self._live_raw()
        return self._side == "r"

    def writable(self):
        self._live_raw()
        return self._side == "w"

    def read(self, size=-1):
        """Read up to ``size`` *compressed* bytes from the underlying file
        and return their decompressed expansion (reference quirk kept:
        huffmanfile.py:152-162 sizes the compressed read)."""
        if not self.readable():
            raise io.UnsupportedOperation("File not open for reading")
        n = size if size >= 0 else io.DEFAULT_BUFFER_SIZE
        return self._codec.decompress(self._raw.read(n))

    def write(self, data):
        if not self.writable():
            raise io.UnsupportedOperation("File not open for writing")
        view = data if isinstance(data, (bytes, bytearray)) else memoryview(data)
        self._raw.write(self._codec.compress(view))
        return view.nbytes if isinstance(view, memoryview) else len(view)


def open(filename, mode="rb", encoding=None, errors=None, newline=None,
         device="cuda"):
    """Open a Huffman-compressed file in binary or text mode
    (huffmanfile.py:184-216); ``device`` is where the codec runs."""
    text = "t" in mode
    if text and "b" in mode:
        raise ValueError("Invalid mode: %r" % (mode,))
    if not text:
        for name, val in (("encoding", encoding), ("errors", errors),
                          ("newline", newline)):
            if val is not None:
                raise ValueError(
                    "Argument '%s' not supported in binary mode" % name)
    hf = HuffmanFile(filename, mode.replace("t", ""), device=device)
    return io.TextIOWrapper(hf, encoding, errors, newline) if text else hf


def compress(data, blocksize: int = DEFAULT_BLOCK_SIZE, device="cuda") -> bytes:
    """One-shot compress (huffmanfile.py:409-417)."""
    comp = HuffmanCompressor(blocksize, device)
    return comp.compress(data) + comp.flush()


def decompress(data, memlimit: int = DEFAULT_MEM_LIMIT,
               device="cuda") -> bytes:
    """One-shot decompress with the reference's strict whole-stream
    semantics: truncated or corrupt streams raise HuffmanError
    (huffmanfile.py:420-432)."""
    return _decode_mod.decode(bytes(data), device=device)
