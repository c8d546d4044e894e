"""huffmanfile-compatible compression API.

The compress half of ``libhuffman_tpu.api`` (the reference Python binding's
``HuffmanCompressor`` and ``compress``, huffmanfile/huffmanfile.py:294-353
and :409-417), backed by the port's encode path.  The decompressor,
``HuffmanFile`` and ``open`` are not ported yet.

Deliberate fix over the reference (as in ``libhuffman_tpu.api``):
``HuffmanCompressor.compress`` after ``flush`` raises ValueError instead of
crashing on ``encoding()`` (huffmanfile.py:303-305 calls a bytes object).
"""

from __future__ import annotations

from . import encode as _encode_mod
from .format import DEFAULT_BLOCK_SIZE
from .streams import MemStream

__all__ = ["HuffmanCompressor", "compress"]


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
        self._device = _encode_mod.resolve_device(device)
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


def compress(data, blocksize: int = DEFAULT_BLOCK_SIZE, device="cuda") -> bytes:
    """One-shot compress (huffmanfile.py:409-417)."""
    comp = HuffmanCompressor(blocksize, device)
    return comp.compress(data) + comp.flush()
