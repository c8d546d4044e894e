"""Whole-stream decode on the host-exact route.

Block boundaries in the libhuffman format are only discoverable by decoding
(the payload length is implicit), so the stream is a chain: each block is
decoded from its header at the offset where the previous block ended.  Here
every block is walked by the native runtime's sequential scanner
(native/huffman_native.cpp ``scan_stream``), or by ``ops/hostref`` without a
toolchain.  This is the ``use_device=False`` route of
``libhuffman_tpu.decode``.

The device route (speculative candidate decode with the resolve, chain and
emission kernels) is not ported yet; ``use_device=True`` raises
NotImplementedError rather than quietly taking the host route.

Error semantics mirror src/decoder.c:201-287: the first failing block in
chain order raises.
"""

from __future__ import annotations

import numpy as np

from .errors import BtreeCorruptedError, BtreeOverflowError, ReadWriteError
from .format import parse_block_header
from . import native
from .ops import hostref

_NO_DEVICE_DECODE = (
    "device decode is not ported to libhuffman_tpu_torch yet: its kernels "
    "(resolve, chain and emission) come with the device-decode slice "
    "(ROADMAP.md M5/M6); pass use_device=False for the host-exact route")


def _chain(data: bytes, length: int):
    """Decode the block chain from offset 0 up to ``length``.

    Returns (decoded bytes, end offset); raises on the first failing block
    in chain order.  ReadWriteError carries ``partial`` = (bytes decoded so
    far, offset of the incomplete block) so incremental callers can buffer.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    out = []
    mv = memoryview(data)
    off = 0
    while off < length:
        try:
            hdr = parse_block_header(mv, off)
            if hdr.n_sym > 8 * max(length - hdr.payload_off, 0):
                # Each symbol consumes >= 1 bit: guaranteed short read.  Also
                # guards output allocation against adversarial u64 lengths.
                raise ReadWriteError("Failed to decode the data")
            if native.available():
                err, consumed_b, produced, _blocks, o = native.scan_stream(
                    buf[off:length], decode=True, out_cap=hdr.n_sym,
                    max_blocks=1,
                )
                if err == 3:
                    raise ReadWriteError("Failed to decode the data")
                if err == 5:
                    raise BtreeOverflowError("Failed to decode the data")
                if err == 6:
                    raise BtreeCorruptedError("Failed to decode the data")
                out.append(o[:produced].tobytes())
                off = off + consumed_b
            else:
                syms, consumed = hostref.decode_block_payload(
                    hdr.tree, buf[hdr.payload_off : length], hdr.n_sym
                )
                out.append(syms.tobytes())
                off = hdr.payload_off + consumed
        except ReadWriteError as e:
            # Incomplete data at the chain tail: everything decoded so far
            # is valid and ``off`` marks the incomplete block's start.
            e.partial = (b"".join(out), off)
            raise
    return b"".join(out), off


def decode(data: bytes, length: int | None = None,
           use_device: bool = False) -> bytes:
    """Whole-stream decode with the reference's strict semantics: the first
    failing block in chain order raises (src/decoder.c:218-275).

    ``length`` caps the compressed bytes consumed.  ``use_device=True``
    raises NotImplementedError until device decode is ported."""
    if use_device:
        raise NotImplementedError(_NO_DEVICE_DECODE)
    if length is None:
        length = len(data)
    if length == 0:
        return b""
    out, _ = _chain(data, length)
    return out


def decode_prefix(data: bytes, length: int | None = None,
                  use_device: bool = False) -> tuple[bytes, int]:
    """Decode every *complete* block; returns (output, consumed offset).

    A trailing incomplete block (short header, tree, or payload) stops the
    chain cleanly instead of raising.  Corruption errors still raise.
    """
    if use_device:
        raise NotImplementedError(_NO_DEVICE_DECODE)
    if length is None:
        length = len(data)
    if length == 0:
        return b"", 0
    try:
        return _chain(data, length)
    except ReadWriteError as e:
        return getattr(e, "partial", (b"", 0))
