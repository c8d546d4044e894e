"""Block-aligned checkpoint and resume: the port's counterpart of
``libhuffman_tpu.resume``.

The reference has no checkpointing, but its format makes every block
boundary a natural resume point: blocks are self-contained (own header, own
tree, own zero-padded bitstream - src/encoder.c:288-374) and the decoder's
only inter-block state is a byte counter (src/decoder.c:218).  This module
exposes that:

  * ``encode_range``      - encode only blocks [start, stop) of the input;
                            the concatenation over a partition of the block
                            range is byte-identical to a whole-stream
                            encode, so an interrupted encode resumes at the
                            next block index.
  * ``block_offsets``     - byte offset of every block header in a
                            compressed stream (one sequential scan on the
                            host, native-accelerated).
  * ``decode_from_block`` - decode a compressed stream from block k on,
                            skipping (without decoding) everything before.

``encode_range`` and ``decode_from_block`` run the port's kernels on
``device`` (default "cuda"; "cpu" for the plain-torch twins).
"""

from __future__ import annotations

import numpy as np

from . import decode as dec_mod
from . import encode as enc_mod
from . import native
from .errors import BtreeCorruptedError, BtreeOverflowError, ReadWriteError
from .format import DEFAULT_BLOCK_SIZE, parse_block_header
from .ops import hostref
from .parallel.shard import resolve_device


def n_blocks(data_len: int, blocksize: int = DEFAULT_BLOCK_SIZE) -> int:
    """Number of blocks a whole-stream encode of ``data_len`` bytes emits."""
    if data_len == 0:
        return 0
    if blocksize <= 0:
        return 1
    return -(-data_len // blocksize)


def encode_range(
    data: bytes | np.ndarray,
    blocksize: int = DEFAULT_BLOCK_SIZE,
    start_block: int = 0,
    stop_block: int | None = None,
    device="cuda",
) -> bytes:
    """Encode blocks [start_block, stop_block) of ``data`` on ``device``.

    Concatenating the outputs of any partition of ``range(n_blocks(...))``
    reproduces ``encode.encode(data, blocksize)`` byte for byte, because
    blocks are independent (per-block histogram, tree and padding,
    src/encoder.c:353-373).
    """
    device = resolve_device(device)
    buf = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8)
    )
    total = n_blocks(len(buf), blocksize)
    if blocksize <= 0:
        blocksize = len(buf)
    if stop_block is None or stop_block > total:
        stop_block = total
    start_block = max(0, start_block)
    if start_block >= stop_block:
        return b""
    seg = buf[start_block * blocksize : stop_block * blocksize]
    return enc_mod.encode(seg, blocksize, device=device)


def block_offsets(stream: bytes, length: int | None = None) -> list[int]:
    """Byte offset of each block header in ``stream`` (offsets[k] = start of
    block k); raises like ``decode`` on a corrupt or truncated chain."""
    if length is None:
        length = len(stream)
    buf = np.frombuffer(stream, dtype=np.uint8)[:length]
    offs: list[int] = []
    off = 0
    mv = memoryview(stream)
    while off < length:
        offs.append(off)
        if native.available():
            err, consumed, _produced, _blocks, _ = native.scan_stream(
                buf[off:length], decode=False, max_blocks=1)
            if err == 3:
                raise ReadWriteError("Failed to decode the data")
            if err == 5:
                raise BtreeOverflowError("Failed to decode the data")
            if err == 6:
                raise BtreeCorruptedError("Failed to decode the data")
            off += consumed
        else:
            hdr = parse_block_header(mv, off)
            _syms, consumed = hostref.decode_block_payload(
                hdr.tree, buf[hdr.payload_off : length], hdr.n_sym)
            off = hdr.payload_off + consumed
    return offs


def decode_from_block(
    stream: bytes,
    start_block: int,
    stop_block: int | None = None,
    length: int | None = None,
    device="cuda",
) -> bytes:
    """Decode blocks [start_block, stop_block) of a compressed stream.

    Blocks before ``start_block`` are chain-scanned on the host (headers and
    payload lengths) but not materialized; the decode itself takes the
    device route on ``device``.
    """
    device = resolve_device(device)
    offs = block_offsets(stream, length)
    if start_block >= len(offs):
        return b""
    if length is None:
        length = len(stream)
    end = (length if stop_block is None or stop_block >= len(offs)
           else offs[stop_block])
    return dec_mod.decode(stream[offs[start_block] : end], device=device)
