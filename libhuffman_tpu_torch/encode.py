"""Whole-stream encode: host orchestration around the device kernels.

The stream is split into independent fixed-size blocks (the reference's
block loop, src/encoder.c:288-374) and batched; each batch goes through
``ops/device.encode_blocks`` (histogram, tree, codes, layout and pack) on
the chosen torch device, or with its rows split over the devices of a
``parallel.shard.BlockMesh`` (one device is a mesh of one), after which
the host serializes the tree headers and assembles (header, tree, payload)
per block with the native runtime.
Blocks the device path flags (codes over 32 bits, or a payload over the
word budget: neither happens for real data below ~2 MB blocks) are
re-encoded by the host-exact codec, so the output is bit-exact either way;
:data:`COUNTS` records how many were.
"""

from __future__ import annotations

import numpy as np

from .format import DEFAULT_BLOCK_SIZE
from .ops import device as dev
from .ops import hostref
from .parallel.shard import (BlockMesh, assemble_stream, gather,
                             resolve_device, run_slices)
from .utils.trace import annotate

# Blocks per device batch: 128 x 64 KiB = 8.4 MiB.
DEFAULT_BATCH_BLOCKS = 128

# Since the last reset: blocks re-encoded on the host (see module
# docstring), bytes copied back from the devices, and stream bytes written
# from what was copied back.
COUNTS = {"host_reencoded_blocks": 0, "encode_d2h_bytes": 0,
          "stream_bytes": 0}


def _bucket(n: int, lo: int) -> int:
    """Round up to a power of two (>= lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _bucket_blocks(nb: int) -> int:
    """Batch-size bucket: powers of two to 256, then multiples of 256, so a
    stream's batches take few distinct shapes."""
    if nb <= 256:
        return _bucket(nb, 1)
    return -(-nb // 256) * 256


def _pack_params(N: int) -> int:
    """Payload word budget W for blocksize N: 24 words per 64 input bytes
    (mean code length <= 12 bits; text averages ~4.5, incompressible data
    exactly 8, and a Huffman code's mean stays below 10 with the unary
    root), never more than the pow2-rounded N words."""
    P = 1
    while P < N:
        P *= 2
    return min(P, 24 * max(P // 64, 1))


def _encode_batch(batch: np.ndarray, n_valid: np.ndarray,
                  mesh: BlockMesh) -> bytes:
    """Encode a (B, N) uint8 batch, its rows split over ``mesh``; returns
    the wire bytes of its blocks."""
    W = _pack_params(batch.shape[1])
    with annotate("huff.encode.device"):
        res = run_slices(lambda b, nv: dev.encode_blocks(b, nv, W),
                         (batch, n_valid), mesh)
    with annotate("huff.encode.d2h"):
        total_bits_h, overflow_h = gather([(r[1], r[5]) for r in res])
        # Transfer only a bucketed prefix of the padded payload buffer: the
        # worst-case row is 4W bytes but typical payloads are ~0.6N.
        maxb = min(_bucket(max(1, (int(total_bits_h.max()) + 7) // 8), 1024),
                   4 * W)
        payload_h, left_h, right_h, root_h = gather(
            [(r[0][:, :maxb], r[2], r[3], r[4]) for r in res])
    COUNTS["encode_d2h_bytes"] += sum(
        a.nbytes for a in (total_bits_h, overflow_h, payload_h, left_h,
                           right_h, root_h))
    with annotate("huff.encode.assemble"):
        out = assemble_stream(n_valid, total_bits_h, payload_h, left_h,
                              right_h, root_h, overflow_h, batch,
                              counts=COUNTS)
    COUNTS["stream_bytes"] += len(out)
    return out


def encode(
    data: bytes | np.ndarray,
    blocksize: int = DEFAULT_BLOCK_SIZE,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    config=None,
    device="cuda",
) -> bytes:
    """Encode ``data`` into the libhuffman block format.

    ``blocksize == 0`` treats the whole input as one block
    (src/encoder.c:163-165); the ragged tail becomes its own smaller block.
    ``device`` is where the kernels run: a CUDA device, or "cpu" for the
    plain-torch twins; the default raises when CUDA is absent.  An
    :class:`~libhuffman_tpu_torch.config.EncodeConfig` overrides the
    positional knobs and the device (config.length caps the input;
    config.mesh splits every batch over its devices, as
    ``parallel.shard.encode_stream_sharded`` does).
    """
    buf = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview))
           else np.asarray(data, dtype=np.uint8))
    mesh = None
    if config is not None:
        blocksize = config.blocksize
        batch_blocks = config.batch_blocks
        device = config.device
        mesh = config.mesh
        if config.length:
            buf = buf[: config.length]
    if mesh is None:
        mesh = BlockMesh((resolve_device(device),))
    return encode_stream(buf, blocksize, batch_blocks, mesh)


def encode_stream(buf: np.ndarray, blocksize: int, batch_blocks: int,
                  mesh: BlockMesh) -> bytes:
    """The stream's blocks in batches of ``batch_blocks`` blocks per device
    of ``mesh`` (each batch's rows split over the mesh), joined in block
    order."""
    n = len(buf)
    if n == 0:
        return b""
    if blocksize <= 0:
        blocksize = n
    if blocksize > (1 << 21):
        # Oversized single blocks (blocksize=0 on a large input, or an
        # explicit multi-MB blocksize): codes can exceed the 32-bit device
        # fast path beyond ~2 MB (ops/device.MAX_CODE_BITS) - take the
        # host-exact encoder, block by block.
        return b"".join(hostref.encode_block(buf[off : off + blocksize])
                        for off in range(0, n, blocksize))
    parts = [_encode_batch(batch, n_valid, mesh)
             for batch, n_valid in _batches(buf, blocksize, batch_blocks,
                                            mesh.size)]
    with annotate("huff.encode.join"):
        return b"".join(parts)


def _batches(buf: np.ndarray, blocksize: int, batch_blocks: int, nd: int):
    """The (batch, n_valid) pairs of ``encode_stream``: ``batch_blocks``
    blocks per device of ``nd`` in each, the row count bucketed and a
    multiple of ``nd`` (rows past the stream are empty blocks)."""
    n = len(buf)
    nblocks = -(-n // blocksize)
    group = batch_blocks * nd
    for start in range(0, nblocks, group):
        # The span closes before the yield, so it leaves out the consumer.
        with annotate("huff.encode.batch"):
            nb = min(group, nblocks - start)
            # Rows per device: the padded batch splits evenly over the mesh.
            B = _bucket_blocks(-(-nb // nd)) * nd
            batch = np.zeros((B, blocksize), dtype=np.uint8)
            n_valid = np.zeros(B, dtype=np.int32)
            seg = buf[start * blocksize : min(n, (start + nb) * blocksize)]
            batch.reshape(-1)[: len(seg)] = seg
            n_valid[:nb] = blocksize
            n_valid[nb - 1] = len(seg) - (nb - 1) * blocksize
        yield batch, n_valid
