"""Whole-stream encode: host orchestration around the device kernels.

The stream is split into independent fixed-size blocks (the reference's
block loop, src/encoder.c:288-374) and batched; each batch goes through
``ops/device.encode_blocks`` on the chosen torch device (histogram, tree,
codes, layout and pack), after which the host serializes the tree headers
and assembles (header, tree, payload) per block with the native runtime.
Blocks the device path flags (codes over 32 bits, or a payload over the
word budget: neither happens for real data below ~2 MB blocks) are
re-encoded by the host-exact codec, so the output is bit-exact either way;
:data:`COUNTS` records how many were.
"""

from __future__ import annotations

import numpy as np
import torch

from .format import ArrayTree, DEFAULT_BLOCK_SIZE, pack_block, serialize_tree
from . import native
from .ops import device as dev
from .ops import hostref
from .utils.trace import annotate

# Blocks per device batch: 128 x 64 KiB = 8.4 MiB.
DEFAULT_BATCH_BLOCKS = 128

# Blocks re-encoded on the host since the last reset (see module docstring).
COUNTS = {"host_reencoded_blocks": 0}


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


def resolve_device(device) -> torch.device:
    """The torch device the kernels run on.  CUDA must be present unless
    the caller asked for the CPU by name: there is no silent CPU route."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain-torch twins of the kernels")
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


def _encode_batch(batch: np.ndarray, n_valid: np.ndarray,
                  device: torch.device) -> list[bytes]:
    """Encode a (B, N) uint8 batch; returns per-block wire bytes."""
    W = _pack_params(batch.shape[1])
    with annotate("huff.encode.device"):
        blocks = torch.from_numpy(batch).to(device)
        nv = torch.from_numpy(n_valid).to(device)
        res = dev.encode_blocks(blocks, nv, W)
    return _assemble_batch(batch, n_valid, res, W)


def _assemble_batch(batch: np.ndarray, n_valid: np.ndarray, res,
                    W: int) -> list[bytes]:
    """Transfer + assemble one device batch's results into wire bytes."""
    payload, total_bits, left, right, root, overflow = res
    with annotate("huff.encode.d2h"):
        total_bits_h = total_bits.cpu().numpy()
        overflow_h = overflow.cpu().numpy()
        # Transfer only a bucketed prefix of the padded payload buffer: the
        # worst-case row is 4W bytes but typical payloads are ~0.6N.
        maxb = _bucket(max(1, (int(total_bits_h.max()) + 7) // 8), 1024)
        payload_h = payload[:, : min(maxb, 4 * W)].cpu().numpy()
        left_h = left.cpu().numpy()
        right_h = right.cpu().numpy()
        root_h = root.cpu().numpy()

    trees = lens_t = None
    if native.available():
        trees, lens_t = native.serialize_trees(left_h, right_h, root_h)

    if trees is not None and not overflow_h.any():
        # Whole-batch native assembly (reference emit order,
        # src/encoder.c:325-351); n_valid == 0 rows are padding, skipped.
        with annotate("huff.encode.assemble"):
            plens = (total_bits_h.astype(np.int64) + 7) // 8
            return [native.assemble_blocks(
                n_valid.astype(np.uint64), trees, lens_t, payload_h, plens)]

    out = []
    with annotate("huff.encode.assemble"):
        for b in range(len(batch)):
            nv = int(n_valid[b])
            if nv == 0:
                continue  # padding block
            if overflow_h[b]:
                COUNTS["host_reencoded_blocks"] += 1
                out.append(hostref.encode_block(batch[b, :nv]))
                continue
            if trees is not None:
                tree = trees[b, : lens_t[b]]
            else:
                tree = serialize_tree(
                    ArrayTree(left_h[b], right_h[b], int(root_h[b])))
            nbytes = (int(total_bits_h[b]) + 7) // 8
            out.append(pack_block(nv, tree, payload_h[b, :nbytes].tobytes()))
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
    positional knobs and the device (config.length caps the input).
    """
    buf = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview))
           else np.asarray(data, dtype=np.uint8))
    if config is not None:
        blocksize = config.blocksize
        batch_blocks = config.batch_blocks
        device = config.device
        if config.length:
            buf = buf[: config.length]
    device = resolve_device(device)
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
    nblocks = -(-n // blocksize)

    chunks: list[bytes] = []
    for start in range(0, nblocks, batch_blocks):
        nb = min(batch_blocks, nblocks - start)
        batch = np.zeros((_bucket_blocks(nb), blocksize), dtype=np.uint8)
        n_valid = np.zeros(len(batch), dtype=np.int32)
        for i in range(nb):
            off = (start + i) * blocksize
            seg = buf[off : off + blocksize]
            batch[i, : len(seg)] = seg
            n_valid[i] = len(seg)
        chunks.extend(_encode_batch(batch, n_valid, device))
    return b"".join(chunks)
