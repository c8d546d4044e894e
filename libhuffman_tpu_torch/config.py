"""Frozen encoder and decoder configurations mirroring ``huf_config_t``.

The reference bundles every tunable into one value-copied struct
(include/huffman/config.h:10-36: length, blocksize, reader_buffer_size,
writer_buffer_size, reader, writer) with zero-value semantics: blocksize == 0
treats the whole input as one block (src/encoder.c:163-165) and zero buffer
sizes mean unbuffered I/O (src/bufio.c:58-68).  These dataclasses carry the
same fields and defaults, plus the device knobs of the PyTorch port (batching,
the decode route and the torch device the kernels run on).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .format import DEFAULT_BLOCK_SIZE, DEFAULT_MEM_LIMIT


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Encoder settings (huf_config_t analogue, encode side).

    length: bytes of input to encode; 0 = the whole input (the reference
        requires an explicit length; 0-means-all matches its Python layer).
    blocksize: bytes per independent block; 0 = single whole-input block
        (src/encoder.c:163-165).
    reader_buffer_size / writer_buffer_size: host I/O buffering hints
        (0 = unbuffered, src/bufio.c:58-68); arrays make them advisory here.
    batch_blocks: blocks per device batch (per device of ``mesh``).
    device: torch device the encode kernels run on ("cuda", "cuda:1", or
        "cpu" for the plain-torch twins).
    mesh: a ``parallel.shard.BlockMesh`` whose devices share the block
        axis: each batch is split into one contiguous row slice per device
        (``parallel.shard.encode_stream_sharded``).  When set it overrides
        ``device``; None runs on ``device`` alone.
    """

    length: int = 0
    blocksize: int = DEFAULT_BLOCK_SIZE
    reader_buffer_size: int = 0
    writer_buffer_size: int = 0
    batch_blocks: int = 256
    device: str = "cuda"
    mesh: Any = None

    def __post_init__(self):
        if self.length < 0 or self.blocksize < 0:
            raise ValueError("length and blocksize must be non-negative")
        if self.batch_blocks <= 0:
            raise ValueError("batch_blocks must be positive")


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decoder settings (huf_config_t analogue, decode side).

    length: compressed bytes to consume; 0 = the whole input.
    memlimit: working-buffer sizing hint (the reference grows its buffer
        past it rather than failing, so it is no cap).
    reader_buffer_size / writer_buffer_size: host I/O buffering hints, as
        in :class:`EncodeConfig`.
    ``decode.decode`` reads only ``length``, ``use_device``, ``device`` and
    ``mesh``:
    ``memlimit`` and the two buffer sizes are kept so the class matches the
    JAX package's field for field, and have no effect on the decode.
    use_device: route eligible blocks through the decode kernels (the
        host-exact walk takes the rest either way); False walks every block
        on the host.
    device: torch device the decode kernels run on ("cuda", "cuda:1", or
        "cpu" for the plain-torch twins).
    mesh: a ``parallel.shard.BlockMesh``: the rows of every device plan
        are split into one contiguous slice per device
        (``parallel.shard.decode_plans_sharded``).  When set it overrides
        ``device``; None runs on ``device`` alone.
    """

    length: int = 0
    memlimit: int = DEFAULT_MEM_LIMIT
    reader_buffer_size: int = 0
    writer_buffer_size: int = 0
    use_device: bool = True
    device: str = "cuda"
    mesh: Any = None

    def __post_init__(self):
        if self.length < 0 or self.memlimit < 0:
            raise ValueError("length and memlimit must be non-negative")
