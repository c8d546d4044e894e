"""Frozen encoder configuration mirroring the encode half of ``huf_config_t``.

The reference bundles every tunable into one value-copied struct
(include/huffman/config.h:10-36: length, blocksize, reader_buffer_size,
writer_buffer_size, reader, writer) with zero-value semantics: blocksize == 0
treats the whole input as one block (src/encoder.c:163-165) and zero buffer
sizes mean unbuffered I/O (src/bufio.c:58-68).  This dataclass carries the
same fields and defaults, plus the device knobs of the PyTorch port (batching
and the torch device the kernels run on).
"""

from __future__ import annotations

import dataclasses

from .format import DEFAULT_BLOCK_SIZE


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Encoder settings (huf_config_t analogue, encode side).

    length: bytes of input to encode; 0 = the whole input (the reference
        requires an explicit length; 0-means-all matches its Python layer).
    blocksize: bytes per independent block; 0 = single whole-input block
        (src/encoder.c:163-165).
    reader_buffer_size / writer_buffer_size: host I/O buffering hints
        (0 = unbuffered, src/bufio.c:58-68); arrays make them advisory here.
    batch_blocks: blocks per device batch.
    device: torch device the encode kernels run on ("cuda", "cuda:1", or
        "cpu" for the plain-torch twins).
    """

    length: int = 0
    blocksize: int = DEFAULT_BLOCK_SIZE
    reader_buffer_size: int = 0
    writer_buffer_size: int = 0
    batch_blocks: int = 256
    device: str = "cuda"

    def __post_init__(self):
        if self.length < 0 or self.blocksize < 0:
            raise ValueError("length and blocksize must be non-negative")
        if self.batch_blocks <= 0:
            raise ValueError("batch_blocks must be positive")
