"""Block-parallel encode and decode over several devices and processes.

The libhuffman format's blocks are fully independent (own histogram, own
tree header, own zero-padded bitstream), so the block axis is the split
axis: no block needs another's data, and the only exchanges are of
per-block or per-range *sizes* for the ordered assembly of the stream.
``shard`` splits a batch over a list of torch devices in one process;
``multihost`` splits a stream over processes with torch.distributed (gloo),
and is imported on its own.
"""

from .shard import (  # noqa: F401
    BlockMesh,
    block_mesh,
    encode_sharded,
    decode_blocks_sharded,
)
