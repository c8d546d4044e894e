"""Blocks of 1 MiB through the port on the CPU, with the kernels' twins.

The encode's wire bytes equal the benchmark's plain NumPy codec
(``portbench/reference/codec.py``, which imports nothing of the program),
the decode returns the input, and ``decode.COUNTS`` accounts for the blocks
that the device route leaves to the host walk: every block whose payload
passes the 2^18-byte cap of a device plan, and no other.  At 64 KiB blocks
the same data walks no oversized block.

The data is a seeded stand-in of Silesia's families (``portbench/corpus.py``:
text, then xray, then samba): three full 1 MiB blocks and a tail of
4272 bytes.  The tail is short because the twins decode a device plan's
padding rows as dearly as its blocks, and a plan has at least 16 rows.
"""

import struct

import pytest

from libhuffman_tpu_torch import decode as tdec
from libhuffman_tpu_torch import encode as tenc
from portbench import corpus
from portbench.reference import codec
from torch_port_util import one_torch_thread  # noqa: F401

_MIB = 1 << 20
_CAP = 1 << 18  # the largest payload a device plan takes (decode.py)
_REASONS = ("host_oversized_blocks", "host_deep_blocks",
            "host_capshort_blocks", "host_missed_blocks")
_MEMBERS = [{"name": "text", "bytes": 1_300_000, "family": "text"},
            {"name": "xray", "bytes": 1_100_000, "family": "xray"},
            {"name": "samba", "bytes": 750_000, "family": "samba"}]


@pytest.fixture(scope="module")
def data():
    config = {"blocksize": _MIB, "members": _MEMBERS,
              "total_bytes": sum(m["bytes"] for m in _MEMBERS)}
    out = corpus.build(config, seed=16)
    assert len(out) == 3 * _MIB + 4272  # three full blocks and a tail
    return out


def _payload_bytes(block: bytes) -> int:
    """Payload bytes of one encoded block: all of it past the u64 length,
    the i16 tree length and the tree."""
    (tree_len,) = struct.unpack_from("<h", block, 8)
    return len(block) - 10 - 2 * tree_len


@pytest.mark.parametrize("blocksize,oversized", [(_MIB, [0, 1, 2]),
                                                 (64 << 10, [])],
                         ids=["1m", "64k"])
def test_blocks_past_the_device_cap_walk_on_the_host(data, blocksize,
                                                     oversized):
    blocks = [data[i : i + blocksize] for i in range(0, len(data), blocksize)]
    payloads = [_payload_bytes(b) for b in codec.encode_blocks(blocks)]
    assert [i for i, p in enumerate(payloads) if p > _CAP] == oversized

    stream = tenc.encode(data.tobytes(), blocksize, device="cpu")
    assert stream == codec.encode(data, blocksize)

    for k in tdec.COUNTS:
        tdec.COUNTS[k] = 0
    assert tdec.decode(stream, device="cpu") == data.tobytes()
    c = tdec.COUNTS
    assert c["host_oversized_blocks"] == len(oversized)
    assert c["host_walked_bytes"] == sum(len(blocks[i]) for i in oversized)
    assert sum(c[k] for k in _REASONS) == c["host_decoded_blocks"]
    assert c["host_decoded_blocks"] + c["device_decoded_blocks"] == len(
        blocks)
    assert c["host_walked_bytes"] + c["device_out_bytes"] == len(data)
