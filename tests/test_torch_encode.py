"""The port's encode slice against the JAX package and the host codec.

``libhuffman_tpu_torch.encode.encode(data, bs, device="cpu")`` runs the
port's whole encode path with the kernels' plain-torch twins; its wire bytes
must equal ``libhuffman_tpu.encode.encode`` (the JAX path, Pallas kernels in
interpret mode on the CPU) and ``hostref.encode`` byte for byte, and the
port's decode must return the input.
"""

import pytest

from libhuffman_tpu import encode as jenc
from libhuffman_tpu.ops import hostref
from libhuffman_tpu_torch import decode as tdec
from libhuffman_tpu_torch import encode as tenc
from torch_port_util import one_torch_thread  # noqa: F401
from torch_port_util import corpora, routes

_CORPUS = corpora()
_SIZE = 40000


def _check(data: bytes, bs: int, **kw):
    got = tenc.encode(data, bs, device="cpu", **kw)
    assert got == hostref.encode(data, bs)
    assert got == jenc.encode(data, bs, **kw)
    assert tdec.decode(got, device="cpu") == data


@pytest.mark.parametrize("data,bs", [
    (b"0123456789", 65536),
    (b"1", 256),
    (b"aab", 65536),
    (b"aabba", 2),
    (b"a" * 1000, 131072),
    (b"\x00" * 4096, 256),
    (bytes(range(256)) * 17, 1024),
], ids=["digits", "one-byte", "aab", "aabba-bs2", "single-symbol-run",
        "zero-run", "all-256-symbols"])
def test_golden_small(data, bs):
    _check(data, bs)


@pytest.mark.parametrize("bs,batch_blocks", [(1024, 128), (512, 16)])
def test_multiblock_batching(bs, batch_blocks):
    """40 blocks in one batch, and 79 blocks in five batches.  Held against
    hostref only: the JAX package fuses several batches into one program
    whose compile would dominate this file, and its own test_device_encode
    holds that program against hostref on this same input."""
    data = (b"The quick brown fox jumps over the lazy dog. " * 1000)[:40000]
    got = tenc.encode(data, bs, batch_blocks=batch_blocks, device="cpu")
    assert got == hostref.encode(data, bs)
    assert tdec.decode(got, device="cpu") == data


@pytest.mark.parametrize("bs", [4096, 8192])
@pytest.mark.parametrize("family", ["text", "samba", "xray"])
def test_corpus(family, bs):
    _check(_CORPUS.FAMILIES[family](_SIZE), bs)


@pytest.mark.parametrize("bs", [0, 3072, 5120])
def test_blocksizes_off_the_pow2_packer(bs):
    """Whole-input blocks and non-pow2 blocksizes, which the JAX package
    routes through its XLA fallbacks; the port's kernels take any N."""
    _check(_CORPUS.text(_SIZE // 2), bs)


def test_decode_routes_and_counts_on_cpu():
    """Both decode routes read the port's stream, and the device route on
    CPU tensors counts its block as device-decoded."""
    stream = tenc.encode(b"abracadabra", 4096, device="cpu")
    assert tdec.decode(stream, use_device=False) == b"abracadabra"
    tdec.COUNTS.update(host_decoded_blocks=0, device_decoded_blocks=0)
    assert tdec.decode(stream, device="cpu") == b"abracadabra"
    assert routes(tdec.COUNTS) == {"host_decoded_blocks": 0,
                                   "device_decoded_blocks": 1}
    assert tdec.decode_prefix(stream + stream[:5], device="cpu") == (
        b"abracadabra", len(stream))
    assert tdec.decode_prefix(stream + stream[:5], use_device=False) == (
        b"abracadabra", len(stream))
