"""The port's whole-stream decode against the JAX package and the host codec.

``libhuffman_tpu_torch.decode.decode(stream, device="cpu")`` runs the port's
whole device-decode route with the kernels' plain-torch twins.  Its bytes,
or its error class, must equal ``libhuffman_tpu.decode.decode`` (the JAX
device route, Pallas kernels in interpret mode on the CPU) and
``hostref.decode`` on every case.  Streams are written by the host codec.
"""

import struct

import numpy as np
import pytest
import torch

from libhuffman_tpu import decode as jdec
from libhuffman_tpu.ops import hostref
from libhuffman_tpu_torch import decode as tdec
from torch_port_util import one_torch_thread  # noqa: F401
from torch_port_util import corpora, routes

_CORPUS = corpora()
_SIZE = 12000


def _reset():
    for k in tdec.COUNTS:
        tdec.COUNTS[k] = 0


def _outcome(fn, stream):
    """Decoded bytes, or the name of the error class raised."""
    try:
        return fn(stream)
    except Exception as e:  # the class is the result under test
        return type(e).__name__


def _check(stream: bytes, data=None) -> bytes | str:
    """Port (twins) == JAX device route == hostref, bytes or error class."""
    _reset()
    got = _outcome(lambda s: tdec.decode(s, device="cpu"), stream)
    assert got == _outcome(jdec.decode, stream)
    assert got == _outcome(hostref.decode, stream)
    if data is not None:
        assert got == data
    return got


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
    _check(hostref.encode(data, bs), data)


@pytest.mark.parametrize("bs", [0, 1024, 4096, 65536])
@pytest.mark.parametrize("family", ["text", "samba", "xray"])
def test_corpus(family, bs):
    data = _CORPUS.FAMILIES[family](_SIZE)
    _check(hostref.encode(data, bs), data)
    assert tdec.COUNTS["device_decoded_blocks"] > 0


def _errors():
    good = hostref.encode(b"0123456789", 65536)
    bad_tree = bytearray(good)
    bad_tree[8:10] = (3).to_bytes(2, "little")
    run = hostref.encode(b"a" * 10000, 0)
    flipped = bytearray(hostref.encode(_CORPUS.text(_SIZE), 4096))
    flipped[23] ^= 0x40  # a tree bit whose flip leaves a missing child
    return {
        "empty": b"",
        "garbage-header": (b"\xde\xad\xbe\xef\x00\x00\x00\x00\xff\x7f"
                           + b"\x00" * 16),
        "truncated-header": good[:20],
        "bad-tree-length": bytes(bad_tree),
        "truncated-payload": run[:-1],
        "trailing-garbage": good + b"\x01\x02\x03",
        "tree-bit-flip": bytes(flipped),
    }


@pytest.mark.parametrize("case", list(_errors()))
def test_errors_match(case):
    stream = _errors()[case]
    got = _check(stream)
    if case == "empty":
        assert got == b""
    else:
        assert got in ("ReadWriteError", "BtreeOverflowError",
                       "BtreeCorruptedError"), got


def _dense_run_block() -> bytes:
    """One 64 KiB block whose run region is much denser than its mean
    (the JAX package's emission-clamp construction)."""
    rng = np.random.default_rng(77)
    head = rng.integers(0, 256, 28 << 10, dtype=np.uint8).tobytes()
    return head + b"a" * (18 << 10) + b"b" * (18 << 10)


def test_dense_run_block_decodes_on_the_device():
    """The TPU clamps its emission and re-decodes this block on the host;
    the port's emission has no clamp and decodes it exactly."""
    data = _dense_run_block()
    _check(hostref.encode(data, 0), data)
    assert routes(tdec.COUNTS) == {"host_decoded_blocks": 0,
                                   "device_decoded_blocks": 1}


def test_tightened_cap_short_read_retries_on_host(monkeypatch):
    """A speculative cap below the true payload (a false candidate inside
    the payload) sends the block to the host walk, which stays exact."""
    data = (b"The retry path must stay byte-exact under short caps. " * 3000
            )[:96 << 10]
    stream = hostref.encode(data, 4096)
    orig = tdec._payload_cap
    monkeypatch.setattr(tdec, "_payload_cap",
                        lambda c, depth, nxt: max(96, orig(c, depth, nxt) // 3))
    _check(stream, data)
    assert tdec.COUNTS["host_decoded_blocks"] > 0
    assert tdec.COUNTS["host_capshort_blocks"] == tdec.COUNTS[
        "host_decoded_blocks"]


def test_non_unary_root_tree_takes_the_host_route():
    """A crafted tree whose root has a real right child ("a" = 0, "b" = 1):
    the encoder never writes one, the native table build rejects it, and the
    host walk decodes it."""
    tree = [256, ord("a"), -1, -1, ord("b"), -1, -1]
    stream = (struct.pack("<Q", 4) + struct.pack("<h", len(tree))
              + b"".join(struct.pack("<h", v) for v in tree)
              + bytes([0b01100000]))
    _check(stream, b"abba")
    assert routes(tdec.COUNTS) == {"host_decoded_blocks": 1,
                                   "device_decoded_blocks": 0}
    assert tdec.COUNTS["host_deep_blocks"] == 1


def test_decode_prefix_stops_at_a_truncated_tail():
    data = _CORPUS.text(_SIZE)
    stream = hostref.encode(data, 4096)
    cut = stream + stream[:5]
    want = (data, len(stream))
    assert tdec.decode_prefix(cut, device="cpu") == want
    assert jdec.decode_prefix(cut) == want
    assert tdec.decode_prefix(cut, use_device=False) == want
    tail = stream[: len(stream) - 3]
    got, off = tdec.decode_prefix(tail, device="cpu")
    assert (got, off) == jdec.decode_prefix(tail)
    assert data.startswith(got) and 0 < off < len(tail)


def test_device_route_without_native_runtime_raises(monkeypatch):
    """Without the native runtime, which builds the resolve tables, the
    device route raises and names g++, rather than walking every block on
    the host unseen."""
    from libhuffman_tpu_torch import native

    stream = hostref.encode(b"abracadabra", 4096)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tdec.decode(stream, device="cpu")
    assert tdec.decode(stream, use_device=False) == b"abracadabra"


def test_default_device_raises_without_cuda(monkeypatch):
    stream = hostref.encode(b"abracadabra", 4096)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdec.decode(stream)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdec.decode_prefix(stream)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdec.decode(stream, length=len(stream))
    assert tdec.decode(stream, use_device=False) == b"abracadabra"
    assert tdec.decode(stream, length=len(stream),
                       device="cpu") == b"abracadabra"
    assert tdec.decode_prefix(stream, use_device=False) == (
        b"abracadabra", len(stream))
