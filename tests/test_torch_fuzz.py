"""Property-based fuzzing of the port (the form of tests/test_fuzz.py).

Arbitrary inputs, blocksizes, corruptions, truncations and garbage go
through ``libhuffman_tpu_torch`` with ``device="cpu"`` (the kernels'
plain-torch twins).  Wire bytes are held against ``ops/hostref.encode``;
decoded bytes, or the class of the error raised, against ``ops/hostref``
and the port's host route (``use_device=False``), exactly.
"""

import pytest

hyp = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

from libhuffman_tpu.ops import hostref
from libhuffman_tpu_torch import api
from libhuffman_tpu_torch import decode as dec_mod
from libhuffman_tpu_torch import encode as enc_mod
from torch_port_util import one_torch_thread  # noqa: F401

_fuzz = settings(
    max_examples=40,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)


def _outcome(fn):
    """Decoded bytes, or the name of the error class raised."""
    try:
        return fn()
    except Exception as e:  # the class is the result under test
        return type(e).__name__


def _decode_all_ways(stream: bytes):
    """The device route on the twins, the host route and hostref agree;
    returns their common outcome."""
    got = _outcome(lambda: dec_mod.decode(stream, device="cpu"))
    assert got == _outcome(lambda: dec_mod.decode(stream, use_device=False))
    assert got == _outcome(lambda: hostref.decode(stream))
    return got


@given(
    data=st.binary(min_size=1, max_size=4096),
    blocksize=st.integers(min_value=1, max_value=1024),
)
@_fuzz
def test_roundtrip_any_input(data, blocksize):
    enc = enc_mod.encode(data, blocksize, device="cpu")
    assert enc == hostref.encode(data, blocksize)
    assert _decode_all_ways(enc) == data


@given(
    data=st.binary(min_size=1, max_size=2048),
    blocksize=st.integers(min_value=1, max_value=512),
    flips=st.lists(
        st.tuples(st.integers(min_value=0),
                  st.integers(min_value=1, max_value=255)),
        min_size=1,
        max_size=8,
    ),
)
@_fuzz
def test_corrupted_stream(data, blocksize, flips):
    """Arbitrary byte corruption decodes to the same bytes, or raises the
    same HuffmanError subclass, on every route."""
    enc = bytearray(hostref.encode(data, blocksize))
    for pos, delta in flips:
        enc[pos % len(enc)] ^= delta
    got = _decode_all_ways(bytes(enc))
    assert isinstance(got, bytes) or got.endswith("Error")


@given(
    data=st.binary(min_size=1, max_size=2048),
    blocksize=st.integers(min_value=1, max_value=512),
    cut=st.floats(min_value=0.0, max_value=1.0, exclude_max=True),
)
@_fuzz
def test_truncated_stream(data, blocksize, cut):
    """A strict prefix decodes (only when block-aligned) or raises alike on
    every route, and decode_prefix recovers exactly the complete blocks and
    the resume offset on both routes."""
    enc = hostref.encode(data, blocksize)
    n = int(cut * len(enc))
    prefix = enc[:n]
    got = _decode_all_ways(prefix)
    if isinstance(got, bytes):
        assert data.startswith(got)
        assert hostref.encode(data[: len(got)], blocksize) == prefix
    out, consumed = dec_mod.decode_prefix(prefix, device="cpu")
    assert (out, consumed) == dec_mod.decode_prefix(prefix, use_device=False)
    assert consumed <= n
    assert data.startswith(out)
    if consumed:
        assert enc[:consumed] == hostref.encode(data[: len(out)], blocksize)


@given(garbage=st.binary(min_size=0, max_size=512))
@_fuzz
def test_garbage_input(garbage):
    """Pure garbage: the same outcome on every route; b"" decodes to b""."""
    got = _decode_all_ways(garbage)
    if garbage == b"":
        assert got == b""


@given(
    parts=st.lists(st.binary(min_size=0, max_size=700), min_size=1,
                   max_size=6),
    blocksize=st.integers(min_value=1, max_value=256),
)
@_fuzz
def test_incremental_compressor_equivalence(parts, blocksize):
    """Chunked compression is wire-identical to one-shot and to hostref."""
    comp = api.HuffmanCompressor(blocksize, device="cpu")
    out = b"".join(comp.compress(p) for p in parts) + comp.flush()
    whole = b"".join(parts)
    assert out == api.compress(whole, blocksize, device="cpu")
    assert out == hostref.encode(whole, blocksize)


@given(
    data=st.binary(min_size=1, max_size=2000),
    chunk=st.integers(min_value=1, max_value=97),
)
@_fuzz
def test_incremental_decompressor_byte_drip(data, chunk):
    enc = hostref.encode(data, 128)
    d = api.HuffmanDecompressor(device="cpu")
    out = b"".join(d.decompress(enc[i : i + chunk])
                   for i in range(0, len(enc), chunk))
    assert out == data
