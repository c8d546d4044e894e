"""The port's block-aligned resume and its tracing and timing hooks.

The cases of tests/test_resume.py, run through ``libhuffman_tpu_torch``
with ``device="cpu"`` (the kernels' plain-torch twins).  Wire bytes are
held against ``ops/hostref.encode`` and decoded bytes against the input,
exactly; the first stream is also held against ``libhuffman_tpu.resume``
itself (``encode_range``, ``block_offsets``, ``decode_from_block``; Pallas
in interpret mode on the CPU).
"""

import json

import numpy as np
import pytest

from libhuffman_tpu import resume as jresume
from libhuffman_tpu.ops import hostref
from libhuffman_tpu_torch import decode as dec_mod
from libhuffman_tpu_torch import encode as enc_mod
from libhuffman_tpu_torch import resume
from libhuffman_tpu_torch.errors import ReadWriteError
from libhuffman_tpu_torch.utils import trace
from torch_port_util import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}


def _corpus(n=5000, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(97, 105, n, dtype=np.uint8).tobytes()


def test_encode_range_partition_identity():
    data = _corpus()
    bs = 512
    full = enc_mod.encode(data, bs, **CPU)
    assert full == hostref.encode(data, bs)
    total = resume.n_blocks(len(data), bs)
    assert total == -(-len(data) // bs) == jresume.n_blocks(len(data), bs)
    parts = [
        resume.encode_range(data, bs, 0, 3, **CPU),
        resume.encode_range(data, bs, 3, 7, **CPU),
        resume.encode_range(data, bs, 7, None, **CPU),
    ]
    assert b"".join(parts) == full
    assert parts[1] == jresume.encode_range(data, bs, 3, 7)
    per_block = b"".join(
        resume.encode_range(data, bs, k, k + 1, **CPU) for k in range(total))
    assert per_block == full


def test_encode_range_edges():
    data = _corpus(100)
    assert resume.encode_range(data, 64, 5, 5, **CPU) == b""
    assert resume.encode_range(data, 64, 99, None, **CPU) == b""
    assert resume.encode_range(b"", 64, **CPU) == b""
    assert resume.n_blocks(0) == 0
    assert resume.n_blocks(100, 0) == 1  # blocksize 0 = whole input
    assert resume.encode_range(data, 0, **CPU) == hostref.encode(data, 0)


def test_block_offsets_and_decode_from_block():
    data = _corpus()
    bs = 512
    stream = hostref.encode(data, bs)
    offs = resume.block_offsets(stream)
    total = resume.n_blocks(len(data), bs)
    assert len(offs) == total and offs[0] == 0
    assert offs == sorted(offs)
    assert offs == jresume.block_offsets(stream)
    for k in (0, 1, total // 2, total - 1):
        assert resume.decode_from_block(stream, k, **CPU) == data[k * bs :], k
    got = resume.decode_from_block(stream, 2, 5, **CPU)
    assert got == data[2 * bs : 5 * bs]
    assert got == jresume.decode_from_block(stream, 2, 5)
    assert resume.decode_from_block(stream, total, None, **CPU) == b""


def test_block_offsets_without_the_native_runtime(monkeypatch):
    """The host-reference scan gives the same offsets and errors as the
    native one."""
    stream = hostref.encode(_corpus(), 512)
    want = resume.block_offsets(stream)
    monkeypatch.setattr(resume.native, "available", lambda: False)
    assert resume.block_offsets(stream) == want
    with pytest.raises(ReadWriteError):
        resume.block_offsets(stream[:-1])


def test_block_offsets_truncated_raises():
    stream = hostref.encode(_corpus(600), 256)
    with pytest.raises(ReadWriteError):
        resume.block_offsets(stream[:-1])


def test_trace_timings_and_annotations():
    trace.reset_timings()
    trace.enable_timing(True)
    try:
        data = _corpus(2000)
        stream = enc_mod.encode(data, 512, **CPU)
        assert dec_mod.decode(stream, **CPU) == data
        t = trace.get_timings()
        assert "huff.encode.device" in t and len(t["huff.encode.device"]) >= 1
        assert "huff.encode.assemble" in t
        assert "huff.decode.scan" in t and "huff.decode.walk" in t
        assert all(v >= 0 for vs in t.values() for v in vs)
    finally:
        trace.enable_timing(False)
    trace.reset_timings()
    assert trace.get_timings() == {}


def test_annotate_is_silent_when_disabled():
    trace.reset_timings()
    with trace.annotate("huff.test.span"):
        pass
    with trace.timed("huff.test.timed"):
        pass
    assert trace.get_timings() == {}


def test_timed_records_when_enabled():
    trace.reset_timings()
    trace.enable_timing(True)
    try:
        with trace.timed("huff.test.timed"):
            pass
        with trace.annotate("huff.test.span"):
            pass
    finally:
        trace.enable_timing(False)
    t = trace.get_timings()
    trace.reset_timings()
    assert sorted(t) == ["huff.test.span", "huff.test.timed"]


def test_start_and_stop_trace_write_the_spans(tmp_path):
    stream = hostref.encode(_corpus(2000), 512)
    trace.start_trace(tmp_path / "trace")
    with pytest.raises(RuntimeError):
        trace.start_trace(tmp_path / "again")
    try:
        dec_mod.decode(stream, **CPU)
    finally:
        path = trace.stop_trace()
    with pytest.raises(RuntimeError):
        trace.stop_trace()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"huff.decode.scan", "huff.decode.device",
            "huff.decode.walk"} <= names
