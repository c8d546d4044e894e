"""The port's bz2-style API against the host codec and the JAX package.

The cases of tests/test_api.py, run through ``libhuffman_tpu_torch.api``
with ``device="cpu"`` (the kernels' plain-torch twins).  Wire bytes are held
against ``ops/hostref.encode`` (where test_api.py asks the C oracle) and
decoded bytes against the input, both exactly; the first case is also held
against ``libhuffman_tpu.api`` itself (Pallas in interpret mode on the CPU).
"""

import io

import numpy as np
import pytest
import torch

from libhuffman_tpu import api as japi
from libhuffman_tpu import config as jconfig
from libhuffman_tpu import decode as jdec
from libhuffman_tpu.ops import hostref
from libhuffman_tpu_torch import api, config, decode as tdec, resume
from libhuffman_tpu_torch import native as tnative
from libhuffman_tpu_torch.errors import HuffmanError
from libhuffman_tpu_torch.format import parse_block_header
from libhuffman_tpu_torch.ops import hostref as thostref
from libhuffman_tpu_torch.streams import MemStream
from torch_port_util import one_torch_thread  # noqa: F401
from torch_port_util import routes

CPU = {"device": "cpu"}


def _outcome(fn):
    """Decoded bytes, or the name of the error class raised."""
    try:
        return fn()
    except Exception as e:  # the class is the result under test
        return type(e).__name__


# ---- the cases of tests/test_api.py, one for one ------------------------

def test_compress_decompress():
    data = b"a" * 1000
    c = api.compress(data, **CPU)
    assert c == hostref.encode(data, 131072)
    assert c == japi.compress(data)
    assert api.decompress(c, **CPU) == data
    assert japi.decompress(c) == data


def test_decompress_corrupted():
    data = b"\x08\x00\x00\x00\x00\x00\x00\x00\x02\x00"
    with pytest.raises(HuffmanError):
        api.decompress(data, **CPU)
    got = _outcome(lambda: api.decompress(data, **CPU))
    assert got == _outcome(lambda: hostref.decode(data))
    assert got == _outcome(lambda: japi.decompress(data))


def test_compress_incremental():
    comp = api.HuffmanCompressor(**CPU)
    out = b""
    data = b""
    for _ in range(10):
        part = b"z" * 1000
        out += comp.compress(part)
        data += part
    out += comp.flush()
    assert out == hostref.encode(data, 131072)
    assert api.decompress(out, **CPU) == data


def test_write_file(tmp_path):
    data = """\
    Donec rhoncus quis sapien sit amet molestie. Fusce scelerisque vel augue
    nec ullamcorper. Nam rutrum pretium placerat. Aliquam vel tristique lorem,
    sit amet cursus ante. In interdum laoreet mi, sit amet ultrices purus
    pulvinar a. Nam gravida euismod magna, non varius justo tincidunt feugiat.
    Aliquam pharetra lacus non risus vehicula rutrum. Maecenas aliquam leo
    felis. Pellentesque semper nunc sit amet nibh ullamcorper, ac elementum
    dolor luctus. Curabitur lacinia mi ornare consectetur vestibulum."""

    filename = tmp_path / "archive.hm"
    with api.open(filename, "wt", **CPU) as f:
        f.write(data)
    assert filename.read_bytes() == hostref.encode(data.encode(), 131072)
    with api.open(filename, "rt", **CPU) as f:
        assert f.read() == data


def test_incremental_compressor_wire_equivalence():
    data = bytes(np.random.default_rng(1).integers(32, 127, 5000,
                                                   dtype=np.uint8))
    comp = api.HuffmanCompressor(1024, **CPU)
    out = b""
    for i in range(0, len(data), 700):
        out += comp.compress(data[i : i + 700])
    out += comp.flush()
    assert out == hostref.encode(data, 1024)
    assert api.decompress(out, **CPU) == data


def test_incremental_decompressor():
    data = b"The quick brown fox. " * 500
    enc = hostref.encode(data, 1024)
    dec = api.HuffmanDecompressor(**CPU)
    out = b""
    for i in range(0, len(enc), 333):  # arbitrary chunking incl. mid-header
        out += dec.decompress(enc[i : i + 333])
    assert out == data


def test_incremental_decompressor_drip_walk_is_linear(monkeypatch):
    """Byte-drip feeding a one-block stream walks each payload byte at most
    once in total: the resumable walk of ``_tail_need``, counted through
    both walk backends' module attributes."""
    data = bytes(np.random.default_rng(7).integers(97, 123, 1 << 15,
                                                   dtype=np.uint8))
    enc = hostref.encode(data, 0)  # blocksize 0: one block

    walked = [0]

    def counting(real):
        def walk(tree, payload, n_sym, state=None):
            pos0 = state[2] if state else 0
            restored, st = real(tree, payload, n_sym, state)
            walked[0] += st[2] - pos0
            return restored, st
        return walk

    monkeypatch.setattr(tnative, "walk_progress_resume",
                        counting(tnative.walk_progress_resume))
    monkeypatch.setattr(thostref, "walk_progress_resume",
                        counting(thostref.walk_progress_resume))

    dec = api.HuffmanDecompressor(**CPU)
    out = b""
    for i in range(0, len(enc), 97):  # sub-block chunks, mid-header feeds
        out += dec.decompress(enc[i : i + 97])
    assert out == data
    assert 0 < walked[0] <= len(enc), (walked[0], len(enc))


def test_native_walk_matches_hostref():
    """The native measurement walks count what ``ops/hostref``'s count on
    every cut of a block's payload, and a resumed walk ends where a
    one-shot walk does."""
    data = bytes(np.random.default_rng(9).integers(0, 90, 3000,
                                                   dtype=np.uint8))
    enc = hostref.encode(data, 0)
    hdr = parse_block_header(memoryview(enc), 0)
    tree = np.asarray(hdr.tree, np.int16)
    payload = np.frombuffer(enc, np.uint8, offset=hdr.payload_off)
    state = hstate = None
    for cut in range(0, len(payload) + 1, 37):
        want = thostref.walk_progress(tree, payload[:cut], hdr.n_sym)
        assert tnative.walk_progress(tree, payload[:cut], hdr.n_sym) == want
        got, state = tnative.walk_progress_resume(tree, payload[:cut],
                                                  hdr.n_sym, state)
        assert (got, state) == thostref.walk_progress_resume(
            tree, payload[:cut], hdr.n_sym, hstate)
        hstate = state
        assert got == want
    assert tnative.walk_progress(tree, payload, hdr.n_sym) == len(data)


def test_incremental_decompressor_big_drip_linear_buffer():
    """A multi-block stream dripped in 4 KiB pieces.  Smaller than
    test_api.py's 1 MiB of 64 KiB blocks: each feed that may complete a
    block runs the whole decode route on the twins, whose chain costs
    about 0.3 s per 64 KiB block on the CPU.  The buffer starts at 4 KiB,
    under the stream's size, so that compaction has to keep it small."""
    rng = np.random.default_rng(11)
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)),
                                dtype=np.uint8)) for _ in range(64)]
    data = b" ".join(words[int(i)] for i in
                     rng.integers(0, 64, 45_000))[: 1 << 18]
    enc = hostref.encode(data, 16384)
    dec = api.HuffmanDecompressor(4096, **CPU)
    out = []
    for i in range(0, len(enc), 4096):
        out.append(dec.decompress(enc[i : i + 4096]))
    assert b"".join(out) == data
    # Compaction keeps the capacity near the largest pending tail, not the
    # stream's history.
    assert len(dec._buf) < len(enc), (len(dec._buf), len(enc))


def test_compressor_after_flush_raises():
    comp = api.HuffmanCompressor(**CPU)
    comp.compress(b"abc")
    comp.flush()
    with pytest.raises(ValueError):
        comp.compress(b"more")
    assert comp.flush() == b""


def test_huffmanfile_binary_roundtrip(tmp_path):
    data = bytes(np.random.default_rng(2).integers(0, 250, 300000,
                                                   dtype=np.uint8))
    fn = tmp_path / "blob.hm"
    with api.HuffmanFile(fn, "wb", blocksize=4096, **CPU) as f:
        for i in range(0, len(data), 50000):
            f.write(data[i : i + 50000])
    assert fn.read_bytes() == hostref.encode(data, 4096)
    out = b""
    with api.HuffmanFile(fn, "rb", **CPU) as f:
        while True:
            part = f.read(8192)
            if not part and f._fp.peek(1) == b"":  # EOF of underlying file
                break
            out += part
    assert out == data


def test_huffmanfile_fileobj():
    bio = io.BytesIO()
    with api.HuffmanFile(bio, "wb", **CPU) as f:
        f.write(b"hello fileobj")
    bio.seek(0)
    with api.HuffmanFile(bio, "rb", **CPU) as f:
        assert f.read(10 ** 6) == b"hello fileobj"


def test_huffmanfile_modes(tmp_path):
    fn = tmp_path / "m.hm"
    with pytest.raises(ValueError):
        api.HuffmanFile(fn, "q", **CPU)
    f = api.HuffmanFile(fn, "wb", **CPU)
    assert f.writable() and not f.seekable()
    with pytest.raises(io.UnsupportedOperation):
        f.read()
    f.close()
    f.close()  # double close ok
    with pytest.raises(ValueError):
        f.writable()  # closed
    with pytest.raises(TypeError):
        api.HuffmanFile(123, **CPU)


def test_memstream_write_len_and_doubling():
    s = MemStream(4)
    s.write(b"abcd")
    assert len(s) == 4 and s.capacity == 4
    s.write(b"ef")  # forces doubling realloc (io.c:84-103)
    assert len(s) == 6 and s.capacity == 8
    assert s.getvalue() == b"abcdef"


def test_memstream_cursor_reads():
    s = MemStream(0)
    s.write(b"0123456789")
    assert s.read(4) == b"0123"
    assert len(s) == 6  # len counts unread bytes (huf_memlen)
    assert s.read(100) == b"456789"  # clamped to available
    assert s.read(1) == b""  # empty read at exhaustion
    s.seek(0)
    assert s.read(3) == b"012"
    with pytest.raises(ValueError):
        s.seek(1)
    with pytest.raises(ValueError):
        s.seek(0, io.SEEK_END)


# ---- what the port adds: devices and the decode configuration -----------

def test_new_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Every entry point of the surface raises at once without CUDA when
    ``device`` is left at "cuda": nothing falls back to the CPU."""
    stream = hostref.encode(b"abracadabra", 4096)
    fn = tmp_path / "never.hm"
    fn.write_bytes(stream)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "HuffmanDecompressor": lambda: api.HuffmanDecompressor(),
        "HuffmanFile rb": lambda: api.HuffmanFile(fn, "rb"),
        "HuffmanFile wb": lambda: api.HuffmanFile(tmp_path / "w.hm", "wb"),
        "open rb": lambda: api.open(fn, "rb"),
        "open wt": lambda: api.open(tmp_path / "t.hm", "wt"),
        "decompress": lambda: api.decompress(stream),
        "encode_range": lambda: resume.encode_range(b"abc", 4096, 0, 0),
        "decode_from_block": lambda: resume.decode_from_block(stream, 0),
        "decode config": lambda: tdec.decode(
            stream, config=config.DecodeConfig()),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "w.hm").exists()
    assert not (tmp_path / "t.hm").exists()
    # Asked for by name, the CPU and the host route still work.
    assert api.decompress(stream, device="cpu") == b"abracadabra"
    assert tdec.decode(stream, config=config.DecodeConfig(
        use_device=False)) == b"abracadabra"


def test_decode_config_matches_the_jax_package():
    """``DecodeConfig`` routes the decode and caps what it consumes, as
    ``libhuffman_tpu.config.DecodeConfig`` does."""
    data = bytes(np.random.default_rng(3).integers(0, 60, 9000,
                                                   dtype=np.uint8))
    stream = hostref.encode(data, 4096)
    tail = stream + b"\x01\x02\x03"
    for use_device in (True, False):
        cfg = config.DecodeConfig(length=len(stream), use_device=use_device,
                                  device="cpu")
        jcfg = jconfig.DecodeConfig(length=len(stream), use_device=False)
        assert tdec.decode(tail, config=cfg) == data
        assert jdec.decode(tail, config=jcfg) == data
        full = config.DecodeConfig(use_device=use_device, device="cpu")
        got = _outcome(lambda: tdec.decode(tail, config=full))
        assert got == _outcome(lambda: jdec.decode(
            tail, config=jconfig.DecodeConfig(use_device=False)))
        assert got == _outcome(lambda: hostref.decode(tail))
    tdec.COUNTS.update(host_decoded_blocks=0, device_decoded_blocks=0)
    tdec.decode(stream, config=config.DecodeConfig(use_device=False))
    assert routes(tdec.COUNTS) == {"host_decoded_blocks": 3,
                                   "device_decoded_blocks": 0}
    with pytest.raises(ValueError):
        config.DecodeConfig(length=-1)
