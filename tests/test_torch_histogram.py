"""The port's ``Histogram`` (tests/test_histogram.py's cases), held against
``libhuffman_tpu.histogram.Histogram`` and ``ops/hostref.histogram``."""

import numpy as np
import pytest

from libhuffman_tpu.histogram import Histogram as JHistogram
from libhuffman_tpu.ops import hostref
from libhuffman_tpu_torch.errors import InvalidArgumentError
from libhuffman_tpu_torch.histogram import Histogram


def u32(*vals) -> bytes:
    return np.asarray(vals, "<u4").tobytes()


def test_allocation():
    h = Histogram(2, 10)
    assert h.iota == 2
    assert h.length == 10
    assert h.start == -1
    assert (h.frequencies == 0).all()


def test_populate_accumulates():
    h = Histogram(4, 10)
    h.populate(u32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9))
    assert h.start == 0
    assert (h.frequencies == 1).all()
    h.populate(u32(0, 0, 1, 1, 8, 8, 8, 8))
    assert h.start == 0
    assert h.frequencies.tolist() == [3, 3, 1, 1, 1, 1, 1, 1, 5, 1]


def test_single_value():
    h = Histogram(4, 10)
    h.populate(u32(1, 1, 1, 1, 1))
    assert h.frequencies[1] == 5


def test_start_tracks_minimum():
    h = Histogram(4, 10)
    h.populate(u32(4, 4, 5, 5, 5, 5, 9))
    assert h.start == 4
    h.populate(u32(1, 1, 1, 8, 8, 8))
    assert h.start == 1


def test_reset():
    h = Histogram(4, 10)
    data = u32(3, 3, 3, 3, 6, 7, 7, 1, 1, 2, 7, 7)
    rates = [0, 2, 1, 4, 0, 0, 1, 4, 0, 0]
    h.populate(data)
    assert h.start == 1
    assert h.frequencies.tolist() == rates
    h.reset()
    assert h.start == -1
    assert (h.frequencies == 0).all()
    h.populate(data)
    assert h.start == 1
    assert h.frequencies.tolist() == rates


def test_ragged_tail_ignored():
    h = Histogram(4, 10)
    h.populate(u32(2, 2) + b"\x03")
    assert h.frequencies[2] == 2
    assert h.frequencies[3] == 0


def test_invalid_args():
    with pytest.raises(InvalidArgumentError):
        Histogram(0, 10)
    with pytest.raises(InvalidArgumentError):
        Histogram(4, 0)
    h = Histogram(1, 4)
    with pytest.raises(InvalidArgumentError):
        h.populate(b"\x09")  # element value outside [0, length)


@pytest.mark.parametrize("iota", [1, 2, 3, 8])
def test_matches_the_jax_package(iota):
    """Random populates at every width: the same frequencies and start as
    the JAX package's class, and at iota 1 as the encoder's byte
    histogram."""
    rng = np.random.default_rng(iota)
    length = 300 if iota > 1 else 256
    ours, theirs = Histogram(iota, length), JHistogram(iota, length)
    for n in (0, 5, 1000, 7 * iota + 1):
        vals = rng.integers(0, length, n // iota, dtype=np.uint64)
        raw = b"".join(int(v).to_bytes(8, "little")[:iota] for v in vals)
        raw += bytes(n % iota)  # a ragged tail
        ours.populate(raw)
        theirs.populate(raw)
        assert np.array_equal(ours.frequencies, theirs.frequencies)
        assert ours.start == theirs.start
    if iota == 1:
        ours.reset()
        block = rng.integers(0, 256, 4096, dtype=np.uint8)
        ours.populate(block.tobytes())
        assert np.array_equal(ours.frequencies,
                              hostref.histogram(block)[:256])
