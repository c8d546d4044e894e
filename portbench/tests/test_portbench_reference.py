"""The plain reference codec: the format's golden vectors, round trips,
agreement with the port's own host codec, and the control's difference."""

import numpy as np
import pytest

from _util import ROOT  # noqa: F401
from portbench.reference import codec

# SURVEY.md section 2.9: captured from the compiled C reference.
GOLDEN = [
    (b"0123456789", 65536, bytes.fromhex(
        "0a000000000000002900"
        "09010801050104013100ffffffff3000ffffffff03013300ffffffff3200ffffffff"
        "070100013900ffffffff3800ffffffff060102013500ffffffff3400ffffffff0101"
        "3700ffffffff3600ffffffffffff"
        "10326b1ee540")),
    (b"1", 256, bytes.fromhex("0100000000000000" "0500"
                              "00013100ffffffffffff" "00")),
]


@pytest.mark.parametrize("data,bs,want", GOLDEN)
def test_golden(data, bs, want):
    assert codec.encode(data, bs) == want
    assert codec.decode(want) == data


def test_golden_aab_tree_and_payload():
    out = codec.encode(b"aab", 65536)
    assert len(out) == 29
    tree = np.frombuffer(out, "<i2", count=9, offset=10).tolist()
    assert tree == [257, 256, 98, -1, -1, 97, -1, -1, -1]
    assert out[-1:] == b"\x50"


def test_aabba_three_blocks():
    out = codec.encode(b"aabba", 2)
    assert len(out) == 63 and codec.decode(out) == b"aabba"


@pytest.mark.parametrize("seed", range(6))
def test_round_trip_random(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40000))
    alphabet = int(rng.choice([1, 2, 7, 100, 256]))
    data = rng.integers(0, alphabet, n).astype(np.uint8).tobytes()
    bs = int(rng.choice([1, 3, 1000, 4096, 65536]))
    assert codec.decode(codec.encode(data, bs)) == data


@pytest.mark.parametrize("seed", range(4))
def test_equals_port_host_codec(seed):
    from libhuffman_tpu_torch.ops import hostref
    rng = np.random.default_rng(100 + seed)
    data = (rng.zipf(1.3, 50000) % 256).astype(np.uint8).tobytes()
    for bs in (17, 4096, 65536):
        assert codec.encode(data, bs) == hostref.encode(data, bs)


def test_chunking_does_not_change_the_stream():
    data = np.random.default_rng(3).integers(0, 9, 70000).astype(np.uint8)
    assert codec.encode(data, 1000, chunk_blocks=1) == codec.encode(data, 1000)


def test_control_differs_but_decodes():
    data = np.random.default_rng(4).integers(0, 256, 200000).astype(np.uint8)
    ref = codec.encode(data, 65536)
    ctl = codec.encode(data, 65536, tie_break="smaller")
    assert ctl != ref
    assert codec.decode(ctl) == data.tobytes()
