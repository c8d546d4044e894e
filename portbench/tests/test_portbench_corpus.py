"""The corpus generators: deterministic per seed, at the configured sizes."""

import numpy as np
import pytest

from _util import ROOT  # noqa: F401
from portbench import corpus, manifest

BENCH = manifest.load()

SILESIA = {"dickens": 10192446, "mozilla": 51220480, "mr": 9970564,
           "nci": 33553445, "ooffice": 6152192, "osdb": 10085684,
           "reymont": 6627202, "samba": 21606400, "sao": 7251944,
           "webster": 41458703, "xml": 5345280, "x-ray": 8474240}


def test_silesia_members_at_published_sizes():
    c = manifest.config(BENCH, "silesia-128k")
    assert {m["name"]: m["bytes"] for m in c["members"]} == SILESIA
    assert [m["name"] for m in c["members"]] == list(SILESIA)
    assert c["total_bytes"] == sum(SILESIA.values()) == 211938580


def test_enwik8_size():
    c = manifest.config(BENCH, "enwik8-64k")
    assert c["total_bytes"] == 10**8 and c["blocksize"] == 65536


@pytest.mark.parametrize("family", sorted(corpus.FAMILIES))
def test_family_deterministic_and_sized(family):
    gen = corpus.FAMILIES[family]
    a = gen(300_001, corpus._rng(2**33 + 5, 0))
    b = gen(300_001, corpus._rng(2**33 + 5, 0))
    c = gen(300_001, corpus._rng(7, 0))
    assert a.dtype == np.uint8 and len(a) == 300_001
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("name,size", [("enwik8-64k", 1 << 20),
                                       ("silesia-128k", 4 << 20)])
def test_build_scaled_config(name, size):
    c = corpus.scaled(manifest.config(BENCH, name), size)
    d1 = corpus.build(c, 123)
    assert len(d1) == c["total_bytes"] <= size
    assert np.array_equal(d1, corpus.build(c, 123))
    d2 = corpus.build(c, 124)
    assert not np.array_equal(d1, d2)
    # Every seed holds the same blocks, in another order within members.
    N = c["blocksize"]
    n = len(d1) // N
    rows = lambda d: sorted(map(bytes, d[: n * N].reshape(n, N)))  # noqa
    assert rows(d1) == rows(d2) == rows(corpus.members(c))
    assert np.array_equal(d1[n * N :], d2[n * N :])
    ends = np.cumsum([m["bytes"] for m in c["members"]])
    for e in ends[:-1]:
        b = int(e) // N  # the block straddling a member boundary stays
        if int(e) % N:
            assert np.array_equal(d1[b * N : b * N + N],
                                  corpus.members(c)[b * N : b * N + N])


def test_text_regime():
    d = corpus.text(1 << 20, corpus._rng(1, 0))
    distinct = [len(np.unique(d[i : i + 65536])) for i in range(0, 1 << 20,
                                                                   65536)]
    assert 150 <= min(distinct) and max(distinct) <= 230


def test_negative_and_large_seeds():
    for seed in (-1, 2**31 + 17, 2**40):
        assert len(corpus.xray(1000, corpus._rng(seed, 3))) == 1000
