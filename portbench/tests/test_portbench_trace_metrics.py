"""The readers of the program's tree, batch and join spans and of its
copy-back byte counters, on a small synthetic record.  Each gives nothing
where a program lacks what it reads, or where its base is 0."""

import pytest

from _util import ROOT  # noqa: F401
from portbench import manifest

PASSES = [{"bytes": 2_000_000_000, "encode_s": 4.0,
           "decode_bytes": 2_000_000_000, "decode_s": 1.0},
          {"bytes": 2_000_000_000, "encode_s": 6.0,
           "decode_bytes": 2_000_000_000, "decode_s": 3.0}]
RECORD = {
    "setup_s": 12.5,
    "passes": PASSES,
    "spans": {"huff.encode.device": 5.0, "huff.encode.d2h": 2.0,
              "huff.encode.assemble": 1.0, "huff.decode.device": 1.0,
              "huff.encode.trees": 2.5, "huff.encode.batch": 0.5,
              "huff.encode.join": 0.25},
    "counts": {"host_decoded_blocks": 1, "device_decoded_blocks": 3,
               "host_reencoded_blocks": 0, "encode_d2h_bytes": 800,
               "stream_bytes": 600, "decode_d2h_bytes": 1000,
               "device_out_bytes": 900},
}
# By hand: 2.5 s of 10 s; (0.5 + 0.25) s of 10 s; 600 of 800 B; 900 of
# 1000 B.
EXPECTED = {
    "encode_trees_pct": 25.0,
    "encode_batching_pct": 7.5,
    "d2h_useful_pct.encode": 75.0,
    "d2h_useful_pct.decode": 90.0,
}
# The spans or counters each reader reads.
READS = {"encode_trees_pct": ["huff.encode.trees"],
         "encode_batching_pct": ["huff.encode.batch", "huff.encode.join"],
         "d2h_useful_pct.encode": ["encode_d2h_bytes", "stream_bytes"],
         "d2h_useful_pct.decode": ["decode_d2h_bytes", "device_out_bytes"]}


def test_each_reader_is_a_listed_metric_of_both_cells():
    per_layer = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in EXPECTED:
        assert per_layer[name]["workloads"] == ["enwik8-64k.whole-64m",
                                                "silesia-128k.whole-64m"]


@pytest.mark.parametrize("name", EXPECTED)
def test_reader(name):
    assert manifest.reader(name)(RECORD) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", EXPECTED)
def test_reader_with_nothing_to_read(name):
    empty = {"setup_s": 1.0, "passes": PASSES}
    assert manifest.reader(name)(empty) is None


@pytest.mark.parametrize("name,key", [(n, k) for n, ks in READS.items()
                                      for k in ks])
def test_reader_without_its_span_or_count(name, key):
    rec = {**RECORD,
           "spans": {k: v for k, v in RECORD["spans"].items() if k != key},
           "counts": {k: v for k, v in RECORD["counts"].items() if k != key}}
    assert manifest.reader(name)(rec) is None


@pytest.mark.parametrize("name", EXPECTED)
def test_reader_with_a_zero_base(name):
    rec = {**RECORD, "passes": [{**p, "encode_s": 0.0} for p in PASSES],
           "counts": {**RECORD["counts"], "encode_d2h_bytes": 0,
                      "decode_d2h_bytes": 0}}
    assert manifest.reader(name)(rec) is None
