"""Each metric reader on a small synthetic record, and the trace
reduction on synthetic profiler events."""

import pytest

from _util import ROOT  # noqa: F401
from portbench import devtrace, manifest

PASSES = [{"bytes": 2_000_000_000, "encode_s": 4.0,
           "decode_bytes": 2_000_000_000, "decode_s": 1.0},
          {"bytes": 2_000_000_000, "encode_s": 6.0,
           "decode_bytes": 2_000_000_000, "decode_s": 3.0}]
RECORD = {
    "setup_s": 12.5,
    "passes": PASSES,
    "spans": {"huff.encode.device": 5.0, "huff.encode.d2h": 2.0,
              "huff.encode.assemble": 1.0, "huff.decode.scan": 0.5,
              "huff.decode.tables": 0.25, "huff.decode.plans": 0.25,
              "huff.decode.device": 1.0, "huff.decode.walk": 1.0},
    "counts": {"host_decoded_blocks": 1, "device_decoded_blocks": 3,
               "host_reencoded_blocks": 0},
    "trace": {
        "encode": {"wall_s": 2.0, "kernels": 300, "kernel_s": 0.5,
                   "busy_s": 0.5, "bytes_in": 100 * 2**20,
                   "bytes_out": 60 * 2**20},
        "decode": {"wall_s": 1.0, "kernels": 30, "kernel_s": 0.1,
                   "busy_s": 0.25, "bytes_in": 60 * 2**20,
                   "bytes_out": 100 * 2**20},
    },
    "peak_bytes_per_s": 160 * 2**20 / 0.001,
}
EXPECTED = {
    "encode_gbps": 0.4,
    "decode_gbps": 1.0,
    "setup_s": 12.5,
    "encode_host_pct": 30.0,
    "decode_host_pct": 50.0,
    "host_walked_pct": 25.0,
    "launches_per_MiB.encode": 3.0,
    "launches_per_MiB.decode": 0.3,
    "encode_roofline": 0.2,
    "decode_roofline": 1.0,
    "device_idle_pct.encode": 75.0,
    "device_idle_pct.decode": 75.0,
}
BENCH = manifest.load()
ALL = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_every_metric_has_an_expectation():
    assert sorted(ALL) == sorted(EXPECTED)


@pytest.mark.parametrize("name", ALL)
def test_reader(name):
    assert manifest.reader(name)(RECORD) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_reader_with_nothing_to_read(name):
    empty = {"setup_s": 1.0, "passes": PASSES}
    assert manifest.reader(name)(empty) is None


def test_reduce():
    ev = [
        (0, 1000, "portbench.encode", False),
        (100, 900, "huff.encode.device", False),
        (100, 900, "huff.encode.device", True),  # the range's device copy
        (100, 200, "kernel_a", True),
        (150, 300, "kernel_b", True),
        (600, 700, "Memcpy DtoH (Device -> Pageable)", True),
        (2000, 2500, "portbench.decode", False),
        (2100, 2200, "kernel_a", True),
    ]
    r = devtrace.reduce(ev)
    assert r["encode"] == {"wall_s": 1e-3, "kernels": 2, "kernel_s": 2.5e-4,
                           "busy_s": 3e-4}
    assert r["decode"]["kernels"] == 1
    assert r["decode"]["busy_s"] == pytest.approx(1e-4)
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps[0] == ["huff.encode.device", 3e-4]
    assert sorted(s for _n, s in gaps) == pytest.approx(
        sorted([1e-4, 3e-4, 3e-4, 1e-4, 3e-4]))
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["kernel_a"] == pytest.approx(2e-4)
