"""The cell of 1 MiB blocks (``silesia-1m.whole-64m``) and the two readers
of the decode's host walk: ``host_walked_bytes_pct`` (a counter) and
``decode_host_walk_pct`` (a span)."""

import pytest

from _util import ROOT  # noqa: F401
from portbench import manifest, run

CELL = "silesia-1m.whole-64m"
NEW = ("host_walked_bytes_pct", "decode_host_walk_pct")
PASSES = [{"bytes": 1000, "encode_s": 1.0, "decode_bytes": 2000,
           "decode_s": 1.5},
          {"bytes": 1000, "encode_s": 1.0, "decode_bytes": 2000,
           "decode_s": 2.5}]
SPANS = {"huff.decode.scan": 0.5, "huff.decode.walk": 1.5,
         "huff.decode.host_walk": 1.0}
# decode.COUNTS as a program without the host walk's counters has it.
PARENT_COUNTS = {"host_decoded_blocks": 3, "device_decoded_blocks": 1,
                 "decode_d2h_bytes": 10, "device_out_bytes": 8}


def _record(spans=None, counts=None):
    r = {"setup_s": 1.0, "passes": PASSES}
    if spans is not None:
        r["spans"] = spans
    if counts is not None:
        r["counts"] = counts
    return r


@pytest.mark.parametrize("record,want", [
    (_record(SPANS, {**PARENT_COUNTS, "host_walked_bytes": 24}), 75.0),
    (_record(SPANS, {**PARENT_COUNTS, "host_walked_bytes": 0}), 0.0),
    (_record(SPANS, {**PARENT_COUNTS, "host_walked_bytes": 0,
                     "device_out_bytes": 0}), None),
    (_record(SPANS, PARENT_COUNTS), None),
    (_record(SPANS), None),
], ids=["walked", "none-walked", "no-output", "parent", "no-counts"])
def test_host_walked_bytes_pct(record, want):
    got = manifest.reader("host_walked_bytes_pct")(record)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("record,want", [
    (_record(SPANS, {**PARENT_COUNTS, "host_walked_bytes": 24}), 25.0),
    (_record({k: v for k, v in SPANS.items() if k != "huff.decode.host_walk"},
             {**PARENT_COUNTS, "host_walked_bytes": 0}), 0.0),
    (_record({k: v for k, v in SPANS.items() if k != "huff.decode.host_walk"},
             PARENT_COUNTS), None),
    (_record(None, {**PARENT_COUNTS, "host_walked_bytes": 24}), None),
    (_record(), None),
], ids=["walked", "none-walked", "parent", "no-spans", "nothing"])
def test_decode_host_walk_pct(record, want):
    got = manifest.reader("decode_host_walk_pct")(record)
    assert got == (None if want is None else pytest.approx(want))


def test_manifest_lists_the_cell_and_the_readers_in_every_cell():
    bench = manifest.load()
    w = manifest.cell(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "silesia-1m", "whole-64m", 1)
    config = manifest.config(bench, "silesia-1m")
    assert config["blocksize"] == 1 << 20 and config["reduced"] == []
    assert config["total_bytes"] == sum(m["bytes"] for m in config["members"])
    cells = {c["name"] for c in bench["workloads"]}
    for name in NEW:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert set(m["workloads"]) == cells
        assert (m["layer"], m["moves"]) == ("decode driver", "decode_gbps")


def test_traced_run_on_cpu_walks_the_full_block():
    """One full 1 MiB block and a tail of about 8 KiB: the host walks the
    block, the device route (the twins) takes the tail."""
    result, numbers = run.run_cell(CELL, 2**31 + 16, 0.0, True,
                                   device="cpu", max_bytes=(1 << 20) + 8192)
    assert result["correct"] is True
    assert all(n["value"] == 0 for n in numbers.values())
    m = result["metrics"]
    assert set(NEW) <= set(m)
    assert 99.0 < m["host_walked_bytes_pct"]["value"] < 100.0
    assert 0.0 < m["decode_host_walk_pct"]["value"] < 100.0
