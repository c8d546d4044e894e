"""A whole run on the CPU (the kernels' plain twins, two 64 KiB blocks)
with the timed path broken underneath: ``correct`` must come out false.
The look for a card is skipped; everything else of a run is driven,
window, check and result line.  The sound run and the control (the
reference with the other tie-break in the program's place) bracket the
faults."""

import pytest

from _util import SMALL
from portbench import control, loop, run

CELL = "enwik8-64k.whole-64m"


def _broken(fault):
    def entry(traffic, config, device):
        enc, dec = loop.entry(traffic, config, device)
        return fault(enc, dec)
    return entry


def _flip(b: bytes, at: int) -> bytes:
    b = bytearray(b)
    b[at] ^= 0x10
    return bytes(b)


def _stream_byte(enc, dec):
    # A payload byte of the last block altered where the encode makes it.
    return (lambda d: _flip(enc(d), -3), dec)


def _output_byte(enc, dec):
    return (enc, lambda s: _flip(dec(s), 70000))


def _half_the_blocks(enc, dec):
    # The encode leaves out the second half of its blocks.
    return (lambda d: enc(d[: len(d) // 2]), dec)


def _raises(enc, dec):
    calls = []

    def flaky(s):
        calls.append(1)
        if len(calls) > 2:  # after the warm-up pass
            raise RuntimeError("device lost")
        return dec(s)
    return (enc, flaky)


def _run(entry=loop.entry):
    return run.run_cell(CELL, 2**31 + 99, 0.0, False, entry=entry, **SMALL)


def test_sound_run_is_correct():
    result, numbers = _run()
    assert result["correct"] is True
    assert all(n["value"] == 0 for n in numbers.values())
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"encode_gbps", "decode_gbps",
                                      "setup_s"}


@pytest.mark.parametrize("fault,number", [
    (_stream_byte, "encode_wrong_bytes"),
    (_output_byte, "decode_wrong_bytes"),
    (_half_the_blocks, "encode_wrong_bytes"),
    (_raises, "failed_calls"),
])
def test_fault_is_not_correct(fault, number):
    result, numbers = _run(_broken(fault))
    assert result["correct"] is False
    assert numbers[number]["value"] > numbers[number]["limit"]


def test_control_is_not_correct():
    result, numbers = _run(control.control_entry)
    assert result["correct"] is False
    assert numbers["encode_wrong_bytes"]["value"] > 0
    assert numbers["decode_wrong_bytes"]["value"] == 0


def test_traced_run_on_cpu_reads_spans_and_counts():
    result, _ = run.run_cell(CELL, 5, 0.0, True, **SMALL)
    assert result["correct"] is True
    m = result["metrics"]
    assert 0 < m["encode_host_pct"]["value"] < 100
    assert m["host_walked_pct"]["value"] == 0.0
    # No card, so nothing on a device timeline to read.
    assert "launches_per_MiB.encode" not in m
