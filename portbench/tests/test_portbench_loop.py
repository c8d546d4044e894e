"""The default traffic generator: its passes, the sample of outputs it
keeps for the check, and how a mix finds its generator."""

import numpy as np
import pytest

from _util import ROOT  # noqa: F401
from portbench import loop, manifest

CORPUS = np.arange(1000, dtype=np.uint64).astype(np.uint8)


def _calls():
    return (lambda d: b"s" * 100, lambda s: b"d" * len(CORPUS))


def test_pass_counts_reads_apart_from_what_is_kept():
    enc, dec = _calls()
    p = loop.one_pass(CORPUS, enc, dec, reads=2)
    assert (p.calls, p.reads, p.error) == (3, 2, None)
    assert p.kept_bytes() == 100 + 2 * 1000
    p.drop()
    assert p.reads == 2 and p.kept_bytes() == 0


def test_failed_call_is_counted_not_timed():
    def dec(s):
        raise RuntimeError("lost")
    p = loop.one_pass(CORPUS, _calls()[0], dec, reads=2)
    assert p.calls == 2 and p.reads == 0 and p.decode_s is None
    assert p.error == "RuntimeError: lost"


def _window_of(n, monkeypatch, keep_bytes):
    """``loop.window`` made to run exactly ``n`` passes."""
    left = [n]
    enc, dec = _calls()

    def counted_enc(d):
        left[0] -= 1
        return enc(d)
    monkeypatch.setattr(loop.time, "perf_counter",
                        lambda: 0.0 if left[0] > 0 else 1.0)
    return loop.window(0.5, CORPUS, counted_enc, dec, reads=2,
                       keep_bytes=keep_bytes)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 40, 129])
def test_window_keeps_an_even_sample_within_its_budget(monkeypatch, n):
    per_pass = 100 + 2 * 1000
    passes = _window_of(n, monkeypatch, 5 * per_pass)
    assert len(passes) == n
    assert all(p.reads == 2 and p.error is None for p in passes)
    kept = [i for i, p in enumerate(passes) if p.stream is not None]
    # The first, every stride-th and the last.
    assert kept[0] == 0 and kept[-1] == n - 1
    stride = kept[1] - kept[0] if len(kept) > 1 else 1
    assert set(kept) == set(range(0, n - 1, stride)) | {n - 1}
    assert sum(p.kept_bytes() for p in passes) <= 5 * per_pass
    if n == 129:
        assert len(kept) >= 3


def test_window_keeps_everything_within_a_large_budget(monkeypatch):
    passes = _window_of(9, monkeypatch, 1 << 30)
    assert all(p.stream is not None and len(p.outputs) == 2 for p in passes)


def test_default_generator_is_the_closed_loop():
    bench = manifest.load()
    for name in {w["traffic"] for w in bench["workloads"]}:
        t = manifest.traffic(name)
        assert manifest.generator(t) is loop
        assert t["reads_per_pass"] >= 1 and t["batch_bytes"] > 0


def test_a_mix_names_its_own_generator(tmp_path, monkeypatch):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "twice.py").write_text(
        "from portbench.loop import entry, one_pass\n"
        "def window(seconds, corpus, enc, dec, reads=1):\n"
        "    return [one_pass(corpus, enc, dec, reads) for _ in range(2)]\n")
    monkeypatch.setattr(manifest, "HERE", tmp_path)
    gen = manifest.generator({"name": "x", "generator": "twice"})
    assert gen.entry is loop.entry
    assert len(gen.window(0, CORPUS, *_calls())) == 2
