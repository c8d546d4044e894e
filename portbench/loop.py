"""The default traffic generator: a closed loop that a traffic file
parameterises.

One client sends a request, waits for its answer, and sends the next.  A
pass is an encode call on the whole corpus and ``reads_per_pass`` decode
calls of the stream it returned, one after another.

A traffic file whose ``generator`` names a module under ``traffic/`` runs
that module instead; it provides the same ``entry``, ``one_pass`` and
``window`` (and may provide ``check``), so a new kind of mix is a new file.
"""

from __future__ import annotations

import time

import numpy as np

# The most bytes of outputs (streams and decoded copies) that the window
# keeps for the check after it closes.
KEEP_BYTES = 4 << 30


def entry(traffic: dict, config: dict, device: str):
    """(encode, decode): the program's calls that a pass makes."""
    from libhuffman_tpu_torch import decode, encode
    from libhuffman_tpu_torch.config import DecodeConfig, EncodeConfig

    bs = int(config["blocksize"])
    ecfg = EncodeConfig(blocksize=bs,
                        batch_blocks=max(1, int(traffic["batch_bytes"]) // bs),
                        device=device)
    dcfg = DecodeConfig(device=device)
    return (lambda data: encode.encode(data, config=ecfg),
            lambda stream: decode.decode(stream, config=dcfg))


class Pass:
    """One pass's outcome: the walls, the bytes encoded and decoded, the
    calls attempted, and the outputs while they are kept for the check."""

    __slots__ = ("encode_s", "decode_s", "nbytes", "reads", "stream",
                 "outputs", "calls", "error")

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.encode_s = self.decode_s = None
        self.stream = self.error = None
        self.outputs = []
        self.reads = self.calls = 0

    def kept_bytes(self) -> int:
        return len(self.stream or b"") + sum(len(o) for o in self.outputs)

    def drop(self) -> None:
        self.stream, self.outputs = None, []


def one_pass(corpus: np.ndarray, enc, dec, reads: int = 1) -> Pass:
    """An encode call on the corpus, then ``reads`` decode calls of its
    stream in a row, timed together as one reading of the host's clock."""
    p = Pass(len(corpus))
    try:
        p.calls += 1
        t0 = time.perf_counter()
        p.stream = enc(corpus)
        t1 = time.perf_counter()
        p.encode_s = t1 - t0
        for _ in range(reads):
            p.calls += 1
            p.outputs.append(dec(p.stream))
            p.reads += 1
        p.decode_s = time.perf_counter() - t1
    except Exception as e:  # the program failed: counted, not timed
        p.error = f"{type(e).__name__}: {e}"
    return p


def window(seconds: float, corpus: np.ndarray, enc, dec, reads: int = 1,
           keep_bytes: int = KEEP_BYTES) -> list[Pass]:
    """Passes until ``seconds`` have gone by; a pass begun in time is
    finished.  The outputs of an evenly spread sample of passes are kept
    for the check, within ``keep_bytes``: the first, every ``stride``-th,
    and the last."""
    passes: list[Pass] = []
    stride, kept = 1, 0
    deadline = time.perf_counter() + seconds
    while not passes or time.perf_counter() < deadline:
        if passes and (len(passes) - 1) % stride:
            kept -= passes[-1].kept_bytes()  # the last but one, unsampled
            passes[-1].drop()
        p = one_pass(corpus, enc, dec, reads)
        passes.append(p)
        kept += p.kept_bytes()
        while kept > keep_bytes and stride < len(passes):
            stride *= 2  # keep every other sampled pass
            for i, q in enumerate(passes[:-1]):
                if i % stride and q.stream is not None:
                    kept -= q.kept_bytes()
                    q.drop()
    return passes
