"""What decides ``correct``: the passes whose outputs the window kept (an
evenly spread sample, ``loop.window``) against the plain reference, after
the window has closed.

The configuration states two guarantees, and both are exact, so each
number compared is a count of wrong bytes with the limit 0:

  encode_wrong_bytes   bytes of the kept encode outputs that differ from
                       the reference codec's stream of the corpus, plus
                       any difference in length;
  decode_wrong_bytes   the same for the kept decode outputs against the
                       corpus, which the benchmark made;
  failed_calls         passes in which a call raised, of every pass.

The reference encodes the corpus once (it is the same in every pass) from
the benchmark's own bytes; it takes nothing the program made.
"""

from __future__ import annotations

import numpy as np

from .reference import codec

LIMITS = {"encode_wrong_bytes": 0, "decode_wrong_bytes": 0,
          "failed_calls": 0}


def wrong_bytes(got, want: bytes) -> int:
    if got == want:
        return 0
    got = bytes(got)
    m = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, count=m)
    b = np.frombuffer(want, np.uint8, count=m)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def check(passes, corpus: np.ndarray, blocksize: int,
          encoder=codec.encode) -> dict:
    """The numbers compared, each as {"value", "limit"}."""
    found = dict.fromkeys(LIMITS, 0)
    want_stream = encoder(corpus, blocksize)
    want_data = corpus.tobytes()
    for p in passes:
        found["failed_calls"] += p.error is not None
        if p.stream is not None:
            found["encode_wrong_bytes"] += wrong_bytes(p.stream, want_stream)
        for out in p.outputs:
            found["decode_wrong_bytes"] += wrong_bytes(out, want_data)
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in found.items()}


def passed(numbers: dict) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
