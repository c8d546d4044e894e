"""General histogram with element widths and min-index tracking.

Parity surface for ``huf_histogram_t`` (include/huffman/histogram.h:10-49,
src/histogram.c:9-103 of the C library), a copy of
``libhuffman_tpu.histogram``: ``iota`` bytes per element are read
little-endian into a 64-bit value and counted; ``start`` tracks the
smallest non-zero frequency index across populates (-1 until data arrives,
matching the SIZE_MAX sentinel reset at src/histogram.c:33 as observed
through the C tests); populates accumulate until ``reset``.

The encoder's own histogram (iota=1, one count per byte value
of each block) is a CUDA
kernel on the device (``ops/kernels.histogram``); this host class covers
the public API's general widths.
"""

from __future__ import annotations

import numpy as np

from .errors import InvalidArgumentError


class Histogram:
    """Accumulating element-frequency histogram.

    iota: element width in bytes (1..8, like huf_histogram_init's
        memcpy-into-u64, src/histogram.c:85-96);
    length: number of tracked frequency slots — elements whose value falls
        outside [0, length) are rejected like the reference's unchecked
        write would corrupt (we validate instead of corrupting).
    """

    def __init__(self, iota: int, length: int):
        if not 1 <= iota <= 8:
            raise InvalidArgumentError("Failed to initialize the histogram")
        if length <= 0:
            raise InvalidArgumentError("Failed to initialize the histogram")
        self.iota = iota
        self.length = length
        self.frequencies = np.zeros(length, np.uint64)
        self.start = -1  # min non-zero index; -1 = empty (SIZE_MAX sentinel)

    def reset(self) -> None:
        """Zero the frequencies and the start marker (src/histogram.c:55-71)."""
        self.frequencies[:] = 0
        self.start = -1

    def populate(self, buf) -> None:
        """Count ``len(buf) // iota`` elements from a byte buffer.

        Mirrors src/histogram.c:74-100: the pointer advances ``iota`` bytes
        per element; a ragged tail (len % iota != 0) is ignored exactly as
        the reference's end-pointer loop ignores it.
        """
        data = np.frombuffer(bytes(buf), np.uint8)
        n = len(data) // self.iota
        if n == 0:
            return
        elems = np.zeros(n, np.uint64)
        for k in range(self.iota):
            elems |= data[k : n * self.iota : self.iota].astype(np.uint64) << (8 * k)
        if int(elems.max(initial=0)) >= self.length:
            raise InvalidArgumentError("Failed to populate the histogram")
        counts = np.bincount(elems.astype(np.int64), minlength=self.length)
        self.frequencies += counts.astype(np.uint64)
        lo = int(elems.min())
        self.start = lo if self.start < 0 else min(self.start, lo)
