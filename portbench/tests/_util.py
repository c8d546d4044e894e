"""Shared helpers of the benchmark's CPU tests."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A run on the CPU at a size a test can hold: the kernels' plain twins,
# two 64 KiB blocks.
SMALL = dict(device="cpu", max_bytes=2 * 65536)
