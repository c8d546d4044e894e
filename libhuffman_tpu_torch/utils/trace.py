"""Tracing and timing hooks: the port's counterpart of
``libhuffman_tpu.utils.trace``.

  * ``annotate(name)``   - a ``torch.profiler.record_function`` range around
                           a host phase, so the encode and decode phases
                           (``huff.encode.device``, ``huff.decode.scan``, ...)
                           show up by name in a ``torch.profiler`` trace
                           beside the kernels they launch;
  * ``start_trace`` /
    ``stop_trace``       - a ``torch.profiler.profile`` over everything in
                           between (the card's kernels and copies too when
                           CUDA is present), written as a Chrome trace into
                           a directory;
  * ``timed(name)`` +
    ``get_timings()``    - opt-in wall-clock accumulation per phase (off by
                           default, so the library stays as silent as the
                           reference); ``annotate`` records the same way.

The timings are host wall time (``time.perf_counter``), as in the JAX
package, and nothing here waits for the card: kernel launches return before
the kernels finish, so on CUDA a span's time does not include the work it
left queued on the card, which the next span that waits for a result (a
copy to the host) takes instead.  A profiler trace has the device times.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_timings: dict[str, list[float]] = defaultdict(list)
_timing_enabled = False
_profiler = None  # (torch.profiler.profile, log_dir) between start and stop


def enable_timing(on: bool = True) -> None:
    """Toggle wall-clock phase accumulation (off by default)."""
    global _timing_enabled
    _timing_enabled = on


def reset_timings() -> None:
    _timings.clear()


def get_timings() -> dict[str, list[float]]:
    """Per-phase wall-time samples (seconds) recorded since the last reset."""
    return {k: list(v) for k, v in _timings.items()}


@contextlib.contextmanager
def annotate(name: str):
    """Named span in ``torch.profiler`` traces, plus its wall time when
    timing is enabled.  Outside a profiler run the range costs one no-op
    object."""
    t0 = time.perf_counter() if _timing_enabled else None
    with torch.profiler.record_function(name):
        yield
    if t0 is not None:
        _timings[name].append(time.perf_counter() - t0)


@contextlib.contextmanager
def timed(name: str):
    """Wall-clock-only span (no profiler range)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _timing_enabled:
            _timings[name].append(time.perf_counter() - t0)


def start_trace(log_dir: str) -> None:
    """Begin a host trace, and a device trace when CUDA is present; the
    matching :func:`stop_trace` writes it into ``log_dir``."""
    global _profiler
    if _profiler is not None:
        raise RuntimeError("a trace is already running")
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _profiler = (prof, os.fspath(log_dir))


def stop_trace() -> str:
    """End the trace begun by :func:`start_trace` and write it as a Chrome
    trace (Perfetto reads it too); returns the file's path."""
    global _profiler
    if _profiler is None:
        raise RuntimeError("no trace is running")
    prof, log_dir = _profiler
    _profiler = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"huff-{os.getpid()}-{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path
