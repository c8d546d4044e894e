"""Named profiler spans around host phases.

``annotate(name)`` is a ``torch.profiler.record_function`` range, so the
encode phases (``huff.encode.device``, ``huff.encode.d2h``,
``huff.encode.assemble``) show up by name in a ``torch.profiler`` trace beside
the kernels they launch.  Outside a profiler run it costs one no-op object.
"""

from __future__ import annotations

import torch


def annotate(name: str):
    """Context manager marking a named span in ``torch.profiler`` traces."""
    return torch.profiler.record_function(name)
