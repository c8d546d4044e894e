"""A traced run's reading of the device: one pass under ``torch.profiler``,
reduced in memory to counts, busy time and the longest idle gaps.

Only a bounded slice is profiled (one pass: its encode call and its
decode call), because a window holds 10^5-10^6 kernel events.  Nothing is
written to disk.  The harness's own host ranges, ``portbench.encode`` and
``portbench.decode``, mark each call; the program's ranges (``huff.*``)
say what the host was doing in each idle gap.
"""

from __future__ import annotations

from collections import defaultdict

HOST_PREFIXES = ("huff.", "portbench.")
CALLS = {"encode": "portbench.encode", "decode": "portbench.decode"}


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def profiled(fn):
    """``fn()`` under the profiler; returns (its result, the events as
    (start_us, end_us, name, on_device) tuples)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    events = [(e.time_range.start, e.time_range.end, e.name,
               e.device_type != DeviceType.CPU) for e in prof.events()]
    return out, events


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(events, top: int = 10) -> dict:
    """Per call kind: its wall, the kernels it launched, their summed
    device time, and the time the device was busy with a kernel or a copy
    (all in seconds); and the breakdown of the traced slice."""
    host = [(s, e, n) for s, e, n, dev in events
            if not dev and n.startswith(HOST_PREFIXES)]
    # Device rows named like a host range are the profiler's copies of
    # those ranges on the device's timeline, not device work.
    device = [(s, e, n) for s, e, n, dev in events
              if dev and not n.startswith(HOST_PREFIXES)]
    out, gaps, op_s = {}, [], defaultdict(float)
    for kind, span in CALLS.items():
        calls = [(s, e) for s, e, n in host if n == span]
        if not calls:
            continue
        rec = {"wall_s": 0.0, "kernels": 0, "kernel_s": 0.0, "busy_s": 0.0}
        for c0, c1 in calls:
            inside = [(s, e, n) for s, e, n in device if c0 <= s < c1]
            rec["wall_s"] += (c1 - c0) / 1e6
            for s, e, n in inside:
                op_s[n] += (e - s) / 1e6
                if not is_copy(n):
                    rec["kernels"] += 1
                    rec["kernel_s"] += (e - s) / 1e6
            busy = _union((s, min(e, c1)) for s, e, _n in inside)
            rec["busy_s"] += sum(e - s for s, e in busy) / 1e6
            edges = [c0] + [x for iv in busy for x in iv] + [c1]
            for g0, g1 in zip(edges[::2], edges[1::2]):
                if g1 > g0:
                    gaps.append(((g1 - g0) / 1e6, _doing(host, (g0 + g1) / 2)))
        out[kind] = rec
    gaps.sort(key=lambda g: -g[0])
    ops = sorted(op_s.items(), key=lambda kv: -kv[1])[:top]
    out["breakdown"] = {
        "device_ops": [[n[:120], s] for n, s in ops],
        "idle_gaps": [[n, s] for s, n in gaps[:top]],
    }
    return out


def _doing(host, t: float) -> str:
    """The innermost host range open at ``t``."""
    best = None
    for s, e, n in host:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, n)
    return best[1] if best else "none"
