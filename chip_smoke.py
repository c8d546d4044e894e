#!/usr/bin/env python3
"""On-card smoke run of libhuffman_tpu_torch's encode path.

Run from the root of a checkout on a machine with one NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``libhuffman_tpu_torch/csrc`` and then:

  1. prints the card's name and power limit (nvidia-smi) and the build
     times of the kernels and of the native host runtime;
  2. kernel phase: holds each kernel (K1 histogram, K2 layout, K3 pack)
     against its plain-torch twin on the card at the encode path's shapes
     (B = 128 blocks of N = 65536 bytes, W = 24576 payload words, a ragged
     last row) for the first 8 MiB of the ``text`` and ``mixed`` corpora
     (bench/corpora.py), exactly, and times both (CUDA events, median);
  3. slice: ``encode(data, 65536)`` on 64 MiB of each corpus; the wire bytes
     of the first 128 blocks must equal the host-exact codec's, the whole
     stream must decode back (host route), every kernel must have been
     launched by that run and no block re-encoded on the host; prints
     end-to-end and device-resident GB/s and a per-stage device breakdown
     with build_trees' share;
  4. prints one JSON line describing the kernels, then the result line
     ``{"ok": true, "device": {...}}`` last.

Any failed check exits non-zero before the result line; so does a machine
without CUDA, and a directory holding this script without the package.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N = 65536                # bench blocksize
B = 128                  # blocks per device batch (encode.DEFAULT_BATCH_BLOCKS)
KERNEL_BYTES = B * N     # 8 MiB: the kernel phase's batch
SLICE_BYTES = 64 << 20   # per corpus, end to end
RAGGED = 40000           # valid bytes in the kernel batch's last row
CORPORA = ("text", "mixed")


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def load_corpora():
    spec = importlib.util.spec_from_file_location(
        "bench_corpora", ROOT / "bench" / "corpora.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stage_ms(torch, dev, kernels, blocks, nv, W: int, reps: int = 5):
    """Device time of each stage of ``encode_blocks`` with events between
    the stages of one pass: (median ms per stage, median pass total,
    median share of build_trees in a pass), after one warm-up pass."""
    names = ("histogram", "build_trees", "extract_codes", "symbol_layout",
             "pack")
    rows = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        freqs = kernels.histogram(blocks, nv)
        ev[1].record()
        _l, _r, parent, pbit, _root = dev.build_trees(freqs)
        ev[2].record()
        codes, lens, _ovf = dev.extract_codes(parent, pbit)
        ev[3].record()
        C, L = kernels.symbol_layout(blocks, dev.as_u32_bits(codes), lens, nv)
        ev[4].record()
        kernels.pack(C, L, W)
        ev[5].record()
        ev[5].synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
    rows = rows[1:]
    med = {n: statistics.median(r[i] for r in rows)
           for i, n in enumerate(names)}
    return (med, statistics.median(sum(r) for r in rows),
            statistics.median(r[1] / sum(r) for r in rows))


def kernel_batch(torch, data: bytes, last_row: int = RAGGED):
    """The first B x N bytes as a device batch whose last row holds
    ``last_row`` valid bytes, zero-padded as encode.encode pads."""
    import numpy as np

    x = np.frombuffer(data[:KERNEL_BYTES], np.uint8).reshape(B, N).copy()
    nv = np.full(B, N, np.int32)
    nv[-1] = last_row
    x[-1, last_row:] = 0
    return (torch.from_numpy(x).cuda(), torch.from_numpy(nv).cuda())


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from libhuffman_tpu_torch import decode as dec
    from libhuffman_tpu_torch import encode as enc
    from libhuffman_tpu_torch import native
    from libhuffman_tpu_torch.ops import _build, hostref, kernels
    from libhuffman_tpu_torch.ops import device as dev

    corpora = load_corpora()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc, {len(_build.sources())} sources, sm_90a)", flush=True)
    t0 = time.perf_counter()
    check(native.available(), "the native host runtime did not build (g++)")
    print(f"native host runtime build: {time.perf_counter() - t0:.3f} s "
          f"(g++; set-up, kept out of the encode timings)", flush=True)

    t0 = time.perf_counter()
    streams = {c: corpora.FAMILIES[c](SLICE_BYTES) for c in CORPORA}
    print(f"corpora: {time.perf_counter() - t0:.1f} s to generate "
          f"{len(CORPORA)} x {SLICE_BYTES >> 20} MiB", flush=True)

    # ---- kernel phase: each kernel against its twin, exact -------------
    W = enc._pack_params(N)
    errs = {"histogram": 0, "symbol_layout": 0, "pack": 0}
    ms = {k: [] for k in errs}
    plain_ms = {k: [] for k in errs}
    for c in CORPORA:
        blocks, nv = kernel_batch(torch, streams[c])
        freqs = kernels.histogram(blocks, nv)
        freqs_p = kernels.histogram_plain(blocks, nv)
        _l, _r, parent, pbit, _root = dev.build_trees(freqs)
        codes, lens, _ovf = dev.extract_codes(parent, pbit)
        codes = dev.as_u32_bits(codes)
        C, L = kernels.symbol_layout(blocks, codes, lens, nv)
        Cp, Lp = kernels.symbol_layout_plain(blocks, codes, lens, nv)
        payload, ovf = kernels.pack(C, L, W)
        payload_p, ovf_p = kernels.pack_plain(C, L, W)
        torch.cuda.synchronize()
        errs["histogram"] = max(errs["histogram"],
                                max_abs_err(freqs, freqs_p))
        errs["symbol_layout"] = max(errs["symbol_layout"],
                                    max_abs_err(C, Cp),
                                    max_abs_err(L, Lp))
        errs["pack"] = max(errs["pack"], max_abs_err(payload, payload_p),
                           max_abs_err(ovf, ovf_p))
        check(int(freqs[:-1, :256].sum()) == (B - 1) * N
              and int(freqs[-1].sum()) == RAGGED,
              f"{c}: histogram totals")
        runs = {
            "histogram": (lambda: kernels.histogram(blocks, nv),
                          lambda: kernels.histogram_plain(blocks, nv)),
            "symbol_layout": (
                lambda: kernels.symbol_layout(blocks, codes, lens, nv),
                lambda: kernels.symbol_layout_plain(blocks, codes, lens, nv)),
            "pack": (lambda: kernels.pack(C, L, W),
                     lambda: kernels.pack_plain(C, L, W)),
        }
        for k, (kfn, pfn) in runs.items():
            ms[k].append(cuda_ms(torch, kfn, reps=15))
            plain_ms[k].append(cuda_ms(torch, pfn, reps=5))
            print(f"kernel {k} [{c}]: {ms[k][-1]:.4f} ms, twin "
                  f"{plain_ms[k][-1]:.4f} ms (B={B}, N={N}, W={W}; {card})",
                  flush=True)
        del blocks, nv, freqs, freqs_p, C, L, Cp, Lp, payload, payload_p
    for k, e in errs.items():
        check(e == 0, f"kernel {k} disagrees with its twin (max |err| {e})")
    print("kernel phase: K1-K3 equal their twins exactly on both corpora",
          flush=True)

    # ---- slice: the encode path end to end -----------------------------
    launches = {k: 0 for k in kernels.LAUNCHES}
    for c in CORPORA:
        data = streams[c]
        torch.cuda.synchronize()
        kernels.reset_launches()
        enc.COUNTS["host_reencoded_blocks"] = 0
        t0 = time.perf_counter()
        stream = enc.encode(data, N)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = dict(kernels.LAUNCHES)
        for k in launches:
            launches[k] += used[k]
        check(all(v > 0 for v in used.values()),
              f"{c}: a kernel was not launched by the encode run: {used}")
        check(enc.COUNTS["host_reencoded_blocks"] == 0,
              f"{c}: blocks re-encoded on the host: {enc.COUNTS}")
        ref = hostref.encode(data[:KERNEL_BYTES], N)
        check(stream[: len(ref)] == ref,
              f"{c}: wire bytes of the first {B} blocks differ from hostref")
        t1 = time.perf_counter()
        back = dec.decode(stream, use_device=False)
        t_dec = time.perf_counter() - t1
        check(back == data, f"{c}: round trip through decode failed")
        print(f"slice [{c}]: {len(data)} B -> {len(stream)} B (ratio "
              f"{len(stream) / len(data):.4f}); encode end to end "
              f"{len(data) / wall / 1e9:.4f} GB/s ({wall:.3f} s); host "
              f"decode {t_dec:.3f} s; launches {used}; host re-encoded 0; "
              f"first {B} blocks wire-equal to hostref; round trip ok "
              f"({card})", flush=True)

        # Device-resident batch: encode_blocks whole, and stage by stage.
        blocks, nv = kernel_batch(torch, data, last_row=N)
        t_all = cuda_ms(torch, lambda: dev.encode_blocks(blocks, nv, W), 5)
        stages, total, share = stage_ms(torch, dev, kernels, blocks, nv, W)
        print(f"device-resident [{c}]: encode_blocks {t_all:.3f} ms per "
              f"{B}x{N} batch = {KERNEL_BYTES / t_all / 1e6:.4f} GB/s; "
              f"stages in one pass (median of 5) "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
              + f" ms, sum {total:.3f} ms; build_trees share "
              f"{100 * share:.1f}% ({card})", flush=True)
        del blocks, nv, stream, back

    sources = {"histogram": "histogram.cu", "symbol_layout": "layout.cu",
               "pack": "pack.cu"}
    replaces = {"histogram": "libhuffman_tpu/ops/device.py:145",
                "symbol_layout": "libhuffman_tpu/ops/device.py:360",
                "pack": "libhuffman_tpu/ops/concat_kernel.py:274"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"libhuffman_tpu_torch/csrc/{sources[k]}",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": statistics.median(ms[k]),
         "plain_ms": statistics.median(plain_ms[k])}
        for k in sources]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
