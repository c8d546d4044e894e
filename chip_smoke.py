#!/usr/bin/env python3
"""On-card smoke run of libhuffman_tpu_torch's encode and decode paths.

Run from the root of a checkout on a machine with one NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``libhuffman_tpu_torch/csrc`` and then:

  1. prints the card's name and power limit (nvidia-smi) and the build
     times of the kernels and of the native host runtime;
  2. encode kernel phase: holds each encode kernel (K1 histogram, K2
     layout, K3 pack) against its plain-torch twin on the card at the
     encode path's shapes (B = 128 blocks of N = 65536 bytes, W = 24576
     payload words, a ragged last row) for the first 8 MiB of the ``text``
     and ``mixed`` corpora (bench/corpora.py), exactly, and times the
     kernel, its twin and, for K1 and K2, the one PyTorch call that
     computes the same function (CUDA events, median; a kernel's time is
     its device time, taken behind a spin kernel so that the host's
     launch work is not in it, and is printed beside its time with that
     work, as an idle card sees it); then a ``limits [encode]`` line on
     the text batch: a ``torch.sum`` that reads the blocks once, sums that
     read C and L once (each also on a float32 view of the same bytes),
     and a ``fill_`` of K3's payload;
  2b. encode edge phase: K1 and K3 against their twins, exactly, on
     crafted inputs from tests/torch_port_util.py, with the output
     buffers poisoned first: K1 on every kind of ``hist_edge_inputs``
     (n_valid 0, 1 and 17; random bytes past n_valid; one byte value; all
     256 values) at N = 3000, N = 65536 (also as rows at an odd byte
     offset) and N = 2^21; K3 on every kind of ``pack_edge_inputs`` (all
     lengths 0 or 32; 32-bit codes at every segment and tile boundary; a
     total of exactly 32 W and one bit more; segments that end inside one
     word) at N = 3001, 4096, 65536, 70000, 131072 and 2^21 with the
     encode path's W for each (1536 to 786432 words); B in {1, 3, 513},
     and {1, 3} at N = 2^21;
  3. decode kernel phase: the same for each decode kernel (K5 resolve, K6
     chain, K4 emit) on the device plans of the encoded 8 MiB prefix of
     each corpus (``decode.build_device_plans``: 128 blocks), summed over
     the plans, and a ``limits`` line: K5 at NS = 0 on the same words and
     one ``fill_`` of K5's and of K4's output;
  3b. decode edge phase: each decode kernel against its twin, exactly, on
     crafted inputs from tests/torch_port_util.py, for B in {1, 3, 513},
     with the output buffers poisoned first: K6 on ``chain_edge_meta`` (dead
     entries on a segment's first and last position, a length 31 on a
     segment's last position, a length 40, a whole segment of 1-bit starts,
     uniform random lengths) with NP = 3 L + 32 for the kernel's segment
     length L = 2048; K5 at every stage count NS in 0..5 (tables of
     ``fib_block(10 + 3 NS)``, words of ``run_words``) with W = 40 and W = 3
     S + 40 for its slice of S = 512 words; K4 on every kind of
     ``emit_edge_inputs`` (n_cap 0, mid-cell, past NG; zero counts; a live
     total past 4 OUTW; counts of 5-8) with NG = 2 T + 148 for its tile of T
     = 2048 groups and OUTW = 3 NG / 4 and 4 NG;
  4. slice: ``encode(data, 65536)`` on 64 MiB of each corpus (the wire
     bytes of the first 128 blocks must equal the host-exact codec's, every
     encode kernel must have been launched, no block re-encoded on the
     host), then ``decode(stream)`` with the default device route (it must
     return the input and equal the host route's output, every decode
     kernel must have been launched, at most 1% of blocks walked on the
     host); the launch counts are set to 0 just before each of the two
     runs and read just after; then holds K5, K6 and K4 against their
     twins, exactly, on every device plan of that decode run (up to 512
     blocks each); prints end-to-end and device-resident GB/s and
     per-stage device breakdowns of both directions, and K5's, K6's and
     K4's times per plan beside their bytes bounds, with, for the first
     plan, K6's three launches' device times (torch.profiler);
  5. error phase: a truncated stream, a flipped tree bit and trailing
     garbage raise the same error class on the device route as on the
     host route;
  6. prints one JSON line describing the six kernels (launches on the
     slice, max |err| over every phase, device time and the twin's time
     per 8 MiB, median over the two corpora, the bound from the bytes each
     must move at 3.35 TB/s, and the PyTorch call's time for K1 and K2),
     then the result line ``{"ok": true, "device": {...}}`` last.

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
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory: 3.35 TB/s
HOST_SHARE_MAX = 0.01      # most blocks the decode slice may walk on the host


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def load_test_util():
    """tests/torch_port_util.py, loaded by path: the corpora and the K6
    edge cases the CPU tests use."""
    spec = importlib.util.spec_from_file_location(
        "torch_port_util", ROOT / "tests" / "torch_port_util.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(torch, fn, reps: int, warmup: int = 2, busy: bool = True
            ) -> float:
    """Median time of ``fn()`` in ms over ``reps`` runs, between CUDA events
    around it.  With ``busy`` a spin kernel of about 0.5 ms runs first, so
    the host's part of ``fn`` (Python, checks, allocation, the launch) is
    done while the card is busy and the events hold the device time alone;
    without it the events also hold the time an idle card waits for that
    host work."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if busy:
            torch.cuda._sleep(1_000_000)
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


def decode_stage_ms(torch, kernels, tops, p, reps: int = 3):
    """Device time of each stage of ``ops.decode.decode_blocks`` on one
    resident plan, with events between the stages of one pass: (median ms
    per stage, median pass total), after one warm-up pass."""
    names = ("resolve", "chain", "emit", "bookkeeping")
    rows = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        meta = kernels.resolve(p["words"], p["tables"], p["ns"])
        ev[1].record()
        start, gw, gc4, gr32 = kernels.chain(meta)
        ev[2].record()
        kernels.emit(gw, gc4, gr32, p["caps"], p["OUTW"])
        ev[3].record()
        tops.bookkeeping(meta, start, gc4, gr32, p["n_sym"], p["NP"])
        ev[4].record()
        ev[4].synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
        del meta, start, gw, gc4, gr32
    rows = rows[1:]
    med = {n: statistics.median(r[i] for r in rows)
           for i, n in enumerate(names)}
    return med, statistics.median(sum(r) for r in rows)


def device_plans(torch, dec, stream: bytes):
    """The device plans of an encoded stream with their inputs on the card,
    and the output bytes they cover."""
    plans, n_out = dec.build_device_plans(stream)
    on_card = []
    for p in plans:
        words, tables, n_sym, caps = dec.plan_tensors(p, torch.device("cuda"))
        on_card.append({
            "words": words, "tables": tables, "n_sym": n_sym, "caps": caps,
            "NP": p.NP, "OUTW": p.OUTW, "ns": p.ns, "blocks": len(p.batch),
            "out_bytes": int(sum(c.n_sym for c, *_r in p.batch))})
    return on_card, n_out


def against_twins(torch, kernels, p):
    """K5, K6 and K4 on plan ``p`` and their twins on the same inputs:
    (max |err| per kernel, meta, chain planes, out)."""
    meta = kernels.resolve(p["words"], p["tables"], p["ns"])
    meta_p = kernels.resolve_plain(p["words"], p["tables"], p["ns"])
    planes = kernels.chain(meta)
    planes_p = kernels.chain_plain(meta)
    e_in = (planes[1], planes[2], planes[3], p["caps"], p["OUTW"])
    out = kernels.emit(*e_in)
    out_p = kernels.emit_plain(*e_in)
    torch.cuda.synchronize()
    errs = {"resolve": max_abs_err(meta, meta_p),
            "chain": max(max_abs_err(a, b) for a, b in zip(planes, planes_p)),
            "emit": max_abs_err(out, out_p)}
    return errs, meta, planes, out


def decode_bound_bytes(torch, p, meta, planes, out):
    """Bytes each decode kernel must move on plan ``p`` (each input read
    once, each output written once): K5 its words, tables and entries; K6
    the entry of each start and its four planes; K4 the counts of every
    group and the words of the live groups (a start before n_cap), and
    its output."""
    Bp, NP = meta.shape
    gc4 = planes[2]
    starts = int(planes[3][:, -1].long().sum())
    cnt = ((gc4.long()[:, :, None] >> torch.arange(0, 32, 8, device="cuda"))
           & 255).reshape(Bp, -1)
    g = torch.arange(cnt.shape[1], device="cuda")
    live = int(((cnt > 0) & (g[None, :] < p["caps"].long()[:, None])).sum())
    return {
        "resolve": (p["words"].numel() * 4 + p["tables"].numel() * 4
                    + Bp * NP * 2),
        # The walk reads the entry of each start only.
        "chain": 2 * starts + 3 * 4 * Bp * (NP // 32) + 4 * Bp * (NP // 8),
        "emit": 4 * gc4.numel() + 4 * live + out.numel()}


DECODE_SPANS = ("huff.decode.scan", "huff.decode.tables", "huff.decode.plans",
                "huff.decode.device", "huff.decode.walk")


def profile_decode(torch, dec, stream: bytes):
    """One ``decode(stream)`` under torch.profiler: (wall ms, ms per span of
    DECODE_SPANS, device ms summed over the kernels and copies it ran).
    Profiler overhead is in every number."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.decode(stream)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = prof.key_averages()
    # A span that launched kernels has a second row on the device side (a
    # user annotation covering them): read spans from the host rows and
    # device time from the device rows that are not annotations.
    spans = {r.key: r.cpu_time_total / 1e3 for r in rows
             if r.key in DECODE_SPANS and r.device_type == DeviceType.CPU}
    device = sum(r.self_device_time_total for r in rows
                 if r.device_type == DeviceType.CUDA
                 and not r.is_user_annotation) / 1e3
    return wall, spans, device


def chain_phases(torch, kernels, meta, reps: int = 3):
    """Device ms of each of K6's three launches (map, compose, write) per
    ``kernels.chain(meta)`` call, from torch.profiler's kernel rows, as
    text: "not measured" where the profiler shows none."""
    from torch.profiler import ProfilerActivity, profile

    kernels.chain(meta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kernels.chain(meta)
        torch.cuda.synchronize()
    out = {}
    for phase in ("chain_map", "chain_compose", "chain_write"):
        us = sum(r.self_device_time_total for r in prof.key_averages()
                 if phase in r.key)
        out[phase] = f"{us / 1e3 / reps:.4f} ms" if us else "not measured"
    return out


def outcome(fn):
    """The name of the error class ``fn()`` raises, or "no error"."""
    try:
        fn()
    except Exception as e:  # the class is what the error phase compares
        return type(e).__name__
    return "no error"


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
    from libhuffman_tpu_torch.ops import decode as tops
    from libhuffman_tpu_torch.ops import device as dev

    util = load_test_util()
    corpora = util.corpora()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
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

    # ---- encode kernel phase: each kernel against its twin, exact ------
    W = enc._pack_params(N)
    errs = {k: 0 for k in kernels.LAUNCHES}
    ms = {k: [] for k in errs}
    plain_ms = {k: [] for k in errs}
    bound_bytes = {k: [] for k in errs}
    # The PyTorch call computing a kernel's function, where there is one;
    # timed as a yardstick only, the port never calls it.
    library_ms = {"histogram": [], "symbol_layout": []}
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
        # Bytes each kernel must move: every input read once, every output
        # written once.
        bound_bytes["histogram"].append(B * N + 4 * B + 4 * B * 512)
        bound_bytes["symbol_layout"].append(
            B * N + 2 * 4 * B * 256 + 4 * B + 2 * 4 * B * N)
        bound_bytes["pack"].append(2 * 4 * B * N + 4 * B * W + B)
        # Their inputs are built outside the timed window: K1's row-offset
        # index (the twin's), K2's table codes | lens << 32 and int64 index
        # (the gather leaves out K2's n_valid mask).
        pos = torch.arange(N, device="cuda")
        idx = torch.where(
            pos[None, :] < nv[:, None].long(),
            blocks.long() + torch.arange(B, device="cuda")[:, None] * 256,
            B * 256).flatten()
        table = (codes.long() & 0xFFFFFFFF) | (lens.long() << 32)
        gidx = blocks.long()
        library = {
            "histogram": lambda: torch.bincount(idx, minlength=B * 256 + 1),
            "symbol_layout": lambda: torch.gather(table, 1, gidx)}
        for k, (kfn, pfn) in runs.items():
            ms[k].append(cuda_ms(torch, kfn, reps=15))
            paced = cuda_ms(torch, kfn, reps=15, busy=False)
            plain_ms[k].append(cuda_ms(torch, pfn, reps=5))
            lib = ""
            if k in library:
                library_ms[k].append(cuda_ms(torch, library[k], reps=15))
                lib = f", library {library_ms[k][-1]:.4f} ms"
            print(f"kernel {k} [{c}]: {ms[k][-1]:.4f} ms ({paced:.4f} ms "
                  f"with its launch), twin {plain_ms[k][-1]:.4f} ms{lib}, "
                  f"bound {bound_bytes[k][-1] / HBM_BYTES_PER_MS:.4f} ms "
                  f"(B={B}, N={N}, W={W}; {card})", flush=True)
        if c == "text":
            # What a kernel moving K1's or K3's bytes can reach at this
            # size: one read of the blocks, one of C and L (as integers, and
            # viewed as float32, whose reduction is faster), one write of
            # the payload.
            f32 = (blocks.view(torch.float32), C.view(torch.float32),
                   L.view(torch.float32))
            lim = [cuda_ms(torch, lambda: blocks.sum(), reps=15),
                   cuda_ms(torch, lambda: f32[0].sum(), reps=15),
                   cuda_ms(torch, lambda: (C.sum(), L.sum()), reps=15),
                   cuda_ms(torch, lambda: (f32[1].sum(), f32[2].sum()),
                           reps=15),
                   cuda_ms(torch, lambda: payload.fill_(1), reps=15)]
            print(f"limits [encode]: sum of blocks {lim[0]:.4f} ms "
                  f"(as float32 {lim[1]:.4f} ms; {B * N} B), sums of C and "
                  f"L {lim[2]:.4f} ms (as float32 {lim[3]:.4f} ms; "
                  f"{8 * B * N} B), fill_ of pack's payload {lim[4]:.4f} ms "
                  f"({4 * B * W} B) ({card})", flush=True)
            del f32
        del blocks, nv, freqs, freqs_p, C, L, Cp, Lp, payload, payload_p
        del idx, table, gidx, library
    for k in ("histogram", "symbol_layout", "pack"):
        check(errs[k] == 0,
              f"kernel {k} disagrees with its twin (max |err| {errs[k]})")
    print("kernel phase: K1-K3 equal their twins exactly on both corpora",
          flush=True)

    # ---- K1 and K3 edge phase: crafted inputs against the twins, exact -
    t0 = time.perf_counter()
    cases = 0
    for edge in util.HIST_EDGES:
        for Nc, offset in ((3000, 0), (N, 0), (N, 1), (1 << 21, 0)):
            sizes = (1, 3) if Nc > 4 * N else (1, 3, 513)
            x, nvc = util.hist_edge_inputs(edge, sizes[-1], Nc, seed=Nc)
            for Bc in sizes:
                # Rows at ``offset`` bytes into a buffer: an odd offset
                # takes the kernel's unaligned path.
                flat = torch.empty(offset + Bc * Nc, dtype=torch.uint8,
                                   device="cuda")
                flat[offset:] = util.tensor(x[:Bc].reshape(-1)).cuda()
                blocks = flat[offset:].view(Bc, Nc)
                nv = util.tensor(nvc[:Bc]).cuda()
                want = kernels.histogram_plain(blocks, nv)
                poison = torch.full_like(want, -1)
                del poison
                got = kernels.histogram(blocks, nv)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs["histogram"] = max(errs["histogram"], err)
                check(err == 0, f"K1 edge {edge}: N={Nc} offset={offset} "
                      f"B={Bc}: max |err| {err} against its twin")
                cases += 1
                del flat, blocks, nv, want, got
    n_hist = cases
    for edge in util.PACK_EDGES:
        for Nc in (3001, 4096, N, 70000, 2 * N, 1 << 21):
            Wc = enc._pack_params(Nc)
            sizes = (1, 3) if Nc > 4 * N else (1, 3, 513)
            Cn, Ln = util.pack_edge_inputs(edge, sizes[-1], Nc, Wc, seed=Nc)
            for Bc in sizes:
                Cc = util.tensor(Cn[:Bc]).cuda()
                Lc = util.tensor(Ln[:Bc]).cuda()
                want = kernels.pack_plain(Cc, Lc, Wc)
                poison = torch.full_like(want[0], 0xA5)
                del poison
                got = kernels.pack(Cc, Lc, Wc)
                torch.cuda.synchronize()
                err = max(max_abs_err(g, w) for g, w in zip(got, want))
                errs["pack"] = max(errs["pack"], err)
                check(err == 0, f"K3 edge {edge}: N={Nc} W={Wc} B={Bc}: max "
                      f"|err| {err} against its twin")
                cases += 1
                del Cc, Lc, want, got
            del Cn, Ln
    print(f"K1/K3 edge phase: {cases} cases (K1: {n_hist}, "
          f"{len(util.HIST_EDGES)} kinds, N in (3000, {N}, {N} at an odd "
          f"offset, {1 << 21}); K3: {cases - n_hist}, "
          f"{len(util.PACK_EDGES)} kinds, N in (3001, 4096, {N}, 70000, "
          f"{2 * N}, {1 << 21}) with W = _pack_params(N); B in (1, 3, 513), "
          f"(1, 3) at N = {1 << 21}) equal the twins exactly "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- decode kernel phase: K5, K6, K4 against their twins, exact ----
    for c in CORPORA:
        prefix = enc.encode(streams[c][:KERNEL_BYTES], N)
        plans, n_out = device_plans(torch, dec, prefix)
        check(n_out >= KERNEL_BYTES, f"{c}: the plans of the {B}-block "
              f"prefix cover {n_out} bytes, not {KERNEL_BYTES}")
        t = {k: [0.0, 0.0, 0, 0.0] for k in ("resolve", "chain", "emit")}
        for p in plans:
            words, tables, ns = p["words"], p["tables"], p["ns"]
            e, meta, planes, out = against_twins(torch, kernels, p)
            for k, v in e.items():
                errs[k] = max(errs[k], v)
            moved = decode_bound_bytes(torch, p, meta, planes, out)
            e_in = (planes[1], planes[2], planes[3], p["caps"], p["OUTW"])
            runs = {
                "resolve": (lambda: kernels.resolve(words, tables, ns),
                            lambda: kernels.resolve_plain(words, tables, ns)),
                "chain": (lambda: kernels.chain(meta),
                          lambda: kernels.chain_plain(meta)),
                "emit": (lambda: kernels.emit(*e_in),
                         lambda: kernels.emit_plain(*e_in)),
            }
            for k, (kfn, pfn) in runs.items():
                t[k][0] += cuda_ms(torch, kfn, reps=5)
                t[k][1] += cuda_ms(torch, pfn, reps=3, warmup=1)
                t[k][2] += moved[k]
                t[k][3] += cuda_ms(torch, kfn, reps=5, busy=False)
            del meta, planes, out, e_in
        shapes = ", ".join(f"B={p['blocks']}/{p['words'].shape[0]} "
                           f"NP={p['NP']} NS={p['ns']}" for p in plans)
        # What bounds K5 and K4 from below: K5 with no lookup past LUT10
        # (NS = 0) on the same words, and one fill_ of each output.
        lim = [0.0, 0.0, 0.0]
        for p in plans:
            meta = kernels.resolve(p["words"], p["tables"], 0)
            out = torch.empty((meta.shape[0], 4 * p["OUTW"]),
                              dtype=torch.uint8, device="cuda")
            lim[0] += cuda_ms(torch, lambda: kernels.resolve(
                p["words"], p["tables"], 0), reps=5)
            lim[1] += cuda_ms(torch, lambda: meta.fill_(1), reps=5)
            lim[2] += cuda_ms(torch, lambda: out.fill_(1), reps=5)
            del meta, out
        print(f"limits [{c}]: resolve at NS=0 {lim[0]:.4f} ms, fill_ of its "
              f"output {lim[1]:.4f} ms; fill_ of emit's output {lim[2]:.4f} "
              f"ms ({card})", flush=True)
        for k, (kms, pms, nbytes, paced) in t.items():
            ms[k].append(kms)
            plain_ms[k].append(pms)
            bound_bytes[k].append(nbytes)
            print(f"kernel {k} [{c}]: {kms:.4f} ms ({paced:.4f} ms with its "
                  f"launches), twin {pms:.4f} ms, bound "
                  f"{nbytes / HBM_BYTES_PER_MS:.4f} ms over {len(plans)} "
                  f"plan(s) ({shapes}; {card})", flush=True)
        del plans
    for k in ("resolve", "chain", "emit"):
        check(errs[k] == 0,
              f"kernel {k} disagrees with its twin (max |err| {errs[k]})")
    print("kernel phase: K4-K6 equal their twins exactly on both corpora",
          flush=True)

    # ---- K6 edge phase: crafted chains against the twin, exact ---------
    cases = 0
    L = util.CHAIN_SEG
    NP = 3 * L + 32
    for edge in util.CHAIN_EDGES:
        for Bc in (1, 3, 513):
            meta = torch.from_numpy(util.chain_edge_meta(
                edge, Bc, NP, L, seed=Bc).view("int16")).cuda()
            want = kernels.chain_plain(meta)
            # Poisoned buffers: the kernel must write every word.
            poison = [torch.full_like(w, -1) for w in want]
            del poison
            got = kernels.chain(meta)
            torch.cuda.synchronize()
            err = max(max_abs_err(g, w) for g, w in zip(got, want))
            errs["chain"] = max(errs["chain"], err)
            check(err == 0, f"K6 edge {edge}: B={Bc} NP={NP}: max |err| "
                  f"{err} against its twin")
            cases += 1
    print(f"K6 edge phase: {cases} cases ({len(util.CHAIN_EDGES)} edges, "
          f"NP = 3 L + 32 for L = {L}, B in (1, 3, 513)) equal the twin "
          f"exactly", flush=True)

    # ---- K5 and K4 edge phase: crafted inputs against the twins, exact -
    import numpy as np

    cases = 0
    span = util.RESOLVE_SPAN
    for ns in range(kernels.MAX_NS + 1):
        tab, got_ns = util.block_tables(util.fib_block(10 + 3 * ns))
        check(got_ns == ns, f"fib_block({10 + 3 * ns}) gives NS {got_ns}")
        for Wc in (40, 3 * span + 40):
            for Bc in (1, 3, 513):
                words = util.tensor(util.run_words(
                    np.random.default_rng(Bc), Bc, Wc)).cuda()
                tables = util.tensor(np.repeat(tab, Bc, axis=0)).cuda()
                want = kernels.resolve_plain(words, tables, ns)
                poison = torch.full_like(want, -1)
                del poison
                got = kernels.resolve(words, tables, ns)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs["resolve"] = max(errs["resolve"], err)
                check(err == 0, f"K5 edge NS={ns} W={Wc} B={Bc}: max |err| "
                      f"{err} against its twin")
                cases += 1
    NG = 2 * util.EMIT_TILE + 148
    for edge in util.EMIT_EDGES:
        for OUTW in (3 * NG // 4, 4 * NG):
            for Bc in (1, 3, 513):
                ins = [util.tensor(a).cuda()
                       for a in util.emit_edge_inputs(edge, Bc, NG, seed=Bc)]
                want = kernels.emit_plain(*ins, OUTW)
                poison = torch.full_like(want, 0xA5)
                del poison
                got = kernels.emit(*ins, OUTW)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs["emit"] = max(errs["emit"], err)
                check(err == 0, f"K4 edge {edge}: OUTW={OUTW} B={Bc}: max "
                      f"|err| {err} against its twin")
                cases += 1
    print(f"K5/K4 edge phase: {cases} cases (K5: NS 0-5, W in (40, "
          f"{3 * span + 40}); K4: {len(util.EMIT_EDGES)} kinds, NG = {NG}, "
          f"OUTW in ({3 * NG // 4}, {4 * NG}); B in (1, 3, 513)) equal the "
          f"twins exactly", flush=True)

    # ---- slice: the encode and decode paths end to end -----------------
    launches = {k: 0 for k in kernels.LAUNCHES}
    encode_kernels = ("histogram", "symbol_layout", "pack")
    decode_kernels = ("resolve", "chain", "emit")
    for c in CORPORA:
        data = streams[c]
        torch.cuda.synchronize()
        kernels.reset_launches()
        enc.COUNTS["host_reencoded_blocks"] = 0
        t0 = time.perf_counter()
        stream = enc.encode(data, N)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = {k: kernels.LAUNCHES[k] for k in encode_kernels}
        for k in encode_kernels:
            launches[k] += used[k]
        check(all(v > 0 for v in used.values()),
              f"{c}: a kernel was not launched by the encode run: {used}")
        check(enc.COUNTS["host_reencoded_blocks"] == 0,
              f"{c}: blocks re-encoded on the host: {enc.COUNTS}")
        ref = hostref.encode(data[:KERNEL_BYTES], N)
        check(stream[: len(ref)] == ref,
              f"{c}: wire bytes of the first {B} blocks differ from hostref")
        print(f"slice encode [{c}]: {len(data)} B -> {len(stream)} B (ratio "
              f"{len(stream) / len(data):.4f}); encode end to end "
              f"{len(data) / wall / 1e9:.4f} GB/s ({wall:.3f} s); launches "
              f"{used}; host re-encoded 0; first {B} blocks wire-equal to "
              f"hostref ({card})", flush=True)

        # Device-resident batch: encode_blocks whole, and stage by stage.
        blocks, nv = kernel_batch(torch, data, last_row=N)
        t_all = cuda_ms(torch, lambda: dev.encode_blocks(blocks, nv, W), 5,
                        busy=False)
        stages, total, share = stage_ms(torch, dev, kernels, blocks, nv, W)
        print(f"device-resident encode [{c}]: encode_blocks {t_all:.3f} ms "
              f"per {B}x{N} batch = {KERNEL_BYTES / t_all / 1e6:.4f} GB/s; "
              f"stages in one pass (median of 5) "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
              + f" ms, sum {total:.3f} ms; build_trees share "
              f"{100 * share:.1f}% ({card})", flush=True)
        del blocks, nv

        # Decode: the device route (the default), then the host route.
        torch.cuda.synchronize()
        kernels.reset_launches()
        for k in dec.COUNTS:
            dec.COUNTS[k] = 0
        t0 = time.perf_counter()
        back = dec.decode(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = {k: kernels.LAUNCHES[k] for k in decode_kernels}
        counts = dict(dec.COUNTS)
        for k in decode_kernels:
            launches[k] += used[k]
        check(back == data, f"{c}: round trip through device decode failed")
        check(all(v > 0 for v in used.values()),
              f"{c}: a kernel was not launched by the decode run: {used}")
        nblocks = counts["host_decoded_blocks"] + counts["device_decoded_blocks"]
        check(counts["host_decoded_blocks"] <= HOST_SHARE_MAX * nblocks,
              f"{c}: too many blocks walked on the host: {counts}")
        t1 = time.perf_counter()
        host = dec.decode(stream, use_device=False)
        t_host = time.perf_counter() - t1
        check(host == back, f"{c}: device and host routes differ")
        print(f"slice decode [{c}]: device route {len(back) / wall / 1e9:.4f}"
              f" GB/s end to end ({wall:.3f} s); host route "
              f"{len(host) / t_host / 1e9:.4f} GB/s ({t_host:.3f} s); "
              f"launches {used}; blocks {counts}; equal to the input and to "
              f"the host route ({card})", flush=True)

        wall_p, spans, busy = profile_decode(torch, dec, stream)
        print(f"decode profile [{c}]: wall {wall_p:.3f} ms; spans "
              + ", ".join(f"{k.split('.')[-1]} {spans.get(k, 0.0):.3f}"
                          for k in DECODE_SPANS)
              + f" ms; device busy {busy:.3f} ms = "
              f"{100 * busy / wall_p:.1f}% of the wall (torch.profiler, "
              f"overhead included; {card})", flush=True)

        # Device-resident plans, the ones the decode run launched on:
        # each kernel against its twin, then decode_blocks whole and stage
        # by stage.
        plans, _n = device_plans(torch, dec, stream)
        check(len(plans) == used["chain"],
              f"{c}: {len(plans)} plans, but the decode run launched "
              f"{used['chain']}")
        for i, p in enumerate(plans):
            e, meta, planes, out = against_twins(torch, kernels, p)
            bound = {k: v / HBM_BYTES_PER_MS for k, v in
                     decode_bound_bytes(torch, p, meta, planes, out).items()}
            e_in = (planes[1], planes[2], planes[3], p["caps"], p["OUTW"])
            t_k4 = cuda_ms(torch, lambda: kernels.emit(*e_in), 5)
            t_k5 = cuda_ms(torch, lambda: kernels.resolve(
                p["words"], p["tables"], p["ns"]), 5)
            del planes, out, e_in
            for k, v in e.items():
                errs[k] = max(errs[k], v)
            check(not any(e.values()),
                  f"{c} plan {i}: a decode kernel disagrees with its twin "
                  f"(max |err| {e})")
            args = (p["words"], p["tables"], p["n_sym"], p["caps"], p["NP"],
                    p["OUTW"], p["ns"])
            t_all = cuda_ms(torch, lambda: tops.decode_blocks(*args), 3,
                            busy=False)
            stages, total = decode_stage_ms(torch, kernels, tops, p)
            t_twin = cuda_ms(torch, lambda: kernels.chain_plain(meta), 1, 0)
            t_k6 = cuda_ms(torch, lambda: kernels.chain(meta), 5)
            split = chain_phases(torch, kernels, meta) if i == 0 else {}
            # The design's own traffic: the entries read twice, the planes
            # written once.
            design = (2 * 2 * meta.numel() + 4 * meta.shape[0]
                      * (3 * (p["NP"] // 32) + p["NP"] // 8))
            del meta
            print(f"device-resident decode [{c}] plan {i}: B={p['blocks']}/"
                  f"{p['words'].shape[0]} NP={p['NP']} NS={p['ns']}: "
                  f"K5/K6/K4 equal their twins (max |err| "
                  f"{max(e.values())}); decode_blocks {t_all:.3f} ms = "
                  f"{p['out_bytes'] / t_all / 1e6:.4f} GB/s out; stages "
                  + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
                  + f" ms, sum {total:.3f} ms; chain twin {t_twin:.3f} ms "
                  f"({card})", flush=True)
            print(f"K6 per plan [{c}] plan {i}: {t_k6:.4f} ms; design "
                  f"bytes {design / HBM_BYTES_PER_MS:.4f} ms at 3.35 TB/s"
                  + ("; launches " + ", ".join(f"{k} {v}" for k, v
                                               in split.items())
                     if split else "")
                  + f" ({card})", flush=True)
            print(f"K5/K4 per plan [{c}] plan {i}: resolve {t_k5:.4f} ms, "
                  f"bound {bound['resolve']:.4f} ms; emit {t_k4:.4f} ms, "
                  f"bound {bound['emit']:.4f} ms (bytes at 3.35 TB/s; "
                  f"{card})", flush=True)
        del plans, back, host

        # ---- error phase: same class on both routes --------------------
        prefix = enc.encode(data[:KERNEL_BYTES], N)
        first, second = dec.scan_candidates(prefix)[:2]
        flipped = None
        for i in range(10, first.payload_off):  # a tree bit that breaks it
            f = bytearray(prefix)
            f[i] ^= 0x40
            # Judged on the first block alone, on the host route.
            if outcome(lambda: dec.decode(bytes(f[: second.off]),
                                          use_device=False)) not in (
                    "no error", "ReadWriteError"):
                flipped = bytes(f)
                break
        check(flipped is not None, f"{c}: no tree bit flip raised")
        cases = {"truncated": prefix[:-1], "tree-bit-flip": flipped,
                 "trailing-garbage": prefix + b"\x01\x02\x03"}
        for case, bad in cases.items():
            d = outcome(lambda: dec.decode(bad))
            h = outcome(lambda: dec.decode(bad, use_device=False))
            check(d == h and d != "no error",
                  f"{c}: {case}: device route {d}, host route {h}")
            print(f"errors [{c}] {case}: {d} on both routes", flush=True)
        del stream, prefix, flipped, cases

    sources = {"histogram": "histogram.cu", "symbol_layout": "layout.cu",
               "pack": "pack.cu", "resolve": "resolve.cu",
               "chain": "chain.cu", "emit": "emit.cu"}
    replaces = {"histogram": "libhuffman_tpu/ops/device.py:145",
                "symbol_layout": "libhuffman_tpu/ops/device.py:360",
                "pack": "libhuffman_tpu/ops/concat_kernel.py:274",
                "resolve": "libhuffman_tpu/ops/decode_v3.py:212",
                "chain": "libhuffman_tpu/ops/decode_v3.py:331",
                "emit": "libhuffman_tpu/ops/concat_kernel.py:340"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"libhuffman_tpu_torch/csrc/{sources[k]}",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": statistics.median(ms[k]),
         "plain_ms": statistics.median(plain_ms[k]),
         "bound_ms": statistics.median(bound_bytes[k]) / HBM_BYTES_PER_MS,
         "bound_by": "bytes",
         # K1: torch.bincount, K2: torch.gather (see the kernel phase); no
         # single PyTorch call computes the other four.
         "library_ms": (statistics.median(library_ms[k])
                        if k in library_ms else None)}
        for k in sources]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
