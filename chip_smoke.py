#!/usr/bin/env python3
"""On-card smoke run of libhuffman_tpu_torch: encode, decode and the API.

Run from the root of a checkout on a machine with one NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``libhuffman_tpu_torch/csrc`` and then:

  1. prints the card's name and power limit (nvidia-smi) and the build
     times of the kernels and of the native host runtime;
  2. encode kernel phase: holds each encode kernel (K1 histogram, K7
     trees, K2 layout, K3 pack) against its plain-torch twin on the card at
     the encode path's shapes (B = 128 blocks of N = 65536 bytes, W = 24576
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
  2a. tree phase: K7 against its twin, every output exactly, on the
     crafted rows of ``tree_edge_freqs`` (all 256 symbols at one rate,
     Fibonacci rows with codes of 22, 32, 33 and 40 bits, the last two
     flagged, five equal rates, one symbol, none) for B in {1, 3, 8,
     513}, outputs poisoned first, and on the batches the benchmark's
     encode gives it (1024 x 65536 and 512 x 131072 bytes of each
     corpus), each timed beside its twin, its bytes bound and one row's
     time (the round chain's latency);
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
  6. API phase, at the API's default blocksize of 131072 (512 blocks per
     corpus): ``api.compress`` (the first 128 blocks wire-equal to the
     host-exact codec, every encode kernel launched, no block re-encoded
     on the host), ``api.decompress`` (the input back, every decode kernel
     launched, at most 1% of blocks walked on the host), ``open(path,
     "wb")`` writing the corpus in 1 MiB writes (the file equal to
     ``compress``'s stream) and ``open(path, "rb").read(1 MiB)`` reading it
     back (and ``read()`` at its default 8 KiB over the first 128 blocks), a ``HuffmanDecompressor`` fed the first 8 MiB of the stream in
     64 KiB pieces (the input's matching whole blocks back), and resume
     (``encode_range`` over three parts of the block range equal to the
     stream, 512 ``block_offsets``, ``decode_from_block(stream, 200,
     300)``); the launch counts are set to 0 before each call and read
     after it, and each call's GB/s is printed; then K1-K3 and K7 against
     their twins on one 128 x 131072 batch and K5, K6 and K4 on every device
     plan of the first 128 blocks, exactly, each with its device time
     beside its bytes bound, and the resident encode batch stage by stage;
  7. blocksize sweep: ``encode`` and ``decode`` at blocksizes 1 (4 KiB of
     each corpus), 17 and 1024 (1 MiB), 3072 and 5120 (8 MiB) and 0 (1 MiB,
     one block), wire-equal to the host-exact codec (computed in worker
     processes), decoded equal to the input and to the host route; every
     encode kernel launched from blocksize 17 and every decode kernel at
     1024, 3072 and 5120; the launches and ``decode.COUNTS`` are printed;
     wherever the encode launched K1-K3 and K7 (every blocksize here) they
     equal their twins on one batch of the input in the shape encode gave
     them
     (128 x blocksize, 1 x 1 MiB at 0), and wherever the decode launched
     K5, K6 and K4 (17 and up) they equal their twins on every device plan
     of the stream, exactly;
  7b. parallel phase (libhuffman_tpu_torch/parallel/shard.py):
     ``block_mesh()`` of the machine (as many devices as cards; the first
     B blocks of each corpus wire-equal to the host-exact codec and
     decoded back), then ``EncodeConfig(blocksize=N, mesh=...)`` and
     ``DecodeConfig(mesh=...)`` with the card listed 2 and 3 times on
     64 MiB of each corpus: the stream equal to the slice's single-device
     stream and to the host-exact codec on the first B blocks, every
     kernel launched, the input back with at most 1% of blocks walked on
     the host, a truncated stream raising the host route's error class;
     GB/s of each; K1-K3 and K7 against their twins on every row slice of
     every batch that encode split over the mesh (256 x N, and 128 x N with
     empty rows in the last batch over 3), and K5, K6 and K4 on every row
     slice of every plan of the decode (``build_device_plans(lane_mult=k)``),
     exactly; then ``encode_sharded`` and ``decode_blocks_sharded``
     over two slices of the card equal to ``encode_blocks`` and
     ``decode_blocks`` on the kernel phase's batch and on the plans of its
     encoding, exactly;
  7c. two-process phase (libhuffman_tpu_torch/parallel/multihost.py): two
     processes of tests/torch_multihost_worker.py on the card, joined over
     gloo through a ``file://`` rendezvous, encode and decode 64 MiB of
     ``text`` at blocksize N: each rank's stream has the single-device
     stream's sha256, the sizes-only segments lie at their offsets, the
     decode returns the input on both ranks, and the bytes exchanged stay
     within the sizes-only bounds; the wall of each step is printed;
  8. prints the smoke's wall time, then one JSON line describing the seven
     kernels (launches summed over the slice, the API phase, the sweep and
     the parallel phase,
     max |err| over every phase, device time and the twin's time per 8 MiB
     at 64 KiB blocks, median over the two corpora, the bound from the
     bytes each must move at 3.35 TB/s, and the PyTorch call's time for K1
     and K2), then the result line ``{"ok": true, "device": {...}}`` last.

Any failed check exits non-zero before the result line; so does a machine
without CUDA, and a directory holding this script without the package.
"""

from __future__ import annotations

import importlib.util
import io
import json
import multiprocessing
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ProcessPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
N = 65536                # bench blocksize
B = 128                  # blocks per device batch (encode.DEFAULT_BATCH_BLOCKS)
KERNEL_BYTES = B * N     # 8 MiB: the kernel phase's batch
SLICE_BYTES = 64 << 20   # per corpus, end to end
RAGGED = 40000           # valid bytes in the kernel batch's last row
CORPORA = ("text", "mixed")
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory: 3.35 TB/s
HOST_SHARE_MAX = 0.01      # most blocks the decode slice may walk on the host
ENCODE_KERNELS = ("histogram", "trees", "symbol_layout", "pack")
DECODE_KERNELS = ("resolve", "chain", "emit")
API_N = 131072             # the API's default blocksize (format.py)
FILE_CHUNK = 1 << 20       # HuffmanFile write and read size in the API phase
FEED_BYTES = 8 << 20       # stream bytes fed to the HuffmanDecompressor
FEED_PIECE = 64 << 10      # bytes per HuffmanDecompressor.decompress call
RESUME_RANGE = (200, 300)  # blocks decode_from_block decodes
# (blocksize, input bytes) of the blocksize sweep; 0 is one whole-input block.
SWEEP = ((1, 4 << 10), (17, 1 << 20), (1024, 1 << 20), (3072, 8 << 20),
         (5120, 8 << 20), (0, 1 << 20))
MESH_SPLITS = (2, 3)     # the parallel phase lists the card this many times
WORKER_TIMEOUT = 300     # seconds for each process of the two-process phase


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


def stage_ms(torch, kernels, blocks, nv, W: int, reps: int = 5):
    """Device time of each stage of ``encode_blocks`` with events between
    the stages of one pass: (median ms per stage, median pass total,
    median share of the tree kernel in a pass), after one warm-up pass."""
    names = ("histogram", "trees", "symbol_layout", "pack")
    rows = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        freqs = kernels.histogram(blocks, nv)
        ev[1].record()
        _l, _r, _root, codes, lens, _ovf, _bits = kernels.trees(
            freqs, blocks.shape[1])
        ev[2].record()
        C, L = kernels.symbol_layout(blocks, codes, lens, nv)
        ev[3].record()
        kernels.pack(C, L, W)
        ev[4].record()
        ev[4].synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
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


def encode_against_twins(torch, kernels, blocks, nv, W: int):
    """K1, K7, K2 and K3 on a batch, and their twins on the same inputs:
    (max |err| per kernel, the kernels' outputs and the code tables)."""
    freqs = kernels.histogram(blocks, nv)
    freqs_p = kernels.histogram_plain(blocks, nv)
    trees = kernels.trees(freqs, blocks.shape[1])
    trees_p = kernels.trees_plain(freqs)
    codes, lens = trees[3], trees[4]
    C, L = kernels.symbol_layout(blocks, codes, lens, nv)
    Cp, Lp = kernels.symbol_layout_plain(blocks, codes, lens, nv)
    payload, ovf = kernels.pack(C, L, W)
    payload_p, ovf_p = kernels.pack_plain(C, L, W)
    torch.cuda.synchronize()
    errs = {"histogram": max_abs_err(freqs, freqs_p),
            "trees": max(max_abs_err(a, b) for a, b in zip(trees, trees_p)),
            "symbol_layout": max(max_abs_err(C, Cp), max_abs_err(L, Lp)),
            "pack": max(max_abs_err(payload, payload_p),
                        max_abs_err(ovf, ovf_p))}
    return errs, {"freqs": freqs, "codes": codes, "lens": lens, "C": C,
                  "L": L, "payload": payload}


def trees_bound_bytes(rows: int) -> int:
    """Bytes K7 must move on ``rows`` histograms: the 256 counts of each
    read once; left and right, codes and lens, root, overflow and
    total_bits written once."""
    return rows * (4 * 256 + 2 * 4 * 512 + 2 * 4 * 256 + 4 + 1 + 8)


def encode_bound_bytes(n: int, W: int) -> dict:
    """Bytes each encode kernel must move on a B x n batch with W payload
    words per block: every input read once, every output written once."""
    return {"histogram": B * n + 4 * B + 4 * B * 512,
            "trees": trees_bound_bytes(B),
            "symbol_layout": B * n + 2 * 4 * B * 256 + 4 * B + 2 * 4 * B * n,
            "pack": 2 * 4 * B * n + 4 * B * W + B}


def kernel_batch(torch, data: bytes, last_row: int = RAGGED, n: int = N,
                 rows: int = B):
    """The first rows x n bytes as a device batch whose last row holds
    ``last_row`` valid bytes, zero-padded as encode.encode pads."""
    import numpy as np

    x = np.frombuffer(data[:rows * n], np.uint8).reshape(rows, n).copy()
    nv = np.full(rows, n, np.int32)
    nv[-1] = last_row
    x[-1, last_row:] = 0
    return (torch.from_numpy(x).cuda(), torch.from_numpy(nv).cuda())


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def resident_encode(torch, dev, kernels, blocks, nv, W: int, tag: str,
                    card: str) -> None:
    """Print the device time of ``encode_blocks`` on a resident batch, whole
    and stage by stage."""
    Bb, n = blocks.shape
    t_all = cuda_ms(torch, lambda: dev.encode_blocks(blocks, nv, W), 5,
                    busy=False)
    stages, total, share = stage_ms(torch, kernels, blocks, nv, W)
    print(f"{tag}: encode_blocks {t_all:.3f} ms per {Bb}x{n} batch = "
          f"{Bb * n / t_all / 1e6:.4f} GB/s; stages in one pass (median of "
          f"5) " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f" ms, sum {total:.3f} ms; trees share "
          f"{100 * share:.1f}% ({card})", flush=True)


def counted(torch, kernels, fn):
    """``fn()`` with the launch counts set to 0 just before it and read
    just after: (its result, wall seconds, launches per kernel)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def reference_pieces(data: bytes, bs: int, piece: int = 1 << 18):
    """``data`` cut at block boundaries into pieces of about ``piece``
    bytes: the host codec's encodings of the pieces, joined, are its
    encoding of ``data`` (blocks are independent), so worker processes can
    share the work."""
    if bs <= 0:
        return [data]
    step = bs * max(1, piece // bs)
    return [data[i : i + step] for i in range(0, len(data), step)]


def trees_phase(torch, kernels, util, streams, errs, card) -> float:
    """K7 against its twin, every output exactly, on the crafted rows of
    ``util.TREE_EDGES`` (B in 1, 3, all of them, and 513 rows repeating
    them; outputs poisoned first) and on the batches the benchmark's
    encode gives it (1024 x 64 KiB and 512 x 128 KiB of each corpus);
    prints K7's time per batch beside its twin's, its bytes bound and one
    row's time (the round chain's latency, which bounds it).  Returns the
    median one-row time in ms."""
    import numpy as np

    edges = util.tree_edge_freqs()
    cases = 0
    for Bc in (1, 3, len(edges), 513):
        freqs = util.tensor(np.resize(edges, (Bc, 512))).cuda()
        Nc = int(freqs.long().sum(dim=1).max())
        want = kernels.trees_plain(freqs)
        poison = [torch.full_like(w, -1) for w in want]
        del poison
        got = kernels.trees(freqs, Nc)
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        errs["trees"] = max(errs["trees"], err)
        check(err == 0, f"K7 edges B={Bc}: max |err| {err} against its twin")
        cases += 1
    print(f"K7 edge phase: {cases} batches of the {len(edges)} crafted rows "
          f"({', '.join(util.TREE_EDGES)}) equal the twin exactly", flush=True)
    one_row = []
    for c in CORPORA:
        for rows, n in ((1024, N), (512, API_N)):
            blocks, nv = kernel_batch(torch, streams[c], last_row=n, n=n,
                                      rows=rows)
            freqs = kernels.histogram(blocks, nv)
            del blocks, nv
            want = kernels.trees_plain(freqs)
            got = kernels.trees(freqs, n)
            torch.cuda.synchronize()
            err = max(max_abs_err(g, w) for g, w in zip(got, want))
            errs["trees"] = max(errs["trees"], err)
            check(err == 0, f"K7 [{c}] {rows}x{n}: max |err| {err}")
            # The row with the most symbols has the longest round chain.
            busiest = int((freqs[:, :256] > 0).sum(dim=1).argmax())
            row = freqs[busiest : busiest + 1].contiguous()
            symbols = int((row[0, :256] > 0).sum())
            t_k = cuda_ms(torch, lambda: kernels.trees(freqs, n), reps=15)
            t_paced = cuda_ms(torch, lambda: kernels.trees(freqs, n),
                              reps=15, busy=False)
            t_one = cuda_ms(torch, lambda: kernels.trees(row, n), reps=15)
            t_twin = cuda_ms(torch, lambda: kernels.trees_plain(freqs),
                             reps=3, warmup=1)
            one_row.append(t_one)
            print(f"K7 [{c}] {rows}x{n}: {t_k:.4f} ms per batch ({t_paced:.4f}"
                  f" ms with its launch), one row of {symbols} symbols "
                  f"{t_one:.4f} ms, twin {t_twin:.4f} ms, bytes bound "
                  f"{trees_bound_bytes(rows) / HBM_BYTES_PER_MS:.4f} ms; "
                  f"equal to the twin ({card})", flush=True)
            del freqs, want, got, row
    return statistics.median(one_row)


def api_phase(torch, m, streams, launches, errs, card, pool):
    """The bz2-style API at its default blocksize: compress, decompress,
    HuffmanFile through open(), the incremental decompressor and resume on
    SLICE_BYTES of each corpus, then K1-K7 against their twins at
    N = API_N."""
    import numpy as np

    Wa = m.enc._pack_params(API_N)
    nblocks = SLICE_BYTES // API_N
    edges = [0, nblocks // 3, 2 * nblocks // 3, None]
    for c in CORPORA:
        data = streams[c]
        # The host codec's encoding of the first B blocks, from the worker
        # processes, before anything is timed.
        pieces = reference_pieces(data[: B * API_N], API_N, 1 << 20)
        ref = b"".join(pool.map(m.hostref.encode, pieces,
                                [API_N] * len(pieces)))

        m.enc.COUNTS["host_reencoded_blocks"] = 0
        stream, wall, used = counted(torch, m.kernels,
                                     lambda: m.api.compress(data))
        add_launches(launches, used)
        check(all(used[k] > 0 for k in ENCODE_KERNELS),
              f"{c}: a kernel was not launched by api.compress: {used}")
        check(m.enc.COUNTS["host_reencoded_blocks"] == 0,
              f"{c}: blocks re-encoded on the host: {m.enc.COUNTS}")
        check(stream[: len(ref)] == ref, f"{c}: api.compress: wire bytes "
              f"of the first {B} blocks differ from hostref")
        print(f"api compress [{c}]: {len(data)} B -> {len(stream)} B (ratio "
              f"{len(stream) / len(data):.4f}), {nblocks} blocks of "
              f"{API_N}; {len(data) / wall / 1e9:.4f} GB/s end to end "
              f"({wall:.3f} s); launches {used}; host re-encoded 0; first "
              f"{B} blocks wire-equal to hostref ({card})", flush=True)

        reset_counts(m.dec)
        back, wall, used = counted(torch, m.kernels,
                                   lambda: m.api.decompress(stream))
        add_launches(launches, used)
        counts = dict(m.dec.COUNTS)
        check(back == data, f"{c}: api.decompress did not return the input")
        check(all(used[k] > 0 for k in DECODE_KERNELS),
              f"{c}: a kernel was not launched by api.decompress: {used}")
        check(counts["host_decoded_blocks"] <= HOST_SHARE_MAX * nblocks,
              f"{c}: api.decompress walked too many blocks on the host: "
              f"{counts}")
        print(f"api decompress [{c}]: {len(back) / wall / 1e9:.4f} GB/s end "
              f"to end ({wall:.3f} s); launches {used}; blocks {counts}; "
              f"equal to the input ({card})", flush=True)

        offs, t_offs, _ = counted(torch, m.kernels,
                                  lambda: m.resume.block_offsets(stream))
        check(len(offs) == nblocks and offs[0] == 0,
              f"{c}: block_offsets gave {len(offs)} offsets, not {nblocks}")
        # The file lives in the checkout's build directory (git-ignored).
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            path = os.path.join(tmp, "corpus.hm")

            def write():
                with m.api.open(path, "wb") as f:
                    for i in range(0, len(data), FILE_CHUNK):
                        f.write(data[i : i + FILE_CHUNK])

            def read(name, size):
                parts = []
                with m.api.open(name, "rb") as f:
                    while True:
                        part = f.read(size)
                        if not part and f._fp.peek(1) == b"":
                            return b"".join(parts)
                        parts.append(part)

            _, t_w, used_w = counted(torch, m.kernels, write)
            with open(path, "rb") as f:
                check(f.read() == stream, f"{c}: the file HuffmanFile wrote "
                      f"differs from api.compress's stream")
            reset_counts(m.dec)
            back, t_r, used_r = counted(torch, m.kernels,
                                        lambda: read(path, FILE_CHUNK))
            counts_r = dict(m.dec.COUNTS)
            # read() at its default size, io.DEFAULT_BUFFER_SIZE compressed
            # bytes, over the first B blocks.
            head = os.path.join(tmp, "head.hm")
            with open(head, "wb") as f:
                f.write(stream[: offs[B]])
            reset_counts(m.dec)
            got, t_d, used_d = counted(torch, m.kernels,
                                       lambda: read(head, -1))
        add_launches(launches, used_w)
        add_launches(launches, used_r)
        add_launches(launches, used_d)
        check(back == data, f"{c}: HuffmanFile read did not return the input")
        check(got == data[: B * API_N], f"{c}: HuffmanFile read() at its "
              f"default size did not return the first {B} blocks")
        print(f"api HuffmanFile [{c}]: open(..., 'wb') in {FILE_CHUNK} B "
              f"writes {len(data) / t_w / 1e9:.4f} GB/s ({t_w:.3f} s; file "
              f"equal to api.compress's stream; launches {used_w}); "
              f"open(..., 'rb').read({FILE_CHUNK}) {len(data) / t_r / 1e9:.4f}"
              f" GB/s ({t_r:.3f} s; launches {used_r}; blocks {counts_r}); "
              f"round trip {len(data) / (t_w + t_r) / 1e9:.4f} GB/s, equal "
              f"to the input ({card})", flush=True)
        print(f"api HuffmanFile [{c}]: read() at its default "
              f"{io.DEFAULT_BUFFER_SIZE} B over the first {B} blocks "
              f"({offs[B]} B) {len(got) / t_d / 1e9:.4f} GB/s ({t_d:.3f} s; "
              f"launches {used_d}; blocks {dict(m.dec.COUNTS)}), equal to "
              f"the input ({card})", flush=True)

        ends = offs[1:] + [len(stream)]
        feed = stream[:FEED_BYTES]

        def drip():
            d = m.api.HuffmanDecompressor()
            return b"".join(d.decompress(feed[i : i + FEED_PIECE])
                            for i in range(0, len(feed), FEED_PIECE))

        reset_counts(m.dec)
        fed, wall, used = counted(torch, m.kernels, drip)
        add_launches(launches, used)
        whole = sum(1 for e in ends if e <= len(feed))
        check(fed == data[: whole * API_N], f"{c}: HuffmanDecompressor fed "
              f"{FEED_PIECE} B pieces returned {len(fed)} B, not the input's "
              f"first {whole} blocks")
        print(f"api HuffmanDecompressor [{c}]: {len(feed)} B of the stream "
              f"in {FEED_PIECE} B pieces -> {len(fed)} B ({whole} blocks, "
              f"equal to the input's prefix); {len(fed) / wall / 1e9:.4f} "
              f"GB/s ({wall:.3f} s); launches {used}; blocks "
              f"{dict(m.dec.COUNTS)} ({card})", flush=True)

        parts, t_enc, used = counted(torch, m.kernels, lambda: [
            m.resume.encode_range(data, API_N, a, b)
            for a, b in zip(edges[:-1], edges[1:])])
        add_launches(launches, used)
        check(b"".join(parts) == stream, f"{c}: encode_range over "
              f"{edges} differs from api.compress's stream")
        lo, hi = RESUME_RANGE
        got, t_dec, used_d = counted(torch, m.kernels, lambda: (
            m.resume.decode_from_block(stream, lo, hi)))
        add_launches(launches, used_d)
        check(got == data[lo * API_N : hi * API_N],
              f"{c}: decode_from_block({lo}, {hi}) differs from the input")
        print(f"api resume [{c}]: encode_range over blocks {edges} equal to "
              f"api.compress ({t_enc:.3f} s; launches {used}); block_offsets "
              f"{len(offs)} offsets ({t_offs:.3f} s); decode_from_block("
              f"{lo}, {hi}) equal to the input ({t_dec:.3f} s; launches "
              f"{used_d}) ({card})", flush=True)

        # ---- K1-K7 against their twins at N = API_N, exact -------------
        blocks, nv = kernel_batch(torch, data, n=API_N)
        e, outs = encode_against_twins(torch, m.kernels, blocks, nv, Wa)
        C, L = outs["C"], outs["L"]
        freqs, codes, lens = outs["freqs"], outs["codes"], outs["lens"]
        del outs
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        check(not any(e.values()), f"{c}: at N={API_N} an encode kernel "
              f"disagrees with its twin (max |err| {e})")
        runs = {"histogram": lambda: m.kernels.histogram(blocks, nv),
                "trees": lambda: m.kernels.trees(freqs, API_N),
                "symbol_layout": lambda: m.kernels.symbol_layout(
                    blocks, codes, lens, nv),
                "pack": lambda: m.kernels.pack(C, L, Wa)}
        bound = encode_bound_bytes(API_N, Wa)
        for k, fn in runs.items():
            t = cuda_ms(torch, fn, reps=15)
            print(f"kernel {k} at N={API_N} [{c}]: {t:.4f} ms, bound "
                  f"{bound[k] / HBM_BYTES_PER_MS:.4f} ms (B={B}, N={API_N}, "
                  f"W={Wa}; equal to its twin; {card})", flush=True)
        resident_encode(torch, m.dev, m.kernels, blocks, nv, Wa,
                        f"device-resident encode at N={API_N} [{c}]", card)
        del blocks, nv, C, L, freqs, codes, lens, runs

        plans, n_out = device_plans(torch, m.dec, stream[: offs[B]])
        check(n_out >= B * API_N, f"{c}: the plans of the first {B} blocks "
              f"cover {n_out} bytes, not {B * API_N}")
        t = {k: [0.0, 0] for k in DECODE_KERNELS}
        for p in plans:
            e, meta, planes, out = against_twins(torch, m.kernels, p)
            for k, v in e.items():
                errs[k] = max(errs[k], v)
            check(not any(e.values()), f"{c}: at N={API_N} a decode kernel "
                  f"disagrees with its twin (max |err| {e})")
            moved = decode_bound_bytes(torch, p, meta, planes, out)
            e_in = (planes[1], planes[2], planes[3], p["caps"], p["OUTW"])
            runs = {"resolve": lambda: m.kernels.resolve(
                        p["words"], p["tables"], p["ns"]),
                    "chain": lambda: m.kernels.chain(meta),
                    "emit": lambda: m.kernels.emit(*e_in)}
            for k, fn in runs.items():
                t[k][0] += cuda_ms(torch, fn, reps=5)
                t[k][1] += moved[k]
            del meta, planes, out, e_in, runs
        shapes = ", ".join(f"B={p['blocks']}/{p['words'].shape[0]} "
                           f"NP={p['NP']} NS={p['ns']}" for p in plans)
        for k, (kms, nbytes) in t.items():
            print(f"kernel {k} at N={API_N} [{c}]: {kms:.4f} ms, bound "
                  f"{nbytes / HBM_BYTES_PER_MS:.4f} ms over {len(plans)} "
                  f"plan(s) of the first {B} blocks ({shapes}; equal to its "
                  f"twin; {card})", flush=True)
        del plans, stream, back, fed, parts, got
    print(f"api phase: compress, decompress, HuffmanFile, "
          f"HuffmanDecompressor and resume at blocksize {API_N} exact on "
          f"both corpora; K1-K7 equal their twins at N={API_N}", flush=True)


def sweep_phase(torch, m, streams, launches, errs, card, pool):
    """encode and decode at the blocksizes of SWEEP, wire-equal to the host
    codec and equal to the input and the host route; at each blocksize
    whose encode launched K1-K3 and K7, those kernels on one batch of the input
    in the shape encode gave them, and at each whose decode launched K5,
    K6 and K4, those kernels on every device plan of the stream, each
    equal to its twin."""
    refs = {(c, bs): pool.map(m.hostref.encode, pieces, [bs] * len(pieces))
            for c in CORPORA for bs, n in SWEEP
            for pieces in [reference_pieces(streams[c][:n], bs)]}
    for c in CORPORA:
        for bs, n in SWEEP:
            data = streams[c][:n]
            m.enc.COUNTS["host_reencoded_blocks"] = 0
            stream, t_enc, used_e = counted(
                torch, m.kernels, lambda: m.enc.encode(data, bs))
            reset_counts(m.dec)
            back, t_dec, used_d = counted(
                torch, m.kernels, lambda: m.dec.decode(stream))
            counts = dict(m.dec.COUNTS)
            host = m.dec.decode(stream, use_device=False)
            add_launches(launches, used_e)
            add_launches(launches, used_d)
            enc_used = {k: used_e[k] for k in ENCODE_KERNELS}
            dec_used = {k: used_d[k] for k in DECODE_KERNELS}
            check(stream == b"".join(refs[c, bs]),
                  f"{c}: encode at blocksize {bs} differs from hostref")
            check(back == data and host == data, f"{c}: decode at blocksize "
                  f"{bs}: device route equal to the input {back == data}, "
                  f"host route {host == data}")
            if bs >= 17:
                check(all(enc_used.values()), f"{c}: blocksize {bs}: an "
                      f"encode kernel was not launched: {enc_used}")
            if bs >= 1024:
                check(all(dec_used.values()), f"{c}: blocksize {bs}: a "
                      f"decode kernel was not launched: {dec_used}")
            held = []
            if all(enc_used.values()):
                # The shape encode gave the kernels: B blocks of bs bytes,
                # or at 0 one block of the whole input; the last row ragged
                # where a block holds more than 1 byte.
                n_blk = bs or len(data)
                rows = min(B, len(data) // n_blk)
                blocks, nv = kernel_batch(
                    torch, data, last_row=max(1, 2 * n_blk // 3), n=n_blk,
                    rows=rows)
                e, _outs = encode_against_twins(
                    torch, m.kernels, blocks, nv, m.enc._pack_params(n_blk))
                for k, v in e.items():
                    errs[k] = max(errs[k], v)
                check(not any(e.values()), f"{c}: at N={n_blk} an encode "
                      f"kernel disagrees with its twin (max |err| {e})")
                held.append(f"K1-K3 and K7 on a {rows}x{n_blk} batch")
                del blocks, nv, _outs
            if all(dec_used.values()):
                plans, _n_out = device_plans(torch, m.dec, stream)
                for p in plans:
                    e, *_outs = against_twins(torch, m.kernels, p)
                    for k, v in e.items():
                        errs[k] = max(errs[k], v)
                    check(not any(e.values()), f"{c}: at blocksize {bs} a "
                          f"decode kernel disagrees with its twin (max "
                          f"|err| {e})")
                    del _outs
                held.append(f"K5, K6 and K4 on {len(plans)} plan(s)")
                del plans
            print(f"sweep [{c}] blocksize {bs}: {n} B -> {len(stream)} B, "
                  f"wire-equal to hostref; encode {t_enc:.3f} s, launches "
                  f"{enc_used}, host re-encoded "
                  f"{m.enc.COUNTS['host_reencoded_blocks']}; decode "
                  f"{t_dec:.3f} s, launches {dec_used}, blocks {counts}; "
                  f"equal to the input and the host route; "
                  f"{' and '.join(held) or 'no kernel'} equal to the twins "
                  f"({card})", flush=True)
    print("sweep: blocksizes " + ", ".join(str(bs) for bs, _n in SWEEP)
          + " wire- and byte-exact on both corpora", flush=True)


def mesh_against_twins(torch, m, data: bytes, stream: bytes, k: int,
                       errs: dict) -> str:
    """K1-K3 and K7 on every row slice that the encode of ``data`` over a
    mesh of ``k`` devices gives them, and K5, K6 and K4 on every row slice
    of the plans that the decode of ``stream`` over it gives them, each
    against its twin; the errors fold into ``errs``.  Returns what was
    held."""
    import numpy as np

    W = m.enc._pack_params(N)
    enc_shapes = []
    for batch, n_valid in m.enc._batches(
            np.frombuffer(data, np.uint8), N,
            m.config.EncodeConfig().batch_blocks, k):
        per = len(batch) // k
        for i in range(k):
            rows = slice(i * per, (i + 1) * per)
            blocks, nv = (m.parallel.shard.tensor_on(a[rows], "cuda")
                          for a in (batch, n_valid))
            e, _outs = encode_against_twins(torch, m.kernels, blocks, nv, W)
            for n, v in e.items():
                errs[n] = max(errs[n], v)
            check(not any(e.values()), f"over {k} devices an encode kernel "
                  f"disagrees with its twin on a {per}x{N} slice "
                  f"(max |err| {e})")
            enc_shapes.append(f"{per}x{N} ({int((n_valid[rows] > 0).sum())} "
                              f"blocks)")
            del blocks, nv, _outs
    plans, _n_out = m.dec.build_device_plans(stream, lane_mult=k)
    dec_shapes = []
    for p in plans:
        per = len(p.words) // k
        for i in range(k):
            rows = slice(i * per, (i + 1) * per)
            on_card = {n: m.parallel.shard.tensor_on(a[rows], "cuda")
                       for n, a in (("words", p.words), ("tables", p.tables),
                                    ("caps", p.caps))}
            on_card.update(NP=p.NP, OUTW=p.OUTW, ns=p.ns)
            e, *_outs = against_twins(torch, m.kernels, on_card)
            for n, v in e.items():
                errs[n] = max(errs[n], v)
            check(not any(e.values()), f"over {k} devices a decode kernel "
                  f"disagrees with its twin on a {per}-row slice of a "
                  f"{len(p.words)}-row plan (max |err| {e})")
            dec_shapes.append(per)
            del on_card, _outs
    return (f"K1-K3 and K7 on {len(enc_shapes)} slices "
            f"({', '.join(enc_shapes)}), "
            f"K5, K6 and K4 on {len(dec_shapes)} slices of {len(plans)} "
            f"plans ({min(dec_shapes)}-{max(dec_shapes)} rows each)")


def parallel_phase(torch, m, streams, singles, refs, launches, errs, card,
                   device: str = "cuda:0"):
    """The block-parallel layer in one process: ``block_mesh()`` of the
    machine, then each corpus encoded and decoded with ``device`` listed
    MESH_SPLITS times in a mesh, then ``encode_sharded`` and
    ``decode_blocks_sharded`` over two slices against the unsharded
    stages.  Every kernel is held against its twin on the row slices the
    mesh gives it.  ``singles`` are the slice's single-device streams,
    ``refs`` the host codec's encodings of their first B blocks."""
    EncodeConfig, DecodeConfig = m.config.EncodeConfig, m.config.DecodeConfig
    mesh = m.parallel.block_mesh()
    check(mesh.size == torch.cuda.device_count(),
          f"block_mesh() holds {mesh.size} devices, the machine "
          f"{torch.cuda.device_count()}")
    for c in CORPORA:
        data = streams[c][:KERNEL_BYTES]
        got = m.enc.encode(data, config=EncodeConfig(blocksize=N, mesh=mesh))
        check(got == refs[c], f"{c}: encode over block_mesh() differs from "
              f"hostref on the first {B} blocks")
        check(m.dec.decode(got, config=DecodeConfig(mesh=mesh)) == data,
              f"{c}: decode over block_mesh() did not return the input")
    print(f"parallel block_mesh(): {mesh.size} device(s) "
          f"{[str(d) for d in mesh.devices]}; encode of the first {B} blocks "
          f"of each corpus equal to hostref, decode equal to the input "
          f"({card})", flush=True)

    for k in MESH_SPLITS:
        mesh = m.parallel.block_mesh([device] * k)
        for c in CORPORA:
            data = streams[c]
            m.enc.COUNTS["host_reencoded_blocks"] = 0
            stream, t_enc, used_e = counted(torch, m.kernels, lambda: (
                m.enc.encode(data, config=EncodeConfig(blocksize=N,
                                                       mesh=mesh))))
            add_launches(launches, used_e)
            check(stream == singles[c], f"{c}: the encode over {k} x "
                  f"{device} differs from the single-device stream")
            check(stream[: len(refs[c])] == refs[c], f"{c}: the encode over "
                  f"{k} x {device} differs from hostref on the first {B} "
                  f"blocks")
            check(all(used_e[n] > 0 for n in ENCODE_KERNELS),
                  f"{c}: a kernel was not launched by the encode over {k} x "
                  f"{device}: {used_e}")
            check(m.enc.COUNTS["host_reencoded_blocks"] == 0,
                  f"{c}: blocks re-encoded on the host: {m.enc.COUNTS}")
            reset_counts(m.dec)
            back, t_dec, used_d = counted(torch, m.kernels, lambda: (
                m.dec.decode(stream, config=DecodeConfig(mesh=mesh))))
            add_launches(launches, used_d)
            counts = dict(m.dec.COUNTS)
            check(back == data, f"{c}: the decode over {k} x {device} did "
                  f"not return the input")
            check(all(used_d[n] > 0 for n in DECODE_KERNELS),
                  f"{c}: a kernel was not launched by the decode over {k} x "
                  f"{device}: {used_d}")
            check(counts["host_decoded_blocks"]
                  <= HOST_SHARE_MAX * sum(counts.values()),
                  f"{c}: the decode over {k} x {device} walked too many "
                  f"blocks on the host: {counts}")
            bad = refs[c][:-1]
            d = outcome(lambda: m.dec.decode(bad, config=DecodeConfig(
                mesh=mesh)))
            h = outcome(lambda: m.dec.decode(bad, use_device=False))
            check(d == h and d != "no error", f"{c}: truncated stream over "
                  f"{k} x {device}: {d}, host route {h}")
            held = mesh_against_twins(torch, m, data, stream, k, errs)
            print(f"parallel mesh {k} x {device} [{c}]: encode "
                  f"{len(data) / t_enc / 1e9:.4f} GB/s ({t_enc:.3f} s; "
                  f"launches { {n: used_e[n] for n in ENCODE_KERNELS} }; "
                  f"wire-equal to the single-device stream and to hostref on "
                  f"the first {B} blocks); decode "
                  f"{len(back) / t_dec / 1e9:.4f} GB/s ({t_dec:.3f} s; "
                  f"launches { {n: used_d[n] for n in DECODE_KERNELS} }; "
                  f"blocks {counts}; equal to the input); truncated stream: "
                  f"{d} on both routes; {held} equal to their twins "
                  f"({card})", flush=True)
            del stream, back

    # The sharded stages against the unsharded ones on the kernel phase's
    # batch and on the plans of its encoded prefix, exactly.
    mesh = m.parallel.block_mesh([device] * 2)
    W = m.enc._pack_params(N)
    err = {"encode_sharded": 0, "decode_blocks_sharded": 0}
    for c in CORPORA:
        blocks, nv = kernel_batch(torch, streams[c])
        want = m.dev.encode_blocks(blocks, nv, W)
        got = m.parallel.encode_sharded(blocks.cpu().numpy(),
                                        nv.cpu().numpy(), mesh,
                                        words_per_block=W)
        err["encode_sharded"] = max(
            err["encode_sharded"],
            *(max_abs_err(torch.from_numpy(g), w.cpu())
              for g, w in zip(got, want)))
        del blocks, nv, want, got
        plans, _n_out = m.dec.build_device_plans(refs[c])
        for p in plans:
            want = m.tops.decode_blocks(
                *m.dec.plan_tensors(p, torch.device(device)), p.NP, p.OUTW,
                p.ns)
            got = m.parallel.decode_blocks_sharded(
                p.words, p.tables, p.n_sym, p.caps, p.NP, p.OUTW, p.ns, mesh)
            err["decode_blocks_sharded"] = max(
                err["decode_blocks_sharded"],
                *(max_abs_err(torch.from_numpy(g), w.cpu())
                  for g, w in zip(got, want)))
            del want, got
        check(not any(err.values()), f"{c}: a sharded stage disagrees with "
              f"the unsharded one over 2 x {device} (max |err| {err})")
        print(f"parallel stages [{c}]: encode_sharded on the {B}x{N} batch "
              f"and decode_blocks_sharded on {len(plans)} plan(s) of its "
              f"encoding over 2 x {device} equal encode_blocks and "
              f"decode_blocks (max |err| {err}) ({card})", flush=True)
        del plans


def two_process_phase(data: bytes, single: bytes, card,
                      device: str = "cuda:0") -> None:
    """Two worker processes (tests/torch_multihost_worker.py, run by path)
    on ``device``, rendezvoused over gloo, encode and decode ``data`` at
    blocksize N: each rank's stream must be ``single`` (its sha256), the
    sizes-only segments must lie at their offsets, the decode must return
    the input on both ranks, and the bytes exchanged must stay within the
    sizes-only bounds."""
    import hashlib

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = os.path.join(tmp, "input.bin")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_multihost_worker.py"),
             f"file://{tmp}/rendezvous", "2", str(pid), tmp, device, path,
             str(N)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(2)]
        try:
            outs = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
        except subprocess.TimeoutExpired as e:
            raise CheckFailed(f"a two-process worker ran past "
                              f"{WORKER_TIMEOUT} s") from e
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for pid, (p, (_out, err)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"two-process worker {pid} exited "
                  f"{p.returncode}: {err[-2000:]}")
        results = [json.loads(pathlib.Path(tmp, f"out_{pid}.json").read_text())
                   for pid in range(2)]
    sha = hashlib.sha256(single).hexdigest()
    for pid, r in enumerate(results):
        n = r["n_candidates"]
        # The offset broadcast (two sizes and 8 B per candidate from each
        # rank) and the tables (two sizes and 24 B per candidate of the
        # larger rank's share from each rank).
        bound = 16 + 16 * n + 16 + 2 * 24 * -(-n // 2)
        check(r["stream_sha"] == sha and r["stream_len"] == len(single),
              f"rank {pid}: the two-process stream differs from the "
              f"single-process one")
        check(r["seg_ok"] and r["seg_len"] > 0, f"rank {pid}: the sizes-only "
              f"segment does not lie at its offset")
        check(r["plain_ok"] and r["dseg_ok"] and r["dseg_len"] > 0,
              f"rank {pid}: the two-process decode did not return the input")
        check(r["dcn_sizes_only"] <= 64, f"rank {pid}: the sizes-only encode "
              f"exchanged {r['dcn_sizes_only']} B")
        check(r["dcn_decode_local"] <= bound, f"rank {pid}: the sizes-only "
              f"decode exchanged {r['dcn_decode_local']} B, over {bound}")
        walls = ", ".join(f"{k} {v:.3f} s ({len(data) / v / 1e9:.4f} GB/s)"
                          for k, v in r["walls"].items())
        print(f"two processes rank {pid} on {device}: stream sha256 equal to "
              f"the single-process stream's, segment of {r['seg_len']} B at "
              f"its offset, decode equal to the input (segment of "
              f"{r['dseg_len']} B); exchanged {r['dcn_sizes_only']} B for the "
              f"sizes-only encode, {r['dcn_decode_local']} B for the "
              f"sizes-only decode ({n} candidates, bound {bound} B); walls "
              f"{walls} ({card})", flush=True)
    print(f"two-process phase: {wall:.1f} s for both workers, start-up "
          f"(interpreter, torch, kernel library) and the gloo rendezvous "
          f"included ({card})", flush=True)


def add_launches(total: dict, used: dict) -> None:
    for k, v in used.items():
        total[k] += v


def reset_counts(dec) -> None:
    for k in dec.COUNTS:
        dec.COUNTS[k] = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from libhuffman_tpu_torch import api, config, parallel, resume
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
        e, outs = encode_against_twins(torch, kernels, blocks, nv, W)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        freqs, codes, lens, C, L, payload = (
            outs[k] for k in ("freqs", "codes", "lens", "C", "L", "payload"))
        del outs
        check(int(freqs[:-1, :256].sum()) == (B - 1) * N
              and int(freqs[-1].sum()) == RAGGED,
              f"{c}: histogram totals")
        runs = {
            "histogram": (lambda: kernels.histogram(blocks, nv),
                          lambda: kernels.histogram_plain(blocks, nv)),
            "trees": (lambda: kernels.trees(freqs, N),
                      lambda: kernels.trees_plain(freqs)),
            "symbol_layout": (
                lambda: kernels.symbol_layout(blocks, codes, lens, nv),
                lambda: kernels.symbol_layout_plain(blocks, codes, lens, nv)),
            "pack": (lambda: kernels.pack(C, L, W),
                     lambda: kernels.pack_plain(C, L, W)),
        }
        for k, v in encode_bound_bytes(N, W).items():
            bound_bytes[k].append(v)
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
        del blocks, nv, freqs, codes, lens, C, L, payload
        del idx, table, gidx, library
    for k in ENCODE_KERNELS:
        check(errs[k] == 0,
              f"kernel {k} disagrees with its twin (max |err| {errs[k]})")
    print("kernel phase: K1, K7, K2 and K3 equal their twins exactly on both "
          "corpora", flush=True)
    one_row_ms = trees_phase(torch, kernels, util, streams, errs, card)

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
    singles, refs = {}, {}
    for c in CORPORA:
        data = streams[c]
        enc.COUNTS["host_reencoded_blocks"] = 0
        stream, wall, used = counted(torch, kernels,
                                     lambda: enc.encode(data, N))
        add_launches(launches, used)
        used = {k: used[k] for k in ENCODE_KERNELS}
        check(all(v > 0 for v in used.values()),
              f"{c}: a kernel was not launched by the encode run: {used}")
        check(enc.COUNTS["host_reencoded_blocks"] == 0,
              f"{c}: blocks re-encoded on the host: {enc.COUNTS}")
        ref = refs[c] = hostref.encode(data[:KERNEL_BYTES], N)
        singles[c] = stream
        check(stream[: len(ref)] == ref,
              f"{c}: wire bytes of the first {B} blocks differ from hostref")
        print(f"slice encode [{c}]: {len(data)} B -> {len(stream)} B (ratio "
              f"{len(stream) / len(data):.4f}); encode end to end "
              f"{len(data) / wall / 1e9:.4f} GB/s ({wall:.3f} s); launches "
              f"{used}; host re-encoded 0; first {B} blocks wire-equal to "
              f"hostref ({card})", flush=True)

        blocks, nv = kernel_batch(torch, data, last_row=N)
        resident_encode(torch, dev, kernels, blocks, nv, W,
                        f"device-resident encode [{c}]", card)
        del blocks, nv

        # Decode: the device route (the default), then the host route.
        reset_counts(dec)
        back, wall, used = counted(torch, kernels, lambda: dec.decode(stream))
        add_launches(launches, used)
        used = {k: used[k] for k in DECODE_KERNELS}
        counts = dict(dec.COUNTS)
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

    # ---- the API at 128 KiB blocks, and the blocksize sweep -------------
    m = types.SimpleNamespace(api=api, config=config, dec=dec, dev=dev,
                              enc=enc, hostref=hostref, kernels=kernels,
                              parallel=parallel, resume=resume, tops=tops)
    # The host codec's reference encodings are made by worker processes
    # (numpy only; no torch, no card) while the card works.
    pool = ProcessPoolExecutor(max(1, min(7, (os.cpu_count() or 2) - 1)),
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        t0 = time.perf_counter()
        api_phase(torch, m, streams, launches, errs, card, pool)
        print(f"api phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        sweep_phase(torch, m, streams, launches, errs, card, pool)
        print(f"sweep phase: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    t0 = time.perf_counter()
    parallel_phase(torch, m, streams, singles, refs, launches, errs, card)
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s", flush=True)
    two_process_phase(streams["text"], singles["text"], card)

    sources = {"histogram": "histogram.cu", "trees": "trees.cu",
               "symbol_layout": "layout.cu",
               "pack": "pack.cu", "resolve": "resolve.cu",
               "chain": "chain.cu", "emit": "emit.cu"}
    replaces = {"histogram": "libhuffman_tpu/ops/device.py:145",
                "trees": "none (libhuffman_tpu/ops/device.py:187 and :264 "
                         "build their trees in XLA)",
                "symbol_layout": "libhuffman_tpu/ops/device.py:360",
                "pack": "libhuffman_tpu/ops/concat_kernel.py:274",
                "resolve": "libhuffman_tpu/ops/decode_v3.py:212",
                "chain": "libhuffman_tpu/ops/decode_v3.py:331",
                "emit": "libhuffman_tpu/ops/concat_kernel.py:340"}
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s, the kernels' "
          f"build included ({card})", flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"libhuffman_tpu_torch/csrc/{sources[k]}",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": statistics.median(ms[k]),
         "plain_ms": statistics.median(plain_ms[k]),
         "bound_ms": statistics.median(bound_bytes[k]) / HBM_BYTES_PER_MS,
         # K7 is bound by its round chain: one row's time on the card.
         "bound_by": "bytes" if k != "trees" else "latency",
         **({"one_row_ms": one_row_ms} if k == "trees" else {}),
         # K1: torch.bincount, K2: torch.gather (see the kernel phase); no
         # single PyTorch call computes the other five.
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
