"""Carry the JAX package's inputs and intermediates into the PyTorch port.

Both sides of a comparison compute from the same values: inputs are made
with numpy from a fixed seed, handed to the JAX function as numpy arrays,
and turned into the port's CPU tensors here.  32-bit words cross as their
int32 bit pattern, the port's carrier for u32 (torch on the CPU has no
shifts, compares or gathers for ``torch.uint32``).  ``chain_edge_meta``,
``emit_edge_inputs`` and ``run_words`` with the tables of ``fib_block``
craft the edge cases of the chain, emit and resolve kernels, and
``hist_edge_inputs`` and ``pack_edge_inputs`` those of the histogram and
pack kernels, and ``tree_edge_freqs`` those of the trees kernel, for these
tests and for ``chip_smoke.py``, which loads this file by path.
``one_torch_thread`` is the autouse fixture the port's test modules
import.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's CPU torch ops on one thread, and restore the
    count after it.  The suite runs several pytest workers at once; with
    torch's default of one thread per core in each of them the cores are
    oversubscribed, and the kernels' twins, many small ops each, then run
    tens of times slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def routes(counts: dict) -> dict:
    """The block counts of each route in ``decode.COUNTS``, without its
    byte counters."""
    return {k: counts[k] for k in ("host_decoded_blocks",
                                   "device_decoded_blocks")}


def tensor(a) -> torch.Tensor:
    """numpy array (or anything ``np.asarray`` takes, e.g. a JAX array) ->
    CPU tensor of the same values; uint32 becomes its int32 bit pattern."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def u32(t: torch.Tensor) -> np.ndarray:
    """Tensor of 32-bit words (int32 bit pattern, or int64 in [0, 2^32))
    -> numpy uint32."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return (a & 0xFFFFFFFF).astype(np.uint32)


def be_bytes(words) -> np.ndarray:
    """(B, W) u32 words -> (B, 4W) u8 big-endian payload bytes (the JAX
    package's ``words_to_bytes``)."""
    w = np.asarray(words, dtype=np.uint32)
    return w.astype(">u4").view(np.uint8).reshape(w.shape[0], 4 * w.shape[1])


def left_align(C: np.ndarray, L: np.ndarray) -> np.ndarray:
    """Right-aligned codewords -> the left-aligned ``level0`` strings the
    JAX packer takes (``libhuffman_tpu/ops/device.py:469-471``)."""
    c = np.asarray(C, np.uint64)
    ln = np.asarray(L, np.int64)
    return np.where(ln > 0, (c << (32 - ln).clip(0, 32).astype(np.uint64))
                    & 0xFFFFFFFF, 0).astype(np.uint32)


def batch(rng: np.random.Generator, B: int, N: int, n_valid) -> tuple:
    """(B, N) uint8 blocks + (B,) int32 valid lengths, zero-padded past
    n_valid as encode.encode pads.  Rows alternate text-like skewed
    bytes and uniform bytes."""
    x = np.zeros((B, N), np.uint8)
    for b in range(B):
        if b % 2:
            x[b] = rng.integers(0, 256, N, dtype=np.uint8)
        else:
            x[b] = rng.choice(np.frombuffer(b" etaoinshrdlu\n", np.uint8),
                              N, p=np.arange(14, 0, -1) / 105)
        x[b, n_valid[b]:] = 0
    return x, np.asarray(n_valid, np.int32)


def corpora():
    """bench/corpora.py, loaded by path (the ``bench`` name resolves to
    bench.py at the repo root)."""
    spec = importlib.util.spec_from_file_location(
        "bench_corpora", ROOT / "bench" / "corpora.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fib_freqs(n: int) -> np.ndarray:
    """A (512,) histogram row of the first n Fibonacci numbers: its code
    lengths run up to n (n - 1 merges deep, and the unary root)."""
    counts = [1, 1]
    while len(counts) < n:
        counts.append(counts[-1] + counts[-2])
    f = np.zeros(512, np.int32)
    f[:n] = counts[:n]
    return f


# Crafted histogram rows of the trees kernel, in the order of
# ``tree_edge_freqs``: all 256 symbols at one rate (256 rounds, ties
# everywhere), Fibonacci rows with codes of 22, exactly 32 and (cut, the
# overflow flag set) 33 and 40 bits, five equal rates, one symbol, none.
TREE_EDGES = ("all256", "fib22", "fib32", "fib33", "fib40", "ties",
              "single", "zero")


def tree_edge_freqs() -> np.ndarray:
    """(len(TREE_EDGES), 512) int32 histogram rows, slots 256..511 zero."""
    rows = np.zeros((len(TREE_EDGES), 512), np.int32)
    rows[0, :256] = 7
    for i, n in ((1, 22), (2, 32), (3, 33), (4, 40)):
        rows[i] = fib_freqs(n)
    rows[5, [3, 9, 200, 201, 255]] = 5
    rows[6, 65] = 10
    return rows


def corpus_freqs(nbytes: int) -> np.ndarray:
    """Histogram rows of both corpus families: for each, ``nbytes`` cut
    into 64 KiB blocks and the next ``nbytes`` into 128 KiB blocks."""
    fam = corpora().FAMILIES
    rows = []
    for c in ("text", "mixed"):
        data = np.frombuffer(fam[c](2 * nbytes), np.uint8)
        for part, n in ((data[:nbytes], 1 << 16), (data[nbytes:], 1 << 17)):
            for blk in part.reshape(-1, n):
                rows.append(np.bincount(blk, minlength=512))
    return np.asarray(rows, np.int32)


CHAIN_SEG = 2048  # positions per segment of the chain kernel (csrc/chain.cu)
CHAIN_EDGES = ("random", "dead-first", "dead-last", "len31-last", "len40",
               "ones")


def chain_edge_meta(kind: str, B: int, NP: int, L: int, seed: int = 0):
    """(B, NP) uint16 K5 entries aux(13:6) | len(5:0) for one of the chain
    edges of ``CHAIN_EDGES``, placed at the boundaries of L-position
    segments: uniform random lengths 1-31 (random aux bytes), then, in
    segment 1 (segment 0 when there is one), a dead entry on its first or
    last position, a length 40, or lengths 1 through the whole segment;
    or a length 31 on the last position of every segment.  A run of 31
    1-bit starts before each such position makes every chain reach it (a
    code is at most 31 bits)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 32, (B, NP)).astype(np.uint16)
    aux = rng.integers(0, 256, (B, NP)).astype(np.uint16)
    k = min(1, (NP - 1) // L)
    s, e = k * L, min(NP, (k + 1) * L)

    def reach(p: int) -> None:
        lens[:, max(0, p - 31):p] = 1

    if kind == "dead-first":
        reach(s)
        lens[:, s] = 0
    elif kind == "dead-last":
        reach(e - 1)
        lens[:, e - 1] = 0
    elif kind == "len31-last":
        for p in [*range(L - 1, NP, L), NP - 1]:
            reach(p)
            lens[:, p] = 31
    elif kind == "len40":
        reach((s + e) // 2)
        lens[:, (s + e) // 2] = 40
    elif kind == "ones":
        reach(s)
        lens[:, s:e] = 1
    elif kind != "random":
        raise ValueError(f"unknown chain edge {kind!r}")
    return (aux << 6) | lens


EMIT_TILE = 2048    # groups per CTA of the emit kernel (csrc/emit.cu)
RESOLVE_SPAN = 512  # fewest words per CTA of the resolve kernel (csrc/resolve.cu)
EMIT_EDGES = ("random", "cap0", "cap-mid-cell", "cap-past-end",
              "zero-counts", "truncate", "eights")


def emit_edge_inputs(kind: str, B: int, NG: int, seed: int = 0):
    """The emit kernel's inputs for one of ``EMIT_EDGES``, shaped as the
    chain kernel gives them: (gw (B, NG) uint32, gc4 and gr32 (B, NG/4)
    uint32, n_cap (B,) int32).  Group counts are 0-4 with their aux bytes
    left-aligned in gw and zeros below (5-8 and four aux bytes for
    "eights", the 1-bit starts a crafted stream gives); gr32 holds the
    running totals of the unmasked counts.  n_cap is random in [0, NG]
    ("random", "eights"), 0 ("cap0"), 2 past a count cell just past the
    first tile or mid-row ("cap-mid-cell"), NG + 5 ("cap-past-end"), or NG
    ("zero-counts": every count 0; "truncate": counts 3-4, whose total of
    ~3.5 NG bytes passes the 3 NG of OUTW = 3 NG / 4, which the ~2 NG of
    random rows stay under)."""
    rng = np.random.default_rng(seed)
    lo, hi = {"truncate": (3, 4), "eights": (5, 8),
              "zero-counts": (0, 0)}.get(kind, (0, 4))
    if kind not in EMIT_EDGES:
        raise ValueError(f"unknown emit edge {kind!r}")
    cnt = rng.integers(lo, hi + 1, (B, NG))
    aux = rng.integers(0, 256, (B, NG, 4), dtype=np.uint64)
    i = np.arange(4, dtype=np.uint64)
    kept = np.minimum(cnt, 4)[..., None]
    gw = np.where(i < kept, aux << (24 - 8 * i), 0).sum(-1).astype(np.uint32)
    cells = cnt.reshape(B, NG // 4, 4)
    gc4 = (cells << np.arange(0, 32, 8)).sum(-1).astype(np.uint32)
    gr32 = np.cumsum(cells.sum(-1), axis=1).astype(np.uint32)
    if kind in ("random", "eights"):
        n_cap = rng.integers(0, NG + 1, B)
    elif kind == "cap0":
        n_cap = np.zeros(B)
    elif kind == "cap-mid-cell":
        n_cap = np.full(B, EMIT_TILE + 14 if NG > EMIT_TILE + 16
                        else (NG // 8) * 4 + 2)
    elif kind == "cap-past-end":
        n_cap = np.full(B, NG + 5)
    else:
        n_cap = np.full(B, NG)
    return gw, gc4, gr32, n_cap.astype(np.int32)


def fib_block(n: int = 18) -> bytes:
    """One host-codec block of Fibonacci frequencies over n symbols: a
    caterpillar tree of depth n (the root wrap included), so n = 10 + 3 k
    needs k lookup stages past LUT10 (k in 0..5) and has codes of the last
    stage's full depth, with few live states at every cut."""
    from libhuffman_tpu_torch.ops import hostref

    vals = []
    a, b = 1, 1
    for s in range(n):
        vals += [s] * a
        a, b = b, a + b
    return hostref.encode_block(np.array(vals, np.uint8))


def block_tables(block: bytes):
    """Native resolve tables of one encoded block: (tables (1, 13, 128)
    uint32, NS); NS < 0 where the device does not take the tree."""
    from libhuffman_tpu_torch import native
    from libhuffman_tpu_torch.format import parse_block_header

    tree = np.asarray(parse_block_header(memoryview(block), 0).tree, np.int16)
    tab, ns, _mi, _ma = native.build_decode_tables(
        tree, np.array([0], np.int64), np.array([len(tree)], np.int32))
    return tab, int(ns[0])


def run_words(rng: np.random.Generator, B: int, W: int) -> np.ndarray:
    """(B, W + 128) uint32 payload words, zero-padded past W, whose rows in
    turn hold uniform bits, 97% ones and 3% ones: the long runs take
    windows down a caterpillar tree's deepest codes."""
    p = np.array([0.5, 0.97, 0.03])[np.arange(B) % 3][:, None, None]
    bits = rng.random((B, W, 32)) < p
    words = np.zeros((B, W + 128), np.uint32)
    words[:, :W] = np.packbits(bits, axis=-1).view(">u4")[..., 0]
    return words


HIST_CLUSTER = 2    # CTAs (segments) per block of the histogram kernel
HIST_EDGES = ("random", "nv0", "nv1", "nv17", "nv-segment", "one-byte",
              "all-values")


def hist_segment(N: int) -> int:
    """Bytes per segment of the histogram kernel: N / HIST_CLUSTER rounded
    up to a multiple of 16."""
    return (-(-N // HIST_CLUSTER) + 15) & ~15


def hist_edge_inputs(kind: str, B: int, N: int, seed: int = 0):
    """The histogram kernel's inputs for one of ``HIST_EDGES``: (blocks
    (B, N) uint8, n_valid (B,) int32).  Rows alternate text-like and
    uniform bytes with random n_valid ("random"), every n_valid is 0, 1 or
    17 (at most N), or ("nv-segment") row by row one byte before, at and
    one byte past the kernel's first segment boundary; "one-byte" is all
    spaces and "all-values" each byte value N / 256 times or more, both
    counted in full.  The padding past n_valid holds random bytes, never
    zeros, so a count that reads past n_valid shows."""
    if kind not in HIST_EDGES:
        raise ValueError(f"unknown histogram edge {kind!r}")
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (B, N), dtype=np.uint8)
    nv = np.full(B, N)
    if kind == "random":
        text = np.frombuffer(b" etaoinshrdlu\n", np.uint8)
        x[::2] = rng.choice(text, (len(x[::2]), N),
                            p=np.arange(14, 0, -1) / 105)
        nv = rng.integers(0, N + 1, B)
    elif kind in ("nv0", "nv1", "nv17"):
        nv = np.full(B, min(N, int(kind[2:])))
    elif kind == "nv-segment":
        nv = np.minimum(N, hist_segment(N) + np.arange(B) % 3 - 1)
    elif kind == "one-byte":
        x[:] = ord(" ")
    elif kind == "all-values":
        x[:] = rng.permuted(np.arange(N) % 256, axis=0).astype(np.uint8)
    return x, nv.astype(np.int32)


PACK_CLUSTER = 8    # CTAs (segments) per block of the pack kernel
PACK_TILE = 2048    # codes per tile of one such CTA
PACK_EDGES = ("random", "zeros", "full32", "straddle", "exact", "over1",
              "sparse")


def pack_segment(N: int) -> int:
    """Codes per segment of the pack kernel: N / PACK_CLUSTER rounded up
    to a multiple of 4."""
    return (-(-N // PACK_CLUSTER) + 3) & ~3


def pack_edge_inputs(kind: str, B: int, N: int, W: int, seed: int = 0):
    """The pack kernel's inputs for one of ``PACK_EDGES``: (C (B, N) uint32
    right-aligned random codes, L (B, N) int32 lengths).  Lengths are
    uniform in 0-32 ("random", with 0-8 on odd rows), all 0, all 32,
    1-32 with a 32-bit code on both sides of every segment and tile
    boundary ("straddle"), a row total of exactly 32 W ("exact") or one bit
    more ("over1"), or ("sparse") two codes of 1-3 bits per segment and
    none in segment 2, so that several segments end inside one word."""
    if kind not in PACK_EDGES:
        raise ValueError(f"unknown pack edge {kind!r}")
    rng = np.random.default_rng(seed)
    if kind == "random":
        L = rng.integers(0, 33, (B, N))
        L[1::2] = rng.integers(0, 9, (len(L[1::2]), N))
    elif kind in ("zeros", "full32"):
        L = np.full((B, N), 0 if kind == "zeros" else 32)
    elif kind == "straddle":
        L = rng.integers(1, 33, (B, N))
        seg = pack_segment(N)
        for lo in range(0, N, max(seg, 1)):
            for i in range(lo, min(N, lo + seg), PACK_TILE):
                L[:, max(i - 1, 0):i + 1] = 32
    elif kind in ("exact", "over1"):
        T = 32 * W + (kind == "over1")
        if T > 32 * N:
            raise ValueError(f"{kind}: 32 N = {32 * N} < {T} bits")
        L = np.full((B, N), T // N)
        for row in L:
            row[rng.choice(N, T - row.sum(), replace=False)] += 1
            # Move random amounts between random pairs: the sum stays T.
            p = rng.permutation(N)
            a, b = p[: N // 2], p[N // 2: 2 * (N // 2)]
            d = (rng.random(len(a)) * (np.minimum(row[a], 32 - row[b]) + 1)
                 ).astype(np.int64)
            row[a] -= d
            row[b] += d
    else:  # sparse
        L = np.zeros((B, N), np.int64)
        seg = max(pack_segment(N), 1)
        for k, lo in enumerate(range(0, N, seg)):
            if k != 2:
                n = min(2, min(N, lo + seg) - lo)
                pos = lo + rng.choice(min(N, lo + seg) - lo, n, replace=False)
                L[:, pos] = rng.integers(1, 4, (B, n))
    raw = rng.integers(0, 1 << 32, (B, N), dtype=np.uint64)
    mask = (np.uint64(1) << L.astype(np.uint64)) - np.uint64(1)
    C = (raw & mask).astype(np.uint32)
    return C, L.astype(np.int32)
