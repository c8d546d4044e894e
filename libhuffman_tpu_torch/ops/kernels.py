"""Wrappers of the CUDA kernels, and their plain-torch twins.

Each wrapper checks its inputs (device, dtype, shape, contiguity) and then
takes one of two routes, chosen by where the tensors lie and nothing else:

  * a CUDA tensor: the hand-written kernel of ``csrc/`` (built on first use
    by :mod:`._build`) is launched on the current stream without a
    synchronize, and the wrapper's entry in :data:`LAUNCHES` goes up by one;
  * a CPU tensor: the kernel's plain-torch twin below, which has the same
    contract.  The CPU tests hold the twins against the JAX package's Pallas
    kernels, and ``chip_smoke.py`` holds each kernel against its twin.

A failing launch raises; there is no fallback from a CUDA tensor to a twin.

32-bit codewords and words are carried in int32 tensors as their bit
pattern (torch on the CPU has no shifts or compares for uint32); the twins
widen them to int64 where they do arithmetic.

  kernel          replaces (libhuffman_tpu)                     source
  histogram       ops/device.py:145 histogram_pallas            csrc/histogram.cu
  trees           none (ops/device.py:187 and :264, in XLA)     csrc/trees.cu
  symbol_layout   ops/device.py:360 symbol_layout_pallas        csrc/layout.cu
  pack            ops/concat_kernel.py:274 concat_words_ovf     csrc/pack.cu
  resolve         ops/decode_v3.py:212 resolve_blocks           csrc/resolve.cu
  chain           ops/decode_v3.py:331 chain_emit               csrc/chain.cu
  emit            ops/concat_kernel.py:340 concat_groups_ovf    csrc/emit.cu

The decode kernels take and give natural-order, block-major planes: the
TPU's pair-packed, position-major and bit-reversed layouts are not copied.
"""

from __future__ import annotations

import torch

from ..format import ASCII_COUNT, HISTOGRAM_LEN
from ..native import TAB_ROWS
from . import _build

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"histogram": 0, "trees": 0, "symbol_layout": 0, "pack": 0,
            "resolve": 0, "chain": 0, "emit": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------------
# K1 histogram
# --------------------------------------------------------------------------

def histogram(blocks: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Byte counts of each block's first ``n_valid`` bytes.

    blocks (B, N) uint8, n_valid (B,) int32 -> (B, 512) int32; slots
    256..511 are zero (build_trees' internal-node scratch)."""
    if blocks.dim() != 2:
        raise ValueError("blocks must be (B, N)")
    B, N = blocks.shape
    dev = blocks.device
    _check(blocks, "blocks", torch.uint8, (B, N), dev)
    _check(n_valid, "n_valid", torch.int32, (B,), dev)
    if not _on_cuda(blocks):
        return histogram_plain(blocks, n_valid)
    out = torch.empty((B, HISTOGRAM_LEN), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        err = _build.library().huff_histogram(
            blocks.data_ptr(), n_valid.data_ptr(), out.data_ptr(), B, N,
            _stream(dev))
    _build.check(err, "histogram")
    LAUNCHES["histogram"] += 1
    return out


def histogram_plain(blocks: torch.Tensor, n_valid: torch.Tensor
                    ) -> torch.Tensor:
    """Twin of :func:`histogram`: one bincount over row-offset byte values,
    with positions at or past n_valid sent to a discarded extra bin."""
    B, N = blocks.shape
    dev = blocks.device
    pos = torch.arange(N, device=dev)
    rows = torch.arange(B, device=dev)[:, None] * ASCII_COUNT
    idx = torch.where(pos[None, :] < n_valid[:, None].long(),
                      blocks.long() + rows, B * ASCII_COUNT)
    counts = torch.bincount(idx.flatten(), minlength=B * ASCII_COUNT + 1)
    out = torch.zeros((B, HISTOGRAM_LEN), dtype=torch.int32, device=dev)
    out[:, :ASCII_COUNT] = counts[: B * ASCII_COUNT].view(B, ASCII_COUNT)
    return out


# --------------------------------------------------------------------------
# K7 trees
# --------------------------------------------------------------------------

TREES_MAX_N = (1 << 31) - 1  # every rate of a row fits in an int32


def trees(freqs: torch.Tensor, N: int):
    """Each row's Huffman tree and codewords, the reference's tie-break.

    freqs (B, 512) int32 from :func:`histogram` (slots 256..511 zero) of
    blocks of N bytes, so each row sums to at most N; N <= TREES_MAX_N ->
    (left, right (B, 512) int32, root (B,) int32 (-1 for an all-zero row),
    codes (B, 256) int32 (u32 bit pattern of the MSB-first codeword),
    lens (B, 256) int32, overflow (B,) bool (a code over 32 bits, cut
    there), total_bits (B,) int64 = the sum of freq x len).  The twin is
    ``ops/device.build_trees`` and ``extract_codes``; the kernel runs every
    row's rounds to its own end and reads nothing back to the host."""
    if freqs.dim() != 2:
        raise ValueError("freqs must be (B, 512)")
    B = freqs.shape[0]
    dev = freqs.device
    _check(freqs, "freqs", torch.int32, (B, HISTOGRAM_LEN), dev)
    if not 0 <= N <= TREES_MAX_N:
        raise ValueError(f"N must be in [0, {TREES_MAX_N}], got {N}")
    if not _on_cuda(freqs):
        return trees_plain(freqs)
    i32 = torch.int32
    left = torch.empty((B, HISTOGRAM_LEN), dtype=i32, device=dev)
    right = torch.empty((B, HISTOGRAM_LEN), dtype=i32, device=dev)
    root = torch.empty((B,), dtype=i32, device=dev)
    codes = torch.empty((B, ASCII_COUNT), dtype=i32, device=dev)
    lens = torch.empty((B, ASCII_COUNT), dtype=i32, device=dev)
    ovf = torch.empty((B,), dtype=torch.bool, device=dev)
    total_bits = torch.empty((B,), dtype=torch.int64, device=dev)
    out = (left, right, root, codes, lens, ovf, total_bits)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        err = _build.library().huff_trees(
            freqs.data_ptr(), *(t.data_ptr() for t in out), B, _stream(dev))
    _build.check(err, "trees")
    LAUNCHES["trees"] += 1
    return out


def trees_plain(freqs: torch.Tensor):
    """Twin of :func:`trees`: the merge rounds and the walk in plain torch
    (``ops/device.build_trees``, ``extract_codes``)."""
    from .device import build_trees, extract_codes  # device imports us

    left, right, parent, pbit, root = build_trees(freqs)
    codes, lens, ovf = extract_codes(parent, pbit)
    total_bits = (freqs[:, :ASCII_COUNT].long() * lens.long()).sum(dim=1)
    return left, right, root, _as_i32(codes), lens, ovf, total_bits


# --------------------------------------------------------------------------
# K2 symbol layout
# --------------------------------------------------------------------------

def symbol_layout(blocks: torch.Tensor, codes: torch.Tensor,
                  lens: torch.Tensor, n_valid: torch.Tensor):
    """Each byte's codeword and length from its block's tables.

    blocks (B, N) uint8, codes (B, 256) int32 (u32 bit pattern of the
    right-aligned codeword), lens (B, 256) int32, n_valid (B,) int32 ->
    C (B, N) int32 = codes[blocks], L (B, N) int32 = lens[blocks] before
    n_valid and 0 from there on."""
    if blocks.dim() != 2:
        raise ValueError("blocks must be (B, N)")
    B, N = blocks.shape
    dev = blocks.device
    _check(blocks, "blocks", torch.uint8, (B, N), dev)
    _check(codes, "codes", torch.int32, (B, ASCII_COUNT), dev)
    _check(lens, "lens", torch.int32, (B, ASCII_COUNT), dev)
    _check(n_valid, "n_valid", torch.int32, (B,), dev)
    if not _on_cuda(blocks):
        return symbol_layout_plain(blocks, codes, lens, n_valid)
    C = torch.empty((B, N), dtype=torch.int32, device=dev)
    L = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return C, L
    with torch.cuda.device(dev):
        err = _build.library().huff_layout(
            blocks.data_ptr(), codes.data_ptr(), lens.data_ptr(),
            n_valid.data_ptr(), C.data_ptr(), L.data_ptr(), B, N,
            _stream(dev))
    _build.check(err, "symbol_layout")
    LAUNCHES["symbol_layout"] += 1
    return C, L


def symbol_layout_plain(blocks: torch.Tensor, codes: torch.Tensor,
                        lens: torch.Tensor, n_valid: torch.Tensor):
    """Twin of :func:`symbol_layout`: two row gathers and a mask."""
    N = blocks.shape[1]
    idx = blocks.long()
    C = torch.gather(codes, 1, idx)
    L = torch.gather(lens, 1, idx)
    pos = torch.arange(N, device=blocks.device)
    L = torch.where(pos[None, :] < n_valid[:, None].long(), L, 0)
    return C, L


# --------------------------------------------------------------------------
# K3 pack
# --------------------------------------------------------------------------

def pack(C: torch.Tensor, L: torch.Tensor, W: int):
    """MSB-first concatenation of each row's codewords into its payload.

    C (B, N) int32 (u32 bit pattern, right-aligned, no bits at or above the
    length), L (B, N) int32 lengths in [0, 32], W words ->
    (payload (B, 4W) uint8: the first W big-endian words of the
    concatenation, zero-filled; overflow (B,) bool: total bits > 32 W,
    whose content past word W is dropped).  N < 2^26.  The kernel writes
    every output byte."""
    if C.dim() != 2:
        raise ValueError("C must be (B, N)")
    B, N = C.shape
    dev = C.device
    _check(C, "C", torch.int32, (B, N), dev)
    _check(L, "L", torch.int32, (B, N), dev)
    if W <= 0:
        raise ValueError("W must be positive")
    if not _on_cuda(C):
        return pack_plain(C, L, W)
    payload = torch.empty((B, 4 * W), dtype=torch.uint8, device=dev)
    ovf = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return payload, ovf
    with torch.cuda.device(dev):
        err = _build.library().huff_pack(
            C.data_ptr(), L.data_ptr(), payload.data_ptr(), ovf.data_ptr(),
            B, N, W, _stream(dev))
    _build.check(err, "pack")
    LAUNCHES["pack"] += 1
    return payload, ovf


_M32 = 0xFFFFFFFF


def pack_plain(C: torch.Tensor, L: torch.Tensor, W: int):
    """Twin of :func:`pack`: a cumsum gives each code its bit offset, and
    the code's one or two word pieces are scatter-added into int64 words
    (the pieces of different codes cover disjoint bits, so the sum is the
    OR)."""
    B, N = C.shape
    dev = C.device
    c = C.long() & _M32
    ln = L.long()
    end = torch.cumsum(ln, dim=1)
    off = end - ln
    total = end[:, -1] if N else torch.zeros(B, dtype=torch.int64, device=dev)
    w = off >> 5
    # s: left shift that puts the code's last bit at its place in word w;
    # s < 0 means the code runs -s bits into word w + 1.
    s = 32 - (off & 31) - ln
    live = ln > 0
    hi = torch.where(s >= 0, c << s.clamp(min=0), c >> (-s).clamp(min=0))
    lo = (c << (32 + s).clamp(0, 31)) & _M32
    hi = torch.where(live, hi, 0)
    lo = torch.where(live & (s < 0), lo, 0)
    words = torch.zeros((B, W + 1), dtype=torch.int64, device=dev)
    # Column W collects (and discards) every piece past the budget.
    words.scatter_add_(1, w.clamp(max=W), hi)
    words.scatter_add_(1, (w + 1).clamp(max=W), lo)
    words = words[:, :W]
    payload = torch.stack(
        [(words >> 24) & 255, (words >> 16) & 255, (words >> 8) & 255,
         words & 255], dim=-1).to(torch.uint8).reshape(B, 4 * W)
    return payload, total > 32 * W


# --------------------------------------------------------------------------
# K5 resolve
# --------------------------------------------------------------------------

MAX_NS = 5          # lookup stages past LUT10: codes up to 10 + 3 * 5 bits
_DONE = 1 << 15     # terminal-entry flag of a table entry


def resolve(words: torch.Tensor, tables: torch.Tensor, NS: int
            ) -> torch.Tensor:
    """The codeword that starts at every bit position of every block.

    words (B, W + 128) int32: each block's payload as big-endian u32 words
    (bit pattern), zero-padded (a window reads one word ahead); tables
    (B, 13, 128) int32: the native resolve tables; NS in [0, 5]: lookup
    stages past LUT10 ->
    meta (B, 32 W) int16: the u16 entry of position p at [b, p],
    DONE(15) | aux(13:6) | len(5:0); len 0 marks a dead position whose aux
    is the fail offset, else aux is the decoded symbol."""
    if words.dim() != 2 or words.shape[1] <= 128:
        raise ValueError("words must be (B, W + 128) with W >= 1")
    B, Wp = words.shape
    W = Wp - 128
    dev = words.device
    _check(words, "words", torch.int32, (B, Wp), dev)
    _check(tables, "tables", torch.int32, (B, TAB_ROWS, 128), dev)
    if not 0 <= NS <= MAX_NS:
        raise ValueError(f"NS must be in [0, {MAX_NS}], got {NS}")
    if not _on_cuda(words):
        return resolve_plain(words, tables, NS)
    meta = torch.empty((B, 32 * W), dtype=torch.int16, device=dev)
    if B == 0:
        return meta
    with torch.cuda.device(dev):
        err = _build.library().huff_resolve(
            words.data_ptr(), tables.data_ptr(), meta.data_ptr(), B, W, NS,
            _stream(dev))
    _build.check(err, "resolve")
    LAUNCHES["resolve"] += 1
    return meta


def _entry(tab: torch.Tensor, base: int, i: torch.Tensor) -> torch.Tensor:
    """u16 entry i of the packed table region starting at cell ``base``:
    cell base + (i >> 1), half i & 1.  tab (B, 13 * 128) int64."""
    cell = torch.gather(tab, 1, base + (i >> 1))
    return (cell >> ((i & 1) << 4)) & 0xFFFF


def resolve_plain(words: torch.Tensor, tables: torch.Tensor, NS: int
                  ) -> torch.Tensor:
    """Twin of :func:`resolve`: the same lookup cascade with gathers on
    int64, one bit phase s of every word at a time."""
    B, Wp = words.shape
    W = Wp - 128
    w = words.long() & _M32
    # The 64-bit pair (word, next word); the window of position 32 i + s is
    # its bits [32 - s, 64 - s), so no shift ever reaches 32.
    pair = (w[:, :W] << 32) | w[:, 1 : W + 1]
    tab = tables.reshape(B, TAB_ROWS * 128).long() & _M32
    meta = torch.empty((B, W, 32), dtype=torch.int16, device=words.device)
    for s in range(32):
        win = (pair >> (32 - s)) & _M32
        e = _entry(tab, 0, (win >> 22) & 511)
        # Unary-root fold: a leading 1 bit never starts a code, so LUT10 has
        # 512 live entries and the other half is the dead entry DONE.
        e = torch.where((win >> 31) != 0, _DONE, e)
        for k in range(1, NS + 1):
            if k == 1:   # stage 1: 128 states x 3 bits
                ek = _entry(tab, 512, ((e & 127) << 3) | ((win >> 19) & 7))
            elif k == 2:  # tail 1: 64 states
                ek = _entry(tab, 1024, ((e & 63) << 3) | ((win >> 16) & 7))
            else:        # tails 2-4: 32 states
                bits3 = (win >> (16 - 3 * (k - 2))) & 7
                ek = _entry(tab, 1280 + 128 * (k - 3),
                            ((e & 31) << 3) | bits3)
            e = torch.where((e & _DONE) != 0, e, ek)
        meta[:, :, s] = ((e ^ 0x8000) - 0x8000).to(torch.int16)
    return meta.reshape(B, 32 * W)


# --------------------------------------------------------------------------
# K6 chain
# --------------------------------------------------------------------------

def chain(meta: torch.Tensor):
    """Which positions start a codeword, and each 8-position group's symbols.

    meta (B, NP) int16 from :func:`resolve`, NP a multiple of 32.  Position
    0 starts; a start p with len(p) in [1, 31] makes p + len(p) a start;
    len 0 (a dead position) and the unused 32..63 end the chain, which
    otherwise runs on through the zero padding up to NP.  Returns, all
    int32 (u32 bit patterns):
      start (B, NP/32): bit t of word j = position 32 j + t starts;
      gw (B, NP/8): the aux bytes of group g's starts in order, each
        (gw << 8) | aux in u32, then left-aligned by (32 - 8 c) & 31 for the
        group's count c (a dead start's aux byte, its fail offset, counts);
      gc4 (B, NP/32): byte k of word j = count of group 4 j + k;
      gr32 (B, NP/32): starts through stripe j (a running total).
    One call counts one launch, though the kernel runs as three (map,
    compose, write)."""
    if meta.dim() != 2:
        raise ValueError("meta must be (B, NP)")
    B, NP = meta.shape
    dev = meta.device
    _check(meta, "meta", torch.int16, (B, NP), dev)
    if NP == 0 or NP % 32:
        raise ValueError(f"NP must be a positive multiple of 32, got {NP}")
    if not _on_cuda(meta):
        return chain_plain(meta)
    # The kernel writes every word of the four planes.
    start = torch.empty((B, NP // 32), dtype=torch.int32, device=dev)
    gw = torch.empty((B, NP // 8), dtype=torch.int32, device=dev)
    gc4 = torch.empty((B, NP // 32), dtype=torch.int32, device=dev)
    gr32 = torch.empty((B, NP // 32), dtype=torch.int32, device=dev)
    if B == 0:
        return start, gw, gc4, gr32
    lib = _build.library()
    # Each segment's exit map and composed entry (csrc/chain.cu).
    scratch = torch.empty((lib.huff_chain_scratch_words(B, NP),),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.huff_chain(
            meta.data_ptr(), start.data_ptr(), gw.data_ptr(), gc4.data_ptr(),
            gr32.data_ptr(), scratch.data_ptr(), B, NP, _stream(dev))
    _build.check(err, "chain")
    LAUNCHES["chain"] += 1
    return start, gw, gc4, gr32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit pattern."""
    return (((x & _M32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def chain_plain(meta: torch.Tensor):
    """Twin of :func:`chain`: the start set by pointer doubling.  With
    J_0(p) = p + len(p) (NP for an end of the chain) and J_{k+1} = J_k o J_k,
    round k adds J_k(S) to S; after log2(NP) + 1 rounds S is the whole orbit
    of position 0."""
    B, NP = meta.shape
    dev = meta.device
    e = meta.long() & 0xFFFF
    ln = e & 63
    pos = torch.arange(NP, device=dev)
    nxt = torch.where((ln >= 1) & (ln <= 31), pos + ln, NP).clamp(max=NP)
    # Column NP is the sink: the end of the chain maps to itself.
    J = torch.cat([nxt, torch.full((B, 1), NP, device=dev)], dim=1)
    S = torch.zeros((B, NP + 1), dtype=torch.bool, device=dev)
    S[:, 0] = True
    for _ in range(NP.bit_length() + 1):
        S = S.scatter(1, torch.where(S, J, NP), S)
        J = torch.gather(J, 1, J)
    S = S[:, :NP]
    sl = S.long()
    start = _as_i32((sl.view(B, NP // 32, 32)
                     << torch.arange(32, device=dev)).sum(-1))
    cnt = sl.view(B, NP // 8, 8).sum(-1)                     # (B, NG)
    # Rank r of each start within its group; in u32 the left-aligned group
    # word holds aux_r at bit 8 (c - 1 - r) + ((32 - 8 c) & 31) where that
    # is below 32 (the (gw << 8) | aux register keeps the last four).
    r = (torch.cumsum(sl.view(B, NP // 8, 8), -1) - 1)
    c = cnt[:, :, None]
    sh = 8 * (c - 1 - r) + ((32 - 8 * c) & 31)
    aux = ((e >> 6) & 255).view(B, NP // 8, 8)
    gw = torch.where(S.view(B, NP // 8, 8) & (sh < 32),
                     aux << sh.clamp(0, 31), 0).sum(-1)
    gc4 = (cnt.view(B, NP // 32, 4)
           << torch.arange(0, 32, 8, device=dev)).sum(-1)
    gr32 = torch.cumsum(sl.view(B, NP // 32, 32).sum(-1), dim=1)
    return start, _as_i32(gw), _as_i32(gc4), gr32.to(torch.int32)


# --------------------------------------------------------------------------
# K4 emit
# --------------------------------------------------------------------------

def emit(gw: torch.Tensor, gc4: torch.Tensor, gr32: torch.Tensor,
         n_cap: torch.Tensor, OUTW: int) -> torch.Tensor:
    """Decoded bytes: each live group's string of count x 8 bits, joined.

    gw (B, NG) int32 left-aligned group words, gc4 (B, NG/4) int32 packed
    counts (byte k of word j = count of group 4 j + k) and gr32 (B, NG/4)
    int32 running totals of those counts, all three from :func:`chain`;
    n_cap (B,) int32 live groups per block; OUTW words ->
    out (B, 4 OUTW) uint8: the strings of groups 0 .. min(n_cap, NG) - 1
    joined in group order, cut at 4 OUTW bytes, zero-filled past their
    total.  Byte i of a group's string is byte i of its word from the top
    for i < 4, and zero past it.  Groups at or past n_cap emit nothing;
    that leaves the offsets of the groups before n_cap, which gr32 gives,
    as they are."""
    if gw.dim() != 2:
        raise ValueError("gw must be (B, NG)")
    B, NG = gw.shape
    dev = gw.device
    if NG == 0 or NG % 4:
        raise ValueError(f"NG must be a positive multiple of 4, got {NG}")
    _check(gw, "gw", torch.int32, (B, NG), dev)
    _check(gc4, "gc4", torch.int32, (B, NG // 4), dev)
    _check(gr32, "gr32", torch.int32, (B, NG // 4), dev)
    _check(n_cap, "n_cap", torch.int32, (B,), dev)
    if OUTW <= 0:
        raise ValueError("OUTW must be positive")
    if not _on_cuda(gw):
        return emit_plain(gw, gc4, gr32, n_cap, OUTW)
    # The kernel writes every output byte.
    out = torch.empty((B, 4 * OUTW), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        err = _build.library().huff_emit(
            gw.data_ptr(), gc4.data_ptr(), gr32.data_ptr(), n_cap.data_ptr(),
            out.data_ptr(), B, NG, OUTW, _stream(dev))
    _build.check(err, "emit")
    LAUNCHES["emit"] += 1
    return out


def emit_plain(gw: torch.Tensor, gc4: torch.Tensor, gr32: torch.Tensor,
               n_cap: torch.Tensor, OUTW: int) -> torch.Tensor:
    """Twin of :func:`emit`: the counts of groups at or past n_cap are
    zeroed, a cumsum gives each group its byte offset (gr32, their running
    total by the contract, is not read), and a scatter places its bytes
    (column 4 OUTW collects and discards what falls past the budget)."""
    B, NG = gw.shape
    dev = gw.device
    cap = 4 * OUTW
    shifts = torch.arange(0, 32, 8, device=dev)
    cnt = ((gc4.long()[:, :, None] >> shifts) & 255).reshape(B, NG)
    g = torch.arange(NG, device=dev)
    cnt = torch.where(g[None, :] < n_cap.long()[:, None], cnt, 0)
    off = torch.cumsum(cnt, dim=1) - cnt
    i = torch.arange(4, device=dev)
    byte = (gw.long()[:, :, None] >> (24 - 8 * i)) & 255      # (B, NG, 4)
    idx = off[:, :, None] + i
    live = (i < cnt[:, :, None]) & (idx < cap)
    out = torch.zeros((B, cap + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, torch.where(live, idx, cap).reshape(B, 4 * NG),
                 byte.to(torch.uint8).reshape(B, 4 * NG))
    return out[:, :cap].contiguous()
