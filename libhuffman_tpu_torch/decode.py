"""Whole-stream decode: speculative block discovery + device kernels.

Block boundaries in the libhuffman format are only discoverable by decoding
(the payload length is implicit), which makes the stream a sequential
chain.  The device route breaks the chain speculatively:

  1. One scan finds every *candidate* header (u64 length with zero high
     bytes, tree length in range); true block starts always match, false
     positives only waste speculative work.
  2. The native runtime builds each candidate's resolve tables; eligible
     candidates are batched into plans and decoded on the torch device, or
     with each plan's rows split over the devices of a
     ``parallel.shard.BlockMesh`` (``ops/decode.decode_blocks``: the
     resolve, chain and emission kernels), each yielding its symbols, its
     consumed payload size and its error flags.
  3. The true chain is resolved on the host by following consumed sizes
     from offset 0; a block the device did not decode (a missed candidate,
     a deep or crafted tree, a speculative cap that fell short) is walked
     on the host by the exact sequential decoder, so the result never
     depends on the speculation.  :data:`COUNTS` records both kinds.

:data:`COUNTS`, since the last reset (every key is zeroed alike):

  host_decoded_blocks     blocks the host walked;
  device_decoded_blocks   blocks taken from a device result;
  decode_d2h_bytes        bytes copied back from the devices;
  device_out_bytes        output bytes taken from what was copied back;
  host_walked_bytes       output bytes the host walk produced;
  host_oversized_blocks   walked blocks whose speculative cap passed 2^18
                          bytes of payload;
  host_deep_blocks        walked blocks whose tree the resolve tables
                          cannot hold (1-bit codes, over-capacity state
                          cuts, depth > 25);
  host_capshort_blocks    walked blocks whose tightened cap fell short of
                          the payload they needed;
  host_missed_blocks      walked blocks with no candidate at their offset
                          (or with the device route off).

The four reasons (oversized, deep, capshort, missed) add up to
``host_decoded_blocks``.  The span ``huff.decode.host_walk``, inside
``huff.decode.walk``, covers each block's host walk.

``use_device=False`` walks every block on the host (the native sequential
scanner, or ``ops/hostref`` without a toolchain).

Error semantics mirror src/decoder.c:201-287: the first failing block in
chain order raises; garbage past the last valid block raises
ReadWrite/BtreeOverflow as the reference's outer loop does.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .errors import BtreeCorruptedError, BtreeOverflowError, ReadWriteError
from .format import find_candidate_headers, parse_block_header
from . import native
from .ops import hostref
from .parallel.shard import (BlockMesh, decode_plans_sharded,
                             resolve_device, tensor_on)
from .utils.trace import annotate

# Bit positions per device plan (~32 MiB of payload): the resolve plane of
# a plan takes 2 bytes per position on the device.
_POSITION_BUDGET = 1 << 28

# Bytes a speculative cap reaches past the next candidate header.  A false
# candidate often sits one byte before a true header (a 65536-symbol block
# whose tree has 1025 entries reads as one), and a cap cut there leaves the
# block before it one byte short, so the host would walk it.
_CAP_SLACK = 16

# Blocks and bytes by route, and why the host walked a block (see the
# module docstring).
COUNTS = {"host_decoded_blocks": 0, "device_decoded_blocks": 0,
          "decode_d2h_bytes": 0, "device_out_bytes": 0,
          "host_walked_bytes": 0, "host_oversized_blocks": 0,
          "host_deep_blocks": 0, "host_capshort_blocks": 0,
          "host_missed_blocks": 0}


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@functools.lru_cache(maxsize=1 << 14)
def _p_bucket(n: int) -> int:
    """Payload-byte budget bucket of a device plan: pow2 up to 4096, then
    eight steps per octave (a 50 KB payload pads to 57344, not 65536),
    multiples of 4096 to 64 KiB, of 8192 to 128 KiB, then of 64 KiB."""
    if n <= 4096:
        return _bucket(n, 512)
    step = max(4096, 1 << (max(n - 1, 1).bit_length() - 3))
    p = -(-n // step) * step
    if p > 131072:
        p = -(-p // 65536) * 65536
    elif p > 65536:
        p = -(-p // 8192) * 8192
    return p


def _b_bucket(n: int) -> int:
    """Block-count bucket: pow2 to 128, then multiples of 128."""
    if n <= 128:
        return _bucket(n, 16)
    return -(-n // 128) * 128


@functools.lru_cache(maxsize=1)
def _pad_table() -> np.ndarray:
    """Resolve table of a padding row: every entry dead (DONE, len 0), so
    its chain ends at position 0; its results are never read."""
    e = 1 << 15
    return np.full((native.TAB_ROWS, 128), e | (e << 16), np.uint32)


class _Candidate:
    """A possible block header.  When the chain reaches it, ``error`` (an
    exception class) raises, else ``result`` is taken, else the host walks
    the block and counts it under ``host_reason``, the :data:`COUNTS` key
    of why the device route left it out."""

    __slots__ = ("off", "n_sym", "tree", "payload_off", "avail", "error",
                 "result", "host_reason")

    def __init__(self, off, n_sym, tree, payload_off, avail):
        self.off = off
        self.n_sym = n_sym
        self.tree = tree
        self.payload_off = payload_off
        self.avail = avail  # payload bytes available before stream end
        self.error = None
        self.result = None  # (symbols bytes, consumed payload bytes)
        self.host_reason = None


class _Plan:
    __slots__ = ("words", "tables", "n_sym", "caps", "NP", "OUTW", "ns",
                 "batch")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def _table_inputs(cands):
    """Concatenated wire trees of the candidates for the native table
    build."""
    bufs = np.concatenate([np.asarray(c.tree, np.int16) for c in cands])
    lens = np.array([len(c.tree) for c in cands], np.int32)
    offs = np.concatenate(([0], np.cumsum(lens[:-1], dtype=np.int64)))
    return bufs, offs, lens


def _device_candidates(cands: list[_Candidate]):
    """The candidates the device takes, as (candidate, tables, cap, NS).

    Settles the others that need no decode (no symbols: empty result;
    more symbols than payload bits, or no tree root: an error); the rest
    (crafted or deep trees, oversized blocks) are left to the host walk.
    The resolve tables come from the native runtime; without it this
    raises rather than walking every block on the host unseen."""
    pending = []
    for c in cands:
        if c.n_sym == 0:
            c.result = (b"", 0)
        elif c.n_sym > 8 * c.avail:
            # Each symbol consumes >= 1 bit: guaranteed short read if this
            # block is ever reached (decoder.c:52-56 path).
            c.error = ReadWriteError
        else:
            pending.append(c)
    if not pending:
        return []
    if not native.available():
        raise RuntimeError(
            "device decode needs the native host runtime to build its "
            "resolve tables, and g++ could not build "
            "native/huffman_native.cpp; pass use_device=False for the "
            "host-exact route")
    tables_all, nstages_all, _mindep, maxdep_all = (
        native.build_decode_tables(*_table_inputs(pending)))
    next_off = _next_candidate_offsets(cands)
    eligible = []
    for i, c in enumerate(pending):
        ns = int(nstages_all[i])
        if ns == -2:
            # NULL root with symbols to restore: the reference NULL-derefs;
            # we raise BTREE_CORRUPTED.
            c.error = BtreeCorruptedError
            continue
        if ns < 0:
            # 1-bit codes, over-capacity state cuts, or depth > 25
            # (crafted trees): host walk.
            c.host_reason = "host_deep_blocks"
            continue
        cap = _payload_cap(c, int(maxdep_all[i]), next_off.get(c.off))
        if cap <= (1 << 18):  # oversized single blocks: host walk
            eligible.append((c, tables_all[i], cap, ns))
        else:
            c.host_reason = "host_oversized_blocks"
    return eligible


def _decode_candidates_device(data: np.ndarray, cands: list[_Candidate],
                              mesh: BlockMesh):
    """Speculatively decode the eligible candidates in plans, each plan's
    rows split over the devices of ``mesh``."""
    with annotate("huff.decode.tables"):
        eligible = _device_candidates(cands)
    with annotate("huff.decode.plans"):
        plans = _build_plans(data, eligible, lane_mult=mesh.size)
    with annotate("huff.decode.device"):
        for plan, res in zip(plans, decode_plans_sharded(plans, mesh)):
            COUNTS["decode_d2h_bytes"] += sum(a.nbytes for a in res)
            _apply_plan_results(plan, *res)


def _next_candidate_offsets(cands) -> dict[int, int]:
    """Map candidate offset -> offset of the next candidate."""
    offs = sorted(c.off for c in cands)
    return {offs[i]: offs[i + 1] for i in range(len(offs) - 1)}


def _payload_cap(c: _Candidate, depth: int, next_off: int | None) -> int:
    """Payload byte budget for a speculative block.

    Any cap up to ``avail`` gives the exact result: the device reads only
    real stream bytes below it, and a block that needs more is sent to the
    host-exact walk (_apply_plan_results).  The cap only sizes the plan:
      * every code is <= depth bits: ceil(n_sym * depth / 8);
      * a true block's payload ends at the next true header, and every true
        header is a candidate, so the next *candidate* offset (plus
        _CAP_SLACK for a false candidate just before a true header) bounds
        it unless that candidate is a false positive inside this payload.
    """
    cap = min(c.avail, (c.n_sym * depth + 7) // 8)
    if next_off is not None:
        gap = next_off - c.payload_off
        if gap > 0:
            cap = min(cap, gap + _CAP_SLACK)
    return cap


def _build_plans(data: np.ndarray, eligible, lane_mult: int = 1
                 ) -> list[_Plan]:
    """Shape-homogeneous device plans from the eligible candidates.

    Sorted by (P bucket, stage count, cap).  Within a P bucket, whole
    128-block tiles of each stage count become their own near-equal plans,
    and the leftovers of every stage count pool into one mixed plan (its
    NS is the largest), so no plan is mostly padding rows.  Each plan's
    row count is a multiple of ``lane_mult`` (the mesh size), padded with
    ``_pad_table`` rows."""
    eligible = sorted(eligible, key=lambda e: (_p_bucket(e[2] + 8), e[3], e[2]))
    batches = []
    i = 0
    while i < len(eligible):
        # A plan holds one P bucket only: every staged payload must fit its
        # P bytes, or the chain would run into zero padding and take it
        # for a complete block.
        P = _p_bucket(eligible[i][2] + 8)
        Bmax = max(1, _POSITION_BUDGET // (8 * P))
        j = i
        while j < len(eligible) and _p_bucket(eligible[j][2] + 8) == P:
            j += 1
        Bcap = max(128, (Bmax // 128) * 128) if Bmax > 128 else Bmax
        residue = []
        k = i
        while k < j:
            m = k
            while m < j and eligible[m][3] == eligible[k][3]:
                m += 1
            seg = eligible[k:m]
            pure = (len(seg) // 128) * 128
            if pure:
                nchunks = -(-pure // Bcap)
                csize = -(-pure // nchunks)  # near-equal chunks
                csize = min(-(-csize // 128) * 128, Bcap)
                for s0 in range(0, pure, csize):
                    batches.append((P, seg[s0 : min(s0 + csize, pure)]))
            residue.extend(seg[pure:])
            k = m
        for s0 in range(0, len(residue), Bcap):
            batches.append((P, residue[s0 : s0 + Bcap]))
        i = j

    plans, offsets = [], []
    for P, batch in batches:
        B = -(-_b_bucket(len(batch)) // lane_mult) * lane_mult
        tables = np.tile(_pad_table(), (B, 1, 1))
        n_sym = np.ones(B, np.int32)
        offs = np.full(B, -1, np.int64)
        caps = np.zeros(B, np.int32)
        for b, (c, tab, cap, _ns) in enumerate(batch):
            offs[b] = c.payload_off
            caps[b] = min(cap, P)
            tables[b] = tab
            n_sym[b] = c.n_sym
        plans.append(_Plan(
            words=None, tables=tables, n_sym=n_sym, caps=caps, NP=8 * P,
            OUTW=_bucket(int(n_sym.max()), 512) // 4,
            ns=max(ns for (_c, _t, _cap, ns) in batch), batch=batch))
        offsets.append(offs)

    def stage(plan, offs):
        # One native pass per plan: slice, zero-pad and byteswap each
        # block's payload into the resolve kernel's word rows.
        plan.words = native.stage_plan(data, offs, plan.caps.astype(np.int64),
                                       plan.NP // 32 + 128)

    with ThreadPoolExecutor(native._POOL_WORKERS) as ex:
        list(ex.map(stage, plans, offsets))
    return plans


def plan_tensors(p: _Plan, device: torch.device):
    """A plan's inputs on ``device``: (words, tables, n_sym, caps)."""
    return tuple(tensor_on(a, device)
                 for a in (p.words, p.tables, p.n_sym, p.caps))


def scan_candidates(data, length: int | None = None,
                    limit: int | None = None,
                    offsets=None) -> list[_Candidate] | None:
    """All plausible block-header candidates of a stream, in offset order:
    one header scan plus a parse per candidate.  ``limit`` returns None on
    a raw-offset explosion (crafted streams) before paying the parses.
    ``offsets`` skips the scan and parses the headers at those offsets
    instead (``parallel/multihost.py``'s ranks reuse rank 0's scan)."""
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    if length is None:
        length = len(buf)
    if offsets is not None:
        offs = np.asarray(offsets, np.int64)
    elif native.available():
        offs = native.find_headers(buf[:length])
    else:
        offs = find_candidate_headers(buf[:length])
    if limit is not None and len(offs) > limit:
        return None
    mv = memoryview(buf)
    cands = []
    for off in offs.tolist():
        try:
            hdr = parse_block_header(mv, off)
        except Exception:
            continue
        avail = length - hdr.payload_off
        if avail < 0:
            continue
        cands.append(_Candidate(off, hdr.n_sym, np.asarray(hdr.tree),
                                hdr.payload_off, avail))
    return cands


def build_device_plans(enc: bytes, lane_mult: int = 1):
    """The device plans of a whole stream, and the output bytes they cover:
    the decoder's host-side preparation (candidate scan, header parse,
    native table build, eligibility, batching) without the decode; each
    plan's rows a multiple of ``lane_mult`` (the mesh size)."""
    buf = np.frombuffer(enc, np.uint8)
    eligible = _device_candidates(scan_candidates(buf))
    return (_build_plans(buf, eligible, lane_mult),
            sum(c.n_sym for c, *_rest in eligible))


def _apply_plan_results(plan, out_h, end_h, cor_h, bad_h):
    for b, (c, _tab, cap, _ns) in enumerate(plan.batch):
        if cor_h[b]:
            # Read-then-step precedence (decoder.c:52-71): a failing bit
            # beyond the available payload is a short read, not corruption
            # of a byte that was never read.  A failure beyond a
            # *tightened* cap (but within avail) is speculation gone
            # short, not a verdict: retry on the host-exact walk.
            if int(bad_h[b]) // 8 < cap:
                c.error = BtreeCorruptedError
            elif cap >= c.avail:
                c.error = ReadWriteError
            else:
                c.host_reason = "host_capshort_blocks"
            continue
        consumed = (int(end_h[b]) + 7) // 8
        if consumed <= cap:
            # A memoryview: the final b"".join copies once.
            c.result = (out_h[b, : c.n_sym].data, consumed)
        elif cap >= c.avail:
            c.error = ReadWriteError
        else:  # the cap fell short of avail; the host walks the block.
            c.host_reason = "host_capshort_blocks"


def _walk_block(buf: np.ndarray, mv: memoryview, off: int, length: int):
    """Decode the block at ``off`` on the host; returns (bytes, next
    offset)."""
    hdr = parse_block_header(mv, off)
    if hdr.n_sym > 8 * max(length - hdr.payload_off, 0):
        # Each symbol consumes >= 1 bit: guaranteed short read.  Also
        # guards output allocation against adversarial u64 lengths.
        raise ReadWriteError("Failed to decode the data")
    if native.available():
        err, consumed_b, produced, _blocks, o = native.scan_stream(
            buf[off:length], decode=True, out_cap=hdr.n_sym, max_blocks=1)
        if err == 3:
            raise ReadWriteError("Failed to decode the data")
        if err == 5:
            raise BtreeOverflowError("Failed to decode the data")
        if err == 6:
            raise BtreeCorruptedError("Failed to decode the data")
        return o[:produced].tobytes(), off + consumed_b
    syms, consumed = hostref.decode_block_payload(
        hdr.tree, buf[hdr.payload_off : length], hdr.n_sym)
    return syms.tobytes(), hdr.payload_off + consumed


def _chain(data: bytes, length: int, mesh: BlockMesh | None):
    """Decode the block chain from offset 0 up to ``length``, on the devices
    of ``mesh`` where it can (None: every block on the host).

    Returns (decoded bytes, end offset); raises on the first failing block
    in chain order.  ReadWriteError carries ``partial`` = (bytes decoded so
    far, offset of the incomplete block) so incremental callers can buffer.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    cand_map: dict[int, _Candidate] = {}
    if mesh is not None and length > 0:
        with annotate("huff.decode.scan"):
            # Candidate explosions (crafted input) take the host walk.
            cands = scan_candidates(buf, length, limit=max(64, length // 64))
        if cands is not None:
            cand_map = {c.off: c for c in cands}
            _decode_candidates_device(buf, cands, mesh)

    out = []
    mv = memoryview(data)
    off = 0
    with annotate("huff.decode.walk"):
        while off < length:
            try:
                c = cand_map.get(off)
                if c is not None and c.error is not None:
                    raise c.error("Failed to decode the data")
                if c is not None and c.result is not None:
                    syms, consumed = c.result
                    out.append(syms)
                    off = c.payload_off + consumed
                    COUNTS["device_decoded_blocks"] += 1
                    COUNTS["device_out_bytes"] += len(syms)
                    continue
                with annotate("huff.decode.host_walk"):
                    syms, off = _walk_block(buf, mv, off, length)
                out.append(syms)
                COUNTS["host_decoded_blocks"] += 1
                COUNTS["host_walked_bytes"] += len(syms)
                COUNTS[c.host_reason if c is not None
                       else "host_missed_blocks"] += 1
            except ReadWriteError as e:
                # Incomplete data at the chain tail: everything decoded so
                # far is valid and ``off`` marks the incomplete block's
                # start.
                e.partial = (b"".join(out), off)
                raise
        return b"".join(out), off


def decode(data: bytes, length: int | None = None, use_device: bool = True,
           device="cuda", config=None) -> bytes:
    """Whole-stream decode with the reference's strict semantics: the first
    failing block in chain order raises (src/decoder.c:218-275).

    ``length`` caps the compressed bytes consumed.  ``device`` is where the
    kernels run: a CUDA device, or "cpu" for their plain-torch twins; the
    default raises when CUDA is absent.  ``use_device=False`` walks every
    block on the host.  A :class:`~libhuffman_tpu_torch.config.DecodeConfig`
    overrides these knobs: its ``use_device`` picks the route, its
    ``device`` is where the kernels run (its ``mesh``, when set, splits the
    rows of every plan over the mesh's devices instead), and a non-zero
    ``length`` caps the bytes consumed."""
    mesh = None
    if config is not None:
        use_device = config.use_device
        device = config.device
        mesh = config.mesh
        if config.length:
            length = config.length
    mesh = _device_mesh(use_device, device, mesh)
    if length is None:
        length = len(data)
    if length == 0:
        return b""
    out, _ = _chain(data, length, mesh)
    return out


def _device_mesh(use_device: bool, device, mesh=None) -> BlockMesh | None:
    """The devices of the device route (None: the host route): ``mesh``,
    else ``device`` alone."""
    if not use_device:
        return None
    return mesh if mesh is not None else BlockMesh((resolve_device(device),))


def decode_prefix(data: bytes, length: int | None = None,
                  use_device: bool = True, device="cuda"
                  ) -> tuple[bytes, int]:
    """Decode every *complete* block; returns (output, consumed offset).

    A trailing incomplete block (short header, tree, or payload) stops the
    chain cleanly instead of raising.  Corruption errors still raise.
    """
    mesh = _device_mesh(use_device, device)
    if length is None:
        length = len(data)
    if length == 0:
        return b"", 0
    try:
        return _chain(data, length, mesh)
    except ReadWriteError as e:
        return getattr(e, "partial", (b"", 0))
