"""The port's decode kernels and ``ops/decode`` against the JAX package.

Each decode kernel's plain-torch twin (the route a CPU tensor takes) is held
against the Pallas function it replaces, run on the CPU in interpret mode as
the JAX package's own tests run it, after the JAX outputs are moved to the
port's natural, block-major order: K5 ``resolve_blocks`` (pair plane), K6
``chain_emit`` (position-major planes) and K4 ``concat_groups_ovf`` through
``_emit_from_chain``.  The port's ``decode_blocks`` is held against
``decode_v3.decode_blocks`` on device plans of small host-codec streams.
The chain twin is also held against ``chain_emit`` on the crafted edges of
``torch_port_util.chain_edge_meta``, and the emit twin against
``_emit_from_chain`` on the crafted counts of ``emit_edge_inputs``.
Integer outputs, compared exactly.  The tests marked ``cuda`` hold each
CUDA kernel against its twin on the card, on the plans of real streams and
on crafted edges, and skip without one.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from libhuffman_tpu_torch import decode as tdec
from libhuffman_tpu_torch import native as tnative
from libhuffman_tpu_torch.format import parse_block_header
from libhuffman_tpu_torch.ops import decode as tops
from libhuffman_tpu_torch.ops import hostref, kernels
from torch_port_util import one_torch_thread  # noqa: F401
from torch_port_util import (CHAIN_EDGES, CHAIN_SEG, EMIT_EDGES, EMIT_TILE,
                             RESOLVE_SPAN, block_tables, chain_edge_meta,
                             corpora, emit_edge_inputs, fib_block, run_words,
                             tensor, u32)

_CORPUS = corpora()


@pytest.fixture(scope="module")
def jx():
    """The JAX package's decode functions, run on the CPU (Pallas in
    interpret mode, as its own tests run them)."""
    import jax.numpy as jnp

    from libhuffman_tpu import decode as jdec
    from libhuffman_tpu.ops import decode_v3

    return SimpleNamespace(a=jnp.asarray, v3=decode_v3, dec=jdec)


def _natural_meta(meta) -> np.ndarray:
    """JAX pair plane (B, 16, WR, 128) u32 -> (B, 32 W) uint16: positions
    32 w + 2 s2 and + 1 are the low and high halves of [b, s2, w]."""
    m = np.asarray(meta)
    B = m.shape[0]
    m = m.reshape(B, 16, -1)
    pairs = np.stack([m & 0xFFFF, m >> 16], axis=-1)  # (B, 16, W, 2)
    return pairs.transpose(0, 2, 1, 3).reshape(B, -1).astype(np.uint16)


# --------------------------------------------------------------------------
# K5 resolve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tree,narrow", [("shallow", False), ("fib", False),
                                         ("fib", True)])
def test_resolve_twin_matches_pallas(jx, tree, narrow):
    shallow, ns0 = block_tables(hostref.encode_block(
        np.frombuffer(b"abracadabra, a shallow tree " * 40, np.uint8)))
    assert ns0 == 0
    fib, nsf = block_tables(fib_block())
    assert nsf >= 1
    if tree == "shallow":
        tables, NS = np.concatenate([shallow, shallow]), 0
    else:
        # Row 1: a shallow tree under a deeper plan's NS, as in a mixed plan.
        tables, NS = np.concatenate([fib, shallow]), nsf
        assert bool(jx.dec._narrow_flags(tables).all()) or not narrow
    rng = np.random.default_rng(3 + NS)
    WR = 4
    words = rng.integers(0, 1 << 32, (2, WR + 1, 128), dtype=np.uint64
                         ).astype(np.uint32)
    words[1, 2] = 0  # a zero run: the padding's long chains
    want = _natural_meta(jx.v3.resolve_blocks(jx.a(words), jx.a(tables), NS,
                                              narrow))
    got = kernels.resolve(tensor(words.reshape(2, -1)), tensor(tables), NS)
    assert got.shape == (2, 32 * 128 * WR) and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    # Dead entries (len 0) occur: a leading 1 bit is always one.
    assert ((want & 63) == 0).any()


# --------------------------------------------------------------------------
# K6 chain
# --------------------------------------------------------------------------

def _chain_input(maxl: int):
    """(B, NP) u16 entries aux(13:6) | len(5:0): random lengths with a dead
    position at [0, 5], an unused length (40) ending block 1's chain at a
    start, and eight 1-bit starts in block 2's first group."""
    rng = np.random.default_rng(7)
    NP, B = 1024, 3
    lens = rng.integers(2, maxl + 1, (B, NP)).astype(np.uint16)
    lens[0, 5] = 0
    lens[1, 0], lens[1, 2] = 2, 40
    lens[2, :8] = 1
    syms = rng.integers(0, 256, (B, NP)).astype(np.uint16)
    return (syms << 6) | lens


# (kind, NP, L): the two random inputs above (ids 10 and 25: their largest
# length), then each crafted edge at NPs the Pallas kernel takes (992 fits
# one of its steps, 4096 and 6144 are multiples of its 2048), placed at the
# boundaries of L-position segments (NP = 3 L + 224 for 992; L = 2048 is
# the chain kernel's own segment length).
_CHAIN_GEOMETRY = ((992, 256), (4096, 1024), (6144, 2048))
_CHAIN_CASES = [pytest.param(m, 1024, 1024, id=m) for m in ("10", "25")] + [
    pytest.param(kind, NP, L, id=f"{kind}-{NP}")
    for NP, L in _CHAIN_GEOMETRY for kind in CHAIN_EDGES]


def _chain_case(kind: str, NP: int, L: int, B: int = 3) -> np.ndarray:
    if kind in ("10", "25"):
        return _chain_input(int(kind))
    return chain_edge_meta(kind, B, NP, L, seed=NP + B)


def _last_start(start: np.ndarray) -> np.ndarray:
    """(B, NP/32) start words -> (B,) position of each row's last start."""
    bits = np.unpackbits(start.view(np.uint8), axis=1, bitorder="little")
    return bits.shape[1] - 1 - np.argmax(bits[:, ::-1], axis=1)


@pytest.mark.parametrize("kind,NP,L", _CHAIN_CASES)
def test_chain_twin_matches_pallas(jx, kind, NP, L):
    m16 = _chain_case(kind, NP, L).astype(np.uint32)
    meta2 = m16[:, 0::2] | (m16[:, 1::2] << 16)  # JAX pair plane rows
    want = [np.asarray(x).T for x in jx.v3.chain_emit(jx.a(meta2.T))]
    got = kernels.chain(tensor(m16.astype(np.uint16).view(np.int16)))
    for name, w, g in zip(("start", "gw", "gc4", "gr32"), want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(u32(g), w, err_msg=name)
    # Each edge shapes the chain as crafted.
    start = u32(got[0])
    last = _last_start(start)
    s = min(1, (NP - 1) // L) * L
    e = min(NP, s + L)
    if kind in ("10", "25"):
        assert start[1, 0] == 0b101          # ends at the length-40 start
        assert start[2, 0] & 0xFF == 0xFF    # eight starts in one group
    elif kind == "random":
        assert (last >= NP - 31).all()       # runs on to the end
    elif kind == "dead-first":
        assert (last == s).all()
    elif kind == "dead-last":
        assert (last == e - 1).all()
    elif kind == "len40":
        assert (last == (s + e) // 2).all()
    elif kind == "len31-last":
        for p in (L - 1, L + 30):            # enters segment 1 at offset 30
            assert ((start[:, p // 32] >> (p % 32)) & 1).all()
    elif kind == "ones":                     # every position of the segment
        assert (start[:, s // 32 : e // 32] == 0xFFFFFFFF).all()


# --------------------------------------------------------------------------
# K4 emit, and decode_blocks, on plans of real streams
# --------------------------------------------------------------------------

def _stream(corrupt: bool = False):
    """Five 4 KiB text blocks from the host codec; ``corrupt`` overwrites
    part of the third block's payload with 0xFF bytes (a leading 1 bit is
    dead under the unary root, so the chain fails there)."""
    data = _CORPUS.text(18000)
    s = bytearray(hostref.encode(data, 4096))
    if corrupt:
        offs = [c.off for c in tdec.scan_candidates(bytes(s))]
        hdr = parse_block_header(memoryview(bytes(s)), offs[2])
        s[hdr.payload_off + 100 : hdr.payload_off + 108] = b"\xff" * 8
    return bytes(s), data


def _jax_chain_planes(jx, p):
    """JAX resolve + chain of a plan: (gw_t (NG, B), gc4 (B, NG/4) and
    gr32 (B, NG/4), uint32 in the port's block-major order)."""
    B = p.words.shape[0]
    meta = jx.v3.resolve_blocks(jx.a(p.words), jx.a(p.tables), p.ns)
    e2 = np.asarray(meta).reshape(B, 16, p.NP // 32)
    meta_t = np.transpose(e2, (2, 1, 0)).reshape(p.NP // 2, B)
    _s, gw_t, gc4_t, gr32_t = jx.v3.chain_emit(jx.a(meta_t))
    return np.asarray(gw_t), np.asarray(gc4_t).T, np.asarray(gr32_t).T


def _masked(gc4: np.ndarray, n_cap) -> np.ndarray:
    """The counts of groups at or past n_cap zeroed, as
    decode_v3.decode_blocks masks them before emission (decode_v3.py:535-549):
    (B, NG/4) uint32."""
    g = np.arange(4 * gc4.shape[1]).reshape(1, -1, 4)
    keep = g < np.asarray(n_cap, np.int64)[:, None, None]
    mask = (np.where(keep, 255, 0) << np.arange(0, 32, 8)).sum(-1)
    return (gc4.astype(np.int64) & mask).astype(np.uint32)


def test_emit_twin_matches_pallas(jx):
    """On every plan of the stream: the twin on the unmasked counts and
    n_cap against ``_emit_from_chain`` on the masked counts."""
    stream, _ = _stream()
    plans, _ = jx.dec.build_device_plans(stream)
    assert plans
    for i, p in enumerate(plans):
        gw_t, gc4, gr32 = _jax_chain_planes(jx, p)
        gc4m = _masked(gc4, p.caps)
        want, ovf = jx.v3._emit_from_chain(jx.a(gw_t), jx.a(gc4m), p.OUTW,
                                           None)
        got = kernels.emit(tensor(gw_t.T), tensor(gc4), tensor(gr32),
                           tensor(p.caps), p.OUTW)
        assert not np.asarray(ovf).any()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # The TPU's capacity clamp (ECW) has no counterpart: compare on the
        # blocks a tight clamp leaves unflagged.
        want8, ovf8 = jx.v3._emit_from_chain(jx.a(gw_t), jx.a(gc4m),
                                             p.OUTW, 8)
        keep = ~np.asarray(ovf8)
        assert i or (keep.any() and not keep.all())
        np.testing.assert_array_equal(got.numpy()[keep],
                                      np.asarray(want8)[keep])


_EMIT_NG = 512  # the fewest groups the Pallas kernel takes (NG2 >= 512)


@pytest.mark.parametrize("kind", [k for k in EMIT_EDGES if k != "eights"])
def test_emit_twin_matches_pallas_on_crafted_counts(jx, kind):
    """The twin against ``_emit_from_chain`` on crafted counts: n_cap 0, in
    the middle of a 4-group cell, past NG; a row of zero counts; a live
    total past 4 OUTW (the twin cuts it there).  Counts stay within 0-4,
    as the main path gives them; "eights" is held on the card only."""
    gw, gc4, gr32, n_cap = emit_edge_inputs(kind, 2, _EMIT_NG, seed=5)
    OUTW = 3 * _EMIT_NG // 4
    want, _ovf = jx.v3._emit_from_chain(jx.a(gw.T.copy()),
                                        jx.a(_masked(gc4, n_cap)), OUTW, None)
    got = kernels.emit(tensor(gw), tensor(gc4), tensor(gr32), tensor(n_cap),
                       OUTW).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    live = _masked(gc4, n_cap).view(np.uint8).reshape(2, -1).sum(1)
    assert ((live > 4 * OUTW) == (kind == "truncate")).all()
    if kind in ("cap0", "zero-counts"):
        assert not got.any()
    if kind == "cap-mid-cell":
        assert (n_cap % 4 == 2).all() and (live > 0).all()
    if kind == "cap-past-end":
        assert (n_cap > _EMIT_NG).all()


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt"])
def test_decode_blocks_matches_decode_v3(jx, corrupt):
    stream, data = _stream(corrupt)
    plans, _ = jx.dec.build_device_plans(stream)
    assert plans
    flagged = False  # a real block (not a padding row) flagged corrupt
    for p in plans:
        want = jx.v3.decode_blocks(jx.a(p.words), jx.a(p.tables),
                                   jx.a(p.n_sym), jx.a(p.caps), p.NP, p.OUTW,
                                   p.ns, None, False)
        out, end_bit, cor, bad_bit, ovf = [np.asarray(x) for x in want]
        got = tops.decode_blocks(
            tensor(p.words.reshape(len(p.words), -1)), tensor(p.tables),
            tensor(p.n_sym), tensor(p.caps), p.NP, p.OUTW, p.ns)
        g_out, g_end, g_cor, g_bad, g_ovf = [x.numpy() for x in got]
        for b, (c, *_rest) in enumerate(p.batch):
            np.testing.assert_array_equal(g_out[b, : c.n_sym],
                                          out[b, : c.n_sym])
        np.testing.assert_array_equal(g_end, end_bit)
        np.testing.assert_array_equal(g_cor, cor)
        np.testing.assert_array_equal(g_bad, bad_bit)
        assert not g_ovf.any() and not ovf.any()
        flagged |= bool(g_cor[: len(p.batch)].any())
    assert flagged == corrupt


# --------------------------------------------------------------------------
# On the card: each CUDA kernel against its twin (skipped without CUDA)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["text", "mixed"])
def test_cuda_decode_kernels_match_twins(cuda, family):
    """K5, K6 and K4 on the card against their twins, on the plans of a
    1 MiB stream, and the plan decode against its CPU run."""
    data = _CORPUS.FAMILIES[family](1 << 20)
    plans, _ = tdec.build_device_plans(hostref.encode(data, 65536))
    assert plans
    for p in plans:
        words = tensor(p.words).to(cuda)
        tables = tensor(p.tables).to(cuda)
        meta = kernels.resolve(words, tables, p.ns)
        assert torch.equal(meta, kernels.resolve_plain(words, tables, p.ns))
        planes = kernels.chain(meta)
        for g, w in zip(planes, kernels.chain_plain(meta)):
            assert torch.equal(g, w)
        caps = tensor(p.caps).to(cuda)
        e_in = (planes[1], planes[2], planes[3], caps, p.OUTW)
        assert torch.equal(kernels.emit(*e_in), kernels.emit_plain(*e_in))
        args = (tensor(p.n_sym), tensor(p.caps), p.NP, p.OUTW, p.ns)
        on_card = tops.decode_blocks(words, tables, *[
            a.to(cuda) if torch.is_tensor(a) else a for a in args])
        on_cpu = tops.decode_blocks(tensor(p.words), tensor(p.tables), *args)
        for g, w in zip(on_card, on_cpu):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CHAIN_EDGES)
def test_cuda_chain_edges_match_twin(cuda, kind):
    """K6 on the card against its twin on the crafted edges, at the NPs of
    the Pallas comparison and at NP = 3 L + 32 for the kernel's segment
    length L (not a multiple of L), for B in {1, 3, 513}.  The output
    buffers are poisoned first: the kernel must write every word."""
    for NP, L in (*_CHAIN_GEOMETRY, (3 * CHAIN_SEG + 32, CHAIN_SEG)):
        for B in (1, 3, 513):
            meta = tensor(_chain_case(kind, NP, L, B).view(np.int16)).to(cuda)
            want = kernels.chain_plain(meta)
            poison = [torch.full_like(w, -1) for w in want]
            del poison
            got = kernels.chain(meta)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (kind, NP, L, B)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EMIT_EDGES)
def test_cuda_emit_edges_match_twin(cuda, kind):
    """K4 on the card against its twin on the crafted counts, with NG =
    2 T + 148 for the kernel's tile of T groups (a multiple of neither T
    nor 8), OUTW = 3 NG / 4 (rows not 16-byte aligned; "truncate" passes
    it) and 4 NG (a long zero fill), for B in {1, 3, 513}.  The output is
    poisoned first: the kernel must write every byte."""
    NG = 2 * EMIT_TILE + 148
    for OUTW in (3 * NG // 4, 4 * NG):
        for B in (1, 3, 513):
            ins = [tensor(a).to(cuda)
                   for a in emit_edge_inputs(kind, B, NG, seed=B)]
            want = kernels.emit_plain(*ins, OUTW)
            poison = torch.full_like(want, 0xA5)
            del poison
            got = kernels.emit(*ins, OUTW)
            assert torch.equal(got, want), (kind, OUTW, B)


@pytest.mark.cuda
@pytest.mark.parametrize("ns", range(6))
def test_cuda_resolve_edges_match_twin(cuda, ns):
    """K5 on the card against its twin at every stage count: the tables of
    a caterpillar tree of depth 10 + 3 NS, words whose long bit runs reach
    its deepest codes, W below one of the kernel's slices of S words and
    W = 3 S + 40 (not a multiple of it), for B in {1, 3, 513}.  The output
    is poisoned first: the kernel must write every entry."""
    tab, got_ns = block_tables(fib_block(10 + 3 * ns))
    assert got_ns == ns
    deepest = 0
    for W in (40, 3 * RESOLVE_SPAN + 40):
        for B in (1, 3, 513):
            words = tensor(run_words(np.random.default_rng(B), B, W)).to(cuda)
            tables = tensor(np.repeat(tab, B, axis=0)).to(cuda)
            want = kernels.resolve_plain(words, tables, ns)
            deepest = max(deepest, int((want.long() & 63).max()))
            poison = torch.full_like(want, -1)
            del poison
            got = kernels.resolve(words, tables, ns)
            assert torch.equal(got, want), (ns, W, B)
    assert deepest == 10 + 3 * ns  # the last stage was taken


@pytest.mark.cuda
def test_cuda_resolve_takes_more_blocks_than_a_grid_row(cuda):
    """A plan of 512-byte payloads may hold 2^28 / 4096 = 65536 blocks,
    past the 65535 of a CUDA grid's y dimension."""
    tables, _ns = block_tables(hostref.encode_block(
        np.frombuffer(b"abracadabra, a shallow tree " * 40, np.uint8)))
    B = 65536 + 7
    g = torch.Generator(device=cuda).manual_seed(1)
    words = (torch.randint(0, 1 << 32, (B, 128 + 128), dtype=torch.int64,
                           device=cuda, generator=g) - (1 << 31)
             ).to(torch.int32)
    tab = tensor(np.repeat(tables, B, axis=0)).to(cuda)
    meta = kernels.resolve(words, tab, 0)
    assert torch.equal(meta, kernels.resolve_plain(words, tab, 0))
