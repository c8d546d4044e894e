"""The port's kernels and device stages against the JAX package.

Each kernel's plain-torch twin (the route a CPU tensor takes) is held
against the Pallas function it replaces, run on the CPU in interpret mode as
the JAX package's own tests run it; ``build_trees``/``extract_codes`` are
held against their JAX counterparts.  Integer outputs, compared exactly.
The tests marked ``cuda`` hold each CUDA kernel against its twin on the
card and skip without one; they need no JAX, so the JAX side is imported by
the ``jx`` fixture of the tests that use it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from libhuffman_tpu_torch.ops import device as tdev
from libhuffman_tpu_torch.ops import hostref, kernels
from torch_port_util import one_torch_thread  # noqa: F401
from torch_port_util import (HIST_EDGES, PACK_EDGES, batch, be_bytes,
                             hist_edge_inputs, left_align, pack_edge_inputs,
                             tensor, u32)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions, run on the CPU (Pallas in interpret
    mode, as its own tests run them)."""
    import jax.numpy as jnp

    from libhuffman_tpu.ops import concat_kernel, device

    return SimpleNamespace(a=jnp.asarray, ck=concat_kernel, dev=device)


def _host_codes(x, nv):
    """Each row's real Huffman codewords laid out per byte (host codec)."""
    C = np.zeros(x.shape, np.uint32)
    L = np.zeros(x.shape, np.int32)
    for b, n in enumerate(nv):
        if n:
            codes, lens = hostref.code_table(
                *hostref.build_tree(hostref.histogram(x[b, :n])))
            C[b, :n] = codes[x[b, :n]]
            L[b, :n] = lens[x[b, :n]]
    return C, L


@pytest.mark.parametrize("N", [4096, 8192])
def test_histogram_twin_matches_pallas(jx, N):
    rng = np.random.default_rng(N)
    x, nv = batch(rng, 4, N, [N, N // 2 + 3, 0, 1])
    want = np.asarray(jx.dev.histogram_pallas(jx.a(x), jx.a(nv)))
    got = kernels.histogram(tensor(x), tensor(nv)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", HIST_EDGES)
def test_histogram_twin_matches_pallas_on_edges(jx, kind):
    """Crafted rows at the Pallas kernel's shape (N % 4096 == 0).  The Pallas
    kernel needs zeros past n_valid; the twin gets random padding, which
    it must not count."""
    N = 4096
    x, nv = hist_edge_inputs(kind, 4, N, seed=3)
    zeroed = np.where(np.arange(N)[None, :] < nv[:, None], x, 0).astype(
        np.uint8)
    want = np.asarray(jx.dev.histogram_pallas(jx.a(zeroed), jx.a(nv)))
    got = kernels.histogram(tensor(x), tensor(nv)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N", [1024, 4096])
def test_symbol_layout_twin_matches_pallas(jx, N):
    rng = np.random.default_rng(N + 1)
    x, nv = batch(rng, 3, N, [N, 0, N - 77])
    # Arbitrary 32-bit table words (high bit set included) and lengths.
    codes = rng.integers(0, 1 << 32, (3, 256), dtype=np.uint64).astype(
        np.uint32)
    lens = rng.integers(0, 33, (3, 256)).astype(np.int32)
    C, L = jx.dev.symbol_layout_pallas(jx.a(x), jx.a(codes), jx.a(lens),
                                       jx.a(nv))
    Ct, Lt = kernels.symbol_layout(tensor(x), tensor(codes), tensor(lens),
                                   tensor(nv))
    np.testing.assert_array_equal(u32(Ct), np.asarray(C))
    np.testing.assert_array_equal(Lt.numpy(), np.asarray(L))


def _exact_and_port(jx, C, L, W):
    exact = jx.ck.concat_words(jx.a(left_align(C, L)), jx.a(L), W)
    payload, ovf = kernels.pack(tensor(C), tensor(L), W)
    return np.asarray(exact), payload.numpy(), ovf.numpy()


def test_pack_twin_matches_concat_kernel_on_real_codes(jx):
    N, W = 4096, 1536
    rng = np.random.default_rng(7)
    x, nv = batch(rng, 4, N, [N, N, 1000, 0])
    C, L = _host_codes(x, nv)
    words24, ovf24 = jx.ck.concat_words_ovf(jx.a(left_align(C, L)), jx.a(L),
                                            W, 24)
    words24, ovf24 = np.asarray(words24), np.asarray(ovf24)
    exact, payload, ovf = _exact_and_port(jx, C, L, W)
    # The capw = 24 clamp is a TPU layout limit the port does not copy:
    # compare on the blocks it leaves unflagged, and fully against the
    # unclamped concatenation.
    keep = ~ovf24
    assert keep.sum() >= 3
    np.testing.assert_array_equal(payload[keep], be_bytes(words24[keep]))
    np.testing.assert_array_equal(payload, be_bytes(exact))
    total = L.astype(np.int64).sum(axis=1)
    np.testing.assert_array_equal(ovf, total > 32 * W)
    assert not ovf.any()


def test_pack_twin_matches_concat_kernel_on_long_codes(jx):
    """Random codes up to 32 bits: word straddles at every offset, and rows
    whose content runs past the W-word budget (overflow, truncated)."""
    N, W = 4096, 1536
    rng = np.random.default_rng(11)
    L = rng.integers(0, 33, (4, N)).astype(np.int32)
    L[1] = rng.integers(0, 9, N)
    L[3] = 0
    raw = rng.integers(0, 1 << 32, (4, N), dtype=np.uint64)
    C = (raw & ((np.uint64(1) << L.astype(np.uint64)) - np.uint64(1))
         ).astype(np.uint32)
    exact, payload, ovf = _exact_and_port(jx, C, L, W)
    np.testing.assert_array_equal(payload, be_bytes(exact))
    total = L.astype(np.int64).sum(axis=1)
    np.testing.assert_array_equal(ovf, total > 32 * W)
    assert ovf[0] and ovf[2] and not ovf[1] and not ovf[3]


@pytest.mark.parametrize("kind", PACK_EDGES)
def test_pack_twin_matches_concat_kernel_on_edges(jx, kind):
    """Crafted lengths at the Pallas kernel's shape (N a power of two, W a
    multiple of 128): all 0, all 32, 32-bit codes at the CUDA kernel's
    segment and tile boundaries, a total of exactly 32 W and one bit more,
    segments that end inside one word."""
    N, W = 4096, 1536
    C, L = pack_edge_inputs(kind, 4, N, W, seed=5)
    exact, payload, ovf = _exact_and_port(jx, C, L, W)
    np.testing.assert_array_equal(payload, be_bytes(exact))
    total = L.astype(np.int64).sum(axis=1)
    np.testing.assert_array_equal(ovf, total > 32 * W)


def _fib_freqs(n):
    counts = [1, 1]
    while len(counts) < n:
        counts.append(counts[-1] + counts[-2])
    f = np.zeros(512, np.int32)
    f[:n] = counts
    return f


def test_build_trees_and_extract_codes_match_jax(jx):
    rng = np.random.default_rng(5)
    x, nv = batch(rng, 4, 4096, [4096, 4096, 333, 0])
    freqs = np.asarray(jx.dev.histogram_pallas(jx.a(x), jx.a(nv)))
    ties = np.zeros(512, np.int32)
    ties[[3, 9, 200, 201, 255]] = 5  # equal rates: the tie-break decides
    single = np.zeros(512, np.int32)
    single[65] = 10
    freqs = np.concatenate([freqs, ties[None], single[None],
                            _fib_freqs(40)[None], _fib_freqs(22)[None]])
    want = jx.dev.build_trees(jx.a(freqs))
    got = tdev.build_trees(tensor(freqs))
    for name, w, g in zip(("left", "right", "parent", "pbit", "root"),
                          want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    codes, lens, ovf = jx.dev.extract_codes(want[2], want[3])
    tcodes, tlens, tovf = tdev.extract_codes(got[2], got[3])
    np.testing.assert_array_equal(u32(tcodes), np.asarray(codes))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(lens))
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(ovf))
    # Fib(40) is deeper than 32 bits: flagged for the host; Fib(22) is not.
    assert tovf.tolist()[-2:] == [True, False]
    assert not tovf[:-2].any()


# --------------------------------------------------------------------------
# On the card: each CUDA kernel against its twin (skipped without CUDA)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_batch(cuda, B, N):
    rng = np.random.default_rng(N)
    x, nv = batch(rng, B, N, [N] * (B - 2) + [N // 3, 0])
    return tensor(x).to(cuda), tensor(nv).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [3000, 4096, 65536])
def test_cuda_histogram_and_layout_match_twins(cuda, N):
    blocks, nv = _cuda_batch(cuda, 6, N)
    freqs = kernels.histogram(blocks, nv)
    assert torch.equal(freqs, kernels.histogram_plain(blocks, nv))
    _l, _r, parent, pbit, _root = tdev.build_trees(freqs)
    codes, lens, _ovf = tdev.extract_codes(parent, pbit)
    codes = tdev.as_u32_bits(codes)
    C, L = kernels.symbol_layout(blocks, codes, lens, nv)
    Cp, Lp = kernels.symbol_layout_plain(blocks, codes, lens, nv)
    assert torch.equal(C, Cp) and torch.equal(L, Lp)


@pytest.mark.cuda
@pytest.mark.parametrize("N,W", [(4096, 1536), (65536, 24576),
                                 (262144, 98304)])
def test_cuda_pack_matches_twin(cuda, N, W):
    """Random lengths, and short codes on one row, at W from 1536 to 98304
    words: one kernel path for every W."""
    g = torch.Generator(device=cuda).manual_seed(N)
    L = torch.randint(0, 33, (4, N), device=cuda, dtype=torch.int32,
                      generator=g)
    L[1] = L[1] % 9
    raw = torch.randint(0, 1 << 32, (4, N), device=cuda, dtype=torch.int64,
                        generator=g)
    C = tdev.as_u32_bits(raw & ((1 << L.long()) - 1))
    payload, ovf = kernels.pack(C, L, W)
    payload_p, ovf_p = kernels.pack_plain(C, L, W)
    assert torch.equal(payload, payload_p) and torch.equal(ovf, ovf_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", PACK_EDGES)
@pytest.mark.parametrize("N,W", [(3001, 1536), (5000, 3072), (65536, 24576)])
def test_cuda_pack_edges_match_twin(cuda, kind, N, W):
    """Crafted lengths (see ``pack_edge_inputs``) on ragged and full
    blocks, three rows, output poisoned first: the kernel must write every
    byte."""
    C, L = pack_edge_inputs(kind, 3, N, W, seed=N)
    C, L = tensor(C).to(cuda), tensor(L).to(cuda)
    want = kernels.pack_plain(C, L, W)
    poison = torch.full_like(want[0], 0xA5)
    del poison
    got = kernels.pack(C, L, W)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", HIST_EDGES)
@pytest.mark.parametrize("N,offset", [(3000, 0), (4096, 1), (65536, 0)])
def test_cuda_histogram_edges_match_twin(cuda, kind, N, offset):
    """Crafted rows (see ``hist_edge_inputs``), random bytes past n_valid,
    rows at an odd byte offset, output poisoned first."""
    x, nv = hist_edge_inputs(kind, 3, N, seed=N)
    flat = torch.zeros(offset + x.size, dtype=torch.uint8, device=cuda)
    flat[offset:] = tensor(x.reshape(-1)).to(cuda)
    blocks = flat[offset:].view(3, N)
    nv = tensor(nv).to(cuda)
    want = kernels.histogram_plain(blocks, nv)
    poison = torch.full_like(want, -1)
    del poison
    assert torch.equal(kernels.histogram(blocks, nv), want)
