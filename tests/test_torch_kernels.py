"""The port's kernels and device stages against the JAX package.

Each kernel's plain-torch twin (the route a CPU tensor takes) is held
against the Pallas function it replaces, run on the CPU in interpret mode as
the JAX package's own tests run it; ``build_trees``/``extract_codes``, the
twin of the trees kernel, are held against their JAX counterparts.
Integer outputs, compared exactly.  The tests marked ``cuda`` hold each
CUDA kernel against its twin on the card and skip without one; they need
no JAX, so the JAX side is imported by the ``jx`` fixture of the tests
that use it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from libhuffman_tpu_torch.ops import device as tdev
from libhuffman_tpu_torch.ops import hostref, kernels
from torch_port_util import one_torch_thread  # noqa: F401
from torch_port_util import (HIST_EDGES, PACK_EDGES, TREE_EDGES, batch,
                             be_bytes, corpora, corpus_freqs, fib_freqs,
                             hist_edge_inputs, left_align, pack_edge_inputs,
                             tensor, tree_edge_freqs, u32)


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


def _tree_cases(jx):
    """Histograms of real blocks (the last one empty), five equal rates
    (the tie-break decides), one symbol, Fibonacci 40 (deeper than 32
    bits) and 22."""
    rng = np.random.default_rng(5)
    x, nv = batch(rng, 4, 4096, [4096, 4096, 333, 0])
    freqs = np.asarray(jx.dev.histogram_pallas(jx.a(x), jx.a(nv)))
    ties = np.zeros(512, np.int32)
    ties[[3, 9, 200, 201, 255]] = 5
    single = np.zeros(512, np.int32)
    single[65] = 10
    return np.concatenate([freqs, ties[None], single[None],
                           fib_freqs(40)[None], fib_freqs(22)[None]])


def test_build_trees_and_extract_codes_match_jax(jx):
    freqs = _tree_cases(jx)
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


def test_trees_twin_matches_jax(jx):
    """``kernels.trees`` on CPU tensors (its twin) against the JAX
    package's tree build and walk, every output; total_bits is freq x len
    summed."""
    freqs = _tree_cases(jx)
    left, right, parent, pbit, root = jx.dev.build_trees(jx.a(freqs))
    codes, lens, ovf = jx.dev.extract_codes(parent, pbit)
    lens = np.asarray(lens)
    total = (freqs[:, :256].astype(np.int64) * lens).sum(axis=1)
    want = (left, right, root, codes, lens, ovf, total)
    got = kernels.trees(tensor(freqs), int(freqs.sum(axis=1).max()))
    names = ("left", "right", "root", "codes", "lens", "overflow",
             "total_bits")
    for name, w, g in zip(names, want, got):
        g = u32(g) if name == "codes" else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert got[6].dtype == torch.int64 and got[5].dtype == torch.bool
    assert got[5].tolist() == [False] * 6 + [True, False]
    assert got[2].tolist()[3] == -1  # the empty block


@pytest.mark.parametrize("case", ["dtype", "shape", "strided", "N"])
def test_trees_wrapper_rejects_what_the_kernel_does_not_take(case):
    f = torch.zeros((2, 512), dtype=torch.int32)
    bad = {"dtype": (f.long(), 64, TypeError),
           "shape": (f[:, :256].contiguous(), 64, ValueError),
           "strided": (torch.zeros((512, 2), dtype=torch.int32).t(), 64,
                       ValueError),
           "N": (f, kernels.TREES_MAX_N + 1, ValueError)}
    freqs, N, err = bad[case]
    with pytest.raises(err):
        kernels.trees(freqs, N)
    if case == "N":
        with pytest.raises(ValueError):
            kernels.trees(f, -1)


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
    _l, _r, _root, codes, lens, _ovf, _bits = kernels.trees(freqs, N)
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
    C = kernels._as_i32(raw & ((1 << L.long()) - 1))
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


def _trees_input(B: int) -> np.ndarray:
    """B histogram rows: the crafted rows of ``TREE_EDGES`` (B = 1: the
    256-round row), then rows of 64 KiB and 128 KiB blocks of both corpus
    families, repeated, and 16 all-zero rows of padding last."""
    edges = tree_edge_freqs()
    if B <= len(edges):
        return edges[:B]
    real = corpus_freqs(4 << 20)
    fill = np.resize(real, (B - len(edges) - 16, 512))
    return np.concatenate([edges, fill, np.zeros((16, 512), np.int32)])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, len(TREE_EDGES), 1024])
def test_cuda_trees_match_twin(cuda, B):
    """K7 against its twin, every output exactly, outputs poisoned first:
    the kernel must write every word."""
    freqs = tensor(_trees_input(B)).to(cuda)
    N = int(freqs.long().sum(dim=1).max())
    want = kernels.trees_plain(freqs)
    poison = [torch.full_like(w, -1) for w in want]
    del poison
    kernels.reset_launches()
    got = kernels.trees(freqs, N)
    assert kernels.LAUNCHES["trees"] == 1
    names = ("left", "right", "root", "codes", "lens", "overflow",
             "total_bits")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if B >= len(TREE_EDGES):  # the Fibonacci 33 and 40 rows overflow
        assert got[5][:len(TREE_EDGES)].tolist() == [
            e in ("fib33", "fib40") for e in TREE_EDGES]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2])
def test_cuda_encode_launches_trees_once_per_batch_slice(cuda, split):
    """An encode round trip on the card, the card listed ``split`` times:
    wire-equal to the host codec, one K7 launch per batch slice."""
    from libhuffman_tpu_torch import decode as tdec
    from libhuffman_tpu_torch import encode as tenc
    from libhuffman_tpu_torch.config import EncodeConfig
    from libhuffman_tpu_torch.parallel import block_mesh

    data = corpora().FAMILIES["text"](17 * 65536 - 1000)
    mesh = block_mesh([cuda] * split)
    kernels.reset_launches()
    s = tenc.encode(data, config=EncodeConfig(blocksize=65536,
                                              batch_blocks=4, mesh=mesh))
    batches = -(-17 // (4 * split))
    assert kernels.LAUNCHES["trees"] == batches * split
    assert kernels.LAUNCHES["histogram"] == batches * split
    assert s == hostref.encode(data, 65536)
    assert tdec.decode(s) == data
