"""The port's block-parallel layer (libhuffman_tpu_torch/parallel/shard.py).

The same inputs go through the JAX package's sharded functions on the
8-device virtual CPU mesh of tests/conftest.py and through the port's on
meshes of 1, 2 and 3 ``"cpu"`` devices (the kernels' plain-torch twins), as
tests/test_sharding.py has them.  Every comparison is byte-exact: wire
bytes, bit totals, decoded bytes, the decode kernels' verdicts, and the
error class a truncated stream raises.  Streams are written with the
port's copy of the host codec; the results are held against the JAX
package's (imported, with JAX, only by the CPU tests' fixture, so the
``cuda`` test runs on the card without JAX).
"""

import numpy as np
import pytest
import torch

from libhuffman_tpu_torch import decode as tdec
from libhuffman_tpu_torch import encode as tenc
from libhuffman_tpu_torch.config import DecodeConfig, EncodeConfig
from libhuffman_tpu_torch.ops import decode as tops
from libhuffman_tpu_torch.ops import hostref
from libhuffman_tpu_torch.parallel import (BlockMesh, block_mesh,
                                           decode_blocks_sharded,
                                           encode_sharded)
from libhuffman_tpu_torch.parallel.shard import (assemble_stream,
                                                 decode_plans_sharded,
                                                 encode_stream_sharded,
                                                 gather, run_slices)
from torch_port_util import one_torch_thread  # noqa: F401
from torch_port_util import routes

MESH_SIZES = [1, 2, 3]


def _batch_data():
    """tests/test_sharding.py:62-79: 16 blocks of 1000 bytes."""
    rng = np.random.default_rng(7)
    B, N = 16, 1000
    data = rng.choice(
        np.frombuffer(b"abcdefgh \n", np.uint8), B * N).astype(np.uint8)
    return data, data.reshape(B, N), np.full(B, N, np.int32)


def _stream_data() -> bytes:
    """tests/test_sharding.py:46-59: text blocks and an incompressible
    tail."""
    rng = np.random.default_rng(11)
    return ((b"the quick brown fox " * 400)[:4096] * 5
            + rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())


def _decode_data() -> bytes:
    """tests/test_sharding.py:28-43: 24 blocks of 1024 bytes."""
    return (b"A sharded stream of many independent blocks! " * 800)[:24 << 10]


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's sharded results on its 8-device mesh, and its
    host codec's encodings, once."""
    from libhuffman_tpu import decode as jdec
    from libhuffman_tpu.config import DecodeConfig as JDecodeConfig
    from libhuffman_tpu.errors import ReadWriteError
    from libhuffman_tpu.ops import hostref as jhostref
    from libhuffman_tpu.parallel import block_mesh as jblock_mesh
    from libhuffman_tpu.parallel import encode_sharded as jencode_sharded
    from libhuffman_tpu.parallel.shard import (
        assemble_stream as jassemble_stream,
        encode_stream_sharded as jencode_stream_sharded)

    mesh = jblock_mesh()
    assert mesh.devices.size == 8
    data, batch, n_valid = _batch_data()
    payload, total_bits, left, right, root, overflow = jencode_sharded(
        batch, n_valid, mesh, words_per_block=batch.shape[1])
    out = {
        "total_bits": np.asarray(total_bits),
        "batch_stream": jassemble_stream(n_valid, total_bits, payload, left,
                                         right, root, overflow, batch),
        "stream": jencode_stream_sharded(
            np.frombuffer(_stream_data(), np.uint8), 1024, mesh),
        "hostref_batch": jhostref.encode(data.tobytes(), batch.shape[1]),
        "hostref_stream": jhostref.encode(_stream_data(), 1024),
        "hostref_3_blocks": jhostref.encode(_stream_data()[:3000], 1024),
    }
    enc = hostref.encode(_decode_data(), 1024)
    out["decoded"] = jdec.decode(enc, config=JDecodeConfig(mesh=mesh))
    with pytest.raises(ReadWriteError) as e:
        jdec.decode(enc[:-3], config=JDecodeConfig(mesh=mesh))
    out["truncated_error"] = type(e.value).__name__
    return out


@pytest.mark.parametrize("k", MESH_SIZES)
def test_encode_sharded_matches_jax(jax_results, k):
    """encode_sharded + assemble_stream == the JAX pair == hostref; the bit
    totals equal the JAX totals (a mesh of 3 takes two padding rows)."""
    data, batch, n_valid = _batch_data()
    pad = -len(batch) % k
    batch_p = np.concatenate([batch, np.zeros((pad, batch.shape[1]),
                                              np.uint8)])
    nv_p = np.concatenate([n_valid, np.zeros(pad, np.int32)])
    payload, total_bits, left, right, root, overflow = encode_sharded(
        batch_p, nv_p, block_mesh(["cpu"] * k),
        words_per_block=batch.shape[1])
    assert payload.shape == (len(batch_p), 4 * batch.shape[1])
    np.testing.assert_array_equal(total_bits[: len(batch)],
                                  jax_results["total_bits"])
    assert not total_bits[len(batch):].any() and not overflow.any()
    stream = assemble_stream(nv_p, total_bits, payload, left, right, root,
                             overflow, batch_p)
    assert stream == jax_results["batch_stream"]
    assert stream == jax_results["hostref_batch"]


@pytest.mark.parametrize("k", MESH_SIZES)
def test_encode_stream_sharded_matches_jax(jax_results, k):
    """The stream encode over k devices == the JAX sharded stream ==
    hostref == the port's unsharded encode; EncodeConfig(mesh=...) routes
    there, and a small batch_blocks gives several batches."""
    data = _stream_data()
    mesh = block_mesh(["cpu"] * k)
    got = encode_stream_sharded(np.frombuffer(data, np.uint8), 1024, mesh)
    assert got == jax_results["stream"] == jax_results["hostref_stream"]
    assert got == tenc.encode(data, 1024, device="cpu")
    assert got == tenc.encode(data, config=EncodeConfig(
        blocksize=1024, mesh=mesh, batch_blocks=2))


@pytest.mark.parametrize("k", MESH_SIZES)
def test_decode_mesh_matches_jax(jax_results, k):
    """DecodeConfig(mesh=...) == the JAX mesh decode == the unsharded port
    decode == the input; a truncated stream raises the same class."""
    data = _decode_data()
    enc = hostref.encode(data, 1024)  # 24 blocks
    cfg = DecodeConfig(mesh=block_mesh(["cpu"] * k))
    tdec.COUNTS.update(host_decoded_blocks=0, device_decoded_blocks=0)
    got = tdec.decode(enc, config=cfg)
    assert routes(tdec.COUNTS) == {"host_decoded_blocks": 0,
                                   "device_decoded_blocks": 24}
    assert got == data == jax_results["decoded"]
    assert got == tdec.decode(enc, device="cpu")
    with pytest.raises(Exception) as e:
        tdec.decode(enc[:-3], config=cfg)
    assert type(e.value).__name__ == jax_results["truncated_error"]


@pytest.mark.parametrize("k", MESH_SIZES)
def test_decode_blocks_sharded_matches_unsharded(k):
    """One plan's rows over k devices == ops/decode.decode_blocks on the
    whole plan: out, end_bit, corrupt, bad_bit."""
    data = (_stream_data() * 3)[: 40 << 10]
    buf = np.frombuffer(hostref.encode(data, 2048), np.uint8)
    eligible = tdec._device_candidates(tdec.scan_candidates(buf))
    plans = tdec._build_plans(buf, eligible, lane_mult=k)
    mesh = block_mesh(["cpu"] * k)
    for p, res in zip(plans, decode_plans_sharded(plans, mesh)):
        assert p.words.shape[0] % k == 0
        want = tops.decode_blocks(
            *tdec.plan_tensors(p, torch.device("cpu")), p.NP, p.OUTW, p.ns)
        got = decode_blocks_sharded(p.words, p.tables, p.n_sym, p.caps,
                                    p.NP, p.OUTW, p.ns, mesh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
        for g, w in zip(res, got[:4]):
            np.testing.assert_array_equal(g, w)


def test_build_plans_pads_rows_to_the_mesh():
    """lane_mult pads a plan's rows with dead-table rows; the batch of real
    candidates is unchanged."""
    buf = np.frombuffer(hostref.encode(_decode_data(), 1024), np.uint8)
    eligible = tdec._device_candidates(tdec.scan_candidates(buf))
    (p1,) = tdec._build_plans(buf, eligible)
    (p3,) = tdec._build_plans(buf, eligible, lane_mult=3)
    assert p1.words.shape[0] == 32 and p3.words.shape[0] == 33
    assert len(p3.batch) == len(p1.batch) == 24
    np.testing.assert_array_equal(p3.tables[32], tdec._pad_table())
    np.testing.assert_array_equal(p3.words[:32], p1.words)


def test_three_blocks_over_four_devices(jax_results):
    """A mesh larger than the block count: the padding rows of the encode
    and of each decode plan are whole slices of their own."""
    data = _stream_data()[:3000]
    mesh = block_mesh(["cpu"] * 4)
    enc = tenc.encode(data, config=EncodeConfig(blocksize=1024, mesh=mesh))
    assert enc == jax_results["hostref_3_blocks"]
    assert tdec.decode(enc, config=DecodeConfig(mesh=mesh)) == data
    _data, batch, n_valid = _batch_data()
    nv = n_valid[:4].copy()
    nv[3] = 0
    payload, total_bits, left, right, root, overflow = encode_sharded(
        batch[:4], nv, mesh, words_per_block=1000)
    assert assemble_stream(nv, total_bits, payload, left, right, root,
                           overflow) == hostref.encode(batch[:3].tobytes(),
                                                       1000)


@pytest.mark.parametrize("use_native", [True, False])
def test_assemble_stream_reencodes_overflow_rows(monkeypatch, use_native):
    """A row flagged in ``overflow`` is re-encoded from the raw batch and
    counted, whichever assembly runs (native trees or the Python one); the
    other rows keep the device's payload, and the stream is hostref's."""
    from libhuffman_tpu_torch import native

    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    data, batch, n_valid = _batch_data()
    payload, total_bits, left, right, root, overflow = encode_sharded(
        batch, n_valid, block_mesh(["cpu"] * 2), words_per_block=1000)
    overflow = overflow.copy()
    overflow[5] = True
    payload = payload.copy()
    payload[5] = 0  # the device's bytes of a flagged row are not used
    counts = {"host_reencoded_blocks": 0}
    assert assemble_stream(n_valid, total_bits, payload, left, right, root,
                           overflow, batch, counts=counts) == \
        hostref.encode(data.tobytes(), 1000)
    assert counts == {"host_reencoded_blocks": 1}
    with pytest.raises(ValueError, match="raw input"):
        assemble_stream(n_valid, total_bits, payload, left, right, root,
                        overflow)


def test_gather_joins_slices_in_block_order():
    """One slice comes back as it is, several are joined in mesh order."""
    a = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    (one,) = gather([(a,)])
    np.testing.assert_array_equal(one, a.numpy())
    got, flags = gather([(a[:1], torch.tensor([True])),
                         (a[1:], torch.tensor([False, True]))])
    np.testing.assert_array_equal(got, a.numpy())
    np.testing.assert_array_equal(flags, [True, False, True])


def test_run_slices_takes_only_even_non_empty_splits():
    mesh = block_mesh(["cpu"] * 3)
    x = np.arange(12, dtype=np.int32).reshape(6, 2)
    got = run_slices(lambda t: (t * 2,), (x,), mesh)
    assert [r[0].tolist() for r in got] == [
        [[0, 2], [4, 6]], [[8, 10], [12, 14]], [[16, 18], [20, 22]]]
    with pytest.raises(ValueError):
        run_slices(lambda t: (t,), (x[:4],), mesh)
    with pytest.raises(ValueError):
        run_slices(lambda t: (t,), (x[:0],), mesh)


def test_block_mesh_devices():
    mesh = block_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert block_mesh(["cpu"]) == BlockMesh((torch.device("cpu"),))
    with pytest.raises(ValueError):
        block_mesh([])
    with pytest.raises(ValueError):
        block_mesh(["meta"])


def test_block_mesh_raises_without_cuda(monkeypatch):
    """No silent CPU route: the default mesh and named CUDA devices need
    CUDA, and a config without a mesh still runs on its default device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        block_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        block_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenc.encode(b"abc", config=EncodeConfig(blocksize=4096))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdec.decode(hostref.encode(b"abc", 4096), config=DecodeConfig())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_one_card_listed_twice(cuda):
    """The split on one card: two slices on cuda:0, equal to the unsharded
    device route and to hostref."""
    data = (_stream_data() * 40)[: 1 << 20]
    mesh = block_mesh(["cuda:0", "cuda:0"])
    enc = tenc.encode(data, config=EncodeConfig(blocksize=65536, mesh=mesh))
    assert enc == tenc.encode(data, 65536) == hostref.encode(data, 65536)
    assert tdec.decode(enc, config=DecodeConfig(mesh=mesh)) == data
    _data, batch, n_valid = _batch_data()
    got = encode_sharded(batch, n_valid, mesh, words_per_block=1000)
    want = encode_sharded(batch, n_valid, block_mesh([cuda]),
                          words_per_block=1000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
