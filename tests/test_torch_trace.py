"""The port's spans and byte counters, on the CPU with the kernels' twins.

The encode opens ``huff.encode.batch`` around each batch's building,
``huff.encode.trees`` around each slice's tree build (inside
``huff.encode.device``) and ``huff.encode.join`` around the final join;
``encode.COUNTS`` and ``decode.COUNTS`` count the bytes copied back from
the devices and the stream or output bytes taken from them.
"""

import numpy as np
import pytest

from libhuffman_tpu_torch import decode as tdec
from libhuffman_tpu_torch import encode as tenc
from libhuffman_tpu_torch.config import DecodeConfig, EncodeConfig
from libhuffman_tpu_torch.ops import hostref
from libhuffman_tpu_torch.parallel.shard import block_mesh
from libhuffman_tpu_torch.utils import trace
from torch_port_util import one_torch_thread  # noqa: F401

_BS = 1024


def _data(nblocks: int, seed: int = 0) -> bytes:
    """Skewed bytes over ``nblocks`` blocks, the last one ragged."""
    rng = np.random.default_rng(seed)
    n = nblocks * _BS - _BS // 3
    return (rng.zipf(1.3, n) % 97).astype(np.uint8).tobytes()


def _reset_counts():
    for c in (tenc.COUNTS, tdec.COUNTS):
        for k in c:
            c[k] = 0


@pytest.fixture
def timing():
    trace.reset_timings()
    trace.enable_timing(True)
    yield
    trace.enable_timing(False)
    trace.reset_timings()


@pytest.mark.parametrize("k,batches", [(1, 3), (2, 2)])
def test_encode_spans_per_batch_slice_and_call(timing, k, batches):
    """10 blocks, 4 per device in a batch: 3 batches on one device, 2
    batches of 2 slices on two."""
    data = _data(10)
    cfg = EncodeConfig(blocksize=_BS, batch_blocks=4,
                       mesh=block_mesh(["cpu"] * k))
    assert tenc.encode(data, config=cfg) == hostref.encode(data, _BS)
    t = trace.get_timings()
    assert len(t["huff.encode.batch"]) == batches
    assert len(t["huff.encode.device"]) == batches
    assert len(t["huff.encode.trees"]) == batches * k
    assert len(t["huff.encode.join"]) == 1
    assert sum(t["huff.encode.trees"]) <= sum(t["huff.encode.device"])


def _ranges(prof, name):
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == name]


def test_encode_ranges_nest_on_the_profiler_clock():
    """Each tree build lies inside a device span, and batch building
    overlaps none: the spans share the profiler's timeline with the
    kernels they launch, as the benchmark's idle-gap breakdown reads
    them."""
    data = _data(6)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tenc.encode(data, _BS, batch_blocks=2, device="cpu")
    device = _ranges(prof, "huff.encode.device")
    trees = _ranges(prof, "huff.encode.trees")
    batch = _ranges(prof, "huff.encode.batch")
    assert len(device) == len(trees) == len(batch) == 3
    assert len(_ranges(prof, "huff.encode.join")) == 1
    for s, e in trees:
        assert any(ds <= s and e <= de for ds, de in device)
    for s, e in batch:
        assert all(e <= ds or de <= s for ds, de in device)


@pytest.mark.parametrize("k", [1, 2])
def test_encode_byte_counters(k):
    data = _data(9, seed=k)
    _reset_counts()
    out = tenc.encode(data, config=EncodeConfig(
        blocksize=_BS, batch_blocks=4, mesh=block_mesh(["cpu"] * k)))
    assert tenc.COUNTS["stream_bytes"] == len(out)
    assert tenc.COUNTS["encode_d2h_bytes"] >= len(out)


@pytest.mark.parametrize("k", [1, 2])
def test_decode_device_out_bytes(k):
    data = _data(12, seed=10 + k)
    stream = hostref.encode(data, _BS)
    _reset_counts()
    out = tdec.decode(stream, config=DecodeConfig(
        mesh=block_mesh(["cpu"] * k)))
    assert out == data
    assert tdec.COUNTS["host_decoded_blocks"] == 0
    assert tdec.COUNTS["device_decoded_blocks"] == 12
    assert tdec.COUNTS["device_out_bytes"] == len(out)
    assert tdec.COUNTS["decode_d2h_bytes"] >= len(out)


def test_decode_host_walk_copies_nothing_back():
    data = _data(3)
    _reset_counts()
    assert tdec.decode(hostref.encode(data, _BS), use_device=False) == data
    assert tdec.COUNTS == {"host_decoded_blocks": 3,
                           "device_decoded_blocks": 0,
                           "decode_d2h_bytes": 0, "device_out_bytes": 0,
                           "host_walked_bytes": len(data),
                           "host_oversized_blocks": 0,
                           "host_deep_blocks": 0,
                           "host_capshort_blocks": 0,
                           "host_missed_blocks": 3}


def test_no_timings_with_timing_off():
    trace.reset_timings()
    data = _data(5)
    stream = tenc.encode(data, _BS, batch_blocks=2, device="cpu")
    assert tdec.decode(stream, device="cpu") == data
    assert trace.get_timings() == {}
