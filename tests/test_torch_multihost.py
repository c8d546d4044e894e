"""The port's multi-process layer (libhuffman_tpu_torch/parallel/multihost.py).

Two layers, as in tests/test_multihost.py:
  * one process: every exchange is skipped, and the entry points equal the
    JAX package's single-process ones and the host codec;
  * two real processes (tests/torch_multihost_worker.py) rendezvous over
    gloo on the CPU, encode and decode the same corpus through the
    multi-process entry points, and must produce the single-process stream
    byte for byte with the exchanges the sizes-only split allows.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from libhuffman_tpu.ops import hostref
from libhuffman_tpu_torch import encode as tenc
from libhuffman_tpu_torch.parallel import block_mesh, multihost
from torch_multihost_worker import corpus
from torch_port_util import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER_TIMEOUT = 120  # seconds per rank


@pytest.fixture(scope="module")
def jax_single_process_stream():
    """The JAX package's single-process multihost encode of the corpus."""
    from libhuffman_tpu.parallel import multihost as jmultihost

    return jmultihost.encode_stream_multihost(corpus(), 4096)


def test_single_process_paths(jax_single_process_stream):
    """One process: the entry points are the local pipeline, equal to the
    JAX package's and to the host codec."""
    data = corpus()
    multihost.initialize(None, 1, 0)  # no-op
    assert not dist.is_initialized()
    stream = multihost.encode_stream_multihost(data, 4096, device="cpu")
    assert stream == jax_single_process_stream == hostref.encode(data, 4096)
    assert stream == tenc.encode(data, 4096, device="cpu")
    assert multihost.decode_stream_multihost(stream, device="cpu") == data
    seg, off, total = multihost.encode_stream_multihost_local(
        data, 4096, device="cpu")
    assert (seg, off, total) == (stream, 0, len(stream))
    dseg, doff, dtotal = multihost.decode_stream_multihost_local(
        stream, device="cpu")
    assert (dseg, doff, dtotal) == (data, 0, len(data))


def test_single_process_mesh_encode():
    data = corpus()
    mesh = block_mesh(["cpu"] * 3)
    stream = multihost.encode_stream_multihost(data, 4096, mesh=mesh)
    assert stream == hostref.encode(data, 4096)


def test_allgather_bytes_single():
    assert multihost._allgather_bytes(b"abc") == [b"abc"]
    assert multihost._broadcast_bytes(b"xyz") == b"xyz"
    assert multihost._allgather_sizes(7).tolist() == [7]


def test_my_range_partition():
    """Block ranges partition [0, n) contiguously in rank order."""
    assert multihost._my_range(17) == (0, 17)
    assert multihost._my_range(0) == (0, 0)


def test_empty_input_and_stream():
    assert multihost.encode_stream_multihost(b"", 4096, device="cpu") == b""
    assert multihost.encode_stream_multihost_local(b"", 4096) == (b"", 0, 0)
    assert multihost.decode_stream_multihost(b"", device="cpu") == b""


@pytest.mark.parametrize("address, url", [
    ("127.0.0.1:29500", "tcp://127.0.0.1:29500"),
    ("tcp://127.0.0.1:29500", "tcp://127.0.0.1:29500"),
    ("file:///tmp/rdv", "file:///tmp/rdv"),
])
def test_initialize_rendezvous(monkeypatch, address, url):
    """A bare host:port becomes tcp://; URLs pass through; gloo always."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    multihost.initialize(address, 2, 1)
    assert calls == [(("gloo",), {"init_method": url, "world_size": 2,
                                  "rank": 1})]


def test_two_process_roundtrip(tmp_path, jax_single_process_stream):
    """Two processes over gloo produce the single-process stream byte for
    byte (ordered assembly by rank), decode it back, and exchange only
    sizes and tables on the sizes-only paths."""
    rendezvous = f"file://{tmp_path / 'rendezvous'}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
             rendezvous, "2", str(pid), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    ref = hostref.encode(corpus(), 4096)
    assert ref == jax_single_process_stream
    for pid in range(2):
        got = json.loads((tmp_path / f"out_{pid}.json").read_text())
        assert got["plain_ok"] is True
        assert got["stream_len"] == len(ref)
        assert got["stream_sha"] == hashlib.sha256(ref).hexdigest()
        # The rank-local segment is a verbatim slice of the stream, and the
        # split's own traffic is the size exchange (8 bytes per process).
        assert got["seg_ok"] is True and got["seg_len"] > 0
        assert got["dcn_sizes_only"] <= 64, got["dcn_sizes_only"]
        # Decode: the offset broadcast plus 24 B per candidate tables, far
        # below the 40 KB output; both ranks own real output.
        assert got["dseg_ok"] is True
        assert got["dseg_len"] > 0
        assert got["dcn_decode_local"] <= 2048, got["dcn_decode_local"]


@pytest.mark.parametrize("nproc", [2, 3, 5])
def test_my_range_partitions_over_ranks(monkeypatch, nproc):
    """With nproc ranks, the ranges of ranks 0..nproc-1 are contiguous and
    cover [0, n), for more items than ranks and for fewer."""
    monkeypatch.setattr(multihost, "_process_count", lambda: nproc)
    for n in (0, 1, 4, 17):
        ranges = []
        for rank in range(nproc):
            monkeypatch.setattr(multihost, "_process_index", lambda r=rank: r)
            ranges.append(multihost._my_range(n))
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
