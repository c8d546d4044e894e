"""Package boundary of the PyTorch port: imports, devices, builds, wrappers.

Nothing here needs a GPU or nvcc; nothing here builds the CUDA kernels.
"""

import os
import subprocess
import sys

import pytest
import torch

import libhuffman_tpu_torch as port
from libhuffman_tpu.ops import hostref
from libhuffman_tpu_torch import api, config, decode as tdec
from libhuffman_tpu_torch import encode as tenc
from libhuffman_tpu_torch.ops import _build, kernels
from torch_port_util import ROOT


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch\n"
        "import libhuffman_tpu_torch as p\n"
        "import libhuffman_tpu_torch.api, libhuffman_tpu_torch.decode\n"
        "import libhuffman_tpu_torch.encode, libhuffman_tpu_torch.native\n"
        "import libhuffman_tpu_torch.ops.device, libhuffman_tpu_torch.ops._build\n"
        "import libhuffman_tpu_torch.ops.kernels, libhuffman_tpu_torch.utils.trace\n"
        "import libhuffman_tpu_torch.ops.decode, libhuffman_tpu_torch.config\n"
        "import libhuffman_tpu_torch.resume, libhuffman_tpu_torch.symbols\n"
        "import libhuffman_tpu_torch.histogram\n"
        "import libhuffman_tpu_torch.parallel\n"
        "import libhuffman_tpu_torch.parallel.multihost\n"
        "p.parallel.block_mesh, p.parallel.shard.encode_stream_sharded\n"
        "p.compress, p.HuffmanCompressor, p.EncodeConfig, p.DecodeConfig\n"
        "p.HuffmanDecompressor, p.HuffmanFile, p.open, p.decompress\n"
        "p.Histogram, p.describe_tree, p.node_to_string, p.resume, p.trace\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'libhuffman_tpu'))\n"
        "print(bad, torch.cuda.is_initialized())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "False"]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenc.encode(b"abc", 4096)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenc.encode(b"abc", config=config.EncodeConfig(blocksize=4096))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.compress(b"abc")
    with pytest.raises(ValueError):
        tenc.encode(b"abc", 4096, device="meta")
    assert tenc.encode(b"abc", 4096, device="cpu") == hostref.encode(
        b"abc", 4096)


def test_cpu_tensors_take_the_twins_and_launch_nothing():
    kernels.reset_launches()
    blocks = torch.zeros((2, 64), dtype=torch.uint8)
    n_valid = torch.tensor([64, 10], dtype=torch.int32)
    freqs = kernels.histogram(blocks, n_valid)
    assert freqs[:, 0].tolist() == [64, 10] and int(freqs.sum()) == 74
    data = bytes(range(200)) * 50
    enc = tenc.encode(data, 4096, device="cpu")
    assert enc == hostref.encode(data, 4096)
    assert tdec.decode(enc, device="cpu") == data
    assert kernels.LAUNCHES == {"histogram": 0, "trees": 0,
                                "symbol_layout": 0, "pack": 0, "resolve": 0,
                                "chain": 0, "emit": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    b = torch.zeros((2, 64), dtype=torch.uint8)
    nv = torch.full((2,), 64, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.histogram(b.int(), nv)
    with pytest.raises(ValueError):
        kernels.histogram(b, nv[:1])
    with pytest.raises(ValueError):
        kernels.histogram(torch.zeros((64, 2), dtype=torch.uint8).t(), nv)
    codes = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.symbol_layout(b, codes.long(), codes, nv)
    C = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.pack(C, C, 0)
    with pytest.raises(ValueError):
        kernels.pack(C, C[:, :32], 16)
    words = torch.zeros((2, 130), dtype=torch.int32)
    tables = torch.zeros((2, 13, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.resolve(words, tables, 6)
    with pytest.raises(ValueError):
        kernels.resolve(words[:, :128].contiguous(), tables, 0)
    with pytest.raises(TypeError):
        kernels.chain(torch.zeros((2, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.chain(torch.zeros((2, 48), dtype=torch.int16))
    with pytest.raises(ValueError):
        kernels.emit(C, C[:, :15].contiguous(), C[:, :16].contiguous(), nv,
                     16)


def test_build_targets_sm90a_into_the_build_dir():
    """One nvcc per source (run in parallel), then one link."""
    out = _build.build_dir() / "lib.so"
    objs = [out.with_suffix(".o")]
    cc = _build.compile_command("nvcc", _build.sources()[0], objs[0])
    link = _build.link_command("nvcc", objs, out)
    for cmd in (cc, link):
        assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-c", "-O3", "-std=c++17"} <= set(cc)
    assert "-shared" in link and str(out) in link
    assert _build.build_dir() == ROOT / "build" / "kernels"
    assert [p.name for p in _build.sources()] == [
        "chain.cu", "emit.cu", "histogram.cu", "layout.cu", "pack.cu",
        "resolve.cu", "trees.cu"]
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("LIBHUFFMAN_TPU_TORCH_KERNEL_DIR", str(tmp_path))
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_compressor_streams_whole_blocks():
    data = bytes(range(97)) * 300
    comp = api.HuffmanCompressor(4096, device="cpu")
    out = comp.compress(data[:5000]) + comp.compress(data[5000:]) + comp.flush()
    assert out == hostref.encode(data, 4096)
    assert comp.flush() == b""
    with pytest.raises(ValueError):
        comp.compress(b"x")
    assert port.compress(data, 4096, device="cpu") == out
