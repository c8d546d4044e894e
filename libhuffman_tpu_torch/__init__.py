"""libhuffman_tpu_torch - the PyTorch and CUDA port of libhuffman_tpu.

A libhuffman-wire-compatible block Huffman codec that runs on an NVIDIA
Hopper GPU.  Encode: per-block histograms, byte layout and bit packing are
hand-written CUDA kernels (``csrc/``, built with nvcc for sm_90a at first
use), the tree build and code walk are plain torch on the same device, and
the host serializes headers and assembles the stream with the native
runtime shared with the JAX package.  Decode: per-position codeword
resolution, the codeword chain and the byte emission are CUDA kernels, fed
by plans the host builds from a speculative header scan.

The public surface is the JAX package's: the bz2-style API
(``compress``, ``decompress``, ``HuffmanCompressor``,
``HuffmanDecompressor``, ``HuffmanFile``, ``open``; each takes ``device``,
"cuda" by default, "cpu" for the kernels' plain-torch twins), block-aligned
resume (``resume``), the tracing and timing hooks (``trace``) and the
block-parallel layer (``parallel``: the block axis split over a list of
devices, ``parallel.shard``, or over processes, ``parallel.multihost``).
Importing the package does no CUDA work and imports neither jax nor
libhuffman_tpu; the api, encode, decode, parallel, resume and trace modules
load on first use.
Low-level entry points: ``libhuffman_tpu_torch.encode.encode(data,
blocksize, device=...)`` and ``libhuffman_tpu_torch.decode.decode(stream,
device=...)``.
"""

import importlib

from .errors import (
    ErrorCode,
    HuffmanError,
    InvalidArgumentError,
    ReadWriteError,
    BtreeOverflowError,
    BtreeCorruptedError,
    error_string,
)
from .format import (
    DEFAULT_BLOCK_SIZE,
    DEFAULT_MEM_LIMIT,
    describe_tree,
    node_to_string,
)
from .config import DecodeConfig, EncodeConfig
from .histogram import Histogram

__version__ = "0.1.0"

# Names whose modules import torch, loaded on first use: attribute -> module.
_LAZY = {name: "api" for name in (
    "HuffmanFile", "HuffmanCompressor", "HuffmanDecompressor", "compress",
    "decompress", "open")}
_SUBMODULES = {name: name for name in (
    "api", "decode", "encode", "native", "ops", "parallel", "resume",
    "symbols", "utils")}
_SUBMODULES["trace"] = "utils.trace"

__all__ = [
    "ErrorCode",
    "HuffmanError",
    "InvalidArgumentError",
    "ReadWriteError",
    "BtreeOverflowError",
    "BtreeCorruptedError",
    "error_string",
    "HuffmanFile",
    "HuffmanCompressor",
    "HuffmanDecompressor",
    "compress",
    "decompress",
    "open",
    "DEFAULT_BLOCK_SIZE",
    "DEFAULT_MEM_LIMIT",
    "EncodeConfig",
    "DecodeConfig",
    "Histogram",
    "describe_tree",
    "node_to_string",
    "__version__",
]


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{_SUBMODULES[name]}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
