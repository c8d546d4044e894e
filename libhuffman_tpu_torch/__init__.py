"""libhuffman_tpu_torch - the PyTorch and CUDA port of libhuffman_tpu.

A libhuffman-wire-compatible block Huffman codec that runs on an NVIDIA
Hopper GPU.  Encode: per-block histograms, byte layout and bit packing are
hand-written CUDA kernels (``csrc/``, built with nvcc for sm_90a at first
use), the tree build and code walk are plain torch on the same device, and
the host serializes headers and assembles the stream with the native
runtime shared with the JAX package.  Decode: per-position codeword
resolution, the codeword chain and the byte emission are CUDA kernels, fed
by plans the host builds from a speculative header scan.

Importing the package does no CUDA work and imports neither jax nor
libhuffman_tpu; the encode/decode/api submodules load on first use.
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
from .format import DEFAULT_BLOCK_SIZE, DEFAULT_MEM_LIMIT
from .config import EncodeConfig

__version__ = "0.1.0"

_LAZY = {"HuffmanCompressor": "api", "compress": "api"}
_SUBMODULES = ("api", "decode", "encode", "native", "ops", "utils")

__all__ = [
    "ErrorCode",
    "HuffmanError",
    "InvalidArgumentError",
    "ReadWriteError",
    "BtreeOverflowError",
    "BtreeCorruptedError",
    "error_string",
    "HuffmanCompressor",
    "compress",
    "DEFAULT_BLOCK_SIZE",
    "DEFAULT_MEM_LIMIT",
    "EncodeConfig",
    "__version__",
]


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
