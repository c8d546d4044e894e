"""ctypes binding for the native host runtime (native/huffman_native.cpp).

The C++ source is shared with the JAX package and referenced by path, not
copied.  The port uses the entry points of its encode path (batch tree
serialization and whole-batch stream assembly) and of the host-exact decode
route (the sequential chain scan).  The library is compiled with g++ on first
use into ``build/native/`` beside the package (or the directory named by
``LIBHUFFMAN_TPU_TORCH_NATIVE_DIR``), keyed by a hash of the source, so the
JAX package's cache is never shared.  Every entry point has a pure-Python
equivalent: without a toolchain, ``available()`` is False and callers take
the slower host path, never a different result.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "huffman_native.cpp"


def _build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "LIBHUFFMAN_TPU_TORCH_NATIVE_DIR", _ROOT / "build" / "native"))


@functools.lru_cache(maxsize=1)
def _lib():
    src = _SRC.read_bytes()
    cache = _build_dir()
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"libhuffman_native-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not so.exists():
        # Build under a private name and rename into place: concurrent test
        # workers may build at once, and a reader must never load a
        # half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-std=c++17", "-O3", "-fPIC", "-shared",
                 str(_SRC), "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    i8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    lib.serialize_trees.argtypes = [i32p, i32p, i32p, ctypes.c_int32, i16p, i32p]
    lib.serialize_trees.restype = None
    lib.scan_stream.argtypes = [
        i8p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.scan_stream.restype = ctypes.c_int32
    lib.assemble_blocks.argtypes = [
        u64p, i16p, i32p, ctypes.c_int64, i8p, ctypes.c_int64, i64p,
        ctypes.c_int32, i8p]
    lib.assemble_blocks.restype = ctypes.c_int64
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def serialize_trees(left: np.ndarray, right: np.ndarray, root: np.ndarray):
    """(B,512)x2 + (B,) array trees -> (out[B,1025] int16, lens[B] int32)."""
    B = len(root)
    out = np.empty((B, 1025), np.int16)
    lens = np.empty(B, np.int32)
    _lib().serialize_trees(
        np.ascontiguousarray(left, np.int32),
        np.ascontiguousarray(right, np.int32),
        np.ascontiguousarray(root, np.int32),
        B, out, lens,
    )
    return out, lens


def scan_stream(data: np.ndarray, decode: bool = False, out_cap: int = 0,
                max_blocks: int = -1):
    """Sequential chain scan (optionally decoding, optionally bounded).

    Returns (err, consumed, produced, blocks, out_bytes_or_None) with
    huf_error_t-compatible err codes (0/3/5/6).
    """
    data = np.ascontiguousarray(data, np.uint8)
    out = np.empty(out_cap, np.uint8) if decode else None
    consumed = ctypes.c_int64()
    produced = ctypes.c_int64()
    blocks = ctypes.c_int64()
    err = _lib().scan_stream(
        data, len(data),
        out.ctypes.data_as(ctypes.c_void_p) if out is not None else None,
        out_cap, ctypes.byref(consumed), ctypes.byref(produced),
        ctypes.byref(blocks), max_blocks,
    )
    return err, consumed.value, produced.value, blocks.value, out


def assemble_blocks(n_sym: np.ndarray, trees: np.ndarray,
                    tree_lens: np.ndarray, payloads: np.ndarray,
                    payload_lens: np.ndarray) -> bytes:
    """Ordered (header, tree, payload) concatenation for a whole batch
    (reference src/encoder.c:325-351); n_sym == 0 rows are padding."""
    n_sym = np.ascontiguousarray(n_sym, np.uint64)
    tree_lens = np.ascontiguousarray(tree_lens, np.int32)
    payload_lens = np.ascontiguousarray(payload_lens, np.int64)
    total = int(np.sum(
        np.where(n_sym > 0, 10 + 2 * tree_lens.astype(np.int64)
                 + payload_lens, 0)))
    out = np.empty(total, np.uint8)
    n = int(_lib().assemble_blocks(
        n_sym, np.ascontiguousarray(trees, np.int16), tree_lens,
        trees.shape[1], np.ascontiguousarray(payloads, np.uint8),
        payloads.shape[1], payload_lens, len(n_sym), out))
    if n != total:
        raise RuntimeError(f"native assembly wrote {n} bytes, expected {total}")
    return out.tobytes()
