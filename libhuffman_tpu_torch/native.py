"""ctypes binding for the native host runtime (native/huffman_native.cpp).

The C++ source is shared with the JAX package and referenced by path, not
copied.  The port uses the entry points of its encode path (batch tree
serialization and whole-batch stream assembly), of its device decode path
(header scan, resolve-table build, plan staging), of the host-exact
decode route (the sequential chain scan) and of the incremental
decompressor (the resumable measurement walk).  The library is compiled
with g++ on first use into ``build/native/`` beside the package (or the
directory named by ``LIBHUFFMAN_TPU_TORCH_NATIVE_DIR``), keyed by a hash
of the source, so the JAX package's cache is never shared.  Every entry
point has a pure-Python equivalent: without a toolchain, ``available()``
is False and callers take the slower host path, never a different result.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "huffman_native.cpp"

# ctypes calls with declared argtypes release the GIL, so stream-scale
# native passes (header scan, table build, plan staging) run in parallel
# across host cores with plain threads.
_POOL_WORKERS = min(8, os.cpu_count() or 1)

# Resolve tables, packed two 16-bit entries per u32 cell: 4 rows LUT10 +
# 4 rows stage 1 (128 states x 3 bits) + 2 rows tail 1 (64 states) + 3 rows
# tails 2-4 (32 states each).  Deeper codes take the host-exact walk.
TAB_ROWS = 13
MAX_TABLE_DEPTH = 25  # 10 + 5 * 3


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
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
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
    lib.build_decode_tables_batch.argtypes = [
        i16p, i64p, i32p, ctypes.c_int32, u32p, i32p, i32p, i32p]
    lib.build_decode_tables_batch.restype = None
    lib.find_headers.argtypes = [i8p, ctypes.c_int64, i64p, ctypes.c_int64]
    lib.find_headers.restype = ctypes.c_int64
    lib.stage_plan.argtypes = [
        i8p, ctypes.c_int64, i64p, i64p, ctypes.c_int32, ctypes.c_int64, u32p]
    lib.stage_plan.restype = None
    lib.walk_progress.argtypes = [
        i16p, ctypes.c_int32, i8p, ctypes.c_int64, ctypes.c_uint64]
    lib.walk_progress.restype = ctypes.c_uint64
    lib.walk_progress_resume.argtypes = [
        i16p, ctypes.c_int32, i8p, ctypes.c_int64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.walk_progress_resume.restype = ctypes.c_int32
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


def build_decode_tables(bufs: np.ndarray, offs: np.ndarray, lens: np.ndarray):
    """Concatenated int16 wire trees -> per-block resolve tables.

    Returns (tables[B, TAB_ROWS, 128] uint32, nstages[B], mindepth[B],
    maxdepth[B]); nstages -1 marks host-route blocks (1-bit codes,
    over-capacity state cuts, or depth > MAX_TABLE_DEPTH), -2 a tree with
    no root.  Threaded above 256 trees."""
    B = len(offs)
    tables = np.empty((B, TAB_ROWS, 128), np.uint32)
    nstages = np.empty(B, np.int32)
    mindep = np.empty(B, np.int32)
    maxdep = np.empty(B, np.int32)
    bufs = np.ascontiguousarray(bufs, np.int16)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    nw = _POOL_WORKERS
    if B < 256 or nw <= 1:
        _lib().build_decode_tables_batch(
            bufs, offs, lens, B, tables, nstages, mindep, maxdep)
        return tables, nstages, mindep, maxdep

    def chunk(i):
        lo, hi = B * i // nw, B * (i + 1) // nw
        if lo == hi:
            return
        # The entry point indexes its outputs from 0: pass chunk views.
        _lib().build_decode_tables_batch(
            bufs, np.ascontiguousarray(offs[lo:hi]),
            np.ascontiguousarray(lens[lo:hi]), hi - lo,
            tables[lo:hi], nstages[lo:hi], mindep[lo:hi], maxdep[lo:hi])

    with ThreadPoolExecutor(nw) as ex:
        list(ex.map(chunk, range(nw)))
    return tables, nstages, mindep, maxdep


def _find_headers_seg(data: np.ndarray) -> np.ndarray:
    cap = max(1024, len(data) // 4096)
    out = np.empty(cap, np.int64)
    k = int(_lib().find_headers(data, len(data), out, cap))
    if k > cap:
        out = np.empty(k, np.int64)
        k = int(_lib().find_headers(data, len(data), out, k))
    return out[:k].copy()


def find_headers(data: np.ndarray) -> np.ndarray:
    """Offsets of plausible block headers (format.find_candidate_headers in
    native code).  Threaded from 8 MiB: segments overlap by the 10-byte
    header window and each keeps only offsets inside its own range."""
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    nw = _POOL_WORKERS
    if n < (8 << 20) or nw <= 1:
        return _find_headers_seg(data)
    bounds = [n * i // nw for i in range(nw + 1)]

    def seg(i):
        lo, hi = bounds[i], min(bounds[i + 1] + 9, n)
        offs = _find_headers_seg(data[lo:hi])
        return offs[offs < bounds[i + 1] - lo] + lo

    with ThreadPoolExecutor(nw) as ex:
        parts = list(ex.map(seg, range(nw)))
    return np.concatenate(parts)


def stage_plan(data: np.ndarray, offs: np.ndarray, caps: np.ndarray,
               row_words: int) -> np.ndarray:
    """Per block, ``caps[b]`` payload bytes from ``offs[b]`` (-1: none) as a
    zero-padded row of ``row_words`` big-endian u32 words, the resolve
    kernel's input."""
    B = len(offs)
    out = np.empty((B, row_words), np.uint32)
    _lib().stage_plan(
        np.ascontiguousarray(data, np.uint8), len(data),
        np.ascontiguousarray(offs, np.int64),
        np.ascontiguousarray(caps, np.int64), B, row_words, out)
    return out


def walk_progress(tree: np.ndarray, payload: np.ndarray, n_sym: int) -> int:
    """Symbols the available ``payload`` of one block yields (a walk that
    measures and writes nothing; 0 on a bad tree)."""
    return int(_lib().walk_progress(
        np.ascontiguousarray(tree, np.int16), len(tree),
        np.ascontiguousarray(payload, np.uint8), len(payload), n_sym,
    ))


def walk_progress_resume(tree: np.ndarray, payload: np.ndarray, n_sym: int,
                         state: tuple[int, int, int] | None = None
                         ) -> tuple[int, tuple[int, int, int]]:
    """Resumable measurement walk: state = (node, restored, pos) carries the
    walk across incremental feeds so each payload byte is visited once.

    Returns (restored, new_state); node -1 in the state marks a walk frozen
    on corruption (the caller's decode attempt classifies it)."""
    node, restored, pos = state if state is not None else (0, 0, 0)
    c_pos = ctypes.c_int64(pos)
    c_state = ctypes.c_int32(node)
    c_restored = ctypes.c_uint64(restored)
    _lib().walk_progress_resume(
        np.ascontiguousarray(tree, np.int16), len(tree),
        np.ascontiguousarray(payload, np.uint8), len(payload), n_sym,
        ctypes.byref(c_pos), ctypes.byref(c_state), ctypes.byref(c_restored),
    )
    return int(c_restored.value), (c_state.value, int(c_restored.value),
                                   c_pos.value)
