"""Carry the JAX package's inputs and intermediates into the PyTorch port.

Both sides of a comparison compute from the same values: inputs are made
with numpy from a fixed seed, handed to the JAX function as numpy arrays,
and turned into the port's CPU tensors here.  32-bit words cross as their
int32 bit pattern, the port's carrier for u32 (torch on the CPU has no
shifts, compares or gathers for ``torch.uint32``).  ``chain_edge_meta``
crafts the chain kernel's edge cases for these tests and for
``chip_smoke.py``, which loads this file by path.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def tensor(a) -> torch.Tensor:
    """numpy array (or anything ``np.asarray`` takes, e.g. a JAX array) ->
    CPU tensor of the same values; uint32 becomes its int32 bit pattern."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def u32(t: torch.Tensor) -> np.ndarray:
    """Tensor of 32-bit words (int32 bit pattern, or int64 in [0, 2^32))
    -> numpy uint32."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return (a & 0xFFFFFFFF).astype(np.uint32)


def be_bytes(words) -> np.ndarray:
    """(B, W) u32 words -> (B, 4W) u8 big-endian payload bytes (the JAX
    package's ``words_to_bytes``)."""
    w = np.asarray(words, dtype=np.uint32)
    return w.astype(">u4").view(np.uint8).reshape(w.shape[0], 4 * w.shape[1])


def left_align(C: np.ndarray, L: np.ndarray) -> np.ndarray:
    """Right-aligned codewords -> the left-aligned ``level0`` strings the
    JAX packer takes (``libhuffman_tpu/ops/device.py:469-471``)."""
    c = np.asarray(C, np.uint64)
    ln = np.asarray(L, np.int64)
    return np.where(ln > 0, (c << (32 - ln).clip(0, 32).astype(np.uint64))
                    & 0xFFFFFFFF, 0).astype(np.uint32)


def batch(rng: np.random.Generator, B: int, N: int, n_valid) -> tuple:
    """(B, N) uint8 blocks + (B,) int32 valid lengths, zero-padded past
    n_valid as encode.encode pads.  Rows alternate text-like skewed
    bytes and uniform bytes."""
    x = np.zeros((B, N), np.uint8)
    for b in range(B):
        if b % 2:
            x[b] = rng.integers(0, 256, N, dtype=np.uint8)
        else:
            x[b] = rng.choice(np.frombuffer(b" etaoinshrdlu\n", np.uint8),
                              N, p=np.arange(14, 0, -1) / 105)
        x[b, n_valid[b]:] = 0
    return x, np.asarray(n_valid, np.int32)


def corpora():
    """bench/corpora.py, loaded by path (the ``bench`` name resolves to
    bench.py at the repo root)."""
    spec = importlib.util.spec_from_file_location(
        "bench_corpora", ROOT / "bench" / "corpora.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHAIN_SEG = 2048  # positions per segment of the chain kernel (csrc/chain.cu)
CHAIN_EDGES = ("random", "dead-first", "dead-last", "len31-last", "len40",
               "ones")


def chain_edge_meta(kind: str, B: int, NP: int, L: int, seed: int = 0):
    """(B, NP) uint16 K5 entries aux(13:6) | len(5:0) for one of the chain
    edges of ``CHAIN_EDGES``, placed at the boundaries of L-position
    segments: uniform random lengths 1-31 (random aux bytes), then, in
    segment 1 (segment 0 when there is one), a dead entry on its first or
    last position, a length 40, or lengths 1 through the whole segment;
    or a length 31 on the last position of every segment.  A run of 31
    1-bit starts before each such position makes every chain reach it (a
    code is at most 31 bits)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 32, (B, NP)).astype(np.uint16)
    aux = rng.integers(0, 256, (B, NP)).astype(np.uint16)
    k = min(1, (NP - 1) // L)
    s, e = k * L, min(NP, (k + 1) * L)

    def reach(p: int) -> None:
        lens[:, max(0, p - 31):p] = 1

    if kind == "dead-first":
        reach(s)
        lens[:, s] = 0
    elif kind == "dead-last":
        reach(e - 1)
        lens[:, e - 1] = 0
    elif kind == "len31-last":
        for p in [*range(L - 1, NP, L), NP - 1]:
            reach(p)
            lens[:, p] = 31
    elif kind == "len40":
        reach((s + e) // 2)
        lens[:, (s + e) // 2] = 40
    elif kind == "ones":
        reach(s)
        lens[:, s:e] = 1
    elif kind != "random":
        raise ValueError(f"unknown chain edge {kind!r}")
    return (aux << 6) | lens
