"""Carry the JAX package's inputs and intermediates into the PyTorch port.

Both sides of a comparison compute from the same values: inputs are made
with numpy from a fixed seed, handed to the JAX function as numpy arrays,
and turned into the port's CPU tensors here.  32-bit words cross as their
int32 bit pattern, the port's carrier for u32 (torch on the CPU has no
shifts, compares or gathers for ``torch.uint32``).
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
