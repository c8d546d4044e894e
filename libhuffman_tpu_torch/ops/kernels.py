"""Wrappers of the encode path's CUDA kernels, and their plain-torch twins.

Each wrapper checks its inputs (device, dtype, shape, contiguity) and then
takes one of two routes, chosen by where the tensors lie and nothing else:

  * a CUDA tensor: the hand-written kernel of ``csrc/`` (built on first use
    by :mod:`._build`) is launched on the current stream without a
    synchronize, and the wrapper's entry in :data:`LAUNCHES` goes up by one;
  * a CPU tensor: the kernel's plain-torch twin below, which has the same
    contract.  The CPU tests hold the twins against the JAX package's Pallas
    kernels, and ``chip_smoke.py`` holds each kernel against its twin.

A failing launch raises; there is no fallback from a CUDA tensor to a twin.

32-bit codewords and words are carried in int32 tensors as their bit
pattern (torch on the CPU has no shifts or compares for uint32); the twins
widen them to int64 where they do arithmetic.

  kernel          replaces (libhuffman_tpu)                     source
  histogram       ops/device.py:145 histogram_pallas            csrc/histogram.cu
  symbol_layout   ops/device.py:360 symbol_layout_pallas        csrc/layout.cu
  pack            ops/concat_kernel.py:274 concat_words_ovf     csrc/pack.cu
"""

from __future__ import annotations

import torch

from ..format import ASCII_COUNT, HISTOGRAM_LEN
from . import _build

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"histogram": 0, "symbol_layout": 0, "pack": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------------
# K1 histogram
# --------------------------------------------------------------------------

def histogram(blocks: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Byte counts of each block's first ``n_valid`` bytes.

    blocks (B, N) uint8, n_valid (B,) int32 -> (B, 512) int32; slots
    256..511 are zero (build_trees' internal-node scratch)."""
    if blocks.dim() != 2:
        raise ValueError("blocks must be (B, N)")
    B, N = blocks.shape
    dev = blocks.device
    _check(blocks, "blocks", torch.uint8, (B, N), dev)
    _check(n_valid, "n_valid", torch.int32, (B,), dev)
    if not _on_cuda(blocks):
        return histogram_plain(blocks, n_valid)
    out = torch.empty((B, HISTOGRAM_LEN), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        err = _build.library().huff_histogram(
            blocks.data_ptr(), n_valid.data_ptr(), out.data_ptr(), B, N,
            _stream(dev))
    _build.check(err, "histogram")
    LAUNCHES["histogram"] += 1
    return out


def histogram_plain(blocks: torch.Tensor, n_valid: torch.Tensor
                    ) -> torch.Tensor:
    """Twin of :func:`histogram`: one bincount over row-offset byte values,
    with positions at or past n_valid sent to a discarded extra bin."""
    B, N = blocks.shape
    dev = blocks.device
    pos = torch.arange(N, device=dev)
    rows = torch.arange(B, device=dev)[:, None] * ASCII_COUNT
    idx = torch.where(pos[None, :] < n_valid[:, None].long(),
                      blocks.long() + rows, B * ASCII_COUNT)
    counts = torch.bincount(idx.flatten(), minlength=B * ASCII_COUNT + 1)
    out = torch.zeros((B, HISTOGRAM_LEN), dtype=torch.int32, device=dev)
    out[:, :ASCII_COUNT] = counts[: B * ASCII_COUNT].view(B, ASCII_COUNT)
    return out


# --------------------------------------------------------------------------
# K2 symbol layout
# --------------------------------------------------------------------------

def symbol_layout(blocks: torch.Tensor, codes: torch.Tensor,
                  lens: torch.Tensor, n_valid: torch.Tensor):
    """Each byte's codeword and length from its block's tables.

    blocks (B, N) uint8, codes (B, 256) int32 (u32 bit pattern of the
    right-aligned codeword), lens (B, 256) int32, n_valid (B,) int32 ->
    C (B, N) int32 = codes[blocks], L (B, N) int32 = lens[blocks] before
    n_valid and 0 from there on."""
    if blocks.dim() != 2:
        raise ValueError("blocks must be (B, N)")
    B, N = blocks.shape
    dev = blocks.device
    _check(blocks, "blocks", torch.uint8, (B, N), dev)
    _check(codes, "codes", torch.int32, (B, ASCII_COUNT), dev)
    _check(lens, "lens", torch.int32, (B, ASCII_COUNT), dev)
    _check(n_valid, "n_valid", torch.int32, (B,), dev)
    if not _on_cuda(blocks):
        return symbol_layout_plain(blocks, codes, lens, n_valid)
    C = torch.empty((B, N), dtype=torch.int32, device=dev)
    L = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return C, L
    with torch.cuda.device(dev):
        err = _build.library().huff_layout(
            blocks.data_ptr(), codes.data_ptr(), lens.data_ptr(),
            n_valid.data_ptr(), C.data_ptr(), L.data_ptr(), B, N,
            _stream(dev))
    _build.check(err, "symbol_layout")
    LAUNCHES["symbol_layout"] += 1
    return C, L


def symbol_layout_plain(blocks: torch.Tensor, codes: torch.Tensor,
                        lens: torch.Tensor, n_valid: torch.Tensor):
    """Twin of :func:`symbol_layout`: two row gathers and a mask."""
    N = blocks.shape[1]
    idx = blocks.long()
    C = torch.gather(codes, 1, idx)
    L = torch.gather(lens, 1, idx)
    pos = torch.arange(N, device=blocks.device)
    L = torch.where(pos[None, :] < n_valid[:, None].long(), L, 0)
    return C, L


# --------------------------------------------------------------------------
# K3 pack
# --------------------------------------------------------------------------

def pack(C: torch.Tensor, L: torch.Tensor, W: int):
    """MSB-first concatenation of each row's codewords into its payload.

    C (B, N) int32 (u32 bit pattern, right-aligned, no bits at or above the
    length), L (B, N) int32 lengths in [0, 32], W words ->
    (payload (B, 4W) uint8: the first W big-endian words of the
    concatenation, zero-filled; overflow (B,) bool: total bits > 32 W,
    whose content past word W is dropped)."""
    if C.dim() != 2:
        raise ValueError("C must be (B, N)")
    B, N = C.shape
    dev = C.device
    _check(C, "C", torch.int32, (B, N), dev)
    _check(L, "L", torch.int32, (B, N), dev)
    if W <= 0:
        raise ValueError("W must be positive")
    if not _on_cuda(C):
        return pack_plain(C, L, W)
    payload = torch.empty((B, 4 * W), dtype=torch.uint8, device=dev)
    ovf = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return payload, ovf
    lib = _build.library()
    scratch = None
    if W > lib.huff_pack_smem_words():
        scratch = torch.zeros((B, W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.huff_pack(
            C.data_ptr(), L.data_ptr(), payload.data_ptr(), ovf.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, N, W,
            _stream(dev))
    _build.check(err, "pack")
    LAUNCHES["pack"] += 1
    return payload, ovf


_M32 = 0xFFFFFFFF


def pack_plain(C: torch.Tensor, L: torch.Tensor, W: int):
    """Twin of :func:`pack`: a cumsum gives each code its bit offset, and
    the code's one or two word pieces are scatter-added into int64 words
    (the pieces of different codes cover disjoint bits, so the sum is the
    OR)."""
    B, N = C.shape
    dev = C.device
    c = C.long() & _M32
    ln = L.long()
    end = torch.cumsum(ln, dim=1)
    off = end - ln
    total = end[:, -1] if N else torch.zeros(B, dtype=torch.int64, device=dev)
    w = off >> 5
    # s: left shift that puts the code's last bit at its place in word w;
    # s < 0 means the code runs -s bits into word w + 1.
    s = 32 - (off & 31) - ln
    live = ln > 0
    hi = torch.where(s >= 0, c << s.clamp(min=0), c >> (-s).clamp(min=0))
    lo = (c << (32 + s).clamp(0, 31)) & _M32
    hi = torch.where(live, hi, 0)
    lo = torch.where(live & (s < 0), lo, 0)
    words = torch.zeros((B, W + 1), dtype=torch.int64, device=dev)
    # Column W collects (and discards) every piece past the budget.
    words.scatter_add_(1, w.clamp(max=W), hi)
    words.scatter_add_(1, (w + 1).clamp(max=W), lo)
    words = words[:, :W]
    payload = torch.stack(
        [(words >> 24) & 255, (words >> 16) & 255, (words >> 8) & 255,
         words & 255], dim=-1).to(torch.uint8).reshape(B, 4 * W)
    return payload, total > 32 * W
