"""Batched device decode: resolve, chain, emission and bookkeeping.

The counterpart of ``libhuffman_tpu/ops/decode_v3.py`` ``decode_blocks``.
For a plan of B blocks of NP bit positions each:

  K5 resolve   the codeword entry at every bit position (ops/kernels.resolve)
  K6 chain     the start set (the orbit of position 0 under p -> p + len(p))
               with each 8-position group's symbols, counts and running
               totals
  K4 emit      the symbol strings of the groups before each block's staged
               payload end joined into the output bytes (zero padding past
               it decodes as dense garbage starts, which K4 leaves out)
  bookkeeping  the reference's end-of-block and corruption verdicts
               (src/decoder.c:52-91): end bit of the n_sym-th symbol,
               whether a dead position started within n_sym, its fail bit

Every plane is natural-order and block-major, so the bookkeeping is a few
``torch.gather`` picks per block; it stays plain torch (the TPU computed it
in XLA, not in a Pallas kernel).
"""

from __future__ import annotations

import torch

from . import kernels


def _pick(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane[b, idx[b]] for every block (idx (B,) int64) -> (B,) int64."""
    return torch.gather(plane, 1, idx[:, None]).squeeze(1).long()


def _nth_start(start, gc4, gr32, target):
    """Position of each block's target-th start (1-based; target <= the
    block's total): the stripe from the running totals, the group from its
    four counts, the position from the group's start byte."""
    dev = start.device
    hit = (gr32.long() >= target[:, None]).to(torch.uint8)
    cell = torch.argmax(hit, dim=1)                  # first such stripe
    before = torch.where(cell > 0,
                         _pick(gr32, (cell - 1).clamp(min=0)), 0)
    shifts = torch.arange(0, 32, 8, device=dev)
    cnts = (_pick(gc4, cell)[:, None] >> shifts) & 255          # (B, 4)
    incl = before[:, None] + torch.cumsum(cnts, dim=1)
    k = torch.argmax((incl >= target[:, None]).to(torch.uint8), dim=1)
    before_g = torch.gather(incl - cnts, 1, k[:, None]).squeeze(1)
    g = 4 * cell + k
    sbyte = (_pick(start, cell) >> (8 * k)) & 255
    bits = (sbyte[:, None] >> torch.arange(8, device=dev)) & 1  # (B, 8)
    rank = torch.cumsum(bits, dim=1)
    want = (target - before_g)[:, None]
    j = torch.argmax(((rank == want) & (bits == 1)).to(torch.uint8), dim=1)
    return 8 * g + j


def decode_blocks(words: torch.Tensor, tables: torch.Tensor,
                  n_sym: torch.Tensor, n_cap: torch.Tensor, NP: int,
                  OUTW: int, NS: int):
    """Decode a plan of blocks (decode_v3.py:489-635).

    words (B, NP/32 + 128) int32 big-endian payload words (zero-padded),
    tables (B, 13, 128) int32 native resolve tables, n_sym (B,) int32
    symbols to restore, n_cap (B,) int32 staged payload bytes (= live
    emission groups), NP bit positions per block (a multiple of 32), OUTW
    output words per block (4 OUTW >= max n_sym), NS lookup stages.

    Returns (out, end_bit, corrupt, bad_bit, emit_ovf):
      out (B, 4 OUTW) uint8: decoded bytes, valid through n_sym[b];
      end_bit (B,) int64: bit offset after the n_sym-th symbol, NP when the
        chain ends before it (a short read);
      corrupt (B,) bool: a dead position started within the first n_sym
        symbols;
      bad_bit (B,) int64: the failing bit (the dead start plus its fail
        offset);
      emit_ovf (B,) bool: always False (the port's emission has no clamp).
    """
    if words.shape[1] != NP // 32 + 128:
        raise ValueError(f"words must have NP/32 + 128 = {NP // 32 + 128} "
                         f"columns, got {words.shape[1]}")
    meta = kernels.resolve(words, tables, NS)
    start, gw, gc4, gr32 = kernels.chain(meta)
    out = kernels.emit(gw, gc4, gr32, n_cap, OUTW)
    end_bit, corrupt, bad_bit = bookkeeping(meta, start, gc4, gr32, n_sym, NP)
    return out, end_bit, corrupt, bad_bit, torch.zeros_like(corrupt)


def bookkeeping(meta, start, gc4, gr32, n_sym, NP: int):
    """The reference's verdicts (decoder.c:52-91) from the chain's planes:
    (end_bit, corrupt, bad_bit) as :func:`decode_blocks` returns them."""
    n = n_sym.long()
    total = gr32[:, -1].long()
    # The n_sym-th start ends the block at its start plus its length.
    reached = total >= n
    p_end = _nth_start(start, gc4, gr32, torch.minimum(n.clamp(min=1), total))
    end_bit = torch.where(reached, p_end + (_pick(meta, p_end) & 63), NP)
    # The chain is one orbit and ends at its first dead start, so a started
    # dead position can only be the last start.  Without one, the failing
    # bit is read at position 0, as decode_v3's first-match search gives.
    p_last = _nth_start(start, gc4, gr32, total)
    anybad = (_pick(meta, p_last) & 63) == 0
    fb = torch.where(anybad, p_last, 0)
    corrupt = anybad & (total <= n)
    bad_bit = fb + ((_pick(meta, fb) >> 6) & 255)
    return end_bit, corrupt, bad_bit
