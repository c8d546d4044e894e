"""Batched device encode: (B, N) blocks -> payloads, bit totals and trees.

The PyTorch counterpart of ``libhuffman_tpu/ops/device.py``.  Everything
here operates on a batch of independent fixed-size blocks; ragged blocks
are zero-padded and masked by ``n_valid``.  The stages of
:func:`encode_blocks`:

  * histogram      - K1, a CUDA kernel (ops/kernels.histogram);
  * trees          - K7, a CUDA kernel: every row's merge rounds, with the
                     reference's exact tie-break (src/tree.c:318-414), and
                     its leaf-to-root codeword walk;
  * symbol_layout  - K2, a CUDA kernel;
  * pack           - K3, a CUDA kernel that also writes the payload bytes.

On CPU tensors the kernels' plain-torch twins run instead (ops/kernels.py);
K7's twin is :func:`build_trees` followed by :func:`extract_codes`.
"""

from __future__ import annotations

import torch

from ..format import ASCII_COUNT, HISTOGRAM_LEN
from ..utils.trace import annotate
from . import kernels

MAX_CODE_BITS = 32  # device fast-path limit; deeper blocks are flagged
_BIG = 1 << 62
_DUMP = HISTOGRAM_LEN  # extra column that swallows the writes of idle rows


def build_trees(freqs: torch.Tensor):
    """Batched reference-exact tree build, (B, 512) int32 -> array trees.

    Per round the two smallest non-zero rates merge into node 256 + round,
    ties broken toward the larger slot index (the reference's running
    two-minimum scan uses ``<=``, src/tree.c:329-352, so the last minimum
    wins); the sole survivor is wrapped in a parent with only a left child
    (tree.c:410-413), the unary root.  Rates are kept as the key
    ``rate * 512 + (511 - slot)`` on live slots and ``_BIG`` elsewhere, so
    one row minimum finds both the smallest rate and, among equal rates,
    the largest slot.  A wrapped root's key is retired as well, so a
    finished row has no live slot and every later round leaves it alone.
    The loop runs as many rounds as the busiest row has distinct symbols
    (k symbols take k - 1 merges and one wrap); the remaining of the 256
    rounds of ``libhuffman_tpu.ops.device.build_trees`` change nothing.

    Returns (left, right, parent, pbit, root): (B, 512) int32 x4 and (B,)
    int32, root -1 for an all-zero histogram.  ``pbit`` is each node's
    branch bit within its parent (0 = left child, 1 = right).
    """
    B = freqs.shape[0]
    dev = freqs.device
    i32 = torch.int32
    slot = torch.arange(HISTOGRAM_LEN + 1, device=dev)
    f = torch.nn.functional.pad(freqs.long(), (0, 1))
    key = torch.where(f > 0, f * HISTOGRAM_LEN + (HISTOGRAM_LEN - 1 - slot),
                      _BIG)
    left = torch.full((B, HISTOGRAM_LEN + 1), -1, dtype=i32, device=dev)
    right = left.clone()
    parent = left.clone()
    pbit = torch.zeros((B, HISTOGRAM_LEN + 1), dtype=i32, device=dev)
    root = torch.full((B,), -1, dtype=i32, device=dev)
    rounds = int((freqs[:, :ASCII_COUNT] > 0).sum(dim=1).max()) if B else 0
    for r in range(rounds):
        node = ASCII_COUNT + r
        k1, i1 = key.min(dim=1, keepdim=True)
        key.scatter_(1, i1, _BIG)
        k2, i2 = key.min(dim=1, keepdim=True)
        merge = k2 < _BIG
        wrap = (k1 < _BIG) & ~merge
        upd = merge | wrap
        t1 = torch.where(upd, i1, _DUMP)
        t2 = torch.where(merge, i2, _DUMP)
        tn = torch.where(upd, node, _DUMP)
        tm = torch.where(merge, node, _DUMP)
        rate = (k1 >> 9) + (k2 >> 9)
        new_key = torch.where(
            merge, rate * HISTOGRAM_LEN + (HISTOGRAM_LEN - 1 - node), _BIG)
        key.scatter_(1, t2, _BIG)
        key.scatter_(1, tn, new_key)
        left.scatter_(1, tn, i1.to(i32))
        right.scatter_(1, tm, i2.to(i32))
        parent.scatter_(1, t1, node)
        parent.scatter_(1, t2, node)
        pbit.scatter_(1, t2, 1)
        root = torch.where(wrap[:, 0], node, root)
    n = HISTOGRAM_LEN
    return left[:, :n], right[:, :n], parent[:, :n], pbit[:, :n], root


def extract_codes(parent: torch.Tensor, pbit: torch.Tensor):
    """Per-symbol codewords from parent pointers and branch bits.

    (B, 512) trees -> codes (B, 256) int64 (values < 2^32), lens (B, 256)
    int32, overflow (B,) bool.  Walks each leaf toward the root for
    MAX_CODE_BITS steps; setting the t-th collected bit at position t leaves
    the root-most bit highest, so ``codes`` holds the MSB-first codeword
    value (the reference's reversed string walk, src/tree.c:12-47 and
    encoder.c:106-108).  ``overflow`` flags blocks whose walk did not reach
    the root; encode.py re-encodes those on the host.
    """
    B = parent.shape[0]
    dev = parent.device
    # pp[n] = (parent[n] + 1) | pbit[n] << 10; parent -1 (root/absent) -> 0.
    pp = (parent.long() + 1) | (pbit.long() << 10)
    node = torch.arange(ASCII_COUNT, device=dev).expand(B, -1)
    code = torch.zeros((B, ASCII_COUNT), dtype=torch.int64, device=dev)
    ln = torch.zeros((B, ASCII_COUNT), dtype=torch.int64, device=dev)
    for _ in range(MAX_CODE_BITS):
        e = torch.gather(pp, 1, node)
        p1 = e & 0x3FF
        has = p1 > 0
        code = code | torch.where(has, ((e >> 10) & 1) << ln, 0)
        ln = ln + has.long()
        node = torch.where(has, p1 - 1, node)
    overflow = ((torch.gather(pp, 1, node) & 0x3FF) > 0).any(dim=1)
    return code, ln.to(torch.int32), overflow


def encode_blocks(blocks: torch.Tensor, n_valid: torch.Tensor, W: int):
    """Full batched encode: (B, N) uint8 + valid lengths (B,) int32 ->
    (payload (B, 4W) uint8, total_bits (B,) int64, left, right (B, 512)
    int32, root (B,) int32, overflow (B,) bool).

    ``overflow`` marks blocks encode.py must re-encode on the host: a code
    longer than MAX_CODE_BITS, or a payload longer than W words.
    """
    freqs = kernels.histogram(blocks, n_valid)
    with annotate("huff.encode.trees"):
        left, right, root, codes, lens, code_ovf, total_bits = kernels.trees(
            freqs, blocks.shape[1])
    C, L = kernels.symbol_layout(blocks, codes, lens, n_valid)
    payload, pack_ovf = kernels.pack(C, L, W)
    return payload, total_bits, left, right, root, code_ovf | pack_ovf
