"""Plain NumPy codec of the libhuffman block format: the benchmark's yardstick.

Written from the format's description alone (SURVEY.md section 2.9 and the
C sources it cites); it imports nothing of the program under test.  A
stream is a concatenation of independent blocks, each

    u64 LE   bytes of input in the block
    i16 LE   tree length n (int16 entries)
    i16[n]   preorder tree: node index, left subtree, right subtree, -1 for
             a missing child (a leaf is ``symbol, -1, -1``)
    u8[...]  the codewords, MSB first, zero-padded to a whole byte

The tree is built over 512 slots: slot s < 256 is the leaf of byte s, and
merge round r creates node 256 + r.  Each round merges the two smallest
non-zero rates, the first taken as the left child; among equal rates the
larger slot is taken first (the C scan compares with ``<=``).  The last
survivor becomes the only (left) child of a unary root, so every codeword
starts with a 0 bit.

:func:`encode` is vectorised over chunks of blocks so that it can check a
whole corpus of a few hundred MB in seconds; :func:`decode` is a plain bit
walk for the tests' small inputs.  ``tie_break="smaller"`` gives the
control: a valid Huffman code with the other tie-break, which breaks the
format's guarantee of the reference's exact bytes.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

HEADER = struct.Struct("<Qh")
MAX_CODE_BITS = 57  # a code and its 64-bit word offset fit in two words


def build_tree(hist: np.ndarray, tie_break: str = "larger"):
    """(left, right, parent, root) over 512 slots for one block's 256
    counts; root -1 for an empty block."""
    left = [-1] * 512
    right = [-1] * 512
    parent = [-1] * 512
    sign = -1 if tie_break == "larger" else 1
    heap = [(int(c), sign * s) for s, c in enumerate(hist.tolist()) if c]
    heapq.heapify(heap)
    node = 256
    root = -1
    while heap:
        r1, k1 = heapq.heappop(heap)
        i1 = sign * k1
        if not heap:
            left[node] = i1
            parent[i1] = node
            root = node
            break
        r2, k2 = heapq.heappop(heap)
        i2 = sign * k2
        left[node], right[node] = i1, i2
        parent[i1] = parent[i2] = node
        heapq.heappush(heap, (r1 + r2, sign * node))
        node += 1
    return left, right, parent, root


def serialize_tree(left, right, root) -> bytes:
    """The preorder int16 wire form of a tree (empty for root -1)."""
    out = []
    stack = [root] if root >= 0 else []
    while stack:
        n = stack.pop()
        out.append(n)
        if n >= 0:
            stack.append(right[n])
            stack.append(left[n])
    return np.asarray(out, dtype="<i2").tobytes()


def code_table(parent: np.ndarray, left: np.ndarray):
    """Codes (uint64, MSB-first value) and lengths of the 256 leaves of
    each row of ``parent`` / ``left`` ((B, 512) int64)."""
    B = parent.shape[0]
    rows = np.arange(B)[:, None]
    node = np.broadcast_to(np.arange(256), (B, 256)).copy()
    code = np.zeros((B, 256), np.uint64)
    ln = np.zeros((B, 256), np.int64)
    for _ in range(MAX_CODE_BITS + 1):
        p = parent[rows, node]
        has = p >= 0
        if not has.any():
            return code, ln
        bit = (left[rows, np.where(has, p, 0)] != node) & has
        code |= bit.astype(np.uint64) << ln.astype(np.uint64)
        ln += has
        node = np.where(has, p, node)
    raise ValueError(f"a code is longer than {MAX_CODE_BITS} bits")


def pack(block: np.ndarray, codes: np.ndarray, lens: np.ndarray,
         total_bits: int) -> bytes:
    """One block's payload: its codewords MSB first, zero-padded to a byte.

    A code touches at most two 64-bit words.  The part in its first word is
    summed per word (codes never share a bit, so the sum is their OR), and
    at most one code spills into any word.  One block at a time keeps the
    temporaries in the CPU's cache."""
    L = lens[block]
    C = codes[block]
    pos = np.cumsum(L)
    pos -= L
    w = pos >> 6
    end = pos & 63
    end += L
    shift = 64 - end
    np.maximum(shift, 0, out=shift)
    hi = C << shift.astype(np.uint64)
    spill = np.flatnonzero(end > 64)
    hi[spill] = C[spill] >> (end[spill] - 64).astype(np.uint64)
    out = np.zeros((total_bits + 63) // 64 + 1, np.uint64)
    if len(w):
        starts = np.flatnonzero(np.diff(w, prepend=-1))
        out[w[starts]] = np.add.reduceat(hi, starts)
    out[w[spill] + 1] |= C[spill] << (128 - end[spill]).astype(np.uint64)
    return out.byteswap().view(np.uint8)[: (total_bits + 7) // 8].tobytes()


def encode_blocks(blocks: list[np.ndarray], tie_break: str = "larger"
                  ) -> list[bytes]:
    """The wire bytes of each of ``blocks`` (uint8 arrays)."""
    B = len(blocks)
    hist = np.zeros((B, 256), np.int64)
    for i, b in enumerate(blocks):
        hist[i] = np.bincount(b, minlength=256)
    left = np.full((B, 512), -1, np.int64)
    parent = np.full((B, 512), -1, np.int64)
    heads = []
    for i in range(B):
        lt, rt, pt, root = build_tree(hist[i], tie_break)
        left[i], parent[i] = lt, pt
        tree = serialize_tree(lt, rt, root)
        heads.append(HEADER.pack(len(blocks[i]), len(tree) // 2) + tree)
    codes, lens = code_table(parent, left)
    total_bits = (hist * lens).sum(axis=1)
    return [h + pack(b, codes[i], lens[i], int(total_bits[i]))
            for i, (h, b) in enumerate(zip(heads, blocks))]


def encode(data, blocksize: int, tie_break: str = "larger",
           chunk_blocks: int = 64) -> bytes:
    """Whole-input encode in independent blocks of ``blocksize`` bytes (the
    ragged tail is its own block; 0 = one block of the whole input),
    ``chunk_blocks`` blocks at a time so that a large input never has all
    its temporaries at once."""
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else np.asarray(data, np.uint8).reshape(-1)
    n = len(buf)
    if blocksize <= 0:
        blocksize = max(n, 1)
    out = []
    for off in range(0, n, blocksize * chunk_blocks):
        part = buf[off : off + blocksize * chunk_blocks]
        out += encode_blocks([part[i : i + blocksize]
                              for i in range(0, len(part), blocksize)],
                             tie_break)
    return b"".join(out)


def _deserialize(tree: np.ndarray):
    """Preorder wire tree -> (left, right, index) over preorder node ids."""
    left, right, index = [], [], []
    pos = 0

    def node():
        nonlocal pos
        if pos >= len(tree) or tree[pos] < 0:
            pos += 1
            return -1
        me = len(index)
        index.append(int(tree[pos]))
        left.append(-1)
        right.append(-1)
        pos += 1
        left[me] = node()
        right[me] = node()
        return me

    root = node() if len(tree) else -1
    return left, right, index, root


def decode(stream: bytes) -> bytes:
    """Whole-stream decode by a bit walk; raises ValueError on a stream
    that ends early or walks into a missing child."""
    mv = memoryview(stream)
    out = bytearray()
    off = 0
    while off < len(mv):
        if off + HEADER.size > len(mv):
            raise ValueError("truncated block header")
        n_sym, tlen = HEADER.unpack_from(mv, off)
        off += HEADER.size
        tree = np.frombuffer(mv, "<i2", count=tlen, offset=off)
        off += 2 * tlen
        left, right, index, root = _deserialize(tree)
        bits = np.unpackbits(np.frombuffer(mv, np.uint8, offset=off))
        i = 0
        for _ in range(n_sym):
            cur = root
            while left[cur] >= 0 or right[cur] >= 0:
                if i >= len(bits):
                    raise ValueError("stream ends inside a block")
                cur = right[cur] if bits[i] else left[cur]
                i += 1
                if cur < 0:
                    raise ValueError("walk into a missing child")
            out.append(index[cur] & 0xFF)
        off += (i + 7) // 8
    return bytes(out)
