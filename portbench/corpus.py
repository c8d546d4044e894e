"""Seeded stand-ins for the corpora the configurations name.

Neither enwik8 nor the Silesia corpus is in the repository, and nothing may
be fetched, so each configuration file lists its members with their sizes
and the family of synthetic bytes that stands in for each.  The families
are vectorised copies of the JAX benchmark's generators (``text``, ``xray``,
``samba``), built so that a corpus of a few hundred MB takes seconds:

  text   an enwik8-like Zipf mix of 4096 words over letters, markup and a
         rare high-byte tail (about 205 distinct bytes per 64 KiB block);
  xray   12-bit sensor samples packed in bytes: every byte value, mildly
         biased, near-incompressible;
  samba  binary with text: zero runs, little-endian records of small
         values, tables of identifiers and runs of raw bytes.

The bytes of each member are drawn once, from a fixed seed, and the run's
``seed`` orders them: the whole blocks that lie inside one member are
shuffled among themselves, and the blocks that straddle two members stay
where they are.  So every seed compresses the same set of blocks, in tar
order member by member, and a pass does the same work whatever the seed.
With bytes drawn from the run's seed the work moved with it: one Silesia
stand-in in six held a false block header whose u64 length read 151 M, and
its decode took 2.35 s a pass against 0.37 s (PERF.md, Open questions).
"""

from __future__ import annotations

import functools

import numpy as np

_VOCAB_SALT = 0x7E57


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *salt])


def _gather(table: np.ndarray, starts: np.ndarray, lens: np.ndarray,
            n: int) -> np.ndarray:
    """The concatenation of ``table[s : s + l]`` over (starts, lens), cut
    to ``n`` bytes."""
    total = np.cumsum(lens, dtype=np.int64)
    k = min(int(np.searchsorted(total, n)) + 1, len(total))
    starts, lens = starts[:k], lens[:k]
    out_start = np.concatenate(([0], total[: k - 1]))
    idx = np.arange(int(total[k - 1]), dtype=np.int64)
    idx += np.repeat(starts - out_start, lens)
    return table[idx[:n]]


@functools.lru_cache(maxsize=1)
def _text_vocab():
    rng = np.random.default_rng(_VOCAB_SALT)
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    markup = np.frombuffer(b"<>/=\"'[]{}|&#;:.,()-_0123456789ABCDEFGHIJKLMN",
                           np.uint8)
    words = []
    for i in range(4096):
        ln = 1 + int(rng.integers(1, 9))
        r = i % 16
        if r == 13:  # markup-ish token
            w = rng.choice(markup, max(2, ln))
        elif r == 15:  # rare high-byte (UTF-8-ish) token
            w = rng.integers(128, 256, 2).astype(np.uint8)
        else:
            w = rng.choice(letters, ln)
        words.append(np.append(w.astype(np.uint8), np.uint8(32)))
    lens = np.array([len(w) for w in words], np.int64)
    ranks = np.arange(1, 4097, dtype=np.float64)
    cdf = np.cumsum(1 / ranks)
    cdf /= cdf[-1]
    # Zipf draws by lookup: 2^22 equal slices of [0, 1), each mapped to the
    # word its midpoint falls in (an error of at most 2^-22 per word).
    zipf = np.searchsorted(cdf, (np.arange(1 << 22) + 0.5) / (1 << 22))
    mean = float(np.dot(np.diff(cdf, prepend=0.0), lens))
    mat = np.zeros((4096, int(lens.max())), np.uint8)
    for i, w in enumerate(words):
        mat[i, : len(w)] = w
    return mat, lens, zipf, mean


def text(n: int, rng: np.random.Generator) -> np.ndarray:
    mat, lens, zipf, mean = _text_vocab()
    w = zipf[rng.integers(0, len(zipf), int(n / mean * 1.01) + 64)]
    while int(lens[w].sum()) < n:
        w = np.concatenate((w, zipf[rng.integers(0, len(zipf), 1024)]))
    # Each word's row of the padded vocabulary, its padding masked out.
    keep = np.arange(mat.shape[1]) < lens[w][:, None]
    return mat[w][keep][:n]


def xray(n: int, rng: np.random.Generator) -> np.ndarray:
    raw = rng.normal(2048, 600, (n + 1) // 2).clip(0, 4095).astype("<u2")
    return raw.view(np.uint8)[:n]


@functools.lru_cache(maxsize=1)
def _samba_idents():
    rng = np.random.default_rng(_VOCAB_SALT + 1)
    chars = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz_", np.uint8)
    ids = [np.append(rng.choice(chars, int(rng.integers(4, 13))), np.uint8(0))
           for _ in range(256)]
    lens = np.array([len(i) for i in ids], np.int64)
    return np.concatenate(ids), np.cumsum(lens) - lens, lens


def samba(n: int, rng: np.random.Generator) -> np.ndarray:
    """Segments of four kinds in a seeded order, each sized as in the JAX
    benchmark's generator: a zero run (64-4095 bytes), 1024 LE u32 records
    below 2^4..2^19, 512 NUL-terminated identifiers, raw bytes
    (512-8191)."""
    itab, istart, ilen = _samba_idents()
    parts, size = [], 0
    while size < n:
        k = 4096
        kinds = rng.integers(0, 4, k)
        zlen = rng.integers(64, 4096, k)
        bits = rng.integers(4, 20, k)
        rlen = rng.integers(512, 8192, k)
        for i in range(k):
            kind = kinds[i]
            if kind == 0:
                seg = np.zeros(int(zlen[i]), np.uint8)
            elif kind == 1:
                seg = rng.integers(0, 1 << int(bits[i]), 1024,
                                   dtype=np.uint32).view(np.uint8)
            elif kind == 2:
                pick = rng.integers(0, 256, 512)
                seg = _gather(itab, istart[pick], ilen[pick],
                              int(ilen[pick].sum()))
            else:
                seg = rng.integers(0, 256, int(rlen[i]), dtype=np.uint8)
            parts.append(seg)
            size += len(seg)
            if size >= n:
                break
    return np.concatenate(parts)[:n]


FAMILIES = {"text": text, "xray": xray, "samba": samba}


POOL_SEED = 0


def members(config: dict) -> np.ndarray:
    """The members' bytes in order, each from its family, drawn from
    ``POOL_SEED``."""
    out = np.empty(int(config["total_bytes"]), np.uint8)
    off = 0
    for i, m in enumerate(config["members"]):
        n = int(m["bytes"])
        out[off : off + n] = FAMILIES[m["family"]](n, _rng(POOL_SEED, i))
        off += n
    if off != len(out):
        raise ValueError(f"members add up to {off} bytes, not "
                         f"total_bytes {len(out)}")
    return out


def build(config: dict, seed: int) -> np.ndarray:
    """The corpus of a run: the members' bytes with the whole blocks inside
    each member in an order drawn from ``seed``."""
    data = members(config)
    N = int(config["blocksize"])
    nfull = len(data) // N
    ends = np.cumsum([int(m["bytes"]) for m in config["members"]])
    # The member holding each whole block's first and last byte.
    first = np.searchsorted(ends, np.arange(nfull) * N, side="right")
    last = np.searchsorted(ends, np.arange(nfull) * N + N - 1, side="right")
    rng = _rng(seed, 0xB10C)
    blocks = data[: nfull * N].reshape(nfull, N)
    order = np.arange(nfull)
    for m in range(len(ends)):
        inside = np.flatnonzero((first == m) & (last == m))
        order[inside] = rng.permutation(inside)
    blocks[:] = blocks[order]
    return data


def scaled(config: dict, max_bytes: int) -> dict:
    """The configuration with each member cut in proportion so that the
    corpus holds about ``max_bytes`` (for tests on the CPU)."""
    f = min(1.0, max_bytes / int(config["total_bytes"]))
    members = [dict(m, bytes=max(1, int(int(m["bytes"]) * f)))
               for m in config["members"]]
    return dict(config, members=members,
                total_bytes=sum(m["bytes"] for m in members))
