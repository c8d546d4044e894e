"""Multi-process codec: process-parallel encode and decode, ordered assembly.

The counterpart of ``libhuffman_tpu/parallel/multihost.py`` over
``torch.distributed`` with the gloo backend.  Two layers of parallelism
compose:

  * within a process, the block axis splits over a list of devices
    (parallel/shard.py);
  * across processes, block *ranges* split by rank; the only traffic
    between processes is the all-gather of per-range compressed sizes
    (tiny) and, for the same-bytes-everywhere entry points, the final
    ordered byte gather.

Every block is self-contained (own header, own tree, byte-aligned), so a
contiguous range of blocks encodes to a self-contained byte string, and the
concatenation of the ranges in rank order *is* the stream.  An exclusive
scan of the gathered sizes gives every process its byte offset.

Everything exchanged lives on the host (CPU int64 and uint8 tensors), which
is why the backend is gloo: it also lets two ranks share one GPU, which
NCCL refuses.

Usage (one call per process, the same arguments everywhere):

    initialize("tcp://host:port" or "host:port" or "file:///path",
               num_processes, process_id)                  # once
    stream = encode_stream_multihost(data, blocksize)      # same bytes
    plain = decode_stream_multihost(stream)                # on every rank

A single process skips every exchange, so the same code runs unchanged
from one process to many.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch
import torch.distributed as dist

from .. import decode as _decode_mod
from .. import encode as _encode_mod
from .shard import BlockMesh, encode_stream_sharded, resolve_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, **kwargs) -> None:
    """Join the gloo process group (a no-op for a single process).

    ``coordinator_address``: a ``tcp://`` or ``file://`` URL, passed on as
    the rendezvous, or a bare ``host:port``, which becomes ``tcp://``."""
    if num_processes is None or num_processes <= 1:
        return
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


# Bytes exchanged between processes (the tests and the smoke bound the
# sizes-only paths by it).
DCN_BYTES = 0


def _count_dcn(n: int) -> None:
    global DCN_BYTES
    DCN_BYTES += int(n)


def _allgather(local: torch.Tensor, nproc: int) -> torch.Tensor:
    """Every process's equal-shape CPU tensor, stacked in rank order."""
    parts = [torch.empty_like(local) for _ in range(nproc)]
    dist.all_gather(parts, local)
    return torch.stack(parts)


def _allgather_sizes(local_size: int) -> np.ndarray:
    """All processes' sizes, in process order."""
    nproc = _process_count()
    if nproc == 1:
        return np.asarray([local_size], np.int64)
    _count_dcn(8 * nproc)
    mine = torch.tensor([local_size], dtype=torch.int64)
    return _allgather(mine, nproc).numpy().reshape(nproc)


def _padded(local: bytes, cap: int) -> torch.Tensor:
    padded = np.zeros(cap, np.uint8)
    padded[: len(local)] = np.frombuffer(local, np.uint8)
    return torch.from_numpy(padded)


def _allgather_bytes(local: bytes) -> list[bytes]:
    """Gather one byte string from every process, in process order."""
    nproc = _process_count()
    if nproc == 1:
        return [local]
    sizes = _allgather_sizes(len(local))
    cap = int(sizes.max())
    if cap == 0:
        # Every string is empty; the size exchange above already
        # synchronized every rank, and a zero-length gather is skipped.
        return [b""] * nproc
    _count_dcn(cap * nproc)
    gathered = _allgather(_padded(local, cap), nproc).numpy()
    return [gathered[i, : sizes[i]].tobytes() for i in range(nproc)]


def _broadcast_bytes(local: bytes) -> bytes:
    """Rank 0's byte string on every process (others contribute nothing)."""
    nproc = _process_count()
    if nproc == 1:
        return local
    mine = local if _process_index() == 0 else b""
    sizes = _allgather_sizes(len(mine))
    cap = int(sizes[0])
    if cap == 0:
        # A zero-length rank-0 payload: the size exchange above already
        # synchronized every rank, so no zero-length gather is made.
        return b""
    _count_dcn(cap * nproc)
    return _allgather(_padded(mine, cap), nproc)[0].numpy().tobytes()


def _my_range(n_items: int) -> tuple[int, int]:
    """Contiguous [lo, hi) item range owned by this process."""
    nproc = _process_count()
    pid = _process_index()
    per = -(-n_items // nproc)
    lo = min(pid * per, n_items)
    return lo, min(lo + per, n_items)


def encode_stream_multihost_local(data, blocksize: int,
                                  mesh: BlockMesh | None = None,
                                  device="cuda"):
    """Encode this process's block range locally; gather SIZES only.

    Each process encodes its contiguous block range (over ``mesh`` when
    given, else on ``device``) and keeps the bytes; the only traffic is the
    all-gather of per-range compressed sizes (8 bytes per process).
    Returns ``(local_segment, offset, total_size)``: the caller writes its
    segment at ``offset`` (a shared file system, an object store, a
    rank-ordered send), and the segments in rank order ARE the stream.
    """
    buf = np.frombuffer(bytes(data), np.uint8)
    n = len(buf)
    if n == 0:
        return b"", 0, 0
    bs = blocksize if blocksize > 0 else n
    nblocks = -(-n // bs)
    lo, hi = _my_range(nblocks)
    local_bytes = buf[lo * bs : min(hi * bs, n)].tobytes()
    if mesh is not None and local_bytes:
        local_stream = encode_stream_sharded(
            np.frombuffer(local_bytes, np.uint8), bs, mesh)
    else:
        local_stream = (_encode_mod.encode(local_bytes, bs, device=device)
                        if local_bytes else b"")
    sizes = _allgather_sizes(len(local_stream))
    pid = _process_index()
    offset = int(sizes[:pid].sum())
    return local_stream, offset, int(sizes.sum())


def encode_stream_multihost(data, blocksize: int,
                            mesh: BlockMesh | None = None,
                            device="cuda") -> bytes:
    """Encode across processes; every process returns the full stream.

    The sizes-only split (:func:`encode_stream_multihost_local`) plus the
    full-payload all-gather that the same-bytes-everywhere contract needs;
    callers who write rank-local segments use the ``_local`` variant and
    skip the payload gather.
    """
    local_stream, _off, total = encode_stream_multihost_local(
        data, blocksize, mesh, device)
    if total == 0:
        return b""
    return b"".join(_allgather_bytes(local_stream))


def decode_stream_multihost_local(stream: bytes, device="cuda"
                                  ) -> tuple[bytes, int, int]:
    """The sizes-only split, decode side: every process runs the device
    work for ITS slice of header candidates on ``device`` and keeps the
    decoded bytes; the only traffic is the candidate-offset broadcast plus
    the all-gather of (offset, consumed, produced) TABLES (24 bytes per
    resolved candidate).  Every process walks the chain over the merged
    table (host work, cheap, deterministic) and returns
    ``(local_segment, offset, total_size)``: candidate ranges are
    contiguous in stream order, so the rank-ordered concatenation of the
    segments IS the decoded output.

    Chain gaps (candidates nobody resolved: blocks the device left to the
    host, missed candidates) are decoded host-exactly on every rank (each
    rank needs the block's consumed and produced sizes to continue its
    walk), and their bytes belong to the rank owning the preceding
    candidate.  Errors raise with the reference's semantics identically on
    every rank (src/decoder.c:218-275).
    """
    nproc = _process_count()
    if nproc == 1:
        out = _decode_mod.decode(stream, device=device)
        return out, 0, len(out)

    buf = np.frombuffer(stream, np.uint8)
    # Rank 0 runs the header scan once and broadcasts the candidate
    # offsets; other ranks only re-parse headers at those offsets
    # (identical results by construction: parse_block_header is
    # deterministic on the replicated stream bytes).
    if _process_index() == 0:
        cands = _decode_mod.scan_candidates(buf)
        _broadcast_bytes(
            np.asarray([c.off for c in cands], np.int64).tobytes())
    else:
        offs = np.frombuffer(_broadcast_bytes(b""), np.int64)
        cands = _decode_mod.scan_candidates(buf, offsets=offs)
    me = _process_index()
    lo, hi = _my_range(len(cands))
    _decode_mod._decode_candidates_device(
        buf, cands[lo:hi],
        BlockMesh((resolve_device(device),)))

    # Sizes-only exchange: (offset, consumed, produced) per resolved
    # candidate; the payload bytes stay on the resolving rank.
    mine = [(c.off, c.result[1], len(c.result[0])) for c in cands[lo:hi]
            if c.result is not None]
    local_bytes = {c.off: c.result[0] for c in cands[lo:hi]
                   if c.result is not None}
    tables = _allgather_bytes(
        np.asarray(mine, np.int64).reshape(-1, 3).tobytes())
    results: dict[int, tuple[int, int, int]] = {}
    for rank, tbl in enumerate(tables):
        for off, cns, prod in np.frombuffer(tbl, np.int64
                                            ).reshape(-1, 3).tolist():
            results[int(off)] = (rank, int(cns), int(prod))

    # Ownership of chain pieces: resolved candidates belong to their
    # resolving rank; gap pieces to the rank owning the preceding
    # candidate (keeps the owner sequence monotone in chain order).
    cand_offs = [c.off for c in cands]
    per = -(-len(cands) // nproc) if cands else 1

    def owner_of_gap(off: int) -> int:
        idx = bisect.bisect_right(cand_offs, off) - 1
        return 0 if idx < 0 else min(idx // per, nproc - 1)

    cand_by_off = {c.off: c for c in cands}
    segment = []
    seg_offset = 0
    total = 0
    off = 0
    while off < len(stream):
        hit = results.get(off)
        if hit is not None:
            owner, consumed, produced = hit
            if owner == me:
                segment.append(bytes(local_bytes[off]))
            off = cand_by_off[off].payload_off + consumed
        else:
            # Gap: host-exact chain-prefix decode, every rank.
            piece, new_off = _decode_mod.decode_prefix(
                bytes(stream[off:]), use_device=False)
            if new_off == 0:
                # errors propagate with reference semantics on all ranks
                _decode_mod.decode(bytes(stream[off:]), use_device=False)
                break
            produced = len(piece)
            owner = owner_of_gap(off)
            if owner == me:
                segment.append(piece)
            off += new_off
        if owner < me:
            # Owners are monotone in chain order (contiguous candidate
            # ranges), so this sum is exactly my segment's byte offset.
            seg_offset += produced
        total += produced
    return b"".join(segment), seg_offset, total


def decode_stream_multihost(stream: bytes, device="cuda") -> bytes:
    """Decode across processes; every process returns the full output.

    The sizes-only split (:func:`decode_stream_multihost_local`) plus the
    rank-ordered payload all-gather that the same-bytes-everywhere contract
    needs; callers who write rank-local segments use the ``_local`` variant
    and skip the payload gather.
    """
    if _process_count() == 1:
        return _decode_mod.decode(stream, device=device)
    segment, _off, total = decode_stream_multihost_local(stream, device)
    if total == 0:
        return b""
    return b"".join(_allgather_bytes(segment))
