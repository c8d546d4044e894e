"""Encode and decode with the block axis split over a list of torch devices.

The counterpart of ``libhuffman_tpu/parallel/shard.py``.  A (B, ...) block
batch or device plan is cut into one contiguous row slice per device of a
:class:`BlockMesh`; each slice runs the single-device stages
(``ops/device.encode_blocks``, ``ops/decode.decode_blocks``) on its own
device, and the host joins the results in block order.  Blocks are
independent, so no slice needs another's data: the JAX package's shard_map
has no collective either, and its gathers become the copies back to the
host.

:func:`run_slices` copies every slice's inputs to its device, then launches
every slice, and copies nothing back: the caller's first ``.cpu()`` comes
after the last launch, so work queued on one card runs while the host
launches the next card's slice.  One card listed twice runs its slices one
after the other on its stream; that is how a one-card machine exercises the
split.

The single-device encode and decode run through here as well, with a mesh
of one device, so the split is the only difference between the routes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..format import ArrayTree, pack_block, serialize_tree
from ..ops import decode as ddec
from ..ops import device as dev
from ..ops import hostref


@dataclasses.dataclass(frozen=True)
class BlockMesh:
    """The devices that share the block axis, in block order.

    Unlike ``torch.distributed.DeviceMesh`` it needs no process group and
    may list one device more than once."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a BlockMesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def resolve_device(device) -> torch.device:
    """The torch device the kernels run on.  CUDA must be present unless
    the caller asked for the CPU by name: there is no silent CPU route."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain-torch twins of the kernels")
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


def block_mesh(devices=None) -> BlockMesh:
    """Mesh over ``devices`` (names or torch.device; default: every visible
    CUDA device).  Raises without CUDA unless every device is named, e.g.
    ``block_mesh(["cpu", "cpu"])`` for the kernels' plain-torch twins."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; name the devices, e.g. "
                "block_mesh(['cpu', 'cpu']), to split over the plain-torch "
                "twins of the kernels")
        devices = range(torch.cuda.device_count())
    out = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return BlockMesh(tuple(out))


def tensor_on(a, device: torch.device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device``; uint32 crosses as its int32
    bit pattern (the port's carrier for 32-bit words)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def run_slices(fn, arrays, mesh: BlockMesh) -> list:
    """``fn(*slices)`` on each device's contiguous row slice of the host
    arrays ``arrays`` (equal row counts, a positive multiple of the mesh
    size): every slice is copied to its device, then every slice is
    launched.  Returns fn's results in mesh (= block) order, on the
    devices; nothing is copied back."""
    B = len(arrays[0])
    if B == 0 or B % mesh.size:
        raise ValueError(f"{B} rows do not split into {mesh.size} non-empty "
                         f"slices (pad with empty blocks)")
    per = B // mesh.size
    staged = [[tensor_on(a[i * per : (i + 1) * per], d) for a in arrays]
              for i, d in enumerate(mesh.devices)]
    return [fn(*ins) for ins in staged]


def gather(results) -> tuple:
    """Per-slice result tuples (tensors) -> one host numpy array per
    output, rows in block order (one slice: its copy, no join)."""
    if len(results) == 1:
        return tuple(t.cpu().numpy() for t in results[0])
    return tuple(np.concatenate([r[k].cpu().numpy() for r in results])
                 for k in range(len(results[0])))


def encode_sharded(batch: np.ndarray, n_valid: np.ndarray, mesh: BlockMesh,
                   words_per_block: int | None = None):
    """Encode a (B, N) uint8 block batch split over ``mesh``.

    B must be a multiple of the mesh size (pad with n_valid == 0 blocks).
    Returns host numpy (payload (B, 4 W) uint8, total_bits, left, right,
    root, overflow), as ``ops/device.encode_blocks`` gives them.
    ``words_per_block`` W: the payload word budget; defaults to the worst
    case of N words (32 bits per byte).  The JAX package's ``capw`` clamp
    fits TPU VMEM and has no counterpart here."""
    W = words_per_block or batch.shape[1]
    return gather(run_slices(
        lambda b, nv: dev.encode_blocks(b, nv, W),
        (batch, np.asarray(n_valid, np.int32)), mesh))


def _decode_slices(words, tables, n_sym, n_cap, NP, OUTW, NS, mesh):
    return run_slices(
        lambda w, t, n, c: ddec.decode_blocks(w, t, n, c, NP, OUTW, NS),
        (words, tables, n_sym, n_cap), mesh)


def decode_blocks_sharded(words, tables, n_sym, n_cap, NP: int, OUTW: int,
                          NS: int, mesh: BlockMesh):
    """``ops/decode.decode_blocks`` on one plan's rows split over ``mesh``
    (host numpy in, host numpy out: out, end_bit, corrupt, bad_bit,
    emit_ovf).  The row count must be a multiple of the mesh size."""
    return gather(_decode_slices(words, tables, n_sym, n_cap, NP, OUTW, NS,
                                 mesh))


def decode_plans_sharded(plans, mesh: BlockMesh) -> list[tuple]:
    """Every device plan of a stream with its rows split over ``mesh``:
    per plan, the host numpy (out, end_bit, corrupt, bad_bit) that
    ``decode._apply_plan_results`` takes.  Plans are padded to a multiple
    of the mesh size by ``decode._build_plans(lane_mult=...)``.  One plan
    at a time: its slices are all launched before its results come back."""
    return [gather([r[:4] for r in _decode_slices(
                p.words, p.tables, p.n_sym, p.caps, p.NP, p.OUTW, p.ns,
                mesh)])
            for p in plans]


def encode_stream_sharded(buf: np.ndarray, blocksize: int,
                          mesh: BlockMesh) -> bytes:
    """Whole-stream encode over ``mesh``: ``encode.encode``'s batching with
    256 blocks per device in each batch (the JAX package's groups and
    EncodeConfig's default), the last batch padded with empty blocks to a
    multiple of the mesh size; blocks over 2 MiB take the host-exact
    codec, as in ``encode.encode``."""
    from ..encode import encode_stream  # the layer above imports this one

    return encode_stream(np.asarray(buf, np.uint8), blocksize, 256, mesh)


def assemble_stream(n_valid, total_bits, payload, left, right, root,
                    overflow, batch=None, counts=None) -> bytes:
    """Ordered host assembly of a sharded encode's outputs.

    The per-block compressed size is header + ceil(total_bits/8); the
    blocks' bytes are joined in block order (reference emit order,
    src/encoder.c:325-351), empty (n_valid == 0) blocks left out, and a
    block flagged in ``overflow`` re-encoded on the host from ``batch``
    (each one counted in ``counts["host_reencoded_blocks"]`` when given).
    ``payload`` may be any prefix of the rows' words that holds every
    block's bytes."""
    trees = lens_t = None
    if native.available():
        trees, lens_t = native.serialize_trees(left, right, root)
    plens = (np.asarray(total_bits).astype(np.int64) + 7) // 8
    if trees is not None and not np.asarray(overflow).any():
        # Whole-batch native assembly, in one pass.
        return native.assemble_blocks(n_valid, trees, lens_t, payload, plens)

    out = []
    for b in range(len(n_valid)):
        nv = int(n_valid[b])
        if nv == 0:
            continue
        if overflow[b]:
            if batch is None:
                raise ValueError("an overflow block needs the raw input")
            if counts is not None:
                counts["host_reencoded_blocks"] += 1
            out.append(hostref.encode_block(batch[b, :nv]))
            continue
        if trees is not None:
            tree = trees[b, : lens_t[b]]
        else:
            tree = serialize_tree(ArrayTree(left[b], right[b], int(root[b])))
        out.append(pack_block(nv, tree, payload[b, : plens[b]].tobytes()))
    return b"".join(out)
