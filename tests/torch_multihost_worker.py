"""One process of the port's multi-process round trip over torch.distributed.

Launched once per rank by tests/test_torch_multihost.py (on the CPU) and by
chip_smoke.py's two-process phase (on the card):

    torch_multihost_worker.py <rendezvous> <num_processes> <process_id> \\
        <outdir> [<device> <input file> <blocksize>]

``rendezvous`` is a ``file://`` or ``tcp://`` URL or a bare ``host:port``.
Without the optional arguments the rank encodes the JAX multihost test's
40 000-byte corpus at blocksize 4096 on the CPU.  Every rank runs the same
program: the sizes-only encode (``encode_stream_multihost_local``), the
full encode, the sizes-only decode and the full decode, and writes the
stream's length and sha256, whether each segment lies at its offset,
whether the decode returned the input, the bytes exchanged between
processes (``DCN_BYTES``) per step, the stream's header-candidate count and
each step's wall seconds to ``<outdir>/out_<process_id>.json``.
"""

import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def corpus() -> bytes:
    """The corpus of tests/test_multihost.py."""
    rng = np.random.default_rng(11)
    return rng.choice(
        np.frombuffer(b"abcdefgh \n", np.uint8), 40_000
    ).astype(np.uint8).tobytes()


def main():
    rendezvous, nproc, pid, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    if len(sys.argv) > 6:
        with open(sys.argv[6], "rb") as f:
            data = f.read()
        blocksize = int(sys.argv[7])
    else:
        data, blocksize = corpus(), 4096
    sys.path.insert(0, ROOT)

    import torch
    import torch.distributed as dist

    if device == "cpu":
        # Ranks share the host's cores with each other and with the tests.
        torch.set_num_threads(1)
    from libhuffman_tpu_torch import decode
    from libhuffman_tpu_torch.parallel import multihost

    multihost.initialize(rendezvous, nproc, pid)
    assert dist.get_world_size() == nproc, dist.get_world_size()
    walls = {}

    # Sizes-only encode: the split's own traffic is 8 bytes per process.
    t0 = time.perf_counter()
    seg, off, total = multihost.encode_stream_multihost_local(
        data, blocksize, device=device)
    walls["encode_local"] = time.perf_counter() - t0
    dcn_local = multihost.DCN_BYTES

    t0 = time.perf_counter()
    stream = multihost.encode_stream_multihost(data, blocksize, device=device)
    walls["encode"] = time.perf_counter() - t0

    # Sizes-only decode: only candidate offsets and (offset, consumed,
    # produced) tables cross between processes.
    dcn_before = multihost.DCN_BYTES
    t0 = time.perf_counter()
    dseg, doff, dtotal = multihost.decode_stream_multihost_local(
        stream, device=device)
    walls["decode_local"] = time.perf_counter() - t0
    dcn_decode_local = multihost.DCN_BYTES - dcn_before

    t0 = time.perf_counter()
    plain = multihost.decode_stream_multihost(stream, device=device)
    walls["decode"] = time.perf_counter() - t0

    with open(os.path.join(outdir, f"out_{pid}.json"), "w") as f:
        json.dump({
            "stream_len": len(stream),
            "stream_sha": hashlib.sha256(stream).hexdigest(),
            "plain_ok": plain == data,
            "seg_ok": stream[off : off + len(seg)] == seg
                      and total == len(stream),
            "seg_len": len(seg),
            "dseg_ok": plain[doff : doff + len(dseg)] == dseg
                       and dtotal == len(plain),
            "dseg_len": len(dseg),
            "dcn_sizes_only": dcn_local,
            "dcn_decode_local": dcn_decode_local,
            "dcn_total": multihost.DCN_BYTES,
            "n_candidates": len(decode.scan_candidates(stream)),
            "walls": walls,
        }, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
