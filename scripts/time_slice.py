"""Time the port's end-to-end slice on one CUDA card, for one or more trees.

    python3 scripts/time_slice.py ROOT [ROOT ...]

Each ROOT is a checkout of this repo.  For each, in the order given, a fresh
process imports ROOT's ``libhuffman_tpu_torch`` (its kernels built into
ROOT/build), encodes 64 MiB of the ``text`` and ``mixed`` corpora
(bench/corpora.py of the tree holding this script) at 64 KiB blocks with
``encode.encode`` and decodes the stream with ``decode.decode`` on the device
route, REPS times each after one warm-up, checks that every stream is the
same and decodes to the input, and prints one JSON line of the wall times
and GB/s.  List two trees as A B B A to compare them within one call, so
that a drift of the host's pace over the call falls on both.  The card's
name and power limit (nvidia-smi) come first.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent
N = 65536                # blocksize of the slice
SLICE_BYTES = 64 << 20   # per corpus
CORPORA = ("text", "mixed")
REPS = 5


def one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    from libhuffman_tpu_torch import decode as dec
    from libhuffman_tpu_torch import encode as enc
    from libhuffman_tpu_torch import native
    from libhuffman_tpu_torch.ops import _build

    if not pathlib.Path(enc.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {enc.__file__}, not from {root}")
    _build.library()
    if not native.available():
        raise RuntimeError("the native host runtime did not build")
    spec = importlib.util.spec_from_file_location(
        "bench_corpora", HERE / "bench" / "corpora.py")
    corpora = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpora)

    out = {"root": str(root)}
    for c in CORPORA:
        data = corpora.FAMILIES[c](SLICE_BYTES)
        want = enc.encode(data, N)           # warm-up
        if dec.decode(want) != data:
            raise RuntimeError(f"{c}: the decode did not return the input")
        t_enc, t_dec = [], []
        for _ in range(REPS):
            t0 = time.perf_counter()
            stream = enc.encode(data, N)
            t_enc.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            back = dec.decode(stream)
            t_dec.append(time.perf_counter() - t0)
            if stream != want or back != data:
                raise RuntimeError(f"{c}: a repeat differs")
        out[c] = {"encode_s": t_enc, "decode_s": t_dec,
                  "encode_gbs_median": len(data) / statistics.median(t_enc)
                  / 1e9,
                  "decode_gbs_median": len(data) / statistics.median(t_dec)
                  / 1e9}
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(pathlib.Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    for root in argv:
        r = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
