"""The control: the reference codec with the other tie-break put in the
program's place, which must come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

Among equal rates the control merges the smaller slot first.  Its trees
are valid Huffman trees and its streams decode, but they are not the
libhuffman reference's bytes, which the configuration guarantees: the
step a faster tree build would be tempted to take.  Each run is a
benchmark run at the cell's own size with the control as the encode
(the program decodes its stream) and a short window; it prints the numbers
compared and ``correct``, which must read false.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import loop, run  # noqa: E402
from portbench.reference import codec  # noqa: E402


def control_entry(traffic, config, device):
    """The control's encode beside the program's decode."""
    _enc, dec = loop.entry(traffic, config, device)
    bs = int(config["blocksize"])
    return (lambda data: codec.encode(data, bs, tie_break="smaller"), dec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        result, numbers = run.run_cell(args.workload, seed, args.seconds,
                                       False, entry=control_entry)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "checks": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
