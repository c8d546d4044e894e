"""The spread study: runs of one cell, one process after another, with each
run's per-call walls kept, and the spread of every metric.

    python3 portbench/spread.py --workload <cell> --seeds 11,12,13 \
        --seconds 51 --out build/spread/<tag> [--trace 1]

Each run is ``run.py`` in a process of its own, as the benchmark is run.
Writes ``<out>/<seed>.calls.json`` (every pass's walls, from ``run.py
--calls-out``), ``<out>/<seed>.json`` (the result line) and
``<out>/<seed>.err`` (standard error), and prints one line per run and, at
the end, each metric's median and spread: the distance between the first
and third quartiles (``statistics.quantiles(values, n=4)``) over the
median, over all runs and without the run farthest from the median.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    m = statistics.median(values)
    return (q3 - q1) / m if m else None


def without_farthest(values: list[float]) -> list[float]:
    """The values less the one farthest from their median."""
    m = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - m))
    return values[:far] + values[far + 1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    values: dict[str, list[float]] = {}
    rc_all = 0
    for seed in [int(s) for s in args.seeds.split(",")]:
        cmd = [sys.executable, str(HERE / "run.py"), "--workload",
               args.workload, "--seed", str(seed), "--seconds",
               str(args.seconds), "--trace", str(args.trace),
               "--calls-out", str(out / f"{seed}.calls.json")]
        t = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t
        (out / f"{seed}.err").write_text(p.stderr)
        lines = p.stdout.strip().splitlines()
        if p.returncode != 0 or not lines:
            print(f"seed {seed} rc {p.returncode} wall {wall:.1f} s\n"
                  f"{p.stderr[-3000:]}", flush=True)
            rc_all = 1
            continue
        (out / f"{seed}.json").write_text(lines[-1])
        res = json.loads(lines[-1])
        summary = {k: v["value"] for k, v in res["metrics"].items()}
        for k, v in summary.items():
            values.setdefault(k, []).append(v)
        checks = {k: v["value"] for k, v in res["checks"].items()}
        print(f"seed {seed} wall {wall:.1f} s correct {res['correct']} "
              f"attempted {res['attempted']} "
              f"{json.dumps(summary)} checks {json.dumps(checks)}",
              flush=True)
    for k, v in values.items():
        s = spread(v)
        d = spread(without_farthest(v)) if len(v) > 2 else None
        print(f"metric {k} median {statistics.median(v)!r} spread "
              f"{s if s is None else round(s, 5)} without the farthest "
              f"{d if d is None else round(d, 5)} n {len(v)} values {v}",
              flush=True)
    return rc_all


if __name__ == "__main__":
    sys.exit(main())
