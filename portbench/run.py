"""One run of one cell of the benchmark of libhuffman_tpu_torch.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, CUDA, the program's kernel and host libraries, the corpus
made from the seed, one warm-up pass of the cell's own shapes), then a
window of ``--seconds`` of closed-loop passes, then the check of every pass
against the plain reference.  With ``--trace 0`` the last line of standard
output is the result with the cell's end-to-end metrics; with ``--trace 1``
the window runs with the program's span timings on, one more pass runs
under ``torch.profiler``, and the line carries the per-layer metrics.
Standard error has the set-up's phases, and, as its last lines, each number
compared with its limit.

``--calls-out PATH`` also writes every pass's walls to PATH, for the spread
study (``portbench/spread.py``).
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # Compiled bytecode, of the program and of every library it imports, is
    # a build cache too: kept at a fixed path in the checkout, so that only
    # a checkout's first run compiles the sources.  Where the environment
    # turns writing it off and the libraries ship none, every run compiled
    # torch's 2141 modules anew: 6-8 s of set-up, varying with the host.
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check, corpus, manifest  # noqa: E402

# Modules whose presence after the window means the run measured the JAX
# package, not the port: compared by whole top-level names.
FORBIDDEN = {"jax", "jaxlib", "flax", "libhuffman_tpu", "bench"}

# Build and kernel caches of the program, at fixed paths in the checkout.
CACHE_ENV = {
    "LIBHUFFMAN_TPU_TORCH_KERNEL_DIR": ROOT / "build" / "kernels",
    "LIBHUFFMAN_TPU_TORCH_NATIVE_DIR": ROOT / "build" / "native",
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
    "TRITON_CACHE_DIR": ROOT / "build" / "triton",
}


class NoCard(RuntimeError):
    """The machine lacks the CUDA devices the cell asks for."""


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calls-out", default=None)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _traced_calls(enc, dec):
    """The calls wrapped in the harness's host ranges, which mark each call
    on the profiler's timeline."""
    from torch.profiler import record_function

    def tenc(data):
        with record_function("portbench.encode"):
            return enc(data)

    def tdec(stream):
        with record_function("portbench.decode"):
            return dec(stream)
    return tenc, tdec


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", max_bytes: int | None = None,
             calls_out: str | None = None,
             bench: dict | None = None, t0: float | None = None,
             entry=None):
    """Set-up, window, trace and check of one run.  Returns the result
    object and the numbers compared.  ``device="cpu"`` and ``max_bytes``
    let tests drive a run at a small size with the kernels' plain twins;
    ``entry(traffic, config, device)`` gives the (encode, decode) calls,
    the traffic's generator's own by default, which the control and the
    fault tests replace."""
    t0 = _T0 if t0 is None else t0
    bench = bench or manifest.load()
    cell = manifest.cell(bench, workload)
    config = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    gen = manifest.generator(traffic)
    if max_bytes is not None:
        config = corpus.scaled(config, max_bytes)
    for k, v in CACHE_ENV.items():
        os.environ[k] = str(v)

    def phase(name, since):
        now = time.perf_counter()
        say(f"setup {name} {now - since:.3f} s")
        return now

    t = time.perf_counter()
    import torch

    from libhuffman_tpu_torch import decode as dec_mod
    from libhuffman_tpu_torch import encode as enc_mod
    from libhuffman_tpu_torch import native
    from libhuffman_tpu_torch.utils import trace as hooks
    t = phase("import", t)
    on_card = device.startswith("cuda")
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < int(cell["chips"])):
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices; the cell "
                     f"asks for {cell['chips']}")
    if on_card:
        torch.cuda.init()
        torch.ones(1, device=device).sum().item()
    t = phase("cuda_init", t)
    if on_card:
        from libhuffman_tpu_torch.ops import _build
        _build.library()
    native._lib()
    t = phase("library_load", t)
    data = corpus.build(config, seed)
    t = phase("corpus", t)
    enc, dec = (entry or gen.entry)(traffic, config, device)
    if trace:
        enc, dec = _traced_calls(enc, dec)
    reads = int(traffic.get("reads_per_pass", 1))
    w = gen.one_pass(data, enc, dec, reads)  # the cell's own shapes
    if w.error:  # the window's passes will count it
        say(f"warm-up pass failed: {w.error}")
    del w
    if on_card:
        torch.cuda.synchronize()
    t = phase("warmup", t)
    setup_s = time.perf_counter() - t0
    say(f"setup total {setup_s:.3f} s")

    # The window.
    span_s: dict[str, float] = {}
    if trace:
        hooks.enable_timing(True)
        hooks.reset_timings()
        for c in (dec_mod.COUNTS, enc_mod.COUNTS):
            for k in c:
                c[k] = 0
    passes = gen.window(seconds, data, enc, dec, reads)
    traced = None
    if trace:
        for k, v in hooks.get_timings().items():
            span_s[k] = sum(v)
        counts = {**enc_mod.COUNTS, **dec_mod.COUNTS}
        hooks.enable_timing(False)
        from portbench import devtrace
        p, events = devtrace.profiled(
            lambda: gen.one_pass(data, enc, dec, reads))
        passes.append(p)
        traced = devtrace.reduce(events)
        if p.error is None:
            traced.setdefault("encode", {}).update(
                bytes_in=p.nbytes, bytes_out=len(p.stream))
            traced.setdefault("decode", {}).update(
                bytes_in=len(p.stream) * p.reads,
                bytes_out=p.nbytes * p.reads)
    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    if on_card:
        torch.cuda.empty_cache()
    timed = [p for p in passes if p.error is None]
    if trace:
        timed = timed[:-1] if passes[-1].error is None else timed
    if calls_out:
        _write_calls(calls_out, passes)

    # The check, after the window and the device's peak.
    t = time.perf_counter()
    numbers = getattr(gen, "check", check.check)(
        passes, data, int(config["blocksize"]))
    say(f"check took {time.perf_counter() - t:.3f} s over "
        f"{sum(p.stream is not None for p in passes)} of {len(passes)} "
        f"passes")
    correct = check.passed(numbers) and bool(timed)

    record = {
        "setup_s": setup_s,
        "passes": [{"bytes": p.nbytes, "encode_s": p.encode_s,
                    "decode_bytes": p.nbytes * p.reads,
                    "decode_s": p.decode_s} for p in timed],
    }
    if trace:
        record.update(spans=span_s, counts=counts, trace=traced,
                      peak_bytes_per_s=_peak(kind))
    metrics = {}
    for m in manifest.metrics(bench, workload, trace):
        v = manifest.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(mem_peak)}
    result = {"correct": correct,
              "attempted": sum(p.calls for p in passes),
              "failed": sum(p.error is not None for p in passes),
              "metrics": metrics, "device": dev}
    if trace and traced is not None:
        dev["busy_s"] = sum(traced[k]["busy_s"] for k in devtrace.CALLS
                            if k in traced)
        dev["window_s"] = sum(traced[k]["wall_s"] for k in devtrace.CALLS
                              if k in traced)
        result["breakdown"] = traced["breakdown"]
    result["checks"] = numbers
    return result, numbers


def _peak(kind: str) -> float | None:
    peaks = json.loads((ROOT / "portbench" / "peaks.json").read_text())
    return peaks.get(kind, {}).get("hbm_bytes_per_s")


def _write_calls(path, passes) -> None:
    """Every pass's encode and decode walls (seconds) and error."""
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump([[p.encode_s, p.decode_s, p.error] for p in passes], f)


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result, numbers = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), calls_out=args.calls_out)
    except NoCard as e:
        say(f"no result: {e}")
        return 2
    found = forbidden_modules()
    if found:
        say("the process holds modules of the JAX package or JAX itself: "
            + ", ".join(found))
        return 3
    say("card", _power_limit())
    for name, n in numbers.items():
        say(f"check {name} {n['value']} limit {n['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
