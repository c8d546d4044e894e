"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load(path: pathlib.Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list it under ``workloads``, or list none."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    return _module(HERE / "metrics" / f"{name}.py",
                   f"portbench.metrics.{name}").read


def generator(traffic: dict):
    """The module that drives a traffic mix: ``traffic/<generator>.py``
    where the mix names one, else the closed loop of ``loop.py``."""
    name = traffic.get("generator")
    if name is None:
        from portbench import loop
        return loop
    return _module(HERE / "traffic" / f"{name}.py",
                   f"portbench.traffic.{name}")
