"""What the benchmark's process imports: never JAX or the JAX package, and
the plain reference nothing of the program."""

import json
import subprocess
import sys

from _util import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "libhuffman_tpu", "bench"}


def _modules(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_path_imports_no_jax():
    top = _modules(
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import run, control, devtrace, spread\n"
        "run.run_cell('silesia-128k.whole-64m', 3, 0.0, True, device='cpu',"
        " max_bytes=20000)")
    assert "libhuffman_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    top = _modules("import sys; sys.path.insert(0, '.')\n"
                   "from portbench.reference import codec\n"
                   "from portbench import check, corpus")
    assert not top & (FORBIDDEN | {"libhuffman_tpu_torch", "torch"})


def test_main_without_a_card_prints_no_result():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "enwik8-64k.whole-64m", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    try:
        import torch
        has_card = torch.cuda.is_available()
    except ImportError:
        has_card = False
    if not has_card:
        assert p.returncode != 0
        assert p.stdout.strip() == ""


def test_without_the_program_prints_no_result(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "enwik8-64k.whole-64m", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
