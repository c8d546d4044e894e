"""Build and bind the CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared library
with a plain C interface, then loaded with ctypes.
No source includes PyTorch's headers, so a build takes seconds, not the
minutes a ``torch.utils.cpp_extension`` build takes.  The library lands in
``build/kernels/`` beside the package (or the directory named by
``LIBHUFFMAN_TPU_TORCH_KERNEL_DIR``), keyed by a hash of the sources and the
flags, and is built at first use, never at import.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception, because a launch the CUDA runtime refuses (too many threads, too much
shared memory) never runs and no later synchronize reports it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "LIBHUFFMAN_TPU_TORCH_KERNEL_DIR", _PKG.parent / "build" / "kernels"))


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc`` (CUDA_HOME defaults to /usr/local/cuda), else
    the first ``nvcc`` on PATH."""
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    return shutil.which("nvcc")


def compile_command(nvcc: str, src: pathlib.Path, obj: pathlib.Path
                    ) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]


def link_command(nvcc: str, objs: list[pathlib.Path], out: pathlib.Path
                 ) -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *map(str, objs)]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the first failure's
    stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [(p.communicate()[1], p.returncode) for p in procs]
    for err, rc in errs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed (exit {rc}):\n{err}")


def build() -> pathlib.Path:
    """Compile the kernels if no library for these sources exists yet;
    returns the library's path.  Raises RuntimeError when nvcc is missing
    or fails (with nvcc's own message)."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = build_dir()
    so = out_dir / f"libhuff_kernels-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of libhuffman_tpu_torch cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    # Private object names and a rename into place: a process that
    # builds at the same time must never load a half-written library.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [pathlib.Path(tmp) / f"{p.stem}.o" for p in srcs]
        _run_all([compile_command(nvcc, p, o) for p, o in zip(srcs, objs)])
        lib = pathlib.Path(tmp) / "lib.so"
        _run_all([link_command(nvcc, objs, lib)])
        os.replace(lib, so)
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kernel library, built on first call, with every entry point's
    argument types declared (pointers and the stream as c_void_p: ctypes
    would otherwise pass a Python int as a 32-bit int and cut it)."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.huff_histogram.argtypes = [p, p, p, i, i, p]
    lib.huff_layout.argtypes = [p, p, p, p, p, p, i, i, p]
    lib.huff_pack.argtypes = [p, p, p, p, i, i, i, p]
    lib.huff_resolve.argtypes = [p, p, p, i, i, i, p]
    lib.huff_chain.argtypes = [p, p, p, p, p, p, i, i, p]
    lib.huff_chain_scratch_words.argtypes = [i, i]
    lib.huff_chain_scratch_words.restype = ctypes.c_longlong
    lib.huff_emit.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.huff_trees.argtypes = [p, p, p, p, p, p, p, p, i, p]
    for fn in (lib.huff_histogram, lib.huff_layout, lib.huff_pack,
               lib.huff_resolve, lib.huff_chain, lib.huff_emit,
               lib.huff_trees):
        fn.restype = ctypes.c_int
    lib.huff_error_string.argtypes = [i]
    lib.huff_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().huff_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {name} failed: {msg} ({err})")
