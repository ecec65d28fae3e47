"""How a kernel is reached (counterpart of ``repro.compat.pallas_call``).

Each CUDA source under ``repro_torch/csrc/`` has a plain C entry point.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root and loaded with ``ctypes``.
No PyTorch header is included: a build takes seconds, not minutes.

Builds happen at first use, never at import, so the package imports on
a host with no CUDA compiler.  A library's file name carries a hash of
its source and flags; an edited source builds anew.  :func:`build_all`
starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Dict, Iterable, List

from repro_torch import compat

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
# <repo>/src/repro_torch/kernels/_build.py -> <repo>/build/kernels
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory lines) of each library
# built by this process, for reports
build_log: Dict[str, str] = {}


def _lib_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels of repro_torch are built at first use and "
            "need the CUDA toolkit")
    return nvcc


def build_all(names: Iterable[str]) -> List[pathlib.Path]:
    """Build every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Raises with the
    compiler's output when a build fails."""
    names = list(names)
    todo = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
