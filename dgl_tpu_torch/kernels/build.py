"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, loaded with ``ctypes``. Libraries go to ``kernels/_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags: a
changed source is rebuilt, an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES: Dict[str, str] = {
    "csr_spmm": os.path.join(_HERE, "csrc", "csr_spmm.cu"),
}
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    with open(SOURCES[name], "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build every named kernel (default: all) that has no current library.

    Returns ``{name: {"path", "seconds", "log"}}``; ``seconds`` is 0 and
    ``log`` empty for a library that was reused. Raises if a build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    result = {}
    for name in SOURCES if names is None else names:
        path = _lib_path(name)
        if os.path.exists(path):
            result[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *_FLAGS, "-o", tmp, SOURCES[name]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, path)
        result[name] = {"path": path, "seconds": time.perf_counter() - t0, "log": proc.stdout}
    return result


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built if needed (one handle per process)."""
    return ctypes.CDLL(build([name])[name]["path"])
