"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, loaded with ``ctypes``. Libraries go to ``kernels/_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags: a
changed source is rebuilt, an unchanged one is reused. ``build`` starts one
``nvcc`` per missing library, all at once, and waits for them all.
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

__all__ = ["SOURCES", "HEADERS", "BUILD_DIR", "build", "load", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES: Dict[str, str] = {
    name: os.path.join(_HERE, "csrc", f"{name}.cu")
    for name in ("csr_spmm", "seg_sum", "gat_attention")
}
# device helpers every source includes (``#include "lanes.cuh"`` resolves
# beside the source); a changed header rebuilds every library
HEADERS = [os.path.join(_HERE, "csrc", "lanes.cuh")]
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
    for path in [SOURCES[name], *HEADERS]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build every named kernel (default: all) that has no current library,
    one ``nvcc`` process per source, run in parallel.

    Returns ``{name: {"path", "seconds", "log"}}``; ``seconds`` is 0 and
    ``log`` empty for a library that was reused. Raises if a build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    result, running = {}, {}
    for name in SOURCES if names is None else names:
        path = _lib_path(name)
        if os.path.exists(path):
            result[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc_path(), *_FLAGS, "-o", tmp, SOURCES[name]],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        result[name] = {"path": path, "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built if needed (one handle per process)."""
    return ctypes.CDLL(build([name])[name]["path"])
