"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, loaded with ``ctypes`` (``csr_spmm.cu`` and ``gat_attention.cu``
two each: their float32 entry points and, built with ``DEFINES``, their
bfloat16 ones). Libraries go to ``kernels/_build/``
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
from typing import Dict, Iterable, List, Optional, Sequence

import torch

__all__ = ["SOURCES", "DEFINES", "HEADERS", "BUILD_DIR", "build", "load", "nvcc_path", "entry",
           "launch"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES: Dict[str, str] = {
    name: os.path.join(_HERE, "csrc", f"{name}.cu")
    for name in ("csr_spmm", "seg_sum", "gat_attention", "row_gather")
}
# K1's and K3's bfloat16 entry points: csr_spmm.cu and gat_attention.cu
# again, with K1_ROWS_BF16 and K3_BF16, so that their instantiations build
# beside the float32 ones, in parallel
SOURCES["csr_spmm_bf16"] = SOURCES["csr_spmm"]
SOURCES["gat_attention_bf16"] = SOURCES["gat_attention"]
DEFINES: Dict[str, List[str]] = {"csr_spmm_bf16": ["-DK1_ROWS_BF16"],
                                 "gat_attention_bf16": ["-DK3_BF16"]}
# headers the sources include (``#include "lanes.cuh"`` resolves beside the
# source): the device helpers every source includes, the asynchronous
# copies of K1, K2, K3 and P1, and their geometry; a changed header
# rebuilds every library
HEADERS = [os.path.join(_HERE, "csrc", name)
           for name in ("lanes.cuh", "async_copy.cuh", "k1_geometry.h", "k2_p1_geometry.h",
                        "k3_geometry.h")]
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
    h.update(" ".join(_FLAGS + DEFINES.get(name, [])).encode())
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
        proc = subprocess.Popen([nvcc_path(), *_FLAGS, *DEFINES.get(name, []), "-o", tmp,
                                 SOURCES[name]],
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


@functools.lru_cache(maxsize=None)
def entry(name: str, fn_name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``fn_name`` of kernel library ``name``, its
    ``argtypes`` (a tuple) set once and ``restype`` int (a CUDA error)."""
    fn = getattr(load(name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(fn: ctypes._CFuncPtr, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` on ``device``'s current stream; raises if the
    launch is refused. The card is made current only where it is not: the
    host work of a launch is all that a small call costs."""
    idx = device.index
    if idx == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed with CUDA error {err}")
