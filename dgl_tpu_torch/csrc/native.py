"""ctypes bindings of the port's host-side neighbour samplers.

``graph_ops.cpp`` is compiled with ``g++`` at first use, with the JAX
package's flags, into ``csrc/_build/`` (listed in ``.gitignore``). The
library is named by a hash of its source and flags and written under a
temporary name, then renamed into place, so a process that finds it finds
it whole, however many build it at once. A failed build raises: there is no
NumPy fallback, whose random stream would differ.

Counterpart of ``dgl_tpu/csrc/native.py:sample_neighbors`` and
``:sample_neighbors_noreplace``; the same seed draws the same neighbours
wherever the OpenMP team size is the same.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["BUILD_DIR", "build", "load", "sample_neighbors", "sample_neighbors_noreplace",
           "NOREPLACE_MAX_FANOUT"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
_SOURCE = os.path.join(_HERE, "graph_ops.cpp")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp", "-std=c++17"]
NOREPLACE_MAX_FANOUT = 64  # Floyd's scratch in graph_ops.cpp

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgraph_ops_{h.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, compiled first if it is missing; raises
    ``RuntimeError`` with the compiler's output if ``g++`` fails."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    r = subprocess.run(["g++", *_FLAGS, _SOURCE, "-o", tmp], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SOURCE} (exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The samplers' library, built if needed (one handle per process)."""
    lib = ctypes.CDLL(build())
    for name in ("sample_neighbors", "sample_neighbors_noreplace"):
        fn = getattr(lib, name)
        fn.argtypes = [_i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                       _i64p]
        fn.restype = None
    return lib


def _sample(name: str, indptr, indices, seeds, fanout: int, seed: int) -> np.ndarray:
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    seeds = np.ascontiguousarray(seeds, np.int64)
    if fanout < 1:
        raise ValueError(f"fanout must be at least 1, got {fanout}")
    if len(seeds) and (seeds.min() < 0 or seeds.max() >= len(indptr) - 1):
        raise ValueError(f"seed ids out of range [0, {len(indptr) - 1})")
    out = np.empty(len(seeds) * fanout, dtype=np.int64)
    getattr(load(), name)(indptr, indices, seeds, len(seeds), fanout,
                          seed & 0xFFFFFFFFFFFFFFFF, out)
    return out.reshape(len(seeds), fanout)


def sample_neighbors(indptr, indices, seeds, fanout: int, seed: int) -> np.ndarray:
    """(len(seeds), fanout) in-neighbour samples with replacement from the
    in-edge CSR ``indptr``/``indices``; zero-degree seeds yield themselves."""
    return _sample("sample_neighbors", indptr, indices, seeds, fanout, seed)


def sample_neighbors_noreplace(indptr, indices, seeds, fanout: int, seed: int) -> np.ndarray:
    """(len(seeds), fanout) distinct in-neighbour samples (DGL's
    without-replacement semantics). Seeds with deg < fanout keep all deg
    neighbours, filled cyclically to the slot count; zero-degree seeds
    yield themselves. ``fanout`` is at most ``NOREPLACE_MAX_FANOUT``."""
    if fanout > NOREPLACE_MAX_FANOUT:
        raise ValueError(f"noreplace fanout is capped at {NOREPLACE_MAX_FANOUT} "
                         "(Floyd scratch in graph_ops.cpp)")
    return _sample("sample_neighbors_noreplace", indptr, indices, seeds, fanout, seed)
