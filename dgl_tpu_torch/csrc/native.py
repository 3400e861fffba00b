"""ctypes bindings of the port's host-side graph runtime.

``graph_ops.cpp`` is compiled with ``g++`` at first use, with the JAX
package's flags, into ``csrc/_build/`` (listed in ``.gitignore``). The
library is named by a hash of its source and flags and written under a
temporary name, then renamed into place, so a process that finds it finds
it whole, however many build it at once. A failed build raises: there is no
NumPy fallback, whose random stream would differ.

Counterpart of ``dgl_tpu/csrc/native.py``: ``sample_neighbors`` and
``sample_neighbors_noreplace`` (the same seed draws the same neighbours
wherever the OpenMP team size is the same), ``SubgraphExtractor``,
``partition_multilevel``, ``partition_lp`` and ``build_csr``, each with the
JAX binding's output bit for bit (``partition_lp``, serial here, against
the JAX binding at one OpenMP thread).
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
           "NOREPLACE_MAX_FANOUT", "SubgraphExtractor", "partition_multilevel", "partition_lp",
           "build_csr"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
_SOURCE = os.path.join(_HERE, "graph_ops.cpp")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp", "-std=c++17"]
NOREPLACE_MAX_FANOUT = 64  # Floyd's scratch in graph_ops.cpp

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i64, _u64 = ctypes.c_int64, ctypes.c_uint64
_SIGNATURES = {  # name: (argtypes, restype)
    "sample_neighbors": ([_i64p, _i64p, _i64p, _i64, _i64, _u64, _i64p], None),
    "sample_neighbors_noreplace": ([_i64p, _i64p, _i64p, _i64, _i64, _u64, _i64p], None),
    "node_subgraph": ([_i64p, _i64p, _i64, _i64p, _i64, _i64p, _u8p, _i64p, _i64p], _i64),
    "partition_lp": ([_i64p, _i64p, _i64, _i64, _i64, _i64, _u64, _i64p], None),
    "partition_multilevel": ([_i64p, _i64p, _i64, _i64, _i64, _u64, _i64p], _i64),
    "build_csr": ([_i64p, _i64p, _i64, _i64, _i64p, _i64p, _i64p], None),
}


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
    """The runtime's library, built if needed (one handle per process)."""
    lib = ctypes.CDLL(build())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
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


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


class SubgraphExtractor:
    """Node-induced subgraph extraction over a by-source CSR (``indptr``,
    ``indices``), its ``num_nodes``-sized scratch allocated once.

    ``extract(nodes)`` returns the (src, dst) int64 edges with both ends in
    ``nodes``, relabelled to positions in ``nodes``, grouped by source
    position in CSR order (``node_subgraph`` in ``graph_ops.cpp``: the
    same for any OpenMP team size). Calls are serialised on the scratch,
    so a prefetch thread and the main thread may share one extractor."""

    def __init__(self, indptr, indices, num_nodes: int):
        self.indptr = _as_i64(indptr)
        self.indices = _as_i64(indices)
        self.num_nodes = num_nodes
        self._mapping = np.zeros(num_nodes, dtype=np.int64)
        self._present = np.zeros(num_nodes, dtype=np.uint8)
        self._scratch_lock = threading.Lock()

    def extract(self, nodes):
        nodes = _as_i64(nodes)
        cap = int(self.indptr[nodes + 1].sum() - self.indptr[nodes].sum())
        out_src = np.empty(max(cap, 1), dtype=np.int64)
        out_dst = np.empty(max(cap, 1), dtype=np.int64)
        with self._scratch_lock:
            n = load().node_subgraph(self.indptr, self.indices, self.num_nodes, nodes,
                                     len(nodes), self._mapping, self._present, out_src, out_dst)
        return out_src[:n], out_dst[:n]


def partition_multilevel(src, dst, num_nodes: int, k: int, seed: int) -> np.ndarray:
    """(num_nodes,) int64 part of every node in [0, k): the multilevel k-way
    partition (heavy-edge matching coarsening, BFS growing, boundary
    refinement under a 1.08 imbalance cap: the METIS recipe). Serial and
    deterministic given the seed."""
    part = np.empty(num_nodes, dtype=np.int64)
    load().partition_multilevel(_as_i64(src), _as_i64(dst), len(src), num_nodes, k,
                                seed & 0xFFFFFFFFFFFFFFFF, part)
    return part


def partition_lp(src, dst, num_nodes: int, k: int, rounds: int, seed: int) -> np.ndarray:
    """(num_nodes,) int64 label-propagation partition into k parts.

    Its rounds walk the edges serially (``graph_ops.cpp``), so the result
    is reproducible at any ``OMP_NUM_THREADS`` and equals the JAX binding's
    at one thread; the JAX binding runs the rounds on OpenMP threads that
    race on the part array, so its result at more threads depends on their
    interleaving."""
    part = np.empty(num_nodes, dtype=np.int64)
    load().partition_lp(_as_i64(src), _as_i64(dst), len(src), num_nodes, k, rounds,
                        seed & 0xFFFFFFFFFFFFFFFF, part)
    return part


def build_csr(key, val, num_nodes: int):
    """Counting-sort CSR of an edge list by ``key``: (indptr, val in key
    order, the input position of each slot), int64, stable."""
    key, val = _as_i64(key), _as_i64(val)
    indptr = np.empty(num_nodes + 1, dtype=np.int64)
    out_val = np.empty(len(val), dtype=np.int64)
    out_eid = np.empty(len(val), dtype=np.int64)
    load().build_csr(key, val, len(key), num_nodes, indptr, out_val, out_eid)
    return indptr, out_val, out_eid
