"""Graph partitioning for cluster-batched training.

The port's own copy of ``dgl_tpu/graph/partition.py``: the METIS role of
the reference (``dgl.transform.metis_partition`` in
``cluster-sage/dgl/partition_utils.py:9-16``) with its on-disk cache of the
assignment (``cluster-sage/dgl/sampler.py:33-41``). Methods:

* ``metis``: the native multilevel partitioner (``csrc/native.py``:
  heavy-edge matching, BFS growing, boundary refinement under a 1.08
  imbalance cap);
* ``lp``: native label propagation, then ``_balance``;
* ``random``: a uniform part per node, the degenerate baseline.

The native library builds or raises, so neither native method has a
fallback. For the same arguments every method gives the JAX package's
assignment bit for bit (``lp`` at one OpenMP thread), and the cache file
has the JAX package's name, so both packages read each other's files.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np

from ..csrc import native

__all__ = ["partition_assignment", "partition_stats", "get_partition_list"]

# keyed into the cache file name, as in the JAX package, whose partitioner
# semantics this copies (v2: the grow phase's weight-capped leftover attach
# and refine's shedding of over-cap parts)
_PART_CACHE_VERSION = 2


def _balance(part: np.ndarray, k: int, cap_ratio: float = 1.3) -> np.ndarray:
    """Move the nodes of every part above ``cap_ratio`` times the ideal size
    into the parts below the ideal size (one stable sort, then a loop over
    the oversized parts only); what is left after that is spread round
    robin."""
    n = len(part)
    target = int(np.ceil(n / k))
    cap = max(int(target * cap_ratio), target + 1)
    counts = np.bincount(part, minlength=k)
    over = np.where(counts > cap)[0]
    if not len(over):
        return part
    order = np.argsort(part, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    excess = np.concatenate([order[offsets[p] + cap: offsets[p + 1]] for p in over])
    under = np.where(counts < target)[0]
    slots = np.repeat(under, target - counts[under])
    part = part.copy()
    m = min(len(excess), len(slots))
    part[excess[:m]] = slots[:m]
    if m < len(excess):
        part[excess[m:]] = np.arange(len(excess) - m) % k
    return part


def _cache_path(cache_dir: str, cache_key: str, src, dst, k: int, method: str, seed: int) -> str:
    """The JAX package's file name: key, version, k, method, seed, edge
    count and a strided content hash of the edge list, so another seed or a
    regenerated graph with the same counts never reuses a stale file."""
    h = 0
    if len(src):
        step = max(len(src) // 4096, 1)
        h = int((np.asarray(src[::step], np.int64) * 31
                 + np.asarray(dst[::step], np.int64)).sum()) & 0xFFFFFFFF
    return os.path.join(cache_dir, f"{cache_key}_part_v{_PART_CACHE_VERSION}_{k}_{method}_s{seed}"
                                   f"_e{len(src)}_h{h:08x}.npy")


def _save(path: str, part: np.ndarray) -> None:
    """Write under a temporary name, then rename: a concurrent reader finds
    no file or the whole file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        np.save(f, part)
    os.replace(tmp, path)


def partition_assignment(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    k: int,
    *,
    method: str = "lp",
    seed: int = 0,
    cache_dir: Optional[str] = None,
    cache_key: Optional[str] = None,
) -> np.ndarray:
    """(num_nodes,) int64 part of every node, read from or written to
    ``cache_dir`` when both ``cache_dir`` and ``cache_key`` are given."""
    path = None
    if cache_dir and cache_key:
        path = _cache_path(cache_dir, cache_key, src, dst, k, method, seed)
        if os.path.exists(path):
            return np.load(path)
    if method == "random":
        part = np.random.default_rng(seed).integers(0, k, size=num_nodes)
    elif method == "metis":
        part = native.partition_multilevel(src, dst, num_nodes, k, seed)
    elif method == "lp":
        part = _balance(native.partition_lp(src, dst, num_nodes, k, 30, seed), k)
    else:
        raise ValueError(f"unknown partition method {method!r}")
    if path is not None:
        _save(path, part)
    return part


def partition_stats(src: np.ndarray, dst: np.ndarray, part: np.ndarray, k: int) -> dict:
    """``edge_cut``, the share of edges whose ends lie in two parts, and
    ``balance``, the largest part over the ideal size (1.0 is perfect)."""
    cut = float(np.mean(part[src] != part[dst])) if len(src) else 0.0
    counts = np.bincount(part, minlength=k)
    balance = float(counts.max() / max(len(part) / k, 1))
    return {"edge_cut": cut, "balance": balance, "parts": int(k)}


def get_partition_list(part: np.ndarray, k: int) -> List[np.ndarray]:
    """The node ids of each part, ascending (the reference's
    ``get_partition_list``)."""
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=k)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return [order[offsets[i]: offsets[i + 1]] for i in range(k)]
