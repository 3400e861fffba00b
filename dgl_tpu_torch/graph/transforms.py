"""Host-side edge-list transforms (NumPy).

The port's own copy of the structure transforms in
``dgl_tpu/graph/transforms.py`` that the GAT drivers need: bidirect
(arxiv) and self-loops (every GAT row). They run once, before the graph is
built, on raw ``(src, dst)`` arrays, and give the same arrays as the
original bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["coalesce", "to_bidirected", "remove_self_loops", "add_self_loops"]


def coalesce(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by (src, dst) and drop duplicate edges."""
    key = np.unique(src.astype(np.int64) * num_nodes + dst.astype(np.int64))
    return (key // num_nodes).astype(src.dtype), (key % num_nodes).astype(dst.dtype)


def to_bidirected(src, dst, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Union of the edges and their reverses, deduplicated."""
    return coalesce(np.concatenate([src, dst]), np.concatenate([dst, src]), num_nodes)


def remove_self_loops(src, dst) -> Tuple[np.ndarray, np.ndarray]:
    keep = src != dst
    return src[keep], dst[keep]


def add_self_loops(src, dst, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Drop existing self-loops, then append (v, v) for every node."""
    src, dst = remove_self_loops(src, dst)
    loop = np.arange(num_nodes, dtype=src.dtype if len(src) else np.int32)
    return np.concatenate([src, loop]), np.concatenate([dst, loop])
