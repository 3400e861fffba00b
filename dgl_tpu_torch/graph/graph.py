"""Directed (possibly bipartite) graph in dst-sorted CSR form.

The counterpart of ``dgl_tpu/graph/graph.py:Graph``. Edges are stored in
canonical order, sorted by destination with ties kept in input order:
``src`` is the CSR column-index array, ``indptr`` the row offsets (edges into
``v`` live at ``indptr[v]:indptr[v+1]``), ``dst`` the row id of every edge and
``eid`` the input-order id of every canonical edge. The transpose is built
once on the host and kept as ``reverse``; backward passes aggregate over it.
A node with no in-edges aggregates to 0.

There is no padding and there are no sentinel edges: arrays hold exactly
``num_edges`` entries. Indices are int32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["Graph", "from_edges"]

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class Graph:
    src: torch.Tensor  # (E,) int32, canonical (dst-sorted) order
    dst: torch.Tensor  # (E,) int32, ascending
    indptr: torch.Tensor  # (num_dst_nodes + 1,) int32
    eid: torch.Tensor  # (E,) int32, input-order id of each canonical edge
    num_src_nodes: int
    num_dst_nodes: int
    reverse: Optional["Graph"] = None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def in_degrees(self) -> torch.Tensor:
        """(num_dst_nodes,) int32 in-edge count per destination."""
        return self.indptr[1:] - self.indptr[:-1]

    def out_degrees(self) -> torch.Tensor:
        """(num_src_nodes,) int32 out-edge count per source."""
        if self.reverse is not None:
            return self.reverse.in_degrees()
        return torch.bincount(self.src.long(), minlength=self.num_src_nodes).int()

    def to(self, device: DeviceLike) -> "Graph":
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            src=self.src.to(dev),
            dst=self.dst.to(dev),
            indptr=self.indptr.to(dev),
            eid=self.eid.to(dev),
            reverse=None if self.reverse is None else self.reverse.to(dev),
        )

    def __repr__(self) -> str:
        return (
            f"Graph(num_src={self.num_src_nodes}, num_dst={self.num_dst_nodes}, "
            f"num_edges={self.num_edges}, device={self.src.device})"
        )


def _build_sorted(
    src: np.ndarray, dst: np.ndarray, num_dst: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stable sort by dst (the order of the JAX package's counting sort):
    returns canonical (src, dst, indptr, eid) as int32."""
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=num_dst)
    indptr = np.zeros(num_dst + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return (
        src[order].astype(np.int32),
        dst[order].astype(np.int32),
        indptr.astype(np.int32),
        order.astype(np.int32),
    )


def from_edges(
    src,
    dst,
    num_src_nodes: int,
    num_dst_nodes: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> Graph:
    """Build a :class:`Graph` and its reverse from COO edge lists.

    Args:
      src, dst: 1-D integer arrays of equal length, in input edge order.
      num_src_nodes: source node count; also the destination count when
        ``num_dst_nodes`` is None (homogeneous graph).
      device: where the arrays live; ``None`` means ``cuda``.
    """
    dev = resolve_device(device)
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src/dst must be 1-D and equal length, got {src.shape} vs {dst.shape}")
    if num_dst_nodes is None:
        num_dst_nodes = num_src_nodes
    num_e = int(src.shape[0])
    if max(num_e, num_src_nodes, num_dst_nodes) > _INT32_MAX:
        raise ValueError(
            f"graph too large for int32 indices: {num_e} edges, "
            f"{num_src_nodes} src / {num_dst_nodes} dst nodes"
        )
    if num_e and (src.min() < 0 or src.max() >= num_src_nodes):
        raise ValueError("src ids out of range")
    if num_e and (dst.min() < 0 or dst.max() >= num_dst_nodes):
        raise ValueError("dst ids out of range")
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)

    s, d, indptr, eid = _build_sorted(src, dst, num_dst_nodes)
    # the transpose is built from the canonical arrays, so rev.eid maps each
    # reverse-canonical slot to the forward-canonical slot of the same edge
    rs, rd, rindptr, reid = _build_sorted(d.astype(np.int64), s.astype(np.int64), num_src_nodes)

    def t(a):
        return torch.from_numpy(a).to(dev)

    rev = Graph(t(rs), t(rd), t(rindptr), t(reid), num_dst_nodes, num_src_nodes)
    return Graph(t(s), t(d), t(indptr), t(eid), num_src_nodes, num_dst_nodes, rev)
