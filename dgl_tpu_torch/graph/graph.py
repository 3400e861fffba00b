"""Directed (possibly bipartite) graph in dst-sorted CSR form.

The counterpart of ``dgl_tpu/graph/graph.py:Graph``. Edges are stored in
canonical order, sorted by destination with ties kept in input order:
``src`` is the CSR column-index array, ``indptr`` the row offsets (edges into
``v`` live at ``indptr[v]:indptr[v+1]``), ``dst`` the row id of every edge and
``eid`` the input-order id of every canonical edge. The transpose is built
once, with the graph, and kept as ``reverse``; backward passes aggregate
over it. Both CSRs are sorted on the graph's device. Each carries its row
split (``split``, ``graph/split.py``), planned on the host from its
``indptr`` when the graph is built: the kernels' plan for rows too long for
one warp.
A node with no in-edges aggregates to 0.

There is no padding and there are no sentinel edges: arrays hold exactly
``num_edges`` entries. Indices are int32.

A sampled block (``sampling/neighbor.py``) sets ``block_fanout``: each of
its ``num_dst_nodes`` destinations has exactly ``block_fanout`` in-edges,
laid out by position (edge ``(i, j)`` runs from source slot
``num_dst_nodes + i·block_fanout + j`` to destination ``i``), so the ops
aggregate it by a reshape (``ops/spmm.py``, ``nn/conv.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .split import RowSplit, row_split

__all__ = ["Graph", "from_edges", "from_scipy_coo", "per_layer"]

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class Graph:
    src: torch.Tensor  # (E,) int32, canonical (dst-sorted) order
    dst: torch.Tensor  # (E,) int32, ascending
    indptr: torch.Tensor  # (num_dst_nodes + 1,) int32
    eid: torch.Tensor  # (E,) int32, input-order id of each canonical edge
    num_src_nodes: int
    num_dst_nodes: int
    split: RowSplit  # the long rows of this CSR and their chunks
    reverse: Optional["Graph"] = None
    block_fanout: Optional[int] = None  # set on positional sampled blocks

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def is_block(self) -> bool:
        """True for a bipartite graph (``num_src_nodes != num_dst_nodes``),
        such as a sampled block, whose models pass ``(h, h[:num_dst_nodes])``."""
        return self.num_src_nodes != self.num_dst_nodes

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
            split=self.split.to(dev),
            reverse=None if self.reverse is None else self.reverse.to(dev),
        )

    def __repr__(self) -> str:
        return (
            f"Graph(num_src={self.num_src_nodes}, num_dst={self.num_dst_nodes}, "
            f"num_edges={self.num_edges}, device={self.src.device})"
        )


def per_layer(graphs: Union[Graph, Sequence[Graph]], n_layers: int) -> List[Graph]:
    """The graph of each of ``n_layers`` layers: one ``Graph`` for all of
    them, or a list of one block a layer, whose length must be ``n_layers``."""
    if isinstance(graphs, Graph):
        return [graphs] * n_layers
    if len(graphs) != n_layers:
        raise ValueError(f"expected {n_layers} blocks, got {len(graphs)}")
    return list(graphs)


def _build_sorted(
    src: torch.Tensor, dst: torch.Tensor, num_dst: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort by dst (the order of the JAX package's counting sort) of
    int64 ``src``/``dst`` on their device: returns canonical (src, dst,
    indptr, eid) as int32."""
    order = torch.sort(dst, stable=True).indices
    indptr = torch.zeros(num_dst + 1, dtype=torch.int64, device=dst.device)
    torch.cumsum(torch.bincount(dst, minlength=num_dst), 0, out=indptr[1:])
    return src[order].int(), dst[order].int(), indptr.int(), order.int()


def _as_int64(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.int64)
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)


def from_edges(
    src,
    dst,
    num_src_nodes: int,
    num_dst_nodes: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> Graph:
    """Build a :class:`Graph` and its reverse from COO edge lists.

    The edge lists go to ``device`` first and both CSRs are sorted there (on
    the card, a graph of 10^8 edges sorts in well under a second, where the
    host's sorts took minutes); each CSR's ``indptr`` is then read back once
    to plan its row split on the host.

    Args:
      src, dst: 1-D integer arrays or tensors of equal length, in input edge
        order.
      num_src_nodes: source node count; also the destination count when
        ``num_dst_nodes`` is None (homogeneous graph).
      device: where the arrays live; ``None`` means ``cuda``.
    """
    dev = resolve_device(device)
    src, dst = _as_int64(src, dev), _as_int64(dst, dev)
    if src.dim() != 1 or src.shape != dst.shape:
        raise ValueError(f"src/dst must be 1-D and equal length, got {tuple(src.shape)} vs "
                         f"{tuple(dst.shape)}")
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

    s, d, indptr, eid = _build_sorted(src, dst, num_dst_nodes)
    del src, dst
    # the transpose is built from the canonical arrays, so rev.eid maps each
    # reverse-canonical slot to the forward-canonical slot of the same edge
    rs, rd, rindptr, reid = _build_sorted(d.long(), s.long(), num_src_nodes)
    rev = Graph(rs, rd, rindptr, reid, num_dst_nodes, num_src_nodes, row_split(rindptr))
    return Graph(s, d, indptr, eid, num_src_nodes, num_dst_nodes, row_split(indptr), rev)


def from_scipy_coo(mat, *, device: DeviceLike = None) -> Graph:
    """Build from a ``scipy.sparse`` matrix in the (dst, src) = (row, col)
    sense, so that ``copy_u``'s sum is ``mat @ x`` (``tocoo()`` is all it
    calls)."""
    coo = mat.tocoo()
    return from_edges(np.asarray(coo.col), np.asarray(coo.row), int(coo.shape[1]),
                      int(coo.shape[0]), device=device)
