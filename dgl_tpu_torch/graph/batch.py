"""Batched graphs: a block-diagonal union and per-graph readout.

Counterpart of ``dgl_tpu/graph/batch.py`` (DGL's batched graph with
``dgl.nn.AvgPooling``, PyG's ``global_mean_pool``). A :class:`GraphBatch`
is one :class:`Graph` whose nodes and edges are the disjoint union of its
member graphs, in order: graph ``i``'s nodes are offset by the node counts
of the graphs before it, so every graph's nodes are contiguous and
``node_gid`` ascends. ``graph_indptr`` holds those node ranges as row
offsets, built on the host with their row split, so a sum or mean readout is
one K2 launch (``ops/segment.py``) that reads nothing back from the card.

Every batch has its true shape: no bucket padding, no sentinel graph ids.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.segment import segment_max, segment_mean, segment_sum
from .graph import Graph, from_edges
from .split import RowSplit, row_split

__all__ = ["GraphBatch", "batch_graphs", "readout"]


def _map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``obj`` with ``fn`` applied to every tensor of its dataclass tree."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn) for f in dataclasses.fields(obj)})
    return obj


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """``graph``: the union (N nodes, E edges); ``node_gid`` (N,) int32, the
    graph of each node; ``graph_indptr`` (B + 1,) int32, the cumulative node
    counts; ``graph_split`` its row split; ``num_graphs`` B."""

    graph: Graph
    node_gid: torch.Tensor
    graph_indptr: torch.Tensor
    graph_split: RowSplit
    num_graphs: int

    @property
    def num_nodes_per_graph(self) -> torch.Tensor:
        return self.graph_indptr[1:] - self.graph_indptr[:-1]

    def graph_mask(self, dtype=torch.float32) -> torch.Tensor:
        """(B,) ones: a batch holds no padded graph slot."""
        return torch.ones(self.num_graphs, dtype=dtype, device=self.graph_indptr.device)

    def to(self, device: DeviceLike, non_blocking: bool = False) -> "GraphBatch":
        dev = resolve_device(device)
        return _map_tensors(self, lambda t: t.to(dev, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        return _map_tensors(self, lambda t: t.pin_memory())


def batch_graphs(
    graphs: Sequence[Tuple[np.ndarray, np.ndarray, int]], *, device: DeviceLike = None
) -> GraphBatch:
    """The union of ``(src, dst, num_nodes)`` triples (graph-local ids), in
    order, built on the host and then moved to ``device``."""
    counts = np.asarray([n for _, _, n in graphs], dtype=np.int64)
    offsets = np.zeros(len(graphs) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    src = np.concatenate([np.asarray(s, np.int64) + o for (s, _, _), o in zip(graphs, offsets)]
                         + [np.zeros(0, np.int64)])
    dst = np.concatenate([np.asarray(d, np.int64) + o for (_, d, _), o in zip(graphs, offsets)]
                         + [np.zeros(0, np.int64)])
    total = int(offsets[-1])
    g = from_edges(src, dst, total, device="cpu")
    gid = np.repeat(np.arange(len(graphs), dtype=np.int32), counts)
    batch = GraphBatch(g, torch.from_numpy(gid), torch.from_numpy(offsets.astype(np.int32)),
                       row_split(offsets), len(graphs))
    dev = resolve_device(device)
    return batch if dev.type == "cpu" else batch.to(dev)


def readout(batch: GraphBatch, x: torch.Tensor, op: str = "mean") -> torch.Tensor:
    """Per-graph readout of node features: (N, ...) → (B, ...). ``mean``
    matches ``dgl.nn.AvgPooling``; a graph with no node gives 0."""
    if op == "mean":
        return segment_mean(x, batch.node_gid, batch.graph_indptr, batch.graph_split)
    if op == "sum":
        return segment_sum(x, batch.node_gid, batch.graph_indptr, batch.graph_split)
    if op == "max":
        return segment_max(x, batch.node_gid, batch.num_graphs)
    raise ValueError(f"unknown readout op: {op!r}")
