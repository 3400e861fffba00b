"""Edge-list transforms.

The port's own copy of the structure transforms in
``dgl_tpu/graph/transforms.py``: bidirect (arxiv and products), self-loops
(every GAT row), the node-induced subgraph with its id compaction
(``reindex``, ``node_subgraph``) and the ``*_graph`` wrappers that rebuild
a :class:`Graph`. They run on raw ``(src, dst)`` integer tensors, where
those lie (on the card for products' ~124M edges, whose host sort took
minutes), and give the original's arrays bit for bit, dtype included.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .graph import Graph, from_edges

__all__ = ["coalesce", "to_bidirected", "remove_self_loops", "add_self_loops", "reindex",
           "node_subgraph", "to_bidirected_graph", "add_self_loops_graph"]

Edges = Tuple[torch.Tensor, torch.Tensor]


def coalesce(src: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> Edges:
    """Sort by (src, dst) and drop duplicate edges."""
    key = torch.unique(src.long() * num_nodes + dst.long())
    return (key // num_nodes).to(src.dtype), (key % num_nodes).to(dst.dtype)


def to_bidirected(src: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> Edges:
    """Union of the edges and their reverses, deduplicated."""
    return coalesce(torch.cat([src, dst]), torch.cat([dst, src]), num_nodes)


def remove_self_loops(src: torch.Tensor, dst: torch.Tensor) -> Edges:
    keep = src != dst
    return src[keep], dst[keep]


def add_self_loops(src: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> Edges:
    """Drop existing self-loops, then append (v, v) for every node."""
    src, dst = remove_self_loops(src, dst)
    loop = torch.arange(num_nodes, dtype=src.dtype, device=src.device)
    return torch.cat([src, loop]), torch.cat([dst, loop])


def reindex(ids: torch.Tensor, num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(unique_ids, mapping)``: the sorted distinct ``ids`` and an int64
    (num_nodes,) map from each of them to its position there (0 for an id
    not in ``ids``)."""
    uniq = torch.unique(ids)
    mapping = torch.zeros(num_nodes, dtype=torch.int64, device=ids.device)
    mapping[uniq] = torch.arange(len(uniq), device=ids.device)
    return uniq, mapping


def node_subgraph(src: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                  nodes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sub_src, sub_dst, nodes)``: the edges with both ends in ``nodes``,
    in input order, relabelled (int64) to positions in ``nodes``, which
    plays DGL's ``NID``."""
    present = torch.zeros(num_nodes, dtype=torch.bool, device=src.device)
    present[nodes] = True
    keep = present[src] & present[dst]
    mapping = torch.zeros(num_nodes, dtype=torch.int64, device=src.device)
    mapping[nodes] = torch.arange(len(nodes), device=src.device)
    return mapping[src[keep]], mapping[dst[keep]], nodes


def to_bidirected_graph(g: Graph) -> Graph:
    """``g``'s edges and their reverses, deduplicated, as a graph on ``g``'s
    device."""
    s, d = to_bidirected(g.src.long(), g.dst.long(), g.num_src_nodes)
    return from_edges(s, d, g.num_src_nodes, device=g.src.device)


def add_self_loops_graph(g: Graph) -> Graph:
    """``g`` without its self-loops and with one (v, v) a node, as a graph
    on ``g``'s device."""
    s, d = add_self_loops(g.src.long(), g.dst.long(), g.num_src_nodes)
    return from_edges(s, d, g.num_src_nodes, device=g.src.device)
