"""Edge-list transforms.

The port's own copy of the structure transforms in
``dgl_tpu/graph/transforms.py`` that the drivers need: bidirect (arxiv and
products) and self-loops (every GAT row). They run once, before the graph
is built, on raw ``(src, dst)`` integer tensors, where those lie (on the
card for products' ~124M edges, whose host sort took minutes), and give
the original's arrays bit for bit, dtype included.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["coalesce", "to_bidirected", "remove_self_loops", "add_self_loops"]

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
