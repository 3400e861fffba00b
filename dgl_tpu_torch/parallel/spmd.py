"""Replicated activations over edge-sharded graphs, and the rank grid.

Counterpart of ``dgl_tpu/parallel/spmd.py``, where GSPMD shards a graph's
edge arrays over the ``graph`` mesh axis and inserts the collective that
completes every SpMM. Here each rank takes its slice of the edges
(``shard_graph``, in dst-sorted order, as the JAX arrays are laid out) and
``sharded_gspmm`` adds the ranks' partial sums with an all-reduce; mean
divides by the global in-degree. Inputs and outputs are replicated: the
output is the same on every rank, and so is the gradient of the input (the
backward all-reduces the partial gradients), as in JAX.

* ``device_mesh``: the rank grid over the world (JAX's default shape
  ``(1, n)``), ``multihost.RankMesh``;
* ``replicated``: a module's parameters and buffers broadcast from the
  first rank (JAX places a replicated array);
* ``node_sharding``: this rank's contiguous slice of a node array's rows;
* ``graph_sharding``: this rank's slice of the edges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph, from_edges
from ..ops.spmm import gspmm
from .comm import all_sum, broadcast_, world_size
from .multihost import RankMesh, rank_grid

__all__ = ["device_mesh", "replicated", "node_sharding", "graph_sharding", "EdgeSharded",
           "shard_graph", "sharded_gspmm"]


def device_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("data", "graph")) -> RankMesh:
    """The world's ranks on a grid; default shape ``(1, ..., world)``."""
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (dist.get_world_size(),)
    return rank_grid(shape, axis_names)


def replicated(module: torch.nn.Module, group=None, src: int = 0) -> torch.nn.Module:
    """Overwrite every parameter and buffer with global rank ``src``'s."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, src, group)
    return module


def node_sharding(x: torch.Tensor, mesh: RankMesh, axis: str = "graph") -> torch.Tensor:
    """This rank's rows of ``x`` along ``axis`` (contiguous, equal blocks)."""
    k, i = mesh.size(axis), mesh.index(axis)
    if x.shape[0] % k:
        raise ValueError(f"{x.shape[0]} rows do not split into {k} equal blocks")
    n = x.shape[0] // k
    return x[i * n:(i + 1) * n]


def graph_sharding(num_edges: int, mesh: RankMesh, axis: str = "graph") -> slice:
    """This rank's range of the dst-sorted edges: ``ceil(E / k)`` a rank."""
    k, i = mesh.size(axis), mesh.index(axis)
    per = -(-num_edges // k)
    return slice(min(i * per, num_edges), min((i + 1) * per, num_edges))


@dataclasses.dataclass(frozen=True)
class EdgeSharded:
    """This rank's edges as a graph over all nodes, the global in-degree
    of every node, and the group whose ranks hold the other slices."""

    graph: Graph
    in_degrees: torch.Tensor
    group: object = None


def shard_graph(src, dst, num_nodes: int, mesh: RankMesh, axis: str = "graph",
                device: DeviceLike = None) -> EdgeSharded:
    """Take this rank's slice (``graph_sharding``) of the dst-sorted edges."""
    dev = resolve_device(device)
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    order = np.argsort(dst, kind="stable")
    part = order[graph_sharding(len(order), mesh, axis)]
    g = from_edges(src[part], dst[part], num_nodes, device=dev)
    deg = torch.from_numpy(np.bincount(dst, minlength=num_nodes)).to(dev)
    return EdgeSharded(g, deg, mesh.groups[axis])


class _CopyToRanks(torch.autograd.Function):
    """Identity forward; the backward adds the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g.contiguous(), ctx.group), None


class _ReduceFromRanks(torch.autograd.Function):
    """All-reduce forward; the backward passes the replicated cotangent on."""

    @staticmethod
    def forward(ctx, x, group):
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sharded_gspmm(sg: EdgeSharded, op: str, reduce: str, x: torch.Tensor) -> torch.Tensor:
    """``gspmm`` of the whole graph from this rank's edge slice: K1's sum
    over the slice, completed by an all-reduce over ``sg.group``; mean
    divides by the global in-degree. ``x`` (N, D) replicated; returns the
    replicated (N, D). ``copy_u`` sum or mean."""
    if op not in ("copy_u", "copy_lhs") or reduce not in ("sum", "mean"):
        raise ValueError(f"sharded_gspmm computes copy_u sum/mean, not {op!r} {reduce!r}")
    if world_size(sg.group) == 1:
        return gspmm(sg.graph, op, reduce, x=x)
    out = _ReduceFromRanks.apply(gspmm(sg.graph, op, "sum", x=_CopyToRanks.apply(x, sg.group)),
                                 sg.group)
    if reduce == "mean":
        out = out / sg.in_degrees.clamp(min=1).to(out.dtype).unsqueeze(1)
    return out
