"""Edge-side gathers and their adjoint reductions.

Counterpart of ``dgl_tpu/ops/gather.py``. Each differentiable op pairs a
row gather with a segment sum over a CSR as its adjoint, so neither
direction is a scatter-add with atomics:

* ``gather_src_rows(g, x)`` = ``x[src[j]]``; backward: for every source
  node, the sum of the cotangents of its out-edges, one K1 launch
  (``kernels/csr_spmm.py``) over the reverse CSR with ``g.reverse.eid``
  (each reverse slot's forward-canonical slot) as its index, so the
  cotangents are read where they lie, with no permuted copy. The JAX
  package permutes them and sums with K2 (``_seg_sum_by_dst``);
* ``spread_dst(g, v)`` = ``v[dst[j]]``; backward: K2 over the dst CSR;
* ``seg_sum_dst(g, msg)`` = K2 over the dst CSR (``ops/segment.py:
  segment_sum`` by dst); backward: the row gather by dst.

``gather_dst`` is the plain row gather; autograd differentiates it.
Edge arrays are in the graph's canonical (dst-sorted) order, any trailing
shape.
"""

from __future__ import annotations

import torch

from ..graph.graph import Graph
from ..kernels.csr_spmm import csr_spmm
from .segment import _seg_sum_rows, segment_sum

__all__ = ["gather_dst", "gather_src_rows", "spread_dst", "seg_sum_dst"]


def gather_dst(g: Graph, v: torch.Tensor) -> torch.Tensor:
    """``v[dst[j]]`` for every edge."""
    return v.index_select(0, g.dst)


class _GatherSrcRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.index_select(0, g.src)

    @staticmethod
    def backward(ctx, ge):
        rev = ctx.g.reverse
        flat = ge.reshape(ge.shape[0], -1).contiguous()
        grad_x = csr_spmm(rev.indptr, rev.eid, flat, split=rev.split)
        return grad_x.reshape((-1,) + tuple(ge.shape[1:])), None


class _SpreadDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, g):
        ctx.g = g
        return gather_dst(g, v)

    @staticmethod
    def backward(ctx, ge):
        return _seg_sum_rows(ge, ctx.g.indptr, ctx.g.split), None


def gather_src_rows(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``x[src[j]]`` whose backward is one K1 launch over the
    reverse CSR. Share one result across every consumer of ``x[src]`` in a
    layer, so the layer pays one gather each way."""
    if g.reverse is None:
        raise ValueError("gather_src_rows needs the graph's reverse for its backward")
    return _GatherSrcRows.apply(x, g)


def spread_dst(g: Graph, v: torch.Tensor) -> torch.Tensor:
    """Differentiable ``v[dst[j]]`` whose backward is one K2 launch."""
    return _SpreadDst.apply(v, g)


def seg_sum_dst(g: Graph, msg: torch.Tensor) -> torch.Tensor:
    """Differentiable sorted segment sum of edge messages by dst (one K2
    launch) whose backward is ``gather_dst``."""
    if msg.shape[0] != g.num_edges:
        raise ValueError(f"edge messages must have {g.num_edges} rows, got {tuple(msg.shape)}")
    return segment_sum(msg, g.dst, g.indptr, g.split)
