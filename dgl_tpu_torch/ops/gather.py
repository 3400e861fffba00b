"""Edge-side gathers and their adjoint reductions.

Counterpart of ``dgl_tpu/ops/gather.py``. Each differentiable op pairs a
row gather with a segment sum over a CSR as its adjoint, so neither
direction is a scatter-add with atomics. Every row gather is P1 in source
order (``kernels/row_gather.py:row_gather_by_source``) over one of the
graph's CSRs, which are its plans: each row is read once and written to its
edges.

* ``gather_src_rows(g, x)`` = ``x[src[j]]``: the reverse CSR, whose
  ``g.reverse.eid`` holds each reverse slot's forward-canonical slot, the
  output position. Backward: for every source node, the sum of the
  cotangents of its out-edges, one K1 launch (``kernels/csr_spmm.py``)
  over the reverse CSR with ``g.reverse.eid`` as its index, so the
  cotangents are read where they lie, with no permuted copy. The JAX
  package permutes them and sums with K2 (``_seg_sum_by_dst``);
* ``spread_dst(g, v)`` and ``gather_dst(g, v)`` = ``v[dst[j]]``: the dst
  CSR, positions equal to slots, so the writes are contiguous runs.
  Backward: K2 over the dst CSR;
* ``seg_sum_dst(g, msg)`` = K2 over the dst CSR (``ops/segment.py:
  segment_sum`` by dst); backward: the row gather by dst.

Edge arrays are in the graph's canonical (dst-sorted) order, any trailing
shape, float32 or bfloat16. The gathers keep their input's type and their
adjoints sum in float32 and round once to it; ``seg_sum_dst`` of bfloat16
messages returns float32 sums, the JAX ``_seg_sum_by_dst``'s promotion, and
its gradient is bfloat16, the messages' type (where the JAX function's
custom VJP returns float32, torch's autograd casts a gradient to its
input's type). The backwards are kernel launches that autograd does not
trace, so the ops have first-order gradients only: a double backward
raises.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..graph.graph import Graph
from ..kernels.csr_spmm import csr_spmm
from .segment import _SegmentSum, _gather_rows, _seg_sum_rows

__all__ = ["gather_dst", "gather_src", "gather_src_rows", "spread_dst", "seg_sum_dst"]


class _GatherSrcRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        rev = g.reverse
        return _gather_rows(x, rev.indptr, rev.eid, rev.split)

    @staticmethod
    @once_differentiable
    def backward(ctx, ge):
        rev = ctx.g.reverse
        flat = ge.reshape(ge.shape[0], -1).contiguous()
        grad_x = csr_spmm(rev.indptr, rev.eid, flat, split=rev.split).to(ge.dtype)
        return grad_x.reshape((-1,) + tuple(ge.shape[1:])), None


class _SpreadDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, g):
        ctx.g = g
        return _gather_rows(v, g.indptr, None, g.split)

    @staticmethod
    @once_differentiable
    def backward(ctx, ge):
        return _seg_sum_rows(ge, ctx.g.indptr, ctx.g.split).to(ge.dtype), None


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


gather_dst = spread_dst  # the JAX package's name for the same gather
gather_src = gather_src_rows  # the JAX package's plain ``x[src]``: the same values


def seg_sum_dst(g: Graph, msg: torch.Tensor) -> torch.Tensor:
    """Differentiable sorted segment sum of edge messages by dst (one K2
    launch) whose backward is ``gather_dst``; float32 sums of float32 or
    bfloat16 messages."""
    if msg.shape[0] != g.num_edges:
        raise ValueError(f"edge messages must have {g.num_edges} rows, got {tuple(msg.shape)}")
    return _SegmentSum.apply(msg, g.indptr, g.split)
