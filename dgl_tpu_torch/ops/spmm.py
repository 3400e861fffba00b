"""g-SpMM: message passing as one sparse-dense product per direction.

Counterpart of ``dgl_tpu/ops/spmm.py:gspmm`` for the ops of the main path::

    out[v] = reduce_{e=(u,v)} x[u],   reduce ∈ {sum, mean}

Zero-in-degree nodes give 0. The forward is one K1 launch over the
dst-sorted CSR (mean divides by the clamped in-degree inside the kernel).
The backward scales the output cotangent by the same ``1/max(deg, 1)`` for
mean and aggregates it with one K1 launch over the reverse CSR, as
``_lane_copy_u_bwd`` does in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph.graph import Graph
from ..kernels.csr_spmm import csr_spmm

__all__ = ["gspmm"]

_COPY_U = ("copy_u", "copy_lhs")
# ops and reduces of the JAX package that later slices of the port bring
_LATER_OPS = {
    "copy_e": "slice B (GAT: segment sums of edge messages)",
    "copy_rhs": "slice B (GAT: segment sums of edge messages)",
    "add": "slice D (binary ops with edge weights)",
    "sub": "slice D (binary ops with edge weights)",
    "mul": "slice D (binary ops with edge weights)",
    "div": "slice D (binary ops with edge weights)",
}
_LATER_REDUCES = {
    "max": "slice B (segment extrema)",
    "min": "slice B (segment extrema)",
}


def _inv_deg(g: Graph, dtype) -> torch.Tensor:
    return 1.0 / g.in_degrees().clamp(min=1).to(dtype)


class _CopyU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, g: Graph, mean: bool) -> torch.Tensor:
        ctx.g, ctx.mean = g, mean
        return csr_spmm(g.indptr, g.src, x.contiguous(), mean=mean)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor):
        g: Graph = ctx.g
        if ctx.mean:
            g_out = g_out * _inv_deg(g, g_out.dtype).unsqueeze(1)
        rev = g.reverse
        grad_x = csr_spmm(rev.indptr, rev.src, g_out.contiguous())
        return grad_x, None, None


def gspmm(
    g: Graph,
    op: str,
    reduce: str,
    x: Optional[torch.Tensor] = None,
    e: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generalized SpMM; this slice serves ``copy_u``/``copy_lhs`` with
    ``sum``/``mean``.

    Args:
      g: graph with its reverse (``from_edges`` builds both).
      op: message op; ``copy_u`` uses only ``x``.
      reduce: ``sum`` or ``mean``.
      x: (num_src_nodes, D) float32 source-node features.
      e: edge features; unused by ``copy_u``.
    Returns:
      (num_dst_nodes, D) aggregated features.
    """
    if op in _LATER_OPS:
        raise NotImplementedError(f"spmm op {op!r} is ported in {_LATER_OPS[op]}")
    if op not in _COPY_U:
        raise ValueError(f"unknown spmm op: {op!r}")
    if reduce in _LATER_REDUCES:
        raise NotImplementedError(f"spmm reduce {reduce!r} is ported in {_LATER_REDUCES[reduce]}")
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown spmm reduce: {reduce!r}")
    if x is None:
        raise ValueError(f"spmm op {op!r} requires node features x")
    if x.dim() != 2 or x.shape[0] != g.num_src_nodes:
        raise ValueError(
            f"x must be (num_src_nodes={g.num_src_nodes}, D), got {tuple(x.shape)}"
        )
    if g.reverse is None:
        raise ValueError("gspmm needs the graph's reverse for its backward")
    return _CopyU.apply(x, g, reduce == "mean")

