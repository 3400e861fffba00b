"""g-SpMM: message passing as one sparse-dense product per direction.

Counterpart of ``dgl_tpu/ops/spmm.py:gspmm`` for the ops of the ported
paths::

    out[v] = reduce_{e=(u,v)} x[u]   (copy_u / copy_lhs)
    out[v] = reduce_{e=(u,v)} e[e]   (copy_e / copy_rhs)
    reduce ∈ {sum, mean}

Zero-in-degree nodes give 0. ``copy_u``: the forward is one K1 launch over
the dst-sorted CSR (mean divides by the clamped in-degree inside the
kernel); the backward scales the output cotangent by the same
``1/max(deg, 1)`` for mean and aggregates it with one K1 launch over the
reverse CSR, as ``_lane_copy_u_bwd`` does in the JAX package. ``copy_e``:
one K2 launch (``ops/gather.py:seg_sum_dst``) over edge features in
canonical order, any trailing shape; mean scales its result by
``1/max(deg, 1)``; the backward is a row gather by dst.

``lowering="scatter"`` is a second lowering the caller names, the PyG twin
(``dgl_tpu/ops/spmm.py:604-626``, the JAX package's
``DGL_TPU_LOWERING=scatter``): the (E, ...) messages are built with
``index_select`` (``copy_u``) or taken as given (``copy_e``), reduced with a
plain ``index_add_`` by dst, mean scaled by ``1/max(deg, 1)``, and autograd
differentiates the gather into a scatter. No K1 or K2 runs and the reverse
CSR is not used. It changes ``gspmm`` only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph.graph import Graph
from ..kernels.csr_spmm import csr_spmm
from .gather import seg_sum_dst

__all__ = ["gspmm"]

_COPY_U = ("copy_u", "copy_lhs")
_COPY_E = ("copy_e", "copy_rhs")
# ops and reduces of the JAX package that later slices of the port bring
_LATER_OPS = {
    "add": "slice D (binary ops with edge weights)",
    "sub": "slice D (binary ops with edge weights)",
    "mul": "slice D (binary ops with edge weights)",
    "div": "slice D (binary ops with edge weights)",
}
_LATER_REDUCES = {
    "max": "a later slice (segment max/min reductions)",
    "min": "a later slice (segment max/min reductions)",
}


def _inv_deg(g: Graph, dtype) -> torch.Tensor:
    return 1.0 / g.in_degrees().clamp(min=1).to(dtype)


class _CopyU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, g: Graph, mean: bool) -> torch.Tensor:
        ctx.g, ctx.mean = g, mean
        return csr_spmm(g.indptr, g.src, x.contiguous(), mean=mean, split=g.split)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor):
        g: Graph = ctx.g
        if ctx.mean:
            g_out = g_out * _inv_deg(g, g_out.dtype).unsqueeze(1)
        rev = g.reverse
        grad_x = csr_spmm(rev.indptr, rev.src, g_out.contiguous(), split=rev.split)
        return grad_x, None, None


def _scatter(g: Graph, msg: torch.Tensor, mean: bool) -> torch.Tensor:
    out = torch.zeros((g.num_dst_nodes,) + tuple(msg.shape[1:]), dtype=msg.dtype,
                      device=msg.device).index_add_(0, g.dst, msg)
    if mean:
        out = out * _inv_deg(g, out.dtype).reshape((-1,) + (1,) * (out.dim() - 1))
    return out


def gspmm(
    g: Graph,
    op: str,
    reduce: str,
    x: Optional[torch.Tensor] = None,
    e: Optional[torch.Tensor] = None,
    *,
    lowering: str = "fused",
) -> torch.Tensor:
    """Generalized SpMM; the port serves ``copy_u``/``copy_lhs`` and
    ``copy_e``/``copy_rhs`` with ``sum``/``mean``.

    Args:
      g: graph with its reverse (``from_edges`` builds both).
      op: message op; ``copy_u`` uses only ``x``, ``copy_e`` only ``e``.
      reduce: ``sum`` or ``mean``.
      x: (num_src_nodes, D) float32 source-node features.
      e: (num_edges, ...) float32 edge features in canonical order.
      lowering: ``fused`` (K1 / K2) or ``scatter`` (the PyG twin, above).
    Returns:
      (num_dst_nodes, D) or (num_dst_nodes, ...) aggregated features.
    """
    if op in _LATER_OPS:
        raise NotImplementedError(f"spmm op {op!r} is ported in {_LATER_OPS[op]}")
    if op not in _COPY_U + _COPY_E:
        raise ValueError(f"unknown spmm op: {op!r}")
    if reduce in _LATER_REDUCES:
        raise NotImplementedError(f"spmm reduce {reduce!r} is ported in {_LATER_REDUCES[reduce]}")
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown spmm reduce: {reduce!r}")
    if lowering not in ("fused", "scatter"):
        raise ValueError(f"unknown spmm lowering: {lowering!r}")
    if op in _COPY_E:
        if e is None:
            raise ValueError(f"spmm op {op!r} requires edge features e")
        if lowering == "scatter":
            return _scatter(g, e, reduce == "mean")
        out = seg_sum_dst(g, e)
        if reduce == "mean":
            out = out * _inv_deg(g, out.dtype).reshape((-1,) + (1,) * (out.dim() - 1))
        return out
    if x is None:
        raise ValueError(f"spmm op {op!r} requires node features x")
    if x.dim() != 2 or x.shape[0] != g.num_src_nodes:
        raise ValueError(
            f"x must be (num_src_nodes={g.num_src_nodes}, D), got {tuple(x.shape)}"
        )
    if lowering == "scatter":
        return _scatter(g, x.index_select(0, g.src), reduce == "mean")
    if g.reverse is None:
        raise ValueError("gspmm needs the graph's reverse for its backward")
    return _CopyU.apply(x, g, reduce == "mean")
