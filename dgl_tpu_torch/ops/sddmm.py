"""g-SDDMM: a per-edge binary op on endpoint features.

Counterpart of ``dgl_tpu/ops/sddmm.py`` (``dgl.ops.gsddmm``,
``fn.u_dot_v``). For every edge ``e = (u, v)``, in canonical (dst-sorted)
order::

    out[e] = op(lhs[u], rhs[v]),  op ∈ {add, sub, mul, div, dot, copy_u, copy_v}

``lhs[u]`` is ``ops/gather.py:gather_src_rows``, whose adjoint is one K1
launch over the reverse CSR; ``rhs[v]`` is ``gather_dst``, a row gather that
autograd differentiates; the ops are elementwise torch. ``dot`` keeps a
trailing axis of 1. The graph has no padded edges, so ``mask_padding`` is
accepted and does nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph.graph import Graph
from .gather import gather_dst, gather_src_rows

__all__ = ["gsddmm", "u_dot_v", "u_mul_v"]

_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "dot": lambda a, b: (a * b).sum(-1, keepdim=True),
}


def gsddmm(
    g: Graph,
    op: str,
    u: Optional[torch.Tensor] = None,
    v: Optional[torch.Tensor] = None,
    *,
    mask_padding: bool = True,
) -> torch.Tensor:
    """Generalized SDDMM: (num_src_nodes, ...) ``u`` and (num_dst_nodes, ...)
    ``v`` to (E, ...) edge values."""
    del mask_padding  # no padded edges to mask
    if op in ("copy_u", "copy_lhs"):
        return gather_src_rows(g, u)
    if op in ("copy_v", "copy_rhs"):
        return gather_dst(g, v)
    if op not in _BINARY:
        raise ValueError(f"unknown sddmm op: {op!r}")
    return _BINARY[op](gather_src_rows(g, u), gather_dst(g, v))


def u_dot_v(g: Graph, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-edge dot product (``fn.u_dot_v``), (E, 1)."""
    return gsddmm(g, "dot", u, v)


def u_mul_v(g: Graph, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return gsddmm(g, "mul", u, v)
