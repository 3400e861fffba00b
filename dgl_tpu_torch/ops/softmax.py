"""Edge softmax: a numerically stable softmax over the in-edges of each node.

Counterpart of ``dgl_tpu/ops/softmax.py:edge_softmax``. Per destination
``v``::

    alpha[j] = exp(z[j] - shift[v]) / Σ_{j'→v} exp(z[j'] - shift[v])

with ``shift`` the exact segment max, or a caller's per-dst upper bound
(``dst_bound``), which softmax does not change under. Both sums are K2
launches: ``seg_sum_dst`` for the denominators and, in the backward of
``spread_dst``, for their cotangents.

A loose bound can shrink a row's denominator until the quotient's backward
overflows (``1/denom²``) or every term underflows. When any denominator
falls to ``eps`` or below, the exact form runs instead (the rescue). ``eps``
is 1e-12, the JAX package's value, or the dtype's smallest normal number
where 1e-12 is not representable (float16). Deciding the rescue reads one
flag from the card, a host sync; ``edge_softmax.rescues`` counts the calls
that took it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph.graph import Graph
from .gather import gather_dst, seg_sum_dst, spread_dst
from .segment import segment_max

__all__ = ["edge_softmax"]


def _eps(dtype: torch.dtype) -> float:
    return max(1e-12, torch.finfo(dtype).smallest_normal)


def _softmax_shifted(g: Graph, logits: torch.Tensor, shift: torch.Tensor):
    expz = torch.exp(logits - gather_dst(g, shift.detach()))
    return expz, spread_dst(g, seg_sum_dst(g, expz))


def _exact(g: Graph, logits: torch.Tensor) -> torch.Tensor:
    # every non-empty row has one term at exp(0) = 1, so denom >= 1
    expz, denom = _softmax_shifted(g, logits, segment_max(logits.detach(), g.dst, g.num_dst_nodes))
    return expz / denom.clamp(min=torch.finfo(expz.dtype).tiny)


def edge_softmax(g: Graph, logits: torch.Tensor, dst_bound: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of (E, ...) edge logits grouped by destination node; trailing
    dims (heads) are independent.

    ``dst_bound`` (N_dst, ...), optional: an upper bound on each node's
    incoming logits, used as the shift in place of the exact segment max.
    """
    if logits.shape[0] != g.num_edges:
        raise ValueError(f"edge logits must have {g.num_edges} rows, got {tuple(logits.shape)}")
    if dst_bound is None:
        return _exact(g, logits)
    bound = dst_bound.reshape(tuple(dst_bound.shape) + (1,) * (logits.dim() - dst_bound.dim()))
    bound = bound.expand((g.num_dst_nodes,) + tuple(logits.shape[1:])).to(logits.dtype)
    expz, denom = _softmax_shifted(g, logits, bound)
    eps = _eps(expz.dtype)
    if bool((denom <= eps).any()):
        edge_softmax.rescues += 1
        return _exact(g, logits)
    return expz / denom.clamp(min=eps)


edge_softmax.rescues = 0
