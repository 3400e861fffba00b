"""Relation-weighted aggregation: RGCN's message passing as weighted K1 passes.

Counterpart of ``dgl_tpu/ops/spmm.py:gspmm_rel`` and of the weighted lane
passes of ``dgl_tpu/ops/rel_lane.py:rel_lane_agg``::

    out[v] = reduce_{e=(u,v)} Σ_r w[e, r] · y[u, r, :],   reduce ∈ {sum, mean}

mean dividing by the shared in-degree, zero-in-degree rows 0.

* Forward: one weighted K1 launch (``kernels/csr_spmm.py``) per relation
  over the dst CSR, on the contiguous slice ``y[r]`` of a relation-major
  (R, N, D) ``y`` with the weights ``w[:, r]`` in dst-CSR order; mean
  divides inside each launch. The R results are added into the first.
* Backward wrt ``y``: one weighted K1 launch per relation over the reverse
  CSR, the weights in reverse-CSR order, ``g_out`` scaled by
  ``1/max(deg, 1)`` for mean.
* Backward wrt ``w``: only when autograd asks for it, the per-edge dot
  ``⟨y[src, r], g_out[dst]⟩`` in plain PyTorch (an (E, D) buffer a
  relation). RGCN's edge weights are dataset constants, so its training
  step never computes it; GATConv's memory-safe form, whose weights are
  the attention ``alpha`` (heads as relations), does.

No (E, R, D) or (E, D) buffer is built on the forward or on the backward
wrt ``y``. Why R passes and not one fused relation kernel: on
ogbn-proteins one relation's ``y[r]`` (132,534 × 32 float32, 17 MB) stays
in the card's 50 MB L2 while a pass gathers it 39.5M times, where a fused
kernel would read a 1 KB row of the 136 MB ``y`` from device memory for
every edge (``PERF.md`` §6).

``RelEdgeWeights`` lays the weights out once per graph; ``gspmm_rel``
takes it or a canonical (E, R) tensor, which it lays out on every call.
``per_relation`` leaves out the sum over relations: ``RelGraphConv`` runs
it where it aggregates before it projects.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch.autograd.function import once_differentiable

from ..graph.graph import Graph
from ..kernels.csr_spmm import csr_spmm

__all__ = ["RelEdgeWeights", "gspmm_rel"]


@dataclasses.dataclass(frozen=True)
class RelEdgeWeights:
    """Per-relation edge weights in the layouts K1 reads.

    ``fwd`` (R, E): row r is relation r's weight of every edge in dst-CSR
    (canonical) order; ``rev`` (R, E): the same in reverse-CSR order
    (``w[rev.eid]``); ``canon``: the (E, R) canonical weights they were
    built from where those require a gradient, which then flows to them,
    else None (no third copy of the weights stays alive)."""

    fwd: torch.Tensor
    rev: torch.Tensor
    canon: Optional[torch.Tensor]

    @property
    def num_relations(self) -> int:
        return int(self.fwd.shape[0])

    @staticmethod
    def build(g: Graph, w: torch.Tensor) -> "RelEdgeWeights":
        """``w``: (E, R) float32 weights in canonical order, on the graph's
        device (``w_input_order[g.eid]``)."""
        if g.reverse is None:
            raise ValueError("RelEdgeWeights needs the graph's reverse")
        if w.dim() != 2 or w.shape[0] != g.num_edges:
            raise ValueError(f"edge weights must be (E={g.num_edges}, R), got {tuple(w.shape)}")
        wd = w.detach()
        return RelEdgeWeights(fwd=wd.t().contiguous(),
                              rev=wd.index_select(0, g.reverse.eid).t().contiguous(),
                              canon=w if w.requires_grad else None)


def _inv_deg(g: Graph, dtype) -> torch.Tensor:
    return (1.0 / g.in_degrees().clamp(min=1).to(dtype)).unsqueeze(1)


class _RelAgg(torch.autograd.Function):
    """``y`` (R, N_src, D) relation-major, each ``y[r]`` contiguous (a view
    expanded along R is fine); returns (N_dst, D) summed over R when
    ``contract``, else (R, N_dst, D)."""

    @staticmethod
    def forward(ctx, y, w, weights: RelEdgeWeights, g: Graph, mean: bool, contract: bool):
        ctx.weights, ctx.g, ctx.mean, ctx.contract = weights, g, mean, contract
        # y is needed only for the weights' gradient: constant weights (a
        # training step's) keep no (R, N, D) y alive until the backward
        ctx.save_for_backward(y if ctx.needs_input_grad[1] else None)
        outs = [csr_spmm(g.indptr, g.src, y[r], weights.fwd[r], mean=mean, split=g.split)
                for r in range(weights.num_relations)]
        if not contract:
            return torch.stack(outs)
        out = outs[0]
        for o in outs[1:]:
            out += o
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        (y,) = ctx.saved_tensors
        g, weights, n_rel = ctx.g, ctx.weights, ctx.weights.num_relations
        if ctx.mean:
            g_out = g_out * _inv_deg(g, g_out.dtype).reshape((1,) * (g_out.dim() - 2) + (-1, 1))
        g_rel = [g_out.contiguous()] * n_rel if ctx.contract else list(g_out.contiguous())
        grad_y = grad_w = None
        if ctx.needs_input_grad[0]:
            rev = g.reverse
            grad_y = torch.stack([csr_spmm(rev.indptr, rev.src, g_rel[r], weights.rev[r],
                                           split=rev.split) for r in range(n_rel)])
        if ctx.needs_input_grad[1]:
            src, dst = g.src.long(), g.dst.long()
            grad_w = torch.stack([(y[r].index_select(0, src) * g_rel[r].index_select(0, dst)).sum(-1)
                                  for r in range(n_rel)], dim=1)
        return grad_y, grad_w, None, None, None, None


def _weights(g: Graph, w: Union[RelEdgeWeights, torch.Tensor]) -> RelEdgeWeights:
    return w if isinstance(w, RelEdgeWeights) else RelEdgeWeights.build(g, w)


def _rows_in_place(y: torch.Tensor) -> torch.Tensor:
    """``y`` (R, N, D) whose every ``y[r]`` is a contiguous (N, D) block, a
    view expanded along R included; copied only when a block is not."""
    if y.stride(2) == 1 and y.stride(1) == y.shape[2]:
        return y
    return y.contiguous()


def gspmm_rel(
    reduce: str,
    g: Graph,
    y: torch.Tensor,
    w: Union[RelEdgeWeights, torch.Tensor],
    *,
    per_relation: bool = False,
) -> torch.Tensor:
    """Relation-contracted SpMM: ``reduce_by_dst(Σ_r w[e, r] · y[src, r])``.

    Args:
      reduce: ``sum`` or ``mean`` (by the in-degree, shared by the relations).
      g: graph with its reverse.
      y: (R, N_src, D) float32, relation-major (the JAX package takes
        (N_src, R, D)), so that each ``y[r]`` is read in place; a view of
        one (N, D) block expanded along R is read as it is, another layout
        is copied once.
      w: ``RelEdgeWeights`` built once for the graph, or (E, R) canonical
        weights, laid out on this call. A gradient wrt the weights flows to
        the tensor (``RelEdgeWeights.canon``) when it requires one.
      per_relation: return each relation's aggregation, (R, N_dst, D), and
        leave out the sum.
    Returns:
      (N_dst, D), or (R, N_dst, D) with ``per_relation``.
    """
    if reduce not in ("sum", "mean"):
        raise ValueError(f"gspmm_rel reduce must be sum or mean, got {reduce!r}")
    weights = _weights(g, w)
    if y.dim() != 3:
        raise ValueError(f"y must be 3-D, got shape {tuple(y.shape)}")
    if y.shape[:2] != (weights.num_relations, g.num_src_nodes):
        raise ValueError(f"y must hold R={weights.num_relations} relations of "
                         f"{g.num_src_nodes} source rows, got {tuple(y.shape)}")
    return _RelAgg.apply(_rows_in_place(y), weights.canon, weights, g, reduce == "mean",
                         not per_relation)

