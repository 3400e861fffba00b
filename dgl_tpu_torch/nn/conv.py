"""Graph convolution layers over ``dgl_tpu_torch.ops``.

Counterpart of ``dgl_tpu/nn/conv.py``; this slice ports ``SAGEConv``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph
from ..ops import gspmm
from .init import relu_gain, xavier_uniform_

__all__ = ["SAGEConv", "dropout"]


def dropout(
    x: torch.Tensor, p: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator`` (on x's device)."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return x * mask / keep


class SAGEConv(nn.Module):
    """GraphSAGE convolution: ``fc_self(x) + fc_neigh(agg(x)) + bias``.

    The reference's hand-built SAGEConv: mean or sum aggregation of source
    features, xavier-uniform (relu gain) weights, bias only on the neighbour
    term, added after aggregation.

    When ``out_feats < in_feats`` the neighbour term projects first and
    aggregates after (aggregation commutes with the linear map), so the SpMM
    moves ``out_feats``-wide rows. ``x_agg``, a precomputed
    ``gspmm(g, copy_u, aggr, x)``, replaces the aggregation entirely; it is
    invalid with ``feat_drop``, which must act before aggregation.

    ``generator`` (a CPU generator) draws the initial weights.
    """

    def __init__(
        self,
        in_feats: int,
        out_feats: int,
        aggr: str = "mean",
        feat_drop: float = 0.0,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if aggr not in ("mean", "sum"):
            raise ValueError(f"SAGEConv aggr must be mean|sum, got {aggr!r}")
        dev = resolve_device(device)
        self.in_feats, self.out_feats = in_feats, out_feats
        self.aggr, self.feat_drop, self.activation = aggr, feat_drop, activation
        self.fc_self = nn.utils.skip_init(nn.Linear, in_feats, out_feats, bias=False)
        self.fc_neigh = nn.utils.skip_init(nn.Linear, in_feats, out_feats, bias=False)
        self.fc_neigh_bias = nn.Parameter(torch.zeros(out_feats))
        xavier_uniform_(self.fc_self.weight, relu_gain(), generator)
        xavier_uniform_(self.fc_neigh.weight, relu_gain(), generator)
        self.to(dev)

    def forward(
        self,
        g: Graph,
        x: torch.Tensor,
        *,
        x_agg: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if self.feat_drop > 0.0:
            if x_agg is not None:
                raise ValueError(
                    "x_agg (precomputed aggregation) is invalid with feat_drop: "
                    "dropout must be applied before aggregation"
                )
            x = dropout(x, self.feat_drop, self.training, generator)
        if x_agg is not None:
            h_neigh = self.fc_neigh(x_agg)
        elif self.out_feats < self.in_feats:
            h_neigh = gspmm(g, "copy_u", self.aggr, x=self.fc_neigh(x))
        else:
            h_neigh = self.fc_neigh(gspmm(g, "copy_u", self.aggr, x=x))
        out = self.fc_self(x) + h_neigh + self.fc_neigh_bias
        if self.activation is not None:
            out = self.activation(out)
        return out
