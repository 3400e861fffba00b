"""GraphSAGE over one full graph.

Counterpart of ``dgl_tpu/models/sage.py:GraphSAGE`` (full-graph part):
* ``batch_norm=False``: the 2-layer citation/reddit net, relu inside the
  hidden convs and dropout only on the last conv's input;
* ``batch_norm=True``: the OGB net, conv → BN → relu → dropout between
  layers.
Dropout masks come from the ``generator`` passed to ``forward``; the
initial weights from the CPU ``generator`` passed to the constructor.
``lowering`` goes to every layer's ``gspmm`` (``ops/spmm.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph
from ..nn import MaskedBatchNorm, SAGEConv
from ..nn.conv import dropout as feature_dropout

__all__ = ["GraphSAGE"]


class GraphSAGE(nn.Module):
    def __init__(
        self,
        in_feats: int,
        hidden_feats: int,
        out_feats: int,
        num_layers: int = 2,
        aggr: str = "mean",
        dropout: float = 0.5,
        batch_norm: bool = False,
        *,
        lowering: str = "fused",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.dropout, self.batch_norm = dropout, batch_norm
        self.convs = nn.ModuleList()
        for i in range(num_layers):
            last = i == num_layers - 1
            self.convs.append(SAGEConv(
                in_feats if i == 0 else hidden_feats,
                out_feats if last else hidden_feats,
                aggr,
                feat_drop=dropout if (last and not batch_norm) else 0.0,
                activation=None if (last or batch_norm) else F.relu,
                lowering=lowering,
                device="cpu",
                generator=generator,
            ))
        self.bns = nn.ModuleList(
            MaskedBatchNorm(hidden_feats, device="cpu") for _ in range(num_layers - 1)
        ) if batch_norm else None
        self.to(dev)

    def forward(
        self,
        g: Graph,
        x: torch.Tensor,
        *,
        x_agg: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``x_agg`` (optional) is the precomputed ``gspmm(g, copy_u, aggr, x)``
        of the input features: in full-graph training layer 1's aggregation
        never changes, so it can be hoisted out of the step (exact, since
        aggregation commutes with the projection)."""
        h = x
        for i, conv in enumerate(self.convs):
            h = conv(g, h, x_agg=x_agg if i == 0 else None, generator=generator)
            if self.batch_norm and i < len(self.convs) - 1:
                h = F.relu(self.bns[i](h))
                h = feature_dropout(h, self.dropout, self.training, generator)
        return h
