"""RGCN over one full graph: the ogbn-proteins network.

Counterpart of ``dgl_tpu/models/rgcn.py:RGCN`` (the reference's
``main_dgl_proteins_rgcn_for.py:62-109``): ``num_layers`` ``RelGraphConv``
layers, relu and dropout between them, none after the last. Dropout masks
come from the ``generator`` passed to ``forward``; the initial weights from
the CPU ``generator`` passed to the constructor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph
from ..nn import RelGraphConv
from ..ops.rel import RelEdgeWeights

__all__ = ["RGCN"]


class RGCN(nn.Module):
    def __init__(
        self,
        in_feats: int,
        hidden_feats: int,
        out_feats: int,
        num_relations: int,
        num_layers: int = 3,
        dropout: float = 0.0,
        *,
        fuse_relations: bool = False,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.convs = nn.ModuleList()
        for i in range(num_layers):
            last = i == num_layers - 1
            self.convs.append(RelGraphConv(
                in_feats if i == 0 else hidden_feats,
                out_feats if last else hidden_feats,
                num_relations,
                activation=None if last else F.relu,
                dropout=0.0 if last else dropout,
                fuse_relations=fuse_relations,
                device="cpu",
                generator=generator,
            ))
        self.to(resolve_device(device))

    def forward(self, g: Graph, x: torch.Tensor, weights: RelEdgeWeights, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for conv in self.convs:
            x = conv(g, x, weights, generator=generator)
        return x
