"""Graph readout modules (``dgl.nn.AvgPooling`` and its kin), thin wrappers
over ``graph/batch.py:readout``. Counterpart of ``dgl_tpu/nn/pooling.py``."""

from __future__ import annotations

import torch
from torch import nn

from ..graph.batch import GraphBatch, readout

__all__ = ["AvgPooling", "SumPooling", "MaxPooling"]


class AvgPooling(nn.Module):
    def forward(self, batch: GraphBatch, x: torch.Tensor) -> torch.Tensor:
        return readout(batch, x, "mean")


class SumPooling(nn.Module):
    def forward(self, batch: GraphBatch, x: torch.Tensor) -> torch.Tensor:
        return readout(batch, x, "sum")


class MaxPooling(nn.Module):
    def forward(self, batch: GraphBatch, x: torch.Tensor) -> torch.Tensor:
        return readout(batch, x, "max")
