"""Batch normalization over (optionally masked) node features.

Counterpart of ``dgl_tpu/nn/norm.py:MaskedBatchNorm``, with its semantics
rather than ``nn.BatchNorm1d``'s: the running variance tracks the biased
batch variance, and the running statistics move as
``momentum · running + (1 - momentum) · batch`` with ``momentum = 0.9``.
With ``mask=None`` every node counts.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device

__all__ = ["MaskedBatchNorm"]


class MaskedBatchNorm(nn.Module):
    def __init__(
        self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
        *, device: DeviceLike = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features, device=dev))
        self.bias = nn.Parameter(torch.zeros(num_features, device=dev))
        self.register_buffer("running_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("running_var", torch.ones(num_features, device=dev))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if mask is None:
                mean = x.mean(dim=0)
                var = ((x - mean) ** 2).mean(dim=0)
            else:
                m = mask.to(x.dtype).unsqueeze(1)
                count = m.sum().clamp(min=1.0)
                mean = (x * m).sum(dim=0) / count
                var = (((x - mean) ** 2) * m).sum(dim=0) / count
            with torch.no_grad():
                mo = self.momentum
                self.running_mean.copy_(mo * self.running_mean + (1 - mo) * mean)
                self.running_var.copy_(mo * self.running_var + (1 - mo) * var)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
