"""Parameter initializers with the reference's conventions.

The reference initializes every hand-built layer with
``xavier_uniform_(w, gain=calculate_gain('relu'))``; RGCN and torch's
``Linear`` default use ``kaiming_uniform_(a=sqrt(5))``. Each initializer
draws from an explicit ``torch.Generator`` so a seed fixes the weights.
Weights are torch ``Linear`` layouts, ``(fan_out, fan_in)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["relu_gain", "xavier_uniform_", "kaiming_uniform_fan_in"]


def relu_gain() -> float:
    return math.sqrt(2.0)


def _fans(tensor: torch.Tensor):
    if tensor.dim() < 2:
        raise ValueError(f"fan in and fan out need a tensor of 2 or more dims, got {tensor.dim()}")
    receptive = tensor[0][0].numel()
    return tensor.shape[1] * receptive, tensor.shape[0] * receptive


@torch.no_grad()
def xavier_uniform_(
    tensor: torch.Tensor, gain: float = 1.0, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """U(-b, b) with b = gain · sqrt(6 / (fan_in + fan_out)), in place."""
    fan_in, fan_out = _fans(tensor)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return tensor.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def kaiming_uniform_fan_in(
    tensor: torch.Tensor, a: float = math.sqrt(5.0), generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """U(-b, b) with b = sqrt(6 / ((1 + a²) · fan_in)), in place."""
    fan_in, _ = _fans(tensor)
    bound = math.sqrt(6.0 / ((1.0 + a * a) * fan_in))
    return tensor.uniform_(-bound, bound, generator=generator)
