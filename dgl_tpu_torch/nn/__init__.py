from .conv import GATConv, SAGEConv, dropout
from .init import kaiming_uniform_fan_in, relu_gain, xavier_uniform_
from .norm import MaskedBatchNorm

__all__ = [
    "SAGEConv",
    "GATConv",
    "MaskedBatchNorm",
    "dropout",
    "relu_gain",
    "xavier_uniform_",
    "kaiming_uniform_fan_in",
]
