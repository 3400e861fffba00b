from .conv import GATConv, GCNConv, GCNConvEdge, RelGraphConv, SAGEConv, dropout
from .encoders import AtomEncoder, BondEncoder, CategoricalEncoder
from .init import kaiming_uniform_fan_in, relu_gain, xavier_uniform_
from .norm import MaskedBatchNorm
from .pooling import AvgPooling, MaxPooling, SumPooling

__all__ = [
    "SAGEConv",
    "GATConv",
    "GCNConv",
    "GCNConvEdge",
    "RelGraphConv",
    "MaskedBatchNorm",
    "AvgPooling",
    "SumPooling",
    "MaxPooling",
    "CategoricalEncoder",
    "AtomEncoder",
    "BondEncoder",
    "dropout",
    "relu_gain",
    "xavier_uniform_",
    "kaiming_uniform_fan_in",
]
