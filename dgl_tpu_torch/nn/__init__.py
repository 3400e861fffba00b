from .conv import GATConv, GCNConv, GCNConvEdge, RelGraphConv, SAGEConv, dropout
from .encoders import AtomEncoder, BondEncoder, CategoricalEncoder
from .gcmc import BiDecoder, DenseBiDecoder, GCMCGraphConv, GCMCLayer
from .hetero import HeteroGraphConv
from .init import kaiming_uniform_fan_in, lecun_normal_, relu_gain, xavier_uniform_
from .norm import MaskedBatchNorm
from .pooling import AvgPooling, MaxPooling, SumPooling
from .predictors import DotPredictor, MLPPredictor, PairMLPPredictor

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
    "DotPredictor",
    "MLPPredictor",
    "PairMLPPredictor",
    "GCMCGraphConv",
    "GCMCLayer",
    "BiDecoder",
    "DenseBiDecoder",
    "HeteroGraphConv",
    "dropout",
    "relu_gain",
    "xavier_uniform_",
    "kaiming_uniform_fan_in",
    "lecun_normal_",
]
