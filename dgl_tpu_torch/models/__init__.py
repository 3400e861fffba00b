from .gat import GAT
from .gcmc import GCMCNet
from .gcn_graph import GCNGraphClassifier, GCNMolClassifier
from .rgcn import RGCN
from .sage import GraphSAGE

__all__ = ["GraphSAGE", "GAT", "GCNGraphClassifier", "GCNMolClassifier", "RGCN", "GCMCNet"]
