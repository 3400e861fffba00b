from .gat import GAT
from .gcn_graph import GCNGraphClassifier, GCNMolClassifier
from .sage import GraphSAGE

__all__ = ["GraphSAGE", "GAT", "GCNGraphClassifier", "GCNMolClassifier"]
