from .gat import GAT
from .sage import GraphSAGE

__all__ = ["GraphSAGE", "GAT"]
