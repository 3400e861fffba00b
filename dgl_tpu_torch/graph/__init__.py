from . import transforms
from .batch import GraphBatch, batch_graphs, readout
from .graph import Graph, from_edges
from .hetero import HeteroGraph

__all__ = ["Graph", "from_edges", "HeteroGraph", "GraphBatch", "batch_graphs", "readout",
           "transforms"]
