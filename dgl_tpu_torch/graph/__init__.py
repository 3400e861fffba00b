from . import transforms
from .batch import GraphBatch, batch_graphs, readout
from .graph import Graph, from_edges, from_scipy_coo
from .hetero import HeteroGraph

__all__ = ["Graph", "from_edges", "from_scipy_coo", "HeteroGraph", "GraphBatch", "batch_graphs",
           "readout", "transforms"]
