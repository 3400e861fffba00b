from . import transforms
from .batch import GraphBatch, batch_graphs, readout
from .graph import Graph, from_edges

__all__ = ["Graph", "from_edges", "GraphBatch", "batch_graphs", "readout", "transforms"]
