"""dgl_tpu_torch: the PyTorch and CUDA port of dgl_tpu, for NVIDIA Hopper.

Plain tensor code is PyTorch; every kernel that dgl_tpu wrote in Pallas for
the TPU is a kernel written by hand for the card (``kernels/csrc``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on CPU
tensors each kernel wrapper computes its plain PyTorch version instead.
"""

from . import graph, ops
from .graph import (Graph, GraphBatch, HeteroGraph, batch_graphs, from_edges, from_scipy_coo,
                    readout)
from .models import GAT, GraphSAGE
from .nn import GATConv, SAGEConv
from .ops import edge_softmax, gspmm

__all__ = ["Graph", "GraphBatch", "HeteroGraph", "batch_graphs", "from_edges", "from_scipy_coo",
           "readout", "ops", "graph", "gspmm", "edge_softmax", "SAGEConv", "GATConv", "GraphSAGE",
           "GAT"]
