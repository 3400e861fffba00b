from .cluster import ClusterBatch, ClusterIter
from .dataloader import GraphBatchLoader, prefetch
from .device import DeviceNeighborSampler
from .neighbor import CSRGraph, MiniBatch, MultiLayerNeighborSampler, NodeDataLoader

__all__ = ["GraphBatchLoader", "prefetch", "CSRGraph", "MiniBatch", "MultiLayerNeighborSampler",
           "NodeDataLoader", "DeviceNeighborSampler", "ClusterIter", "ClusterBatch"]
