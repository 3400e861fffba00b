from .loaders import data_root, load_graph_dataset, load_node_dataset
from .synthetic import (
    GRAPH_DATASET_STATS,
    NODE_DATASET_STATS,
    GraphClassificationData,
    NodeClassificationData,
    synthetic_graph_classification,
    synthetic_node_classification,
)

__all__ = [
    "data_root",
    "load_node_dataset",
    "load_graph_dataset",
    "NODE_DATASET_STATS",
    "GRAPH_DATASET_STATS",
    "NodeClassificationData",
    "GraphClassificationData",
    "synthetic_node_classification",
    "synthetic_graph_classification",
]
