from .loaders import data_root, load_node_dataset
from .synthetic import (
    NODE_DATASET_STATS,
    NodeClassificationData,
    synthetic_node_classification,
)

__all__ = [
    "data_root",
    "load_node_dataset",
    "NODE_DATASET_STATS",
    "NodeClassificationData",
    "synthetic_node_classification",
]
