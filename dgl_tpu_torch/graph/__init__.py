from . import transforms
from .graph import Graph, from_edges

__all__ = ["Graph", "from_edges", "transforms"]
