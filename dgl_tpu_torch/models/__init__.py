from .sage import GraphSAGE

__all__ = ["GraphSAGE"]
