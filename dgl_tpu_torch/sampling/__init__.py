from .dataloader import GraphBatchLoader, prefetch

__all__ = ["GraphBatchLoader", "prefetch"]
