from .spmm import gspmm

__all__ = ["gspmm"]
