from .gather import gather_dst, gather_src_rows, seg_sum_dst, spread_dst
from .segment import segment_max, segment_mean, segment_sum
from .softmax import edge_softmax
from .spmm import gspmm

__all__ = [
    "gspmm",
    "edge_softmax",
    "gather_dst",
    "gather_src_rows",
    "spread_dst",
    "seg_sum_dst",
    "segment_sum",
    "segment_mean",
    "segment_max",
]
