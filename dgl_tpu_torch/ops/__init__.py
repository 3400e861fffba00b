from .gather import gather_dst, gather_src_rows, seg_sum_dst, spread_dst
from .rel import RelEdgeWeights, gspmm_rel
from .segment import segment_max, segment_mean, segment_min, segment_sum
from .softmax import edge_softmax
from .spmm import gspmm

__all__ = [
    "gspmm",
    "gspmm_rel",
    "RelEdgeWeights",
    "edge_softmax",
    "gather_dst",
    "gather_src_rows",
    "spread_dst",
    "seg_sum_dst",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
]
