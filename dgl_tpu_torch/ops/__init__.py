from .gather import gather_dst, gather_src, gather_src_rows, seg_sum_dst, spread_dst
from .rel import RelEdgeWeights, gspmm_rel
from .sddmm import gsddmm, u_dot_v, u_mul_v
from .segment import segment_count, segment_max, segment_mean, segment_min, segment_sum
from .softmax import edge_softmax
from .spmm import copy_u_mean, copy_u_sum, gspmm, u_mul_e_sum

__all__ = [
    "gspmm",
    "copy_u_sum",
    "copy_u_mean",
    "u_mul_e_sum",
    "gspmm_rel",
    "RelEdgeWeights",
    "edge_softmax",
    "gsddmm",
    "u_dot_v",
    "u_mul_v",
    "gather_dst",
    "gather_src",
    "gather_src_rows",
    "spread_dst",
    "seg_sum_dst",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_count",
]
