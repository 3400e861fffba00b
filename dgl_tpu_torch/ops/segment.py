"""Sorted segment extrema over the dst-sorted edge order.

Counterpart of ``dgl_tpu/ops/segment.py:segment_max``; the exact shift of
``edge_softmax`` needs it. The sorted segment *sum* is K2
(``kernels/seg_sum.py``); the JAX package's prefix-scan and blocked forms
exist only for the TPU and are not ported.
"""

from __future__ import annotations

import torch

__all__ = ["segment_max"]


def segment_max(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[r] = max_{j: seg_ids[j] = r} data[j]`` over the first axis;
    a segment with no element gives 0 (DGL semantics)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    index = seg_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, index, data, "amax", include_self=False)
