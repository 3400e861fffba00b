"""Sorted segment reductions over the first axis.

Counterpart of ``dgl_tpu/ops/segment.py`` for sorted segment ids (the
JAX package's prefix-scan and blocked forms exist only for the TPU and are
not ported):

* ``segment_sum`` / ``segment_mean``: one K2 launch (``kernels/seg_sum.py``)
  over the segments' row offsets ``indptr``, which the caller builds on the
  host with their row split (as ``from_edges`` and ``batch_graphs`` do), so
  nothing is read back from the card; the backward is the row gather
  ``gout[seg_ids]``. An empty segment gives 0; mean divides by
  ``max(count, 1)``.
* ``segment_max``: plain PyTorch (an XLA op in the JAX package, not a
  kernel); the exact shift of ``edge_softmax`` and the max readout use it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph.split import RowSplit
from ..kernels.seg_sum import seg_sum

__all__ = ["segment_sum", "segment_mean", "segment_max"]


def _seg_sum_rows(data: torch.Tensor, indptr: torch.Tensor,
                  split: Optional[RowSplit]) -> torch.Tensor:
    """K2 over ``indptr``, any trailing shape: (E, ...) → (S, ...)."""
    tail = tuple(data.shape[1:])
    out = seg_sum(indptr, data.reshape(data.shape[0], -1).contiguous(), split=split)
    return out.reshape((indptr.numel() - 1,) + tail)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg_ids, indptr, split):
        ctx.save_for_backward(seg_ids)
        return _seg_sum_rows(data, indptr, split)

    @staticmethod
    def backward(ctx, gout):
        (seg_ids,) = ctx.saved_tensors
        return gout.index_select(0, seg_ids), None, None, None


def segment_sum(data: torch.Tensor, seg_ids: torch.Tensor, indptr: torch.Tensor,
                split: Optional[RowSplit] = None) -> torch.Tensor:
    """``out[s] = Σ_{j: seg_ids[j] = s} data[j]``, differentiable in ``data``.

    ``seg_ids`` (E,) ascending, ``indptr`` (S + 1,) the same segments as row
    offsets (``indptr[s]:indptr[s + 1]`` holds segment ``s``), ``split``
    their row split (see ``kernels/seg_sum.py``; without one a launch on the
    card reads ``indptr`` back)."""
    if data.shape[0] != seg_ids.shape[0]:
        raise ValueError(f"data has {data.shape[0]} rows, seg_ids {seg_ids.shape[0]}")
    return _SegmentSum.apply(data, seg_ids, indptr, split)


def segment_mean(data: torch.Tensor, seg_ids: torch.Tensor, indptr: torch.Tensor,
                 split: Optional[RowSplit] = None) -> torch.Tensor:
    """``segment_sum`` divided by ``max(count, 1)`` per segment."""
    out = segment_sum(data, seg_ids, indptr, split)
    inv = 1.0 / (indptr[1:] - indptr[:-1]).clamp(min=1).to(out.dtype)
    return out * inv.reshape((-1,) + (1,) * (out.dim() - 1))


def segment_max(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[r] = max_{j: seg_ids[j] = r} data[j]`` over the first axis;
    a segment with no element gives 0 (DGL semantics)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    index = seg_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, index, data, "amax", include_self=False)
