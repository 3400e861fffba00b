"""Sorted segment reductions over the first axis.

Counterpart of ``dgl_tpu/ops/segment.py`` for sorted segment ids (the
JAX package's prefix-scan and blocked forms exist only for the TPU and are
not ported):

* ``segment_sum`` / ``segment_mean``: one K2 launch (``kernels/seg_sum.py``)
  over the segments' row offsets ``indptr``, which the caller builds on the
  host with their row split (as ``from_edges`` and ``batch_graphs`` do), so
  nothing is read back from the card; the backward is the row gather
  ``gout[seg_ids]``, P1 in source order over the same row offsets
  (``kernels/row_gather.py:row_gather_by_source``, positions equal to
  slots). An empty segment gives 0; mean divides by ``max(count, 1)``.
  bfloat16 data is summed in float32 (K2's bfloat16 instantiation) and
  the result rounded once to bfloat16, the type the JAX ``segment_sum``
  and ``segment_mean`` return;
* ``segment_max`` / ``segment_min``: plain PyTorch ``scatter_reduce`` (an
  XLA op in the JAX package, not a kernel); the exact shift of
  ``edge_softmax``, the max readout and ``gspmm``'s max/min use them.
* ``segment_count`` / ``segment_softmax_denom``: the JAX package's
  unsorted helpers over any ids, plain ``scatter_add_`` / ``index_add_``
  (XLA scatters there); ids outside ``[0, num_segments)`` are dropped.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..graph.split import RowSplit
from ..kernels.row_gather import row_gather_by_source
from ..kernels.seg_sum import seg_sum

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min", "segment_count",
           "segment_softmax_denom"]


def _seg_sum_rows(data: torch.Tensor, indptr: torch.Tensor,
                  split: Optional[RowSplit]) -> torch.Tensor:
    """K2 over ``indptr``, any trailing shape: (E, ...) → (S, ...)."""
    tail = tuple(data.shape[1:])
    out = seg_sum(indptr, data.reshape(data.shape[0], -1).contiguous(), split=split)
    return out.reshape((indptr.numel() - 1,) + tail)


def _gather_rows(v: torch.Tensor, indptr: torch.Tensor, pos: Optional[torch.Tensor],
                 split: Optional[RowSplit], num_out: Optional[int] = None) -> torch.Tensor:
    """P1 in source order over a CSR, any trailing shape: (N, ...) → (E, ...)."""
    rows = v.reshape(v.shape[0], math.prod(v.shape[1:])).contiguous()
    out = row_gather_by_source(rows, indptr, pos, split, num_out=num_out)
    return out.reshape((out.shape[0],) + tuple(v.shape[1:]))


class _SegmentSum(torch.autograd.Function):
    """K2 over ``indptr``: float32 sums of float32 or bfloat16 data. Its
    backward gathers the cotangent rounded to the data's type (rounding the
    N rows before the gather equals rounding the E gathered rows)."""

    @staticmethod
    def forward(ctx, data, indptr, split):
        ctx.save_for_backward(indptr)
        ctx.split, ctx.num, ctx.dtype = split, data.shape[0], data.dtype
        return _seg_sum_rows(data, indptr, split)

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        (indptr,) = ctx.saved_tensors
        grad = _gather_rows(gout.to(ctx.dtype), indptr, None, ctx.split, num_out=ctx.num)
        return grad, None, None


def segment_sum(data: torch.Tensor, seg_ids: torch.Tensor, indptr: torch.Tensor,
                split: Optional[RowSplit] = None) -> torch.Tensor:
    """``out[s] = Σ_{j: seg_ids[j] = s} data[j]``, differentiable in ``data``.

    ``seg_ids`` (E,) ascending, ``indptr`` (S + 1,) the same segments as row
    offsets (``indptr[s]:indptr[s + 1]`` holds segment ``s``), ``split``
    their row split (see ``kernels/seg_sum.py``; without one a launch on the
    card reads ``indptr`` back). ``data`` is float32 or bfloat16, the
    result in its type: a bfloat16 sum is taken in float32 and rounded once.
    First-order gradients only: a double backward raises."""
    return _sums(data, seg_ids, indptr, split).to(data.dtype)


def _sums(data, seg_ids, indptr, split):
    if data.shape[0] != seg_ids.shape[0]:
        raise ValueError(f"data has {data.shape[0]} rows, seg_ids {seg_ids.shape[0]}")
    return _SegmentSum.apply(data, indptr, split)


def segment_mean(data: torch.Tensor, seg_ids: torch.Tensor, indptr: torch.Tensor,
                 split: Optional[RowSplit] = None) -> torch.Tensor:
    """``segment_sum`` divided by ``max(count, 1)`` per segment (in float32
    for bfloat16 data, rounded once)."""
    out = _sums(data, seg_ids, indptr, split)
    inv = 1.0 / (indptr[1:] - indptr[:-1]).clamp(min=1).to(out.dtype)
    return (out * inv.reshape((-1,) + (1,) * (out.dim() - 1))).to(data.dtype)


def _segment_extremum(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                      how: str) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    index = seg_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, index, data, how, include_self=False)


def segment_max(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[r] = max_{j: seg_ids[j] = r} data[j]`` over the first axis;
    a segment with no element gives 0 (DGL semantics), and a non-finite
    maximum is kept (the JAX package maps it to 0)."""
    return _segment_extremum(data, seg_ids, num_segments, "amax")


def segment_min(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_max``'s counterpart with the minimum."""
    return _segment_extremum(data, seg_ids, num_segments, "amin")


def _in_range(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``seg_ids`` with every id outside ``[0, num_segments)`` sent to the
    spare row ``num_segments``, which the callers drop (no host sync)."""
    ids = seg_ids.long()
    return torch.where((ids < 0) | (ids >= num_segments), num_segments, ids)


def segment_count(seg_ids: torch.Tensor, num_segments: int,
                  dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``out[s] = |{j: seg_ids[j] = s}|``."""
    ids = _in_range(seg_ids, num_segments)
    out = torch.zeros(num_segments + 1, dtype=torch.int64, device=ids.device)
    return out.scatter_add_(0, ids, torch.ones_like(ids))[:num_segments].to(dtype)


def segment_softmax_denom(z: torch.Tensor, seg_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """The sum of ``z`` over each element's segment, gathered back to the
    elements: (E, ...) → (E, ...)."""
    denom = z.new_zeros((num_segments + 1,) + tuple(z.shape[1:]))
    denom = denom.index_add_(0, _in_range(seg_ids, num_segments), z)[:num_segments]
    return denom[seg_ids.long().clamp(max=num_segments - 1)]
