"""K2: sorted segment sum of edge messages, the kernel behind every
``copy_e`` sum: the GAT edge form's aggregation, the edge-softmax
denominators and the backward of ``spread_dst``.

``seg_sum`` launches the hand-written CUDA kernel in ``csrc/seg_sum.cu`` for
CUDA tensors and uses ``seg_sum_plain`` only for CPU tensors.
``seg_sum.launches`` counts the calls that launch the kernel, one a call.
``seg_sum.combines`` stays 0: the kernel folds its long rows inside its
launch (it is kept so that the paths' checks of combine launches read it).

The kernel streams each run of consecutive rows' messages, one contiguous
span, through shared memory by TMA bulk copies (``csrc/seg_sum.cu``). Long
rows are split as in K1 (``kernels/csr_spmm.py``): every row of more than
``T`` edges (the plan's ``t``; ``graph/split.py:SPLIT_T`` = 512 for a
graph's CSRs) is cut into chunks of at most ``T`` edges, each summed by one
warp of the same launch; the warp that finishes a row's last chunk, counted
on the plan's ``counters``, adds the row's chunks in ascending chunk order
and writes the row once. No atomics decide the order, so two runs are
bitwise equal and small-integer sums exact.

``msg`` is float32 or bfloat16; the sums and the output are float32 either
way, as the JAX package's ``_seg_sum_by_dst`` promotes bf16 messages
(``dgl_tpu/ops/spmm.py:121-123``). ``seg_sum.launches_bf16`` counts the
bfloat16 instantiation's launches among ``launches``.

Counterpart of ``dgl_tpu/kernels/piece_reduce.py:segment_sum_mxu``. Its
backward, ``grad_msg[j] = gout[dst[j]]``, is a row gather (an XLA op in the
JAX package, P1 in source order here: ``row_gather.py:row_gather_by_source``
over the same row offsets); ``ops/gather.py`` pairs the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import trace
from ..graph.split import RowSplit, row_split
from .build import entry, launch

__all__ = ["seg_sum", "seg_sum_plain", "csr_rows", "ROW_DTYPES", "sum_dtype"]

ROW_DTYPES = (torch.float32, torch.bfloat16)  # the rows the kernels gather


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the kernels and their plain versions sum rows of ``dtype``
    in: float32 for bfloat16 rows, the rows' own type otherwise (float64 in
    the reference runs)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def csr_rows(indptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    """The CSR row of every edge slot (int64), for the plain versions."""
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(indptr.numel() - 1, device=indptr.device), deg, output_size=n_edges
    )


def seg_sum_plain(indptr: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: ``index_add_`` of the messages
    into the rows that ``indptr`` assigns them; bfloat16 messages are
    converted to float32 first and summed in float32, as the kernel does."""
    dtype = sum_dtype(msg.dtype)
    out = torch.zeros((indptr.numel() - 1,) + tuple(msg.shape[1:]), dtype=dtype,
                      device=msg.device)
    return out.index_add_(0, csr_rows(indptr, msg.shape[0]), msg.to(dtype))


def _check(indptr, msg) -> None:
    if msg.dtype not in ROW_DTYPES:
        raise TypeError(f"seg_sum takes float32 or bfloat16 messages, got {msg.dtype}")
    if msg.dim() != 2:
        raise ValueError(f"seg_sum takes 2-D messages (E, W), got shape {tuple(msg.shape)}")
    if indptr.dtype not in (torch.int32, torch.int64) or indptr.dim() != 1 or indptr.numel() < 1:
        raise TypeError(f"indptr must be 1-D int32/int64, got {indptr.dtype} {tuple(indptr.shape)}")
    if indptr.device != msg.device:
        raise ValueError("seg_sum operands lie on different devices")
    if not (indptr.is_contiguous() and msg.is_contiguous()):
        raise ValueError("seg_sum operands must be contiguous")


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# indptr, its int64 flag, msg, out, n_rows, w, n_edges, rows, chunk_ptr,
# n_long, chunks, n_chunks, partials, counters, stream
_ARGTYPES = (_P, _I, _P, _P, _LL, _I, _LL, _P, _P, _LL, _P, _LL, _P, _P, _P)


def seg_sum(indptr: torch.Tensor, msg: torch.Tensor,
            split: Optional[RowSplit] = None) -> torch.Tensor:
    """``out[r] = Σ_{j in [indptr[r], indptr[r+1])} msg[j]``; float32 out.

    ``indptr`` (R+1,) int32/int64, ``msg`` (E, W) float32 or bfloat16 in CSR
    order with ``E == indptr[-1]``. Returns (R, W) float32; an empty row
    gives 0.

    ``split``: the CSR's row split (``graph.split`` / ``graph.reverse.split``
    for a graph's CSRs), on the device of ``indptr``. One whose row or edge
    count differs raises ``ValueError`` before any launch; one of another CSR
    with the same counts is not caught: the rows it lists get the sums of its
    chunks, the others are summed as usual. Without one, a launch
    on the card builds it from ``indptr``: a copy of ``indptr`` to the host,
    which waits for the card. The package's ops always pass the graph's plan.
    """
    with trace.span("dgl_tpu_torch.K2"):
        _check(indptr, msg)
        e = msg.shape[0]
        if split is not None:
            split.check(indptr, e, "seg_sum")
        if msg.is_cpu:
            return seg_sum_plain(indptr, msg)
        if not msg.is_cuda:
            raise ValueError(f"seg_sum runs on cuda or cpu tensors, got {msg.device}")
        n_rows, w = indptr.numel() - 1, msg.shape[1]
        dev = msg.device
        out = torch.empty((n_rows, w), dtype=torch.float32, device=dev)
        if n_rows == 0 or w == 0:
            return out.zero_()
        if split is None:
            split = row_split(indptr)
        bf16 = msg.dtype == torch.bfloat16
        partials = (torch.empty((split.num_chunks, w), dtype=torch.float32, device=dev)
                    if split.num_chunks else None)
        launch(entry("seg_sum", "seg_sum_bf16" if bf16 else "seg_sum_f32", _ARGTYPES), dev,
               indptr.data_ptr(), int(indptr.dtype == torch.int64), msg.data_ptr(), out.data_ptr(),
               n_rows, w, e, *split.kernel_args(partials, counters=True)[1:])
        seg_sum.launches += 1
        seg_sum.launches_bf16 += int(bf16)
        trace.launch("K2", "seg_sum", indptr, msg, msg)
        return out


seg_sum.launches = 0
seg_sum.launches_bf16 = 0
seg_sum.combines = 0
