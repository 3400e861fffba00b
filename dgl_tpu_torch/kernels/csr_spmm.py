"""K1: CSR SpMM, the kernel behind every copy_u sum/mean aggregation.

``csr_spmm`` launches the hand-written CUDA kernel in ``csrc/csr_spmm.cu``
for CUDA tensors and uses ``csr_spmm_plain`` only for CPU tensors.
``csr_spmm.launches`` counts the calls that launch the kernel, one launch a
call: the long rows' combine runs inside that launch.

The kernel stages the gathered rows in shared memory: each warp keeps a
ring of stages of rows in flight, each row copied as the 16-byte-aligned
span that covers it, at any width and alignment of ``x``: by TMA bulk
copies (one a row) for wide spans, by cp.async copies of 16 bytes spread
over the lanes for narrow ones; the indices come in blocks of 32 edges
fetched ahead of the stages. Its lanes then sum the staged rows column by
column. ``csrc/k1_geometry.h`` sizes the ring, the copy route, the lane
layout and the runs of rows (one warp each) from the row width, the value's
bytes, the alignment of ``x`` and the CSR's counts, on the host side of the
launch. The source note in ``csrc/csr_spmm.cu`` says why, with the card's
numbers in ``PERF.md``.

Long rows are split: every row of more than ``T`` edges (the plan's ``t``;
``graph/split.py:SPLIT_T`` = 512 for a graph's CSRs) is cut into chunks of
at most ``T`` edges, each summed by one warp of the same launch (two
consecutive chunks a warp on plans with many chunks)
into a (C, D) partials buffer; the warp that completes a long row's
count of chunks (on the plan's ``counters``) adds the row's chunks in
ascending chunk order, applies mean's ``1/deg`` of the whole row, and
writes the row once. No atomic decides an order of additions, so two runs
are bitwise equal. ``2T`` bounds the longest walk a chunk warp makes: one
warp per row walked the reverse reddit CSR's 212,102-edge row alone. The
counters belong to the plan, so two launches over one CSR must not run at
once on two streams (the package runs on one).

``x`` is float32 or bfloat16. A bfloat16 ``x`` launches the kernel's
bfloat16 instantiation (``csr_spmm.launches_bf16`` counts those launches
among ``launches``): its rows are read as bfloat16 and converted exactly to
float32, the weight stays float32, and the sums and the output are float32,
as ``lane_spmm(..., compute_dtype=jnp.bfloat16)`` keeps them
(``lane_spmm.py:425-451``); the lane kernel rounds ``w·x`` to bfloat16 before
its sum (``:390``), this kernel keeps the product in float32.

Counterpart of ``dgl_tpu/kernels/lane_spmm.py:lane_spmm``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import trace
from ..graph.split import RowSplit, row_split
from .build import load
from .seg_sum import ROW_DTYPES, csr_rows, sum_dtype

__all__ = ["csr_spmm", "csr_spmm_plain"]


def csr_spmm_plain(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    x: torch.Tensor,
    w: Optional[torch.Tensor] = None,
    *,
    mean: bool = False,
) -> torch.Tensor:
    """The same function in plain PyTorch: gather the rows of ``x``, weight
    them and ``index_add_`` them into their CSR rows. Materialises an
    (E, D) message buffer. bfloat16 rows are converted to float32 first,
    so the sums are float32 as the kernel's (a bfloat16 ``index_add_``
    would round every partial sum)."""
    n_rows = indptr.numel() - 1
    dtype = sum_dtype(x.dtype)
    deg = (indptr[1:] - indptr[:-1]).long()
    rows = csr_rows(indptr, indices.numel())
    msg = x.to(dtype).index_select(0, indices.long())
    if w is not None:
        msg = msg * w.unsqueeze(1)
    out = torch.zeros((n_rows, x.shape[1]), dtype=dtype, device=x.device)
    out.index_add_(0, rows, msg)
    if mean:
        out = out * (1.0 / deg.clamp(min=1).to(dtype)).unsqueeze(1)
    return out


def _check(indptr, indices, x, w) -> None:
    if x.dtype not in ROW_DTYPES:
        raise TypeError(f"csr_spmm takes float32 or bfloat16 features, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"csr_spmm takes 2-D features, got shape {tuple(x.shape)}")
    if indices.dtype != torch.int32 or indices.dim() != 1:
        raise TypeError(f"indices must be 1-D int32, got {indices.dtype} {tuple(indices.shape)}")
    if indptr.dtype not in (torch.int32, torch.int64) or indptr.dim() != 1 or indptr.numel() < 1:
        raise TypeError(f"indptr must be 1-D int32/int64, got {indptr.dtype} {tuple(indptr.shape)}")
    tensors = [indptr, indices, x]
    if w is not None:
        if w.dtype != torch.float32 or w.shape != indices.shape:
            raise ValueError(
                f"w must be float32 of shape {tuple(indices.shape)}, got {w.dtype} {tuple(w.shape)}"
            )
        tensors.append(w)
    if any(t.device != x.device for t in tensors):
        raise ValueError("csr_spmm operands lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("csr_spmm operands must be contiguous")


def _kernel_fn(dtype: torch.dtype):
    name = "csr_spmm_bf16" if dtype == torch.bfloat16 else "csr_spmm_f32"
    fn = getattr(load("csr_spmm_bf16" if dtype == torch.bfloat16 else "csr_spmm"), name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        ll = ctypes.c_longlong
        i = ctypes.c_int
        fn.argtypes = [p, i, p, p, p, ll, p, ll, i, i, ll, p, p, ll, p, ll, p, p, ll, p]
        fn.restype = ctypes.c_int
    return fn


def csr_spmm(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    x: torch.Tensor,
    w: Optional[torch.Tensor] = None,
    *,
    mean: bool = False,
    split: Optional[RowSplit] = None,
) -> torch.Tensor:
    """``out[r] = Σ_{j in row r} w[j] · x[indices[j]]`` (``w`` = 1 when None),
    divided by ``max(deg_r, 1)`` when ``mean``; float32 out.

    ``indptr`` (R+1,) int32/int64, ``indices`` (E,) int32, ``x`` (N, D)
    float32 or bfloat16 (summed in float32), ``w`` (E,) float32 in CSR
    order. Returns (R, D) float32.

    ``split``: the CSR's row split (``graph.split`` / ``graph.reverse.split``
    for a graph's CSRs), on the device of ``indptr``. One whose row or edge
    count differs raises ``ValueError`` before any launch; one of another CSR
    with the same counts is not caught, and the rows it lists are then
    written from its chunks. Without one, a launch on the card builds it
    from ``indptr``: a copy of ``indptr`` to the host, which waits for the
    card. The package's ops always pass the graph's plan. Two launches with
    one plan must not run at once on two streams (its counters).
    """
    with trace.span("dgl_tpu_torch.K1"):
        _check(indptr, indices, x, w)
        if split is not None:
            split.check(indptr, indices.numel(), "csr_spmm")
        if x.device.type == "cpu":
            return csr_spmm_plain(indptr, indices, x, w, mean=mean)
        if x.device.type != "cuda":
            raise ValueError(f"csr_spmm runs on cuda or cpu tensors, got {x.device}")
        n_rows, d = indptr.numel() - 1, x.shape[1]
        out = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
        if n_rows == 0 or d == 0:
            return out
        if split is None:
            split = row_split(indptr)
        partials = torch.empty((split.num_chunks, d), dtype=torch.float32, device=x.device)
        fn = _kernel_fn(x.dtype)
        with torch.cuda.device(x.device):
            err = fn(
                indptr.data_ptr(), int(indptr.dtype == torch.int64), indices.data_ptr(),
                None if w is None else w.data_ptr(), x.data_ptr(), x.shape[0], out.data_ptr(),
                n_rows, d, int(mean), *split.kernel_args(partials, counters=True), indices.numel(),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"csr_spmm kernel launch failed with CUDA error {err}")
        csr_spmm.launches += 1
        csr_spmm.launches_bf16 += int(x.dtype == torch.bfloat16)
        trace.launch("K1", "spmm", indptr, indices, x, weighted=w is not None)
        return out


csr_spmm.launches = 0
csr_spmm.launches_bf16 = 0
