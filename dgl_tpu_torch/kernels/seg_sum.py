"""K2: sorted segment sum of edge messages, the kernel behind every
``copy_e`` sum: the GAT edge form's aggregation, the edge-softmax
denominators and the backward of ``spread_dst``.

``seg_sum`` launches the hand-written CUDA kernel in ``csrc/seg_sum.cu`` for
CUDA tensors and uses ``seg_sum_plain`` only for CPU tensors.
``seg_sum.launches`` counts the kernel's launches.

Counterpart of ``dgl_tpu/kernels/piece_reduce.py:segment_sum_mxu``. Its
backward, ``grad_msg[j] = gout[dst[j]]``, is a row gather (an XLA op in the
JAX package, ``index_select`` here); ``ops/gather.py`` pairs the two.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

__all__ = ["seg_sum", "seg_sum_plain", "csr_rows"]


def csr_rows(indptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    """The CSR row of every edge slot (int64), for the plain versions."""
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(indptr.numel() - 1, device=indptr.device), deg, output_size=n_edges
    )


def seg_sum_plain(indptr: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: ``index_add_`` of the messages
    into the rows that ``indptr`` assigns them."""
    out = torch.zeros((indptr.numel() - 1,) + tuple(msg.shape[1:]), dtype=msg.dtype,
                      device=msg.device)
    return out.index_add_(0, csr_rows(indptr, msg.shape[0]), msg)


def _check(indptr, msg) -> None:
    if msg.dtype != torch.float32:
        raise TypeError(f"seg_sum takes float32 messages, got {msg.dtype}")
    if msg.dim() != 2:
        raise ValueError(f"seg_sum takes 2-D messages (E, W), got shape {tuple(msg.shape)}")
    if indptr.dtype not in (torch.int32, torch.int64) or indptr.dim() != 1 or indptr.numel() < 1:
        raise TypeError(f"indptr must be 1-D int32/int64, got {indptr.dtype} {tuple(indptr.shape)}")
    if indptr.device != msg.device:
        raise ValueError("seg_sum operands lie on different devices")
    if not (indptr.is_contiguous() and msg.is_contiguous()):
        raise ValueError("seg_sum operands must be contiguous")


def _kernel_fn():
    fn = load("seg_sum").seg_sum_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def seg_sum(indptr: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """``out[r] = Σ_{j in [indptr[r], indptr[r+1])} msg[j]``; float32 in and out.

    ``indptr`` (R+1,) int32/int64, ``msg`` (E, W) in CSR order with
    ``E == indptr[-1]``. Returns (R, W); an empty row gives 0.
    """
    _check(indptr, msg)
    if msg.device.type == "cpu":
        return seg_sum_plain(indptr, msg)
    if msg.device.type != "cuda":
        raise ValueError(f"seg_sum runs on cuda or cpu tensors, got {msg.device}")
    n_rows, w = indptr.numel() - 1, msg.shape[1]
    out = torch.empty((n_rows, w), dtype=torch.float32, device=msg.device)
    if n_rows == 0 or w == 0:
        return out.zero_()
    fn = _kernel_fn()
    with torch.cuda.device(msg.device):
        err = fn(
            indptr.data_ptr(), int(indptr.dtype == torch.int64), msg.data_ptr(), out.data_ptr(),
            n_rows, w, torch.cuda.current_stream(msg.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"seg_sum kernel launch failed with CUDA error {err}")
    seg_sum.launches += 1
    return out


seg_sum.launches = 0
