"""K1: CSR SpMM, the kernel behind every copy_u sum/mean aggregation.

``csr_spmm`` launches the hand-written CUDA kernel in ``csrc/csr_spmm.cu``
for CUDA tensors and uses ``csr_spmm_plain`` only for CPU tensors.
``csr_spmm.launches`` counts the kernel's launches.

Counterpart of ``dgl_tpu/kernels/lane_spmm.py:lane_spmm``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import load
from .seg_sum import csr_rows

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
    (E, D) message buffer."""
    n_rows = indptr.numel() - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    rows = csr_rows(indptr, indices.numel())
    msg = x.index_select(0, indices.long())
    if w is not None:
        msg = msg * w.unsqueeze(1)
    out = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    out.index_add_(0, rows, msg)
    if mean:
        out = out * (1.0 / deg.clamp(min=1).to(x.dtype)).unsqueeze(1)
    return out


def _check(indptr, indices, x, w) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"csr_spmm takes float32 features, got {x.dtype}")
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


def _kernel_fn():
    fn = load("csr_spmm").csr_spmm_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def csr_spmm(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    x: torch.Tensor,
    w: Optional[torch.Tensor] = None,
    *,
    mean: bool = False,
) -> torch.Tensor:
    """``out[r] = Σ_{j in row r} w[j] · x[indices[j]]`` (``w`` = 1 when None),
    divided by ``max(deg_r, 1)`` when ``mean``; float32 in and out.

    ``indptr`` (R+1,) int32/int64, ``indices`` (E,) int32, ``x`` (N, D),
    ``w`` (E,) in CSR order. Returns (R, D).
    """
    _check(indptr, indices, x, w)
    if x.device.type == "cpu":
        return csr_spmm_plain(indptr, indices, x, w, mean=mean)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm runs on cuda or cpu tensors, got {x.device}")
    n_rows, d = indptr.numel() - 1, x.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
    if n_rows == 0 or d == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        err = fn(
            indptr.data_ptr(), int(indptr.dtype == torch.int64), indices.data_ptr(),
            None if w is None else w.data_ptr(), x.data_ptr(), out.data_ptr(),
            n_rows, d, int(mean), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"csr_spmm kernel launch failed with CUDA error {err}")
    csr_spmm.launches += 1
    return out


csr_spmm.launches = 0
