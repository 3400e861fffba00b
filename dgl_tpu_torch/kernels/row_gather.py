"""P1 and P2: the row gather ``out[i] = x[idx[i]]``, the probe of how fast
the card reads indexed rows (every K1 and K3 edge is one such read).

``row_gather_async`` (P1) and ``row_gather_smem`` (P2) launch the
hand-written CUDA kernels in ``csrc/row_gather.cu`` for CUDA tensors and use
``row_gather_plain`` only for CPU tensors. ``row_gather_async.launches`` and
``row_gather_smem.launches`` count the kernels' launches.

Counterparts of ``tools/exp_dma_gather.py:dma_gather`` (one async copy per
row into on-chip memory) and ``:vmem_gather`` (x wholly in on-chip memory).
P2 holds x in one block's shared memory, so it takes an x of at most
``SMEM_LIMIT_BYTES`` and raises ``ValueError`` for a larger one, on CPU
tensors too, as ``vmem_gather`` fails above its VMEM limit.

Neither kernel checks its indices: an index outside ``[0, n)`` reads
outside x (the plain version raises instead).
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

__all__ = ["row_gather_async", "row_gather_smem", "row_gather_plain", "SMEM_LIMIT_BYTES"]

SMEM_LIMIT_BYTES = 232448  # 227 KB: the most shared memory one H100 block may have
MAX_ASYNC_TILE = 8192  # P1 keeps a tile's row offsets in shared memory
_DTYPES = (torch.float32, torch.bfloat16)


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: ``x[idx]``."""
    return x[idx]


def _check(name, x, idx, tile, max_tile) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 rows, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} takes 2-D x (n, d), got shape {tuple(x.shape)}")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise TypeError(f"idx must be 1-D int32/int64, got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != x.device:
        raise ValueError(f"{name} operands lie on different devices")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name} operands must be contiguous")
    if not 1 <= tile <= max_tile:
        raise ValueError(f"{name} takes 1 <= tile <= {max_tile}, got {tile}")


def _kernel_fn(name):
    fn = getattr(load("row_gather"), name)
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([p, p, i, p, ll, ll, i, p] if name == "row_gather_async"
                       else [p, ll, p, i, p, ll, ll, i, p])
        fn.restype = ctypes.c_int
    return fn


def _launch(name, out, x, idx, tile, *lead) -> None:
    """Launch ``name`` on the current stream into ``out`` and raise on a
    refused launch; ``lead`` are the entry point's arguments before idx."""
    with torch.cuda.device(x.device):
        err = _kernel_fn(name)(
            *lead, idx.data_ptr(), int(idx.dtype == torch.int64), out.data_ptr(), idx.shape[0],
            x.shape[1] * x.element_size(), tile, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _empty_out(x, idx):
    return torch.empty((idx.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)


def row_gather_async(x: torch.Tensor, idx: torch.Tensor, tile: int = 256) -> torch.Tensor:
    """P1: ``out[i] = x[idx[i]]``, one block per ``tile`` output rows, each
    row copied asynchronously into shared memory, then written out.

    ``x`` (n, d) float32 or bfloat16, ``idx`` (e,) int32 or int64, any e.
    Returns (e, d), bit for bit ``x[idx]``.
    """
    _check("row_gather_async", x, idx, tile, MAX_ASYNC_TILE)
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"row_gather_async runs on cuda or cpu tensors, got {x.device}")
    out = _empty_out(x, idx)
    if out.numel():
        _launch("row_gather_async", out, x, idx, tile, x.data_ptr())
        row_gather_async.launches += 1
    return out


def row_gather_smem(x: torch.Tensor, idx: torch.Tensor, tile: int = 512) -> torch.Tensor:
    """P2: ``out[i] = x[idx[i]]`` from a copy of the whole of x in each
    block's shared memory: one persistent block per SM, walking tiles of
    ``tile`` output rows.

    As ``row_gather_async``; raises ``ValueError`` before any launch, on CPU
    tensors too, when x holds more than ``SMEM_LIMIT_BYTES``.
    """
    _check("row_gather_smem", x, idx, tile, 2**31 - 1)
    need = x.numel() * x.element_size()
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"row_gather_smem needs x in one block's shared memory: x holds {need} B, "
                         f"the limit is {SMEM_LIMIT_BYTES} B")
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"row_gather_smem runs on cuda or cpu tensors, got {x.device}")
    out = _empty_out(x, idx)
    if out.numel():
        _launch("row_gather_smem", out, x, idx, tile, x.data_ptr(), x.shape[0])
        row_gather_smem.launches += 1
    return out


row_gather_async.launches = 0
row_gather_smem.launches = 0
