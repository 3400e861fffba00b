"""P1 and P2: the row gather ``out[i] = x[idx[i]]``, the probe of how fast
the card reads indexed rows (every K1 and K3 edge is one such read), and P1
in source order, the port's graph gathers.

``row_gather_async`` (P1 in index order) and ``row_gather_smem`` (P2) launch
the hand-written CUDA kernels in ``csrc/row_gather.cu`` for CUDA tensors and
use ``row_gather_plain`` only for CPU tensors. ``row_gather_by_source`` (P1
in source order) takes the plan of the indices, their CSR by source row
(``gather_plan``), reads each row of x once and writes it to every position
that asks for it; it uses ``row_gather_by_source_plain`` only for CPU
tensors. Each wrapper's ``launches`` counts its kernel's launches. P1 stages
rows in shared memory by TMA bulk copies (``csrc/async_copy.cuh``) and
writes 16-byte words, or bulk stores where out is aligned; the wrappers
launch through ``build.launch``.

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
from typing import NamedTuple, Optional

import torch

from .. import trace
from ..graph.split import SPLIT_T, RowSplit, row_split
from .build import entry, launch

__all__ = ["row_gather_async", "row_gather_smem", "row_gather_plain", "SMEM_LIMIT_BYTES",
           "GatherPlan", "gather_plan", "row_gather_by_source", "row_gather_by_source_plain"]

SMEM_LIMIT_BYTES = 232448  # 227 KB: the most shared memory one H100 block may have
MAX_ASYNC_TILE = 8192  # the most output rows a block of P1 in index order takes
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


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# x, n, idx, its int64 flag, out, e, row_bytes, tile, stream (P1 in index order and P2)
_INDEX_ARGTYPES = (_P, _LL, _P, _I, _P, _LL, _LL, _I, _P)
# x, indptr, its int64 flag, pos, its int64 flag, out, n, row_bytes, long_t,
# rows, chunk_ptr, n_long, chunks, n_chunks, stream
_SOURCE_ARGTYPES = (_P, _P, _I, _P, _I, _P, _LL, _LL, _LL, _P, _P, _LL, _P, _LL, _P)


def _launch(name, out, x, idx, tile) -> None:
    """Launch ``name`` (``row_gather_async`` or ``row_gather_smem``) on the
    current stream into ``out``; raises on a refused launch."""
    launch(entry("row_gather", name, _INDEX_ARGTYPES), x.device, x.data_ptr(), x.shape[0],
           idx.data_ptr(), int(idx.dtype == torch.int64), out.data_ptr(), idx.shape[0],
           x.shape[1] * x.element_size(), tile)


def _empty_out(x, idx):
    return torch.empty((idx.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)


def row_gather_async(x: torch.Tensor, idx: torch.Tensor, tile: int = 256) -> torch.Tensor:
    """P1: ``out[i] = x[idx[i]]``, one block per ``tile`` output rows, a
    warp's slice of them streamed through a ring of shared-memory stages
    (rows in by TMA or cp.async, out by bulk stores or 16-byte words).

    ``x`` (n, d) float32 or bfloat16, ``idx`` (e,) int32 or int64, any e.
    Returns (e, d), bit for bit ``x[idx]``.
    """
    with trace.span("dgl_tpu_torch.P1.index"):
        _check("row_gather_async", x, idx, tile, MAX_ASYNC_TILE)
        if x.is_cpu:
            return row_gather_plain(x, idx)
        if not x.is_cuda:
            raise ValueError(f"row_gather_async runs on cuda or cpu tensors, got {x.device}")
        out = _empty_out(x, idx)
        if out.numel():
            _launch("row_gather_async", out, x, idx, tile)
            row_gather_async.launches += 1
            trace.launch("P1", "index", None, idx, x)
        return out


def row_gather_smem(x: torch.Tensor, idx: torch.Tensor, tile: int = 512) -> torch.Tensor:
    """P2: ``out[i] = x[idx[i]]`` from a copy of the whole of x in each
    block's shared memory: one persistent block per SM, walking tiles of
    ``tile`` output rows.

    As ``row_gather_async``; raises ``ValueError`` before any launch, on CPU
    tensors too, when x holds more than ``SMEM_LIMIT_BYTES``.
    """
    with trace.span("dgl_tpu_torch.P2"):
        _check("row_gather_smem", x, idx, tile, 2**31 - 1)
        need = x.numel() * x.element_size()
        if need > SMEM_LIMIT_BYTES:
            raise ValueError(f"row_gather_smem needs x in one block's shared memory: x holds "
                             f"{need} B, the limit is {SMEM_LIMIT_BYTES} B")
        if x.device.type == "cpu":
            return row_gather_plain(x, idx)
        if x.device.type != "cuda":
            raise ValueError(f"row_gather_smem runs on cuda or cpu tensors, got {x.device}")
        out = _empty_out(x, idx)
        if out.numel():
            _launch("row_gather_smem", out, x, idx, tile)
            row_gather_smem.launches += 1
            trace.launch("P2", "smem", None, idx, x)
        return out


row_gather_async.launches = 0
row_gather_smem.launches = 0


# -- P1 in source order --------------------------------------------------------

_NO_SPLIT_T = 2**62  # the kernel's long-row threshold without a split: no row is long


class GatherPlan(NamedTuple):
    """The indices' CSR by source row: slots ``indptr[r]:indptr[r + 1]``
    are the positions ``pos`` that read row ``r``; ``split`` its row split.
    ``row_gather_by_source(x, *plan)`` is ``x[idx]``."""

    indptr: torch.Tensor
    pos: torch.Tensor
    split: RowSplit


def gather_plan(idx: torch.Tensor, n: int, t: int = SPLIT_T) -> GatherPlan:
    """The plan of ``x[idx]`` for an x of ``n`` rows, on idx's device: a
    stable sort of idx gives the positions (each row's in ascending order),
    the sorted values' boundaries the row offsets, and ``row_split`` their
    split, after the one read of the plan back to the host. ``indptr`` and
    ``pos`` are int32 when the e positions fit, else int64. Raises
    ``ValueError`` for an index outside ``[0, n)``. Build it once per index
    array, as a graph builds its CSRs."""
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be 1-D int32/int64, got {idx.dtype} {tuple(idx.shape)}")
    if n < 0:
        raise ValueError(f"gather_plan needs n >= 0, got {n}")
    e = idx.numel()
    dt = torch.int32 if e <= torch.iinfo(torch.int32).max else torch.int64
    keys = idx if n < torch.iinfo(idx.dtype).max else idx.long()
    values, pos = torch.sort(keys, stable=True)
    # indptr[r]: the slots of rows below r; an index outside [0, n) shows as
    # indptr[0] > 0 or indptr[n] < e
    bounds = torch.arange(n + 1, dtype=keys.dtype, device=idx.device)
    indptr = torch.searchsorted(values, bounds).to(dt)
    host = indptr.cpu().numpy()
    if host[0] != 0 or host[-1] != e:
        raise ValueError(f"gather_plan: an index lies outside [0, {n})")
    return GatherPlan(indptr, pos.to(dt), row_split(host, t, device=idx.device))


def row_gather_by_source_plain(x: torch.Tensor, indptr: torch.Tensor,
                               pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch: each row of x repeated by its
    slot count, scattered to the positions (in slot order without them)."""
    counts = (indptr[1:] - indptr[:-1]).long()
    e = pos.numel() if pos is not None else None
    rows = x.repeat_interleave(counts, dim=0, output_size=e)
    if pos is None:
        return rows
    return torch.empty_like(rows).index_copy_(0, pos.long(), rows)


_IDX_DTYPES = (torch.int32, torch.int64)


def _check_by_source(x, indptr, pos, split, num_out) -> int:
    """Check the operands; return the number of output rows."""
    if x.dim() != 2:
        raise ValueError(f"row_gather_by_source takes 2-D x (n, d), got shape {tuple(x.shape)}")
    if x.element_size() % 2:
        raise TypeError(f"row_gather_by_source moves values of an even byte size, got {x.dtype}")
    if indptr.dtype not in _IDX_DTYPES or indptr.dim() != 1:
        raise TypeError(f"indptr must be 1-D int32/int64, got {indptr.dtype} {tuple(indptr.shape)}")
    if indptr.numel() != x.shape[0] + 1:
        raise ValueError(f"indptr has {indptr.numel()} offsets for {x.shape[0]} rows of x")
    dev = x.device
    if pos is not None:
        if pos.dtype not in _IDX_DTYPES or pos.dim() != 1:
            raise TypeError(f"pos must be 1-D int32/int64, got {pos.dtype} {tuple(pos.shape)}")
        if pos.device != dev:
            raise ValueError("row_gather_by_source operands lie on different devices")
    if indptr.device != dev:
        raise ValueError("row_gather_by_source operands lie on different devices")
    if not (x.is_contiguous() and indptr.is_contiguous()
            and (pos is None or pos.is_contiguous())):
        raise ValueError("row_gather_by_source operands must be contiguous")
    e = None
    for n in (None if pos is None else pos.numel(), None if split is None else split.num_edges,
              num_out):
        if n is None or n == e:
            continue
        if e is not None:
            counts = {c for c in (None if pos is None else pos.numel(),
                                  None if split is None else split.num_edges, num_out)
                      if c is not None}
            raise ValueError(f"row_gather_by_source: pos, the split and num_out disagree on the "
                             f"number of slots: {sorted(counts)}")
        e = n
    if e is None:
        raise ValueError("row_gather_by_source needs pos, a split or num_out for the number "
                         "of output rows (it never reads indptr back)")
    if split is not None:
        split.check(indptr, e, "row_gather_by_source")
    return e


def row_gather_by_source(x: torch.Tensor, indptr: torch.Tensor,
                         pos: Optional[torch.Tensor] = None, split: Optional[RowSplit] = None,
                         *, num_out: Optional[int] = None) -> torch.Tensor:
    """P1 in source order: ``out[pos[k]] = x[r]`` for every slot ``k`` in
    ``[indptr[r], indptr[r + 1])``; with ``pos`` None, ``out[k] = x[r]`` (a
    dst CSR's ``v[dst[j]]``). Given ``gather_plan(idx, n)``, bit for bit
    ``x[idx]``.

    ``x`` (n, d) of any type of an even byte size, ``indptr`` (n + 1,) and
    ``pos`` (e,) int32 or int64; ``pos`` must hold each position once, and
    ``indptr[-1]`` must be e, which is not checked. Returns (e, d): e from
    ``pos``, else ``split.num_edges``, else ``num_out``.

    ``split``: the CSR's row split (``RowSplit``), on indptr's device; a row
    of more than ``split.t`` slots is cut into chunks, each one block's work,
    and each chunk reads its row once more; a block shares its rows' longer
    walks out among its warps. One whose row or slot count differs raises
    ``ValueError`` before any launch. Without one, each row is one block's
    work however long: right, but slow on a row of many thousand slots. The
    wrapper never reads indptr back.

    The launch walks all n rows of the plan, one offset read each: an e far
    below n (a few rows of a large x) leaves most warps idle, and
    ``row_gather_async`` suits it better. The graph gathers have e >= n.
    """
    with trace.span("dgl_tpu_torch.P1.source"):
        e = _check_by_source(x, indptr, pos, split, num_out)
        if x.is_cpu:
            out = row_gather_by_source_plain(x, indptr, pos)
            if out.shape[0] != e:
                raise ValueError(f"row_gather_by_source: indptr holds {out.shape[0]} slots, "
                                 f"not {e}")
            return out
        if not x.is_cuda:
            raise ValueError(f"row_gather_by_source runs on cuda or cpu tensors, got {x.device}")
        out = torch.empty((e, x.shape[1]), dtype=x.dtype, device=x.device)
        if not out.numel():
            return out
        plan = ((_NO_SPLIT_T, None, None, 0, None, 0) if split is None
                else split.kernel_args(None)[:-1])
        launch(entry("row_gather", "row_gather_by_source", _SOURCE_ARGTYPES), x.device,
               x.data_ptr(), indptr.data_ptr(), int(indptr.dtype == torch.int64),
               None if pos is None else pos.data_ptr(),
               int(pos is not None and pos.dtype == torch.int64),
               out.data_ptr(), x.shape[0], x.shape[1] * x.element_size(), *plan)
        row_gather_by_source.launches += 1
        trace.launch("P1", "source", indptr, out, x)
        return out


row_gather_by_source.launches = 0
