"""g-SpMM: message passing as one sparse-dense product per direction.

Counterpart of ``dgl_tpu/ops/spmm.py:gspmm``::

    out[v] = reduce_{e=(u,v)} op(x[u], e[e])
    op ∈ {copy_u, copy_e, add, sub, mul, div},  reduce ∈ {sum, mean, max, min}

Zero-in-degree nodes give 0. ``copy_u`` sum/mean: the forward is one K1
launch over the dst-sorted CSR (mean divides by the clamped in-degree inside
the kernel); the backward scales the output cotangent by the same
``1/max(deg, 1)`` for mean and aggregates it with one K1 launch over the
reverse CSR, as ``_lane_copy_u_bwd`` does in the JAX package. ``copy_e``
sum/mean: one K2 launch (``ops/gather.py:seg_sum_dst``) over edge features
in canonical order, any trailing shape; mean scales its result by
``1/max(deg, 1)``; the backward is a row gather by dst (P1 in source order
over the dst CSR).

Binary ops with sum/mean combine ``x[src]`` with ``e`` under broadcasting
(``x`` (N, H, D) with ``e`` (E, H, 1), as ``_combine`` does): the message
is ``gather_src_rows`` (P1), the elementwise op, then ``seg_sum_dst`` (K2),
and autograd runs through their adjoints (K1 by ``rev.eid``, P1 by dst), as
``_spmm_xe`` computes. RGCN's relation-weighted sums, which would be
``mul`` by a per-edge scalar, call ``ops/rel.py:gspmm_rel`` instead, with
the graph's weights laid out once, so they build no (E, R, D) message.
max/min: the messages (``gather_src_rows`` and the op, or ``e``)
reduced by ``scatter_reduce`` (amax/amin), plain PyTorch as in the JAX
package, which computes them outside any Pallas kernel; a row with no
in-edge is 0, and a non-finite extremum is kept (the JAX package maps it to
0, ``dgl_tpu/ops/segment.py:109``).

A positional sampled block (``g.block_fanout`` set, ``sampling/neighbor.py``)
takes ``copy_u`` with any reduce as ``x[nd : nd + nd·f]`` viewed (nd, f, ...)
and reduced over ``f``, as ``dgl_tpu/ops/spmm.py:636-649`` does: no K1 or K2
launch, and autograd differentiates the reshape. It comes before
``lowering``: the layout is the block's semantics, not a lowering.

``x`` and ``e`` may be bfloat16, the JAX package's bf16 messages: the
fused sum/mean forwards read them as bfloat16 and sum in float32 (K1's and
K2's bfloat16 instantiations) and return float32, as the JAX ``gspmm``
does; every gradient comes in its input's type, summed in float32 and
rounded once (``dgl_tpu/ops/spmm.py:244,290,305,308``). ``copy_u``'s
backward aggregates the float32 cotangent over the reverse CSR with K1's
float32 instantiation and rounds the sum to x's type; the cotangent is not
rounded to bfloat16 first, as the TPU lane kernel does. The scatter lowering
returns the messages' type, as the JAX one does (its ``segment_sum`` keeps
bf16), summing in float32 and rounding once.

``lowering="scatter"`` is a second lowering the caller names, the PyG twin
(``dgl_tpu/ops/spmm.py:604-626``, the JAX package's
``DGL_TPU_LOWERING=scatter``), for sum and mean: the (E, ...) messages are
built with ``index_select`` (and the op) or taken as given (``copy_e``),
reduced with a plain ``index_add_`` by dst, mean scaled by
``1/max(deg, 1)``, and autograd differentiates the gather into a scatter.
No K1 or K2 runs and the reverse CSR is not used. max/min take the same
path under either lowering.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import trace
from ..graph.graph import Graph
from ..kernels.csr_spmm import csr_spmm
from ..kernels.seg_sum import sum_dtype
from .gather import gather_src_rows, seg_sum_dst
from .segment import segment_max, segment_min

__all__ = ["gspmm", "copy_u_sum", "copy_u_mean", "u_mul_e_sum"]

_COPY_U = ("copy_u", "copy_lhs")
_COPY_E = ("copy_e", "copy_rhs")
_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div}
_EXTREMA = {"max": segment_max, "min": segment_min}


def _inv_deg(g: Graph, dtype) -> torch.Tensor:
    return 1.0 / g.in_degrees().clamp(min=1).to(dtype)


class _CopyU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, g: Graph, mean: bool) -> torch.Tensor:
        with trace.span("dgl_tpu_torch._CopyU.forward"):
            ctx.g, ctx.mean, ctx.dtype = g, mean, x.dtype
            return csr_spmm(g.indptr, g.src, x.contiguous(), mean=mean, split=g.split)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor):
        with trace.span("dgl_tpu_torch._CopyU.backward"):
            g: Graph = ctx.g
            if ctx.mean:
                g_out = g_out * _inv_deg(g, g_out.dtype).unsqueeze(1)
            rev = g.reverse
            grad_x = csr_spmm(rev.indptr, rev.src, g_out.contiguous(), split=rev.split)
            return grad_x.to(ctx.dtype), None, None


def _scale_mean(g: Graph, out: torch.Tensor) -> torch.Tensor:
    return out * _inv_deg(g, out.dtype).reshape((-1,) + (1,) * (out.dim() - 1))


def _scatter(g: Graph, msg: torch.Tensor, mean: bool) -> torch.Tensor:
    """``index_add_`` of the messages by dst, in float32 for bfloat16
    messages, returned in the messages' type."""
    dtype = sum_dtype(msg.dtype)
    out = torch.zeros((g.num_dst_nodes,) + tuple(msg.shape[1:]), dtype=dtype,
                      device=msg.device).index_add_(0, g.dst, msg.to(dtype))
    return (_scale_mean(g, out) if mean else out).to(msg.dtype)


_BLOCK_REDUCE = {"sum": torch.sum, "mean": torch.mean, "max": torch.amax, "min": torch.amin}


def _block_reduce(g: Graph, x: torch.Tensor, reduce: str) -> torch.Tensor:
    """``copy_u`` over a positional block: destination ``i``'s sources are
    the ``f`` slots ``nd + i·f ...``, so a reshape and a reduce over them."""
    nd, f = g.num_dst_nodes, g.block_fanout
    if x.shape[0] != g.num_src_nodes:
        raise ValueError(f"x must have num_src_nodes={g.num_src_nodes} rows, got {tuple(x.shape)}")
    return _BLOCK_REDUCE[reduce](x[nd: nd + nd * f].reshape((nd, f) + tuple(x.shape[1:])), 1)


def gspmm(
    g: Graph,
    op: str,
    reduce: str,
    x: Optional[torch.Tensor] = None,
    e: Optional[torch.Tensor] = None,
    *,
    lowering: str = "fused",
) -> torch.Tensor:
    """Generalized SpMM (see the module docstring).

    Args:
      g: graph with its reverse (``from_edges`` builds both).
      op: message op; ``copy_u`` uses only ``x``, ``copy_e`` only ``e``, the
        binary ops combine both with broadcasting.
      reduce: ``sum``, ``mean``, ``max`` or ``min``.
      x: (num_src_nodes, ...) float32 or bfloat16 source-node features; 2-D
        for ``copy_u``.
      e: (num_edges, ...) float32 or bfloat16 edge features in canonical
        order.
      lowering: ``fused`` (the kernels) or ``scatter`` (the PyG twin, above).
    Returns:
      (num_dst_nodes, ...) aggregated features: float32 for the fused sum
      and mean of bfloat16 (above), else the inputs' type.
    """
    if op not in _COPY_U + _COPY_E + tuple(_BINARY):
        raise ValueError(f"unknown spmm op: {op!r}")
    if reduce not in ("sum", "mean") + tuple(_EXTREMA):
        raise ValueError(f"unknown spmm reduce: {reduce!r}")
    if lowering not in ("fused", "scatter"):
        raise ValueError(f"unknown spmm lowering: {lowering!r}")
    if op not in _COPY_U and e is None:
        raise ValueError(f"spmm op {op!r} requires edge features e")
    if op not in _COPY_E and x is None:
        raise ValueError(f"spmm op {op!r} requires node features x")
    mean = reduce == "mean"
    if g.block_fanout is not None and op in _COPY_U:
        return _block_reduce(g, x, reduce)
    if reduce in _EXTREMA:
        msg = e if op in _COPY_E else gather_src_rows(g, x)
        if op in _BINARY:
            msg = _BINARY[op](msg, e)
        return _EXTREMA[reduce](msg, g.dst, g.num_dst_nodes)
    if op in _COPY_E:
        if lowering == "scatter":
            return _scatter(g, e, mean)
        out = seg_sum_dst(g, e)
        return _scale_mean(g, out) if mean else out
    if op in _COPY_U and (x.dim() != 2 or x.shape[0] != g.num_src_nodes):
        raise ValueError(
            f"x must be (num_src_nodes={g.num_src_nodes}, D), got {tuple(x.shape)}"
        )
    if lowering == "scatter":
        msg = x.index_select(0, g.src)
        return _scatter(g, _BINARY[op](msg, e) if op in _BINARY else msg, mean)
    if g.reverse is None:
        raise ValueError("gspmm needs the graph's reverse for its backward")
    if op in _COPY_U:
        return _CopyU.apply(x, g, mean)
    out = seg_sum_dst(g, _BINARY[op](gather_src_rows(g, x), e))
    return _scale_mean(g, out) if mean else out


def copy_u_sum(g: Graph, x: torch.Tensor) -> torch.Tensor:
    return gspmm(g, "copy_u", "sum", x=x)


def copy_u_mean(g: Graph, x: torch.Tensor) -> torch.Tensor:
    return gspmm(g, "copy_u", "mean", x=x)


def u_mul_e_sum(g: Graph, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return gspmm(g, "mul", "sum", x=x, e=e)
