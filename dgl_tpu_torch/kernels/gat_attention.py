"""K3: fused GAT attention, forward and backward, with no per-edge tensor.

``gat_attention(g, v, a_src, a_dst)`` computes, for every head,
``out[d] = Σ_{s→d} drop(softmax_d(leaky_relu(a_src[s] + a_dst[d]))) · v[s]``
as a ``torch.autograd.Function``: its forward is one launch of
``gat_attention_fwd`` over the dst CSR, its backward one launch of
``gat_attention_bwd`` (the "b2" pass) over the reverse CSR plus the N-wide
closed forms of ``_lane_gat_bwd``::

    C          = Σ_D g · out
    grad_a_dst = Σ_D g · w1 − C · w1s
    grad_a_src = Σ_D v · w2 − w3

Each pass wrapper launches its hand-written CUDA kernel
(``csrc/gat_attention.cu``) for CUDA tensors and uses its plain version
(``*_plain``: gathers, ``exp`` and ``index_add_``) only for CPU tensors;
``gat_attention_fwd.launches`` and ``gat_attention_bwd.launches`` count the
kernels' launches. ``gat_attention_plain`` is the whole function written
with gathers and differentiated by autograd, the yardstick of the tests.

Attention dropout is the JAX package's stateless hash of the
forward-canonical edge id (``keep_mask``), so masks agree bit for bit with
``dgl_tpu/kernels/lane_attention.py:_hash_keep`` and between the two
passes. The seed is a (1,) int32 tensor on the operands' device.

Counterpart of ``dgl_tpu/kernels/lane_attention.py:lane_gat_agg``. The
softmax shift is the exact row maximum, where the JAX kernel uses the loose
bound ``leaky_relu(max a_src + a_dst)``; softmax does not change under the
shift.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.segment import segment_max
from .build import load
from .seg_sum import csr_rows

__all__ = [
    "gat_attention",
    "gat_attention_plain",
    "gat_attention_fwd",
    "gat_attention_fwd_plain",
    "gat_attention_bwd",
    "gat_attention_bwd_plain",
    "keep_mask",
]

_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2³²`` for int64 ``x`` in [0, 2³²), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _drop_consts(keep: float) -> Tuple[int, float]:
    """The hash threshold ``int(keep·2²⁴)`` and the scale ``float32(1/keep)``."""
    return min(int(keep * float(1 << 24)), 1 << 24), float(np.float32(1.0 / keep))


def keep_mask(eid: torch.Tensor, seed: torch.Tensor, keep: float) -> torch.Tensor:
    """Per-edge dropout factor: murmur3 fmix32 of ``eid ^ seed`` as uint32,
    ``1/keep`` where its low 24 bits fall below ``int(keep·2²⁴)``, else 0."""
    x = torch.bitwise_xor(eid.to(torch.int32), seed.to(torch.int32)).to(torch.int64) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    thresh, scale = _drop_consts(keep)
    return torch.where((x & 0xFFFFFF) < thresh, scale, 0.0).to(torch.float32)


def _leaky(x: torch.Tensor, ns: float) -> torch.Tensor:
    return torch.where(x > 0, x, ns * x)


def _row_shift(indptr, rows, src, a_src, a_dst, ns) -> torch.Tensor:
    """Exact per-row shift ``leaky_relu(max_{s→d} a_src[s] + a_dst[d])``
    (leaky_relu is monotone); 0 on an empty row."""
    mx = segment_max(a_src[src], rows, a_dst.shape[0])
    has_edges = (indptr[1:] > indptr[:-1]).unsqueeze(1)
    return torch.where(has_edges, _leaky(mx + a_dst, ns), 0.0)


def _zeros_like_rows(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((n,) + tuple(like.shape[1:]), dtype=like.dtype, device=like.device)


def gat_attention_fwd_plain(
    indptr, src, v, a_src, a_dst, *, negative_slope: float, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None,
):
    """The forward pass in plain PyTorch; returns (out, w1, inv_s, w1s, shift)
    like the kernel. Materialises (E, H, D) buffers."""
    n, e = indptr.numel() - 1, src.numel()
    rows, s = csr_rows(indptr, e), src.long()
    shift = _row_shift(indptr, rows, s, a_src, a_dst, negative_slope)
    raw = a_src[s] + a_dst[rows]
    slope = torch.where(raw > 0, 1.0, negative_slope)
    p = torch.exp(_leaky(raw, negative_slope) - shift[rows])
    pm = p if keep >= 1.0 else p * keep_mask(torch.arange(e, device=src.device), seed, keep)[:, None]
    vs = v[s]
    num = _zeros_like_rows(n, v).index_add_(0, rows, pm.unsqueeze(-1) * vs)
    w1u = _zeros_like_rows(n, v).index_add_(0, rows, (pm * slope).unsqueeze(-1) * vs)
    ssum = _zeros_like_rows(n, a_dst).index_add_(0, rows, p)
    w1su = _zeros_like_rows(n, a_dst).index_add_(0, rows, p * slope)
    live = ssum > 0
    div = torch.where(live, ssum, 1.0)
    out = torch.where(live.unsqueeze(-1), num / div.unsqueeze(-1), 0.0)
    w1 = torch.where(live.unsqueeze(-1), w1u / div.unsqueeze(-1), 0.0)
    return out, w1, torch.where(live, 1.0 / div, 0.0), torch.where(live, w1su / div, 0.0), shift


def gat_attention_bwd_plain(
    indptr, dst, eid, g, node, a_src, *, negative_slope: float, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None,
):
    """The b2 pass in plain PyTorch over the reverse CSR (``dst`` holds the
    original dst of each slot, ``eid`` its forward-canonical id, ``node``
    (N_dst, H, 4) the packed a_dst, shift, inv_s, C); returns
    (grad_v, w2, w3)."""
    n, e = indptr.numel() - 1, dst.numel()
    rows, d = csr_rows(indptr, e), dst.long()
    q = node[d]
    raw = a_src[rows] + q[..., 0]
    slope = torch.where(raw > 0, 1.0, negative_slope)
    alpha = torch.exp(_leaky(raw, negative_slope) - q[..., 1]) * q[..., 2]
    wv = alpha if keep >= 1.0 else alpha * keep_mask(eid, seed, keep)[:, None]
    gd = g[d]
    grad_v = _zeros_like_rows(n, g).index_add_(0, rows, wv.unsqueeze(-1) * gd)
    w2 = _zeros_like_rows(n, g).index_add_(0, rows, (wv * slope).unsqueeze(-1) * gd)
    w3 = _zeros_like_rows(n, a_src).index_add_(0, rows, alpha * slope * q[..., 3])
    return grad_v, w2, w3


def gat_attention_plain(
    indptr, src, v, a_src, a_dst, *, negative_slope: float = 0.2, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The whole function in plain PyTorch, differentiated by autograd:
    gathers, the detached exact shift, ``exp`` and ``index_add_``."""
    n, e = indptr.numel() - 1, src.numel()
    rows, s = csr_rows(indptr, e), src.long()
    shift = _row_shift(indptr, rows, s, a_src.detach(), a_dst.detach(), negative_slope)
    p = torch.exp(_leaky(a_src[s] + a_dst[rows], negative_slope) - shift[rows])
    ssum = _zeros_like_rows(n, a_dst).index_add(0, rows, p)
    alpha = p / ssum[rows]  # an edge's row is never empty
    if keep < 1.0:
        alpha = alpha * keep_mask(torch.arange(e, device=src.device), seed, keep)[:, None]
    return _zeros_like_rows(n, v).index_add(0, rows, alpha.unsqueeze(-1) * v[s])


def _check(name, indptr, index_arrays, floats, seed, keep) -> None:
    dev = floats[0].device
    if indptr.dtype not in (torch.int32, torch.int64) or indptr.dim() != 1 or indptr.numel() < 1:
        raise TypeError(f"{name}: indptr must be 1-D int32/int64, got {indptr.dtype} {tuple(indptr.shape)}")
    for a in index_arrays:
        if a.dtype != torch.int32 or a.dim() != 1:
            raise TypeError(f"{name}: edge arrays must be 1-D int32, got {a.dtype} {tuple(a.shape)}")
    for a in floats:
        if a.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 operands, got {a.dtype}")
    if keep < 1.0 and (seed is None or seed.dtype != torch.int32 or seed.numel() != 1):
        raise ValueError(f"{name}: dropout (keep < 1) needs a (1,) int32 seed tensor")
    tensors = [indptr, *index_arrays, *floats] + ([seed] if keep < 1.0 else [])
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} operands lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"{name}: keep must be in (0, 1], got {keep}")


def _fn(name: str, n_ptrs_before_dims: int):
    fn = getattr(load("gat_attention"), name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p, ctypes.c_int] + [p] * n_ptrs_before_dims
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, p,
                          ctypes.c_uint, ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def _drop_args(keep: float, seed):
    if keep >= 1.0:
        return None, 0, 1.0
    thresh, scale = _drop_consts(keep)
    return seed.data_ptr(), thresh, scale


def gat_attention_fwd(
    indptr, src, v, a_src, a_dst, *, negative_slope: float, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None,
):
    """The forward pass over the dst CSR (``indptr`` (N_dst+1,), ``src`` (E,)
    int32, ``v`` (N_src, H, D), ``a_src`` (N_src, H), ``a_dst`` (N_dst, H)).
    Returns ``out`` and ``w1`` (N_dst, H, D), ``inv_s``, ``w1s`` and
    ``shift`` (N_dst, H); every one is 0 on an empty row."""
    _check("gat_attention_fwd", indptr, [src], [v, a_src, a_dst], seed, keep)
    n, (n_src, heads, d) = indptr.numel() - 1, v.shape
    if a_src.shape != (n_src, heads) or a_dst.shape != (n, heads):
        raise ValueError(f"gat_attention_fwd: a_src {tuple(a_src.shape)} / a_dst "
                         f"{tuple(a_dst.shape)} do not match v {tuple(v.shape)} and {n} rows")
    if v.device.type == "cpu":
        return gat_attention_fwd_plain(indptr, src, v, a_src, a_dst, negative_slope=negative_slope,
                                       keep=keep, seed=seed)
    out, w1 = (torch.empty((n, heads, d), dtype=torch.float32, device=v.device) for _ in range(2))
    inv_s, w1s, shift = (torch.empty((n, heads), dtype=torch.float32, device=v.device)
                         for _ in range(3))
    if n == 0 or d == 0 or heads == 0:
        return out, w1, inv_s, w1s, shift
    seed_ptr, thresh, scale = _drop_args(keep, seed)
    with torch.cuda.device(v.device):
        err = _fn("gat_fwd_f32", 9)(
            indptr.data_ptr(), int(indptr.dtype == torch.int64), src.data_ptr(), v.data_ptr(),
            a_src.data_ptr(), a_dst.data_ptr(), out.data_ptr(), w1.data_ptr(), inv_s.data_ptr(),
            w1s.data_ptr(), shift.data_ptr(), n, heads, d, negative_slope, seed_ptr, thresh,
            scale, torch.cuda.current_stream(v.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"gat_attention_fwd kernel launch failed with CUDA error {err}")
    gat_attention_fwd.launches += 1
    return out, w1, inv_s, w1s, shift


gat_attention_fwd.launches = 0


def gat_attention_bwd(
    indptr, dst, eid, g, node, a_src, *, negative_slope: float, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None,
):
    """The b2 pass over the reverse CSR (``indptr`` (N_src+1,), ``dst`` and
    ``eid`` (E,) int32: each slot's original dst and forward-canonical id),
    with ``g`` (N_dst, H, D) the output cotangent, ``node`` (N_dst, H, 4)
    the packed a_dst, shift, inv_s and C, and ``a_src`` (N_src, H). Returns
    ``grad_v``, ``w2`` (N_src, H, D) and ``w3`` (N_src, H)."""
    _check("gat_attention_bwd", indptr, [dst, eid], [g, node, a_src], seed, keep)
    n, (n_dst, heads, d) = indptr.numel() - 1, g.shape
    if node.shape != (n_dst, heads, 4) or a_src.shape != (n, heads):
        raise ValueError(f"gat_attention_bwd: node {tuple(node.shape)} / a_src "
                         f"{tuple(a_src.shape)} do not match g {tuple(g.shape)} and {n} rows")
    if eid.shape != dst.shape:
        raise ValueError("gat_attention_bwd: dst and eid differ in length")
    if g.device.type == "cpu":
        return gat_attention_bwd_plain(indptr, dst, eid, g, node, a_src,
                                       negative_slope=negative_slope, keep=keep, seed=seed)
    if node.data_ptr() % 16:
        raise ValueError("gat_attention_bwd: node must be 16-byte aligned (one float4 per row)")
    grad_v, w2 = (torch.empty((n, heads, d), dtype=torch.float32, device=g.device) for _ in range(2))
    w3 = torch.empty((n, heads), dtype=torch.float32, device=g.device)
    if n == 0 or d == 0 or heads == 0:
        return grad_v, w2, w3
    seed_ptr, thresh, scale = _drop_args(keep, seed)
    with torch.cuda.device(g.device):
        err = _fn("gat_b2_f32", 8)(
            indptr.data_ptr(), int(indptr.dtype == torch.int64), dst.data_ptr(), eid.data_ptr(),
            g.data_ptr(), node.data_ptr(), a_src.data_ptr(), grad_v.data_ptr(), w2.data_ptr(),
            w3.data_ptr(), n, heads, d, negative_slope, seed_ptr, thresh, scale,
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"gat_attention_bwd kernel launch failed with CUDA error {err}")
    gat_attention_bwd.launches += 1
    return grad_v, w2, w3


gat_attention_bwd.launches = 0


class _GATAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, a_src, a_dst, g, negative_slope, keep, seed):
        out, w1, inv_s, w1s, shift = gat_attention_fwd(
            g.indptr, g.src, v, a_src, a_dst, negative_slope=negative_slope, keep=keep, seed=seed
        )
        ctx.save_for_backward(v, a_src, a_dst, out, w1, inv_s, w1s, shift)
        ctx.g, ctx.negative_slope, ctx.keep, ctx.seed = g, negative_slope, keep, seed
        return out

    @staticmethod
    def backward(ctx, g_out):
        v, a_src, a_dst, out, w1, inv_s, w1s, shift = ctx.saved_tensors
        g_out = g_out.contiguous()
        c = (g_out * out).sum(-1)
        grad_a_dst = (g_out * w1).sum(-1) - c * w1s
        node = torch.stack([a_dst, shift, inv_s, c], dim=-1)
        rev = ctx.g.reverse
        grad_v, w2, w3 = gat_attention_bwd(
            rev.indptr, rev.src, rev.eid, g_out, node, a_src,
            negative_slope=ctx.negative_slope, keep=ctx.keep, seed=ctx.seed,
        )
        grad_a_src = (v * w2).sum(-1) - w3
        return grad_v, grad_a_src, grad_a_dst, None, None, None, None


def gat_attention(
    g, v: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, *,
    negative_slope: float = 0.2, keep: float = 1.0, seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused attention aggregation over graph ``g`` (with its reverse):
    ``v`` (N_src, H, D), ``a_src`` (N_src, H), ``a_dst`` (N_dst, H), all
    float32; ``keep`` < 1 applies the hash dropout with the (1,) int32
    ``seed``. Returns (N_dst, H, D); a row with no in-edges is 0."""
    if g.reverse is None:
        raise ValueError("gat_attention needs the graph's reverse for its backward")
    if v.shape[0] != g.num_src_nodes or a_dst.shape[0] != g.num_dst_nodes:
        raise ValueError(f"gat_attention: v {tuple(v.shape)} / a_dst {tuple(a_dst.shape)} do not "
                         f"match the graph ({g.num_src_nodes} src, {g.num_dst_nodes} dst nodes)")
    return _GATAttention.apply(v.contiguous(), a_src.contiguous(), a_dst.contiguous(), g,
                               float(negative_slope), float(keep), seed)
