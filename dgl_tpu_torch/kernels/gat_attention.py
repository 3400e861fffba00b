"""K3: fused GAT attention, forward and backward, with no per-edge tensor.

``gat_attention(g, v, a_src, a_dst)`` computes, for every head,
``out[d] = Σ_{s→d} drop(softmax_d(leaky_relu(a_src[s] + a_dst[d]))) · v[s]``
as a ``torch.autograd.Function``: its forward is one call of
``gat_attention_fwd`` over the dst CSR with the graph's row split
(``g.split``), its backward one call of ``gat_score_grad`` and one of
``gat_attention_bwd`` (the "b2" pass) over the reverse CSR with its split
(``g.reverse.split``), which give the N-wide closed forms of
``_lane_gat_bwd``::

    C          = Σ_D g · out              (gat_score_grad)
    grad_a_dst = Σ_D g · w1 − C · w1s     (gat_score_grad)
    grad_a_src = Σ_D v · w2 − w3          (b2, from v's row: w2 and w3
                                           never leave the launch)

``gat_attention_vectors(g, z, attn_src, attn_dst)``, GATConv's fused form,
takes the scores from the attention vectors as well: ``gat_scores``
computes ``a_src = Σ_D z·attn_src`` and ``a_dst = Σ_D z_dst·attn_dst``
before the forward, and ``gat_vector_grad`` the gradients of z (adding v's
where v is z) and of the attention vectors after b2, so that no torch
arithmetic on (N, H, D) tensors is left around K3 ("K3's node passes",
below).

Each pass wrapper launches its hand-written CUDA kernel
(``csrc/gat_attention.cu``, one launch a call, through ``build.launch``) for
CUDA tensors and uses its plain version (``*_plain``: gathers, ``exp`` and
``index_add_``, the unsplit definition) only for CPU tensors;
``gat_attention_fwd.launches`` and ``gat_attention_bwd.launches`` count the
calls that launch a pass. ``.combines`` stays 0: the kernels fold their
long rows inside their launch.

The kernels (``csrc/gat_attention.cu``, sized by ``csrc/k3_geometry.h``)
replace ``dgl_tpu/kernels/lane_attention.py:_attn_pass``. On the card they
are bound by dependent row gathers, as K1 is, so their design is K1's: a
warp walks a run of consecutive rows for every head at once, each edge's
index read once and its whole H·D row staged in shared memory by TMA bulk
or ``cp.async`` copies, with the edge's ``a_src`` (b2: its ``node``) staged
beside it; lanes own columns of the row and take their own head's weight
of each edge, which the lane scoring that (edge, head) pair wrote to
shared memory. The softmax shift is found online, a running maximum per
head whose rise rescales that head's sums (design (a)). A pre-pass over the
row's indices and ``a_src`` for the exact maxima first (design (b)) was
built beside it, timed in turns on an NVIDIA H100 80GB HBM3 at 700 W and
removed: (a) took 0.5153 ms against 0.5796 at H = 1 on reddit and 0.4482
against 0.5066 at H = 4 on arxiv (D = 16, with dropout; PERF.md §6 names
the run). Long rows are split as in K1 (``kernels/csr_spmm.py``):
every row of more than ``T`` edges is cut into chunks of at most ``T``
edges, each one warp's work in the pass's launch, and the warp that counts
a long row's last chunk on the plan's ``counters`` combines it in the same
launch: b2's sums linearly in ascending chunk order; the forward's, each
chunk with its own shift ``sh_k`` (its chunk's maximum), scaled by
``exp(sh_k − sh)`` to the row's shift ``sh = max_k sh_k`` and added in
ascending order. No atomics decide an order, so two runs are bitwise equal.
The forward and b2 over one CSR share its plan's counters: the package runs
both on one stream. A CSR of 2^31 edges or rows or more is refused (the
index arrays are int32). ``gat_attention_plain`` is the whole function
written with gathers and differentiated by autograd, the yardstick of the
tests.

Attention dropout is the JAX package's stateless hash
(``dgl_tpu/kernels/lane_attention.py:_hash_keep``, ``keep_mask``) keyed on
``eid·H + h`` (``drop_keys``: ``eid`` the forward-canonical edge id, ``h``
the head), so each (edge, head) pair is dropped on its own, as DGL's
GATConv and the edge form drop them, and both passes draw the same mask.
At H = 1 the key is ``eid`` and the mask equals the lane kernel's bit for
bit; the lane kernel keys on ``eid`` alone at every H, one mask an edge for
all heads. The seed is a (1,) int32 tensor on the operands' device.

``v`` is float32 or bfloat16, as ``lane_gat_agg``'s ``compute_dtype``
(``lane_attention.py:503``): the forward reads v's rows as bfloat16 and
keeps the logits, the shift, the softmax, the dropout and every sum in
float32, and writes float32; b2 reads the float32 cotangent, sums
``grad_v`` in float32 and rounds it once to v's type (``:477``); its
``grad_a_src = Σ_D v·w2 − w3`` reads v's bfloat16 row converted to
float32. The node passes are float32 only. ``.launches_bf16`` counts each pass's
bfloat16 launches among ``.launches``. The kernels take at most
``MAX_HEADS`` heads.

Counterpart of ``dgl_tpu/kernels/lane_attention.py:lane_gat_agg``. The
softmax shift is the exact row maximum, where the JAX kernel uses the loose
bound ``leaky_relu(max a_src + a_dst)``; softmax does not change under the
shift.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..graph.split import RowSplit, row_split
from ..ops.segment import segment_max
from .build import entry, launch
from .seg_sum import ROW_DTYPES, csr_rows, sum_dtype

__all__ = [
    "gat_attention",
    "gat_attention_vectors",
    "gat_attention_plain",
    "gat_attention_fwd",
    "gat_attention_fwd_plain",
    "gat_attention_bwd",
    "gat_attention_bwd_plain",
    "gat_scores",
    "gat_score_grad",
    "gat_vector_grad",
    "keep_mask",
    "drop_keys",
]

_U32 = 0xFFFFFFFF
MAX_HEADS = 32  # the kernels' lanes score head lane % H (H rounded up to a power of two)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2³²`` for int64 ``x`` in [0, 2³²), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _drop_consts(keep: float) -> Tuple[int, float]:
    """The hash threshold ``int(keep·2²⁴)`` and the scale ``float32(1/keep)``."""
    return min(int(keep * float(1 << 24)), 1 << 24), float(np.float32(1.0 / keep))


def drop_keys(eid: torch.Tensor, heads: int) -> torch.Tensor:
    """(E, heads) int64 dropout keys ``eid·heads + h mod 2³²`` of the
    forward-canonical edge ids ``eid``."""
    h = torch.arange(heads, dtype=torch.int64, device=eid.device)
    return ((eid.to(torch.int64) & _U32).unsqueeze(1) * heads + h) & _U32


def keep_mask(key: torch.Tensor, seed: torch.Tensor, keep: float) -> torch.Tensor:
    """Dropout factor of each key (an edge id, or ``drop_keys``' per-head
    key): murmur3 fmix32 of ``key ^ seed`` as uint32, ``1/keep`` where its
    low 24 bits fall below ``int(keep·2²⁴)``, else 0."""
    x = torch.bitwise_xor(key.to(torch.int64), seed.to(torch.int64)) & _U32
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
    like the kernel. Materialises (E, H, D) buffers. A bfloat16 ``v`` is
    converted to float32 first, so its sums are float32 as the kernel's."""
    n, e = indptr.numel() - 1, src.numel()
    rows, s = csr_rows(indptr, e), src.long()
    v = v.to(sum_dtype(v.dtype))
    shift = _row_shift(indptr, rows, s, a_src, a_dst, negative_slope)
    raw = a_src[s] + a_dst[rows]
    slope = torch.where(raw > 0, 1.0, negative_slope)
    p = torch.exp(_leaky(raw, negative_slope) - shift[rows])
    if keep < 1.0:
        pm = p * keep_mask(drop_keys(torch.arange(e, device=src.device), p.shape[1]), seed, keep)
    else:
        pm = p
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
    indptr, dst, eid, g, node, a_src, v, *, negative_slope: float, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None,
):
    """The b2 pass in plain PyTorch over the reverse CSR (``dst`` holds the
    original dst of each slot, ``eid`` its forward-canonical id, ``node``
    (N_dst, H, 4) the packed a_dst, shift, inv_s, C, ``v`` the forward's
    gathered rows); returns (grad_v, grad_a_src) with ``grad_a_src = Σ_D
    v·w2 − w3``, both summed in g's type, ``grad_v`` rounded once to
    bfloat16 where v is bfloat16."""
    n, e = indptr.numel() - 1, dst.numel()
    rows, d = csr_rows(indptr, e), dst.long()
    q = node[d]
    raw = a_src[rows] + q[..., 0]
    slope = torch.where(raw > 0, 1.0, negative_slope)
    alpha = torch.exp(_leaky(raw, negative_slope) - q[..., 1]) * q[..., 2]
    wv = alpha if keep >= 1.0 else alpha * keep_mask(drop_keys(eid, alpha.shape[1]), seed, keep)
    gd = g[d]
    grad_v = _zeros_like_rows(n, g).index_add_(0, rows, wv.unsqueeze(-1) * gd)
    w2 = _zeros_like_rows(n, g).index_add_(0, rows, (wv * slope).unsqueeze(-1) * gd)
    w3 = _zeros_like_rows(n, a_src).index_add_(0, rows, alpha * slope * q[..., 3])
    grad_a_src = (v.to(g.dtype) * w2).sum(-1) - w3
    return grad_v.to(v.dtype) if v.dtype == torch.bfloat16 else grad_v, grad_a_src


def gat_attention_plain(
    indptr, src, v, a_src, a_dst, *, negative_slope: float = 0.2, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The whole function in plain PyTorch, differentiated by autograd:
    gathers, the detached exact shift, ``exp`` and ``index_add_``. A
    bfloat16 ``v`` is converted to float32 before its gather, so its
    gradient is summed in float32 and rounded once."""
    n, e = indptr.numel() - 1, src.numel()
    v = v.to(sum_dtype(v.dtype))
    rows, s = csr_rows(indptr, e), src.long()
    shift = _row_shift(indptr, rows, s, a_src.detach(), a_dst.detach(), negative_slope)
    p = torch.exp(_leaky(a_src[s] + a_dst[rows], negative_slope) - shift[rows])
    ssum = _zeros_like_rows(n, a_dst).index_add(0, rows, p)
    alpha = p / ssum[rows]  # an edge's row is never empty
    if keep < 1.0:
        alpha = alpha * keep_mask(drop_keys(torch.arange(e, device=src.device), alpha.shape[1]),
                                  seed, keep)
    return _zeros_like_rows(n, v).index_add(0, rows, alpha.unsqueeze(-1) * v[s])


def _check(name, indptr, index_arrays, floats, seed, keep, rows=()) -> None:
    """``floats`` must be float32, ``rows`` (v) float32 or bfloat16."""
    dev = floats[0].device
    if indptr.dtype not in (torch.int32, torch.int64) or indptr.dim() != 1 or indptr.numel() < 1:
        raise TypeError(f"{name}: indptr must be 1-D int32/int64, got {indptr.dtype} {tuple(indptr.shape)}")
    for a in index_arrays:
        if a.dtype != torch.int32 or a.dim() != 1:
            raise TypeError(f"{name}: edge arrays must be 1-D int32, got {a.dtype} {tuple(a.shape)}")
    for a in floats:
        if a.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 operands, got {a.dtype}")
    for a in rows:
        if a.dtype not in ROW_DTYPES:
            raise TypeError(f"{name} takes float32 or bfloat16 v, got {a.dtype}")
    if keep < 1.0 and (seed is None or seed.dtype != torch.int32 or seed.numel() != 1):
        raise ValueError(f"{name}: dropout (keep < 1) needs a (1,) int32 seed tensor")
    tensors = [indptr, *index_arrays, *floats, *rows] + ([seed] if keep < 1.0 else [])
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} operands lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"{name}: keep must be in (0, 1], got {keep}")


_P, _LL, _I, _F, _U = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
# The C entry points' arguments: indptr and its int64 flag, the pass's
# arrays and sizes, the dropout (seed, thresh, scale), the row split
# (RowSplit.kernel_args(p0, counters=True) less its T), the other partials,
# the CSR's edge count, the stream.
_FWD_ARGTYPES = (_P, _I, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _F, _P, _U, _F,
                 _P, _P, _LL, _P, _LL, _P, _P, _P, _P, _LL, _P)
_B2_ARGTYPES = (_P, _I, _P, _P, _P, _LL, _P, _P, _P, _P, _P, _LL, _I, _I, _F, _P, _U, _F,
                _P, _P, _LL, _P, _LL, _P, _P, _P, _P, _LL, _P)


def _entry(name: str, dtype: torch.dtype, argtypes):
    """Pass ``name``'s C entry point for rows of ``dtype`` (v, or b2's
    grad_v): the float32 pair in ``gat_attention``'s library, the bfloat16
    pair in ``gat_attention_bf16``'s."""
    if dtype == torch.bfloat16:
        return entry("gat_attention_bf16", f"{name}_bf16", argtypes)
    return entry("gat_attention", f"{name}_f32", argtypes)


def _partials(chunks: int, dev, *shapes):
    """The chunks' float32 partials buffers, or ``None`` each (null
    pointers, which the kernels never read) for a plan with no chunks."""
    if not chunks:
        return (None,) * len(shapes)
    return tuple(torch.empty(s, dtype=torch.float32, device=dev) for s in shapes)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_heads(name: str, heads: int) -> None:
    if heads > MAX_HEADS:
        raise ValueError(f"{name}: the kernels take at most {MAX_HEADS} heads, got {heads}")


def _drop_args(keep: float, seed):
    if keep >= 1.0:
        return None, 0, 1.0
    thresh, scale = _drop_consts(keep)
    return seed.data_ptr(), thresh, scale


def gat_attention_fwd(
    indptr, src, v, a_src, a_dst, *, negative_slope: float, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None, split: Optional[RowSplit] = None,
):
    """The forward pass over the dst CSR (``indptr`` (N_dst+1,), ``src`` (E,)
    int32, ``v`` (N_src, H, D) float32 or bfloat16, ``a_src`` (N_src, H),
    ``a_dst`` (N_dst, H) float32). Returns ``out`` and ``w1`` (N_dst, H, D),
    ``inv_s``, ``w1s`` and ``shift`` (N_dst, H), all float32; every one is 0
    on an empty row.

    ``split``: the CSR's row split (``g.split`` for a graph's dst CSR), on
    the device of ``indptr``, checked as ``csr_spmm`` checks it: one whose
    row or edge count differs raises ``ValueError`` before any launch; one
    of another CSR with the same counts is not caught: the rows it lists get
    the sums of its chunks, the others are summed as usual. Without one, a
    launch on the card builds it from ``indptr`` (a host sync). The
    package's ops always pass the graph's plan. Two launches with one plan
    (this pass's or b2's) must not run at once on two streams (its
    counters).
    """
    with trace.span("dgl_tpu_torch.K3.fwd"):
        _check("gat_attention_fwd", indptr, [src], [a_src, a_dst], seed, keep, rows=[v])
        n, (n_src, heads, d) = indptr.numel() - 1, v.shape
        if a_src.shape != (n_src, heads) or a_dst.shape != (n, heads):
            raise ValueError(f"gat_attention_fwd: a_src {tuple(a_src.shape)} / a_dst "
                             f"{tuple(a_dst.shape)} do not match v {tuple(v.shape)} and {n} rows")
        if split is not None:
            split.check(indptr, src.numel(), "gat_attention_fwd")
        if v.device.type == "cpu":
            return gat_attention_fwd_plain(indptr, src, v, a_src, a_dst,
                                           negative_slope=negative_slope, keep=keep, seed=seed)
        out, w1 = (torch.empty((n, heads, d), dtype=torch.float32, device=v.device)
                   for _ in range(2))
        inv_s, w1s, shift = (torch.empty((n, heads), dtype=torch.float32, device=v.device)
                             for _ in range(3))
        if n == 0 or d == 0 or heads == 0:
            return out, w1, inv_s, w1s, shift
        _check_heads("gat_attention_fwd", heads)
        if split is None:
            split = row_split(indptr)
        c = split.num_chunks
        # the chunks' unnormalised sums and (shift, s, w1su)
        pnum, pw1u, pscal = _partials(c, v.device, (c, heads, d), (c, heads, d), (3, c, heads))
        seed_ptr, thresh, scale = _drop_args(keep, seed)
        launch(_entry("gat_fwd", v.dtype, _FWD_ARGTYPES), v.device,
               indptr.data_ptr(), int(indptr.dtype == torch.int64), src.data_ptr(), v.data_ptr(),
               n_src, a_src.data_ptr(), a_dst.data_ptr(), out.data_ptr(), w1.data_ptr(),
               inv_s.data_ptr(), w1s.data_ptr(), shift.data_ptr(), n, heads, d, negative_slope,
               seed_ptr, thresh, scale, *split.kernel_args(pnum, counters=True)[1:], _ptr(pw1u),
               _ptr(pscal), src.numel())
        gat_attention_fwd.launches += 1
        gat_attention_fwd.launches_bf16 += int(v.dtype == torch.bfloat16)
        trace.launch("K3", "fwd", indptr, src, v, dropout=keep < 1.0)
        return out, w1, inv_s, w1s, shift


gat_attention_fwd.launches = 0
gat_attention_fwd.launches_bf16 = 0
gat_attention_fwd.combines = 0


def gat_attention_bwd(
    indptr, dst, eid, g, node, a_src, v, *, negative_slope: float, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None, split: Optional[RowSplit] = None,
):
    """The b2 pass over the reverse CSR (``indptr`` (N_src+1,), ``dst`` and
    ``eid`` (E,) int32: each slot's original dst and forward-canonical id),
    with ``g`` (N_dst, H, D) the output cotangent, ``node`` (N_dst, H, 4)
    the packed a_dst, shift, inv_s and C, and ``a_src`` (N_src, H), all
    float32, and ``v`` (N_src, H, D) the forward's rows, float32 or
    bfloat16. Returns ``grad_v`` (N_src, H, D) in v's type (summed in
    float32, rounded once) and ``grad_a_src = Σ_D v·w2 − w3`` (N_src, H)
    float32, which the launch computes from v's row at the end of each row's
    sums: ``w2`` and ``w3`` never leave it.

    ``split``: the reverse CSR's row split (``g.reverse.split``), as for
    ``gat_attention_fwd``; the forward over the same CSR shares its
    counters."""
    with trace.span("dgl_tpu_torch.K3.b2"):
        _check("gat_attention_bwd", indptr, [dst, eid], [g, node, a_src], seed, keep, rows=[v])
        n, (n_dst, heads, d) = indptr.numel() - 1, g.shape
        if node.shape != (n_dst, heads, 4) or a_src.shape != (n, heads) or v.shape != (n, heads, d):
            raise ValueError(f"gat_attention_bwd: node {tuple(node.shape)} / a_src "
                             f"{tuple(a_src.shape)} / v {tuple(v.shape)} do not match g "
                             f"{tuple(g.shape)} and {n} rows")
        if eid.shape != dst.shape:
            raise ValueError("gat_attention_bwd: dst and eid differ in length")
        if split is not None:
            split.check(indptr, dst.numel(), "gat_attention_bwd")
        if g.device.type == "cpu":
            return gat_attention_bwd_plain(indptr, dst, eid, g, node, a_src, v,
                                           negative_slope=negative_slope, keep=keep, seed=seed)
        if node.data_ptr() % 16:
            raise ValueError("gat_attention_bwd: node must be 16-byte aligned (one float4 per row)")
        v_dtype = v.dtype
        grad_v = torch.empty((n, heads, d), dtype=v_dtype, device=g.device)
        grad_a_src = torch.empty((n, heads), dtype=torch.float32, device=g.device)
        if n == 0 or d == 0 or heads == 0:
            return grad_v, grad_a_src
        _check_heads("gat_attention_bwd", heads)
        if split is None:
            split = row_split(indptr)
        c = split.num_chunks
        pgv, pw2, pw3 = _partials(c, g.device, (c, heads, d), (c, heads, d), (c, heads))
        seed_ptr, thresh, scale = _drop_args(keep, seed)
        launch(_entry("gat_b2", v_dtype, _B2_ARGTYPES), g.device,
               indptr.data_ptr(), int(indptr.dtype == torch.int64), dst.data_ptr(), eid.data_ptr(),
               g.data_ptr(), n_dst, node.data_ptr(), a_src.data_ptr(), v.data_ptr(),
               grad_v.data_ptr(), grad_a_src.data_ptr(), n, heads, d, negative_slope, seed_ptr,
               thresh, scale,
               *split.kernel_args(pgv, counters=True)[1:], _ptr(pw2), _ptr(pw3), dst.numel())
        gat_attention_bwd.launches += 1
        gat_attention_bwd.launches_bf16 += int(v_dtype == torch.bfloat16)
        trace.launch("K3", "b2", indptr, dst, g, value_dtype=v_dtype, dropout=keep < 1.0)
        return grad_v, grad_a_src


gat_attention_bwd.launches = 0
gat_attention_bwd.launches_bf16 = 0
gat_attention_bwd.combines = 0


# ---- K3's node passes ------------------------------------------------------
#
# The per-(node, head) dot products around the two edge passes
# (csrc/gat_attention.cu, "K3's node passes"), float32, one launch a call on
# the card and the plain torch expression on the CPU:
#
#   gat_scores       before the forward: a_src = Σ_D z·attn_src,
#                    a_dst = Σ_D z_dst·attn_dst;
#   gat_score_grad   before b2: C = Σ_D g·out, grad_a_dst = Σ_D g·w1 − C·w1s
#                    and b2's packed node rows (a_dst, shift, inv_s, C);
#   gat_vector_grad  after b2: grad_z = grad_v + grad_a_src ⊗ attn_src +
#                    grad_a_dst ⊗ attn_dst (over grad_v's buffer) and the
#                    attention vectors' gradients Σ_n grad_a·z.
#
# Their launches are traced as kernel "K3N" (passes "scores", "score_grad",
# "vector_grad") and counted by ``.launches`` on each wrapper, apart from
# K3's own records and counters.

_SCORES_ARGTYPES = (_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P)
_SCORE_GRAD_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P)
_VECTOR_GRAD_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _LL, _LL, _I, _I,
                         _P)


def _check_node(name: str, *tensors) -> None:
    """Float32, contiguous, on one cuda or cpu device (None skipped)."""
    ts = [t for t in tensors if t is not None]
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 operands, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} operands lie on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")


def _check_vectors(name: str, z: torch.Tensor, *vectors: torch.Tensor) -> None:
    """Check the attention vectors against z (N, H, D); they may be (1, H, D)."""
    if z.dim() != 3:
        raise ValueError(f"{name}: z must be (N, H, D), got {tuple(z.shape)}")
    for a in vectors:
        if a.numel() != z.shape[1] * z.shape[2] or a.shape[-2:] != z.shape[1:]:
            raise ValueError(f"{name}: attention vector {tuple(a.shape)} does not match z "
                             f"{tuple(z.shape)}")


def gat_scores_plain(z, attn_src, attn_dst, z_dst=None):
    """``(Σ_D z·attn_src, Σ_D z_dst·attn_dst)``, (N_src, H) and (N_dst, H);
    ``z_dst`` None: z."""
    zd = z if z_dst is None else z_dst
    return (z * attn_src.view(z.shape[1:])).sum(-1), (zd * attn_dst.view(z.shape[1:])).sum(-1)


def gat_scores(z, attn_src, attn_dst, z_dst: Optional[torch.Tensor] = None):
    """The attention scores of every node and head: ``a_src = Σ_D
    z·attn_src`` (N_src, H) and ``a_dst = Σ_D z_dst·attn_dst`` (N_dst, H),
    ``z`` (N_src, H, D), ``z_dst`` (N_dst, H, D) or None for z (each row
    read once for both), the attention vectors (H, D) or (1, H, D); all
    float32."""
    with trace.span("dgl_tpu_torch.K3N.scores"):
        zd = None if z_dst is None or z_dst is z else z_dst
        _check_node("gat_scores", z, zd, attn_src, attn_dst)
        _check_vectors("gat_scores", z, attn_src, attn_dst)
        if zd is not None and zd.shape[1:] != z.shape[1:]:
            raise ValueError(f"gat_scores: z_dst {tuple(zd.shape)} does not match z {tuple(z.shape)}")
        if z.device.type == "cpu":
            return gat_scores_plain(z, attn_src, attn_dst, zd)
        n_src, heads, d = z.shape
        n_dst = n_src if zd is None else zd.shape[0]
        a_src = torch.empty((n_src, heads), dtype=torch.float32, device=z.device)
        a_dst = torch.empty((n_dst, heads), dtype=torch.float32, device=z.device)
        launch(entry("gat_attention", "gat_scores_f32", _SCORES_ARGTYPES), z.device,
               z.data_ptr(), _ptr(zd), attn_src.data_ptr(), attn_dst.data_ptr(), a_src.data_ptr(),
               a_dst.data_ptr(), n_src, n_dst, heads, d)
        gat_scores.launches += 1
        trace.launch("K3N", "scores", None, z, z)
        return a_src, a_dst


gat_scores.launches = 0


def gat_score_grad_plain(g, out, w1, a_dst, shift, inv_s, w1s):
    """``(node, grad_a_dst)``: C = Σ_D g·out, node (N, H, 4) = (a_dst,
    shift, inv_s, C), grad_a_dst = Σ_D g·w1 − C·w1s."""
    c = (g * out).sum(-1)
    return torch.stack([a_dst, shift, inv_s, c], -1), (g * w1).sum(-1) - c * w1s


def gat_score_grad(g, out, w1, a_dst, shift, inv_s, w1s):
    """Before b2, over the dst rows: ``g`` the output cotangent, ``out``,
    ``w1`` (N_dst, H, D) and ``a_dst``, ``shift``, ``inv_s``, ``w1s``
    (N_dst, H) the forward's, all float32. Returns b2's packed ``node``
    (N_dst, H, 4) = (a_dst, shift, inv_s, C), C = Σ_D g·out, and
    ``grad_a_dst = Σ_D g·w1 − C·w1s`` (N_dst, H)."""
    with trace.span("dgl_tpu_torch.K3N.score_grad"):
        _check_node("gat_score_grad", g, out, w1, a_dst, shift, inv_s, w1s)
        if out.shape != g.shape or w1.shape != g.shape or any(
                t.shape != g.shape[:2] for t in (a_dst, shift, inv_s, w1s)):
            raise ValueError(f"gat_score_grad: operands do not match g {tuple(g.shape)}")
        if g.device.type == "cpu":
            return gat_score_grad_plain(g, out, w1, a_dst, shift, inv_s, w1s)
        n, heads, d = g.shape
        node = torch.empty((n, heads, 4), dtype=torch.float32, device=g.device)
        grad_a_dst = torch.empty((n, heads), dtype=torch.float32, device=g.device)
        launch(entry("gat_attention", "gat_score_grad_f32", _SCORE_GRAD_ARGTYPES), g.device,
               g.data_ptr(), out.data_ptr(), w1.data_ptr(), a_dst.data_ptr(), shift.data_ptr(),
               inv_s.data_ptr(), w1s.data_ptr(), node.data_ptr(), grad_a_dst.data_ptr(), n,
               heads, d)
        gat_score_grad.launches += 1
        trace.launch("K3N", "score_grad", None, g, g)
        return node, grad_a_dst


gat_score_grad.launches = 0


def gat_vector_grad_plain(z, attn_src, attn_dst, grad_a_src, grad_a_dst, grad_v=None,
                          z_dst=None):
    """``(grad_z, grad_z_dst, grad_attn_src, grad_attn_dst)`` as
    ``gat_vector_grad`` returns them, in plain PyTorch."""
    shape = z.shape[1:]
    a_s, a_d = attn_src.view(shape), attn_dst.view(shape)
    grad_z = grad_a_src.unsqueeze(-1) * a_s
    if grad_v is not None:
        grad_z = grad_v + grad_z
    zd, grad_z_dst = z, None
    if z_dst is None:
        grad_z = grad_z + grad_a_dst.unsqueeze(-1) * a_d
    else:
        zd, grad_z_dst = z_dst, grad_a_dst.unsqueeze(-1) * a_d
    return (grad_z, grad_z_dst, (grad_a_src.unsqueeze(-1) * z).sum(0),
            (grad_a_dst.unsqueeze(-1) * zd).sum(0))


@functools.lru_cache(maxsize=None)
def _max_blocks(index: int) -> int:
    """The blocks a gat_vector_grad launch may take: two an SM."""
    return 2 * torch.cuda.get_device_properties(index).multi_processor_count


def gat_vector_grad(z, attn_src, attn_dst, grad_a_src, grad_a_dst, *,
                    grad_v: Optional[torch.Tensor] = None, z_dst: Optional[torch.Tensor] = None):
    """After b2: the gradients of ``z`` (N_src, H, D), of ``z_dst`` (N_dst,
    H, D; None: z is both sides) and of the attention vectors (H, D) or (1,
    H, D) from the scores' gradients ``grad_a_src`` (N_src, H) and
    ``grad_a_dst`` (N_dst, H); ``grad_v`` (N_src, H, D), v's gradient where
    v is z, is added to z's (on the card in place, its buffer becoming
    ``grad_z``). All float32. Returns ``(grad_z, grad_z_dst or None,
    grad_attn_src, grad_attn_dst)``, the last two (H, D); on the card the
    attention vectors' column sums over N are fixed per-block partials that
    the launch's last block adds in a fixed order, the block found by a
    ticket of the call's own, zeroed on the stream before the launch."""
    with trace.span("dgl_tpu_torch.K3N.vector_grad"):
        zd = None if z_dst is None or z_dst is z else z_dst
        _check_node("gat_vector_grad", z, zd, attn_src, attn_dst, grad_a_src, grad_a_dst, grad_v)
        _check_vectors("gat_vector_grad", z, attn_src, attn_dst)
        n_src, heads, d = z.shape
        n_dst = n_src if zd is None else zd.shape[0]
        if (grad_a_src.shape != (n_src, heads) or grad_a_dst.shape != (n_dst, heads)
                or (grad_v is not None and grad_v.shape != z.shape)
                or (zd is not None and zd.shape[1:] != z.shape[1:])):
            raise ValueError(f"gat_vector_grad: operands do not match z {tuple(z.shape)}")
        if z.device.type == "cpu":
            return gat_vector_grad_plain(z, attn_src, attn_dst, grad_a_src, grad_a_dst, grad_v, zd)
        dev = z.device
        grad_z = torch.empty_like(z) if grad_v is None else grad_v
        grad_z_dst = None if zd is None else torch.empty_like(zd)
        grad_attn = torch.empty((2, heads, d), dtype=torch.float32, device=dev)
        if max(n_src, n_dst) == 0 or heads * d == 0:
            grad_attn.zero_()
            return grad_z, grad_z_dst, grad_attn[0], grad_attn[1]
        blocks = _max_blocks(dev.index)
        # the blocks' (2, H·D) partials, then the int32 ticket
        partials = torch.empty(blocks * 2 * heads * d + 1, dtype=torch.float32, device=dev)
        launch(entry("gat_attention", "gat_vector_grad_f32", _VECTOR_GRAD_ARGTYPES), dev,
               z.data_ptr(), _ptr(zd), attn_src.data_ptr(), attn_dst.data_ptr(),
               grad_a_src.data_ptr(), grad_a_dst.data_ptr(), _ptr(grad_v), grad_z.data_ptr(),
               _ptr(grad_z_dst), partials.data_ptr(), blocks,
               partials.data_ptr() + 4 * blocks * 2 * heads * d,
               grad_attn.data_ptr(), n_src, n_dst, heads, d)
        gat_vector_grad.launches += 1
        trace.launch("K3N", "vector_grad", None, z, z)
        return grad_z, grad_z_dst, grad_attn[0], grad_attn[1]


gat_vector_grad.launches = 0


def _attention_bwd(ctx, g_out, v, a_src, a_dst, out, w1, inv_s, w1s, shift):
    """(grad_v, grad_a_src, grad_a_dst): gat_score_grad, then b2."""
    g_out = g_out.contiguous()
    node, grad_a_dst = gat_score_grad(g_out, out, w1, a_dst, shift, inv_s, w1s)
    rev = ctx.g.reverse
    grad_v, grad_a_src = gat_attention_bwd(
        rev.indptr, rev.src, rev.eid, g_out, node, a_src, v,
        negative_slope=ctx.negative_slope, keep=ctx.keep, seed=ctx.seed, split=rev.split,
    )
    return grad_v, grad_a_src, grad_a_dst


def _attention_fwd(ctx, g, v, a_src, a_dst, negative_slope, keep, seed):
    ctx.g, ctx.negative_slope, ctx.keep, ctx.seed = g, negative_slope, keep, seed
    return gat_attention_fwd(g.indptr, g.src, v, a_src, a_dst, negative_slope=negative_slope,
                             keep=keep, seed=seed, split=g.split)


class _GATAttention(torch.autograd.Function):
    """The aggregation of given scores (``gat_attention``, the counterpart
    of ``lane_gat_agg``; the package's layers take the attention vectors):
    the forward pass; its backward gat_score_grad and b2, with no torch
    arithmetic on (N, H, D) tensors."""

    @staticmethod
    def forward(ctx, v, a_src, a_dst, g, negative_slope, keep, seed):
        with trace.span("dgl_tpu_torch._GATAttention.forward"):
            out, w1, inv_s, w1s, shift = _attention_fwd(ctx, g, v, a_src, a_dst, negative_slope,
                                                         keep, seed)
            ctx.save_for_backward(v, a_src, a_dst, out, w1, inv_s, w1s, shift)
            return out

    @staticmethod
    def backward(ctx, g_out):
        with trace.span("dgl_tpu_torch._GATAttention.backward"):
            v, a_src, a_dst, *fwd = ctx.saved_tensors
            return (*_attention_bwd(ctx, g_out, v, a_src, a_dst, *fwd),
                    None, None, None, None)


class _GATAttentionVectors(torch.autograd.Function):
    """The aggregation with its scores from the attention vectors: forward
    gat_scores and the forward pass; backward gat_score_grad, b2 and
    gat_vector_grad. ``z_dst`` None: z; ``v`` None: z."""

    @staticmethod
    def forward(ctx, z, z_dst, v, attn_src, attn_dst, g, negative_slope, keep, seed):
        with trace.span("dgl_tpu_torch._GATAttention.forward"):
            a_src, a_dst = gat_scores(z, attn_src, attn_dst, z_dst)
            out, w1, inv_s, w1s, shift = _attention_fwd(
                ctx, g, z if v is None else v, a_src, a_dst, negative_slope, keep, seed)
            ctx.save_for_backward(z, z_dst, v, attn_src, attn_dst, a_src, a_dst, out, w1, inv_s,
                                  w1s, shift)
            return out

    @staticmethod
    def backward(ctx, g_out):
        with trace.span("dgl_tpu_torch._GATAttention.backward"):
            z, z_dst, v, attn_src, attn_dst, a_src, a_dst, *fwd = ctx.saved_tensors
            grad_v, grad_a_src, grad_a_dst = _attention_bwd(
                ctx, g_out, z if v is None else v, a_src, a_dst, *fwd)
            grad_z, grad_z_dst, grad_as, grad_ad = gat_vector_grad(
                z, attn_src, attn_dst, grad_a_src, grad_a_dst,
                grad_v=grad_v if v is None else None, z_dst=z_dst)
            return (grad_z, grad_z_dst, None if v is None else grad_v,
                    grad_as.view(attn_src.shape), grad_ad.view(attn_dst.shape),
                    None, None, None, None)


def _graph_check(name, g, v, n_dst) -> None:
    if g.reverse is None:
        raise ValueError(f"{name} needs the graph's reverse for its backward")
    if v.shape[0] != g.num_src_nodes or n_dst != g.num_dst_nodes:
        raise ValueError(f"{name}: v {tuple(v.shape)} / {n_dst} dst rows do not match the graph "
                         f"({g.num_src_nodes} src, {g.num_dst_nodes} dst nodes)")


def gat_attention(
    g, v: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, *,
    negative_slope: float = 0.2, keep: float = 1.0, seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused attention aggregation over graph ``g`` (with its reverse):
    ``v`` (N_src, H, D) float32 or bfloat16, ``a_src`` (N_src, H), ``a_dst``
    (N_dst, H) float32; ``keep`` < 1 applies the hash dropout with the (1,)
    int32 ``seed``. Returns (N_dst, H, D) float32; a row with no in-edges is
    0. v's gradient comes in v's type."""
    _graph_check("gat_attention", g, v, a_dst.shape[0])
    return _GATAttention.apply(v.contiguous(), a_src.contiguous(), a_dst.contiguous(), g,
                               float(negative_slope), float(keep), seed)


def gat_attention_vectors(
    g, z: torch.Tensor, attn_src: torch.Tensor, attn_dst: torch.Tensor, *,
    z_dst: Optional[torch.Tensor] = None, v: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2, keep: float = 1.0, seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``gat_attention`` with its scores from the attention vectors, as
    GATConv's fused form takes it: ``a_src = Σ_D z·attn_src``, ``a_dst =
    Σ_D z_dst·attn_dst``, computed and differentiated by K3's node passes.
    ``z`` (N_src, H, D) and ``z_dst`` (N_dst, H, D; None or z itself: z)
    float32, the attention vectors (1, H, D) or (H, D) float32; ``v`` the
    rows aggregated (N_src, H', D'), float32 or bfloat16; None or z itself:
    z, whose gradient then takes v's in place. Returns (N_dst, H, D')
    float32."""
    zd = None if z_dst is None or z_dst is z else z_dst.contiguous()
    vv = None if v is None or v is z else v.contiguous()
    _graph_check("gat_attention_vectors", g, z, g.num_src_nodes if zd is None else zd.shape[0])
    return _GATAttentionVectors.apply(z.contiguous(), zd, vv, attn_src.contiguous(),
                                      attn_dst.contiguous(), g, float(negative_slope),
                                      float(keep), seed)
