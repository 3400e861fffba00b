"""K3: fused GAT attention, forward and backward, with no per-edge tensor.

``gat_attention(g, v, a_src, a_dst)`` computes, for every head,
``out[d] = Σ_{s→d} drop(softmax_d(leaky_relu(a_src[s] + a_dst[d]))) · v[s]``
as a ``torch.autograd.Function``: its forward is one call of
``gat_attention_fwd`` over the dst CSR with the graph's row split
(``g.split``), its backward one call of ``gat_attention_bwd`` (the "b2"
pass) over the reverse CSR with its split (``g.reverse.split``) plus the
N-wide closed forms of ``_lane_gat_bwd``::

    C          = Σ_D g · out
    grad_a_dst = Σ_D g · w1 − C · w1s
    grad_a_src = Σ_D v · w2 − w3

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
``grad_v`` in float32 and rounds it once to v's type (``:477``), which
``gat_attention_bwd`` takes as ``v_dtype``; ``grad_a_src = Σ_D v·w2 − w3``
reads v converted to float32. ``.launches_bf16`` counts each pass's
bfloat16 launches among ``.launches``. The kernels take at most
``MAX_HEADS`` heads.

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

from .. import trace
from ..graph.split import RowSplit, row_split
from ..ops.segment import segment_max
from .build import entry, launch
from .seg_sum import ROW_DTYPES, csr_rows, sum_dtype

__all__ = [
    "gat_attention",
    "gat_attention_plain",
    "gat_attention_fwd",
    "gat_attention_fwd_plain",
    "gat_attention_bwd",
    "gat_attention_bwd_plain",
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
    indptr, dst, eid, g, node, a_src, *, negative_slope: float, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None, v_dtype: Optional[torch.dtype] = None,
):
    """The b2 pass in plain PyTorch over the reverse CSR (``dst`` holds the
    original dst of each slot, ``eid`` its forward-canonical id, ``node``
    (N_dst, H, 4) the packed a_dst, shift, inv_s, C); returns
    (grad_v, w2, w3), ``grad_v`` summed in g's type and rounded once to
    ``v_dtype`` where given."""
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
    return grad_v if v_dtype is None else grad_v.to(v_dtype), w2, w3


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
    indptr, dst, eid, g, node, a_src, *, negative_slope: float, keep: float = 1.0,
    seed: Optional[torch.Tensor] = None, split: Optional[RowSplit] = None,
    v_dtype: torch.dtype = torch.float32,
):
    """The b2 pass over the reverse CSR (``indptr`` (N_src+1,), ``dst`` and
    ``eid`` (E,) int32: each slot's original dst and forward-canonical id),
    with ``g`` (N_dst, H, D) the output cotangent, ``node`` (N_dst, H, 4)
    the packed a_dst, shift, inv_s and C, and ``a_src`` (N_src, H), all
    float32. Returns ``grad_v`` (N_src, H, D) in ``v_dtype`` (v's type,
    float32 or bfloat16: summed in float32, rounded once), ``w2`` (N_src,
    H, D) and ``w3`` (N_src, H) float32.

    ``split``: the reverse CSR's row split (``g.reverse.split``), as for
    ``gat_attention_fwd``; the forward over the same CSR shares its
    counters."""
    with trace.span("dgl_tpu_torch.K3.b2"):
        _check("gat_attention_bwd", indptr, [dst, eid], [g, node, a_src], seed, keep)
        if v_dtype not in ROW_DTYPES:
            raise TypeError(f"gat_attention_bwd: v_dtype must be float32 or bfloat16, "
                            f"got {v_dtype}")
        n, (n_dst, heads, d) = indptr.numel() - 1, g.shape
        if node.shape != (n_dst, heads, 4) or a_src.shape != (n, heads):
            raise ValueError(f"gat_attention_bwd: node {tuple(node.shape)} / a_src "
                             f"{tuple(a_src.shape)} do not match g {tuple(g.shape)} and {n} rows")
        if eid.shape != dst.shape:
            raise ValueError("gat_attention_bwd: dst and eid differ in length")
        if split is not None:
            split.check(indptr, dst.numel(), "gat_attention_bwd")
        if g.device.type == "cpu":
            return gat_attention_bwd_plain(indptr, dst, eid, g, node, a_src,
                                           negative_slope=negative_slope, keep=keep, seed=seed,
                                           v_dtype=v_dtype)
        if node.data_ptr() % 16:
            raise ValueError("gat_attention_bwd: node must be 16-byte aligned (one float4 per row)")
        grad_v = torch.empty((n, heads, d), dtype=v_dtype, device=g.device)
        w2 = torch.empty((n, heads, d), dtype=torch.float32, device=g.device)
        w3 = torch.empty((n, heads), dtype=torch.float32, device=g.device)
        if n == 0 or d == 0 or heads == 0:
            return grad_v, w2, w3
        _check_heads("gat_attention_bwd", heads)
        if split is None:
            split = row_split(indptr)
        c = split.num_chunks
        pgv, pw2, pw3 = _partials(c, g.device, (c, heads, d), (c, heads, d), (c, heads))
        seed_ptr, thresh, scale = _drop_args(keep, seed)
        launch(_entry("gat_b2", v_dtype, _B2_ARGTYPES), g.device,
               indptr.data_ptr(), int(indptr.dtype == torch.int64), dst.data_ptr(), eid.data_ptr(),
               g.data_ptr(), n_dst, node.data_ptr(), a_src.data_ptr(), grad_v.data_ptr(),
               w2.data_ptr(), w3.data_ptr(), n, heads, d, negative_slope, seed_ptr, thresh, scale,
               *split.kernel_args(pgv, counters=True)[1:], _ptr(pw2), _ptr(pw3), dst.numel())
        gat_attention_bwd.launches += 1
        gat_attention_bwd.launches_bf16 += int(v_dtype == torch.bfloat16)
        trace.launch("K3", "b2", indptr, dst, g, value_dtype=v_dtype, dropout=keep < 1.0)
        return grad_v, w2, w3


gat_attention_bwd.launches = 0
gat_attention_bwd.launches_bf16 = 0
gat_attention_bwd.combines = 0


class _GATAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, a_src, a_dst, g, negative_slope, keep, seed):
        with trace.span("dgl_tpu_torch._GATAttention.forward"):
            out, w1, inv_s, w1s, shift = gat_attention_fwd(
                g.indptr, g.src, v, a_src, a_dst, negative_slope=negative_slope, keep=keep,
                seed=seed, split=g.split,
            )
            ctx.save_for_backward(v, a_src, a_dst, out, w1, inv_s, w1s, shift)
            ctx.g, ctx.negative_slope, ctx.keep, ctx.seed = g, negative_slope, keep, seed
            return out

    @staticmethod
    def backward(ctx, g_out):
        with trace.span("dgl_tpu_torch._GATAttention.backward"):
            v, a_src, a_dst, out, w1, inv_s, w1s, shift = ctx.saved_tensors
            g_out = g_out.contiguous()
            c = (g_out * out).sum(-1)
            grad_a_dst = (g_out * w1).sum(-1) - c * w1s
            node = torch.stack([a_dst, shift, inv_s, c], dim=-1)
            rev = ctx.g.reverse
            grad_v, w2, w3 = gat_attention_bwd(
                rev.indptr, rev.src, rev.eid, g_out, node, a_src,
                negative_slope=ctx.negative_slope, keep=ctx.keep, seed=ctx.seed, split=rev.split,
                v_dtype=v.dtype,
            )
            grad_a_src = (v * w2).sum(-1) - w3
            return grad_v, grad_a_src, grad_a_dst, None, None, None, None


def gat_attention(
    g, v: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, *,
    negative_slope: float = 0.2, keep: float = 1.0, seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused attention aggregation over graph ``g`` (with its reverse):
    ``v`` (N_src, H, D) float32 or bfloat16, ``a_src`` (N_src, H), ``a_dst``
    (N_dst, H) float32; ``keep`` < 1 applies the hash dropout with the (1,)
    int32 ``seed``. Returns (N_dst, H, D) float32; a row with no in-edges is
    0. v's gradient comes in v's type."""
    if g.reverse is None:
        raise ValueError("gat_attention needs the graph's reverse for its backward")
    if v.shape[0] != g.num_src_nodes or a_dst.shape[0] != g.num_dst_nodes:
        raise ValueError(f"gat_attention: v {tuple(v.shape)} / a_dst {tuple(a_dst.shape)} do not "
                         f"match the graph ({g.num_src_nodes} src, {g.num_dst_nodes} dst nodes)")
    return _GATAttention.apply(v.contiguous(), a_src.contiguous(), a_dst.contiguous(), g,
                               float(negative_slope), float(keep), seed)
