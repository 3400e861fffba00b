"""Operations and bytes: the yardstick of every share the benchmark reports.

Two parts.

* Kernel bounds, frozen copies of ``chip_smoke.py`` at commit 2745c07
  (``HBM_BYTES_PER_S``, ``FP32_FLOPS``, ``spmm_bound``, ``_bound_ms``,
  ``k3_fwd_bound``, ``k3_bwd_bound``, ``k2_bound``, ``gather_bound``,
  ``sage_k1_launches``): each input read once and each output written once,
  against the published peaks of one H100 SXM. ``gather_bound`` takes the
  count of distinct rows instead of the index tensor, so that it needs no
  card.
* The step's model work (``Work``), counted from the model's math at the
  cell's shapes and not from what the kernels do: every linear's forward
  and backward GEMMs, one add per aggregated edge element and the
  attention's per-edge work; the bytes of each aggregation's CSR, input
  rows and output, each linear's operands and result, and the parameters
  with Adam's state, each once. Where two orders of a layer are valid
  (aggregate the input, or project first and aggregate the projection), the
  smaller count of each kind is taken, so the least time that follows is a
  lower bound of every schedule and no share of it passes 100 %.
  Elementwise work (activations, dropout, the loss, Adam's arithmetic) is
  not counted.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F32 = 4  # bytes of a float32 value or an int32 index


# -- kernel bounds (frozen from chip_smoke.py) -------------------------------

def spmm_bound(n_rows, n_src, nnz, d, indptr_bytes, x_bytes=4):
    """Least time (ms) of one CSR SpMM and what sets it: each input read
    once (x at ``x_bytes`` a value: 2 for bfloat16 rows) and the float32
    output written once, or nnz·d FMAs at the float32 peak."""
    moved = nnz * 4 + (n_rows + 1) * indptr_bytes + n_src * d * x_bytes + n_rows * d * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2 * nnz * d / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _bound_ms(moved_bytes, flops):
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k3_fwd_bound(n_dst, n_src, e, h, d, v_bytes=4):
    """Read indptr, src, v (``v_bytes`` a value: 2 in bfloat16), a_src and
    a_dst once; write out and w1 (N, H, D) and inv_s, w1s, shift (N, H),
    float32. About 4·D + 12 operations per edge and head (two FMAs per
    feature, the logit, exp and scalar sums)."""
    moved = (4 * ((n_dst + 1) + e + n_src * h + n_dst * h + 2 * n_dst * h * d + 3 * n_dst * h)
             + v_bytes * n_src * h * d)
    return _bound_ms(moved, e * h * (4 * d + 12))


def k3_bwd_bound(n_src, n_dst, e, h, d, dropout, v_bytes=4):
    """Read the reverse indptr and dst (and eid with dropout), g (N, H, D),
    the packed node float4s and a_src once; write grad_v (``v_bytes`` a
    value: v's type), w2 (N, H, D) and w3 (N, H)."""
    moved = (4 * ((n_src + 1) + e * (2 if dropout else 1) + n_dst * h * d + 4 * n_dst * h
                  + n_src * h + n_src * h * d + n_src * h)
             + v_bytes * n_src * h * d)
    return _bound_ms(moved, e * h * (4 * d + 14))


def k2_bound(n_rows, e, w, msg_bytes=4):
    """Read msg (``msg_bytes`` a value) and indptr once, write the float32
    out once; one add per element."""
    return _bound_ms(msg_bytes * e * w + 4 * (n_rows + 1 + n_rows * w), e * w)


def gather_bound(e, touched, idx_bytes, row_bytes):
    """Least time (ms) of ``x[idx]`` with ``e`` indices of ``idx_bytes``
    over ``touched`` distinct rows: the rows idx touches read once, idx read
    once and the output written once."""
    return _bound_ms(touched * row_bytes + e * idx_bytes + e * row_bytes, 0)


def sage_k1_launches(in_feats, hidden, classes, layers, hoisted):
    """K1's launches in one training step of GraphSAGE, from the code
    (nn/conv.py:SAGEConv, ops/spmm.py): a layer with out < in projects first
    and aggregates at out, else it aggregates its input at in; each
    aggregation is one forward launch over the dst CSR and, where what it
    aggregates needs a gradient, one backward launch over the reverse CSR.
    Layer 1's input is data, so aggregated first it has no backward; hoisted,
    layer 1 aggregates nothing (x_agg is one launch before training).
    Returns [(layer, "fwd" | "bwd", D), ...]."""
    out = []
    for i in range(layers):
        d_in = in_feats if i == 0 else hidden
        d_out = classes if i == layers - 1 else hidden
        if i == 0 and hoisted:
            continue
        project_first = d_out < d_in
        width = d_out if project_first else d_in
        out.append((i, "fwd", width))
        if project_first or i > 0:
            out.append((i, "bwd", width))
    return out


def gat_k3_launches(in_feats, hidden, classes, heads: Sequence[int], attn_drop: float):
    """K3's launches in one training step of the fused GAT
    (nn/conv.py:GATConv._fused): per layer one forward over the dst CSR and
    one b2 over the reverse CSR, at D = out_feats where in_feats >= D (the
    layer projects first), else at in_feats (it aggregates its input per
    head); attention dropout on every layer but the first. Returns
    [(layer, "fwd" | "b2", H, D, dropout), ...]."""
    out, width = [], in_feats
    for i, h in enumerate(heads):
        d = classes if i == len(heads) - 1 else hidden
        dv = d if width >= d else width
        drop = i > 0 and attn_drop > 0.0
        out += [(i, "fwd", h, dv, drop), (i, "b2", h, dv, drop)]
        width = h * d
    return out


# -- the step's model work ---------------------------------------------------

@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def least_s(self) -> float:
        """The least time of this work on one card: the larger of its
        operations over the float32 peak and its bytes over HBM's."""
        return max(self.flops / FP32_FLOPS, self.bytes / HBM_BYTES_PER_S)


def _least(*options: Work) -> Work:
    """The smallest count of each kind over valid orders of one layer."""
    return Work(min(o.flops for o in options), min(o.bytes for o in options))


def gemm(m, k, n) -> Work:
    """(m, k) @ (k, n): 2mkn operations; operands read and result written once."""
    return Work(2.0 * m * k * n, F32 * (m * k + k * n + m * n))


def linear_fwd_bwd(rows, d_in, d_out, input_grad: bool) -> Work:
    """A bias-free linear's forward, its weight gradient, and its input's
    gradient where the input needs one."""
    w = gemm(rows, d_in, d_out) + gemm(d_in, rows, d_out)
    return w + gemm(rows, d_out, d_in) if input_grad else w


def csr_aggregate(n_dst, n_src, e, width) -> Work:
    """One pass of a sum or mean over a CSR: one add per edge element; the
    CSR, the input rows and the output each moved once."""
    return Work(float(e) * width, F32 * ((n_dst + 1) + e + n_src * width + n_dst * width))


def slot_aggregate(n_dst, fanout, width) -> Work:
    """A positional block's mean: ``fanout`` rows a destination, no CSR."""
    return Work(float(n_dst) * fanout * width, F32 * (n_dst * fanout * width + n_dst * width))


def adam(num_params) -> Work:
    """Adam with its state: gradient, parameter, both moments read, the
    parameter and both moments written."""
    return Work(0.0, 7.0 * F32 * num_params)


def sage_layer_full(n, e, d_in, d_out, input_grad: bool) -> Work:
    """One SAGEConv (``fc_self(x) + fc_neigh(mean(x))``) over a whole graph,
    forward and backward. Its two linears are counted as one GEMM, which is
    the least they move: over ``[x, mean(x)]`` (K = 2·d_in) where the layer
    aggregates its input, over x into both weights (N = 2·d_out) where it
    projects first."""
    agg_in = csr_aggregate(n, n, e, d_in)
    agg_out = csr_aggregate(n, n, e, d_out)
    first = (linear_fwd_bwd(n, 2 * d_in, d_out, input_grad) + agg_in
             + (agg_in if input_grad else Work()))
    project = linear_fwd_bwd(n, d_in, 2 * d_out, input_grad) + agg_out + agg_out
    return _least(first, project)


def sage_layer_block(n_dst, fanout, d_in, d_out, input_grad: bool) -> Work:
    """One SAGEConv over a positional block of ``n_dst`` destinations: the
    self term over the destinations, the neighbour term over their mean (or
    over every slot, projected first)."""
    slots = n_dst * fanout
    first = (linear_fwd_bwd(n_dst, 2 * d_in, d_out, input_grad)
             + slot_aggregate(n_dst, fanout, d_in)
             + (slot_aggregate(n_dst, fanout, d_in) if input_grad else Work()))
    project = (linear_fwd_bwd(n_dst, d_in, d_out, input_grad)
               + linear_fwd_bwd(slots, d_in, d_out, input_grad)
               + slot_aggregate(n_dst, fanout, d_out) + slot_aggregate(n_dst, fanout, d_out))
    return _least(first, project)


def attention_full(n, e, heads, width) -> Work:
    """Softmax attention over a whole graph at ``width`` values a head:
    per (edge, head) the logit, its exp and sum and the weighted row
    forward, the rows' and the scores' gradients backward; the CSR, v, the
    node scores and the output moved once each way."""
    hw = heads * width
    fwd = Work(float(e) * heads * (2 * width + 4),
               F32 * ((n + 1) + e + n * hw + 2 * n * heads + n * hw))
    bwd = Work(float(e) * heads * (4 * width + 4),
               F32 * ((n + 1) + e + 2 * n * hw + 2 * n * heads + n * hw + 2 * n * heads))
    return fwd + bwd


def attention_block(n_dst, fanout, heads, width) -> Work:
    """Softmax attention over a positional block: ``fanout`` slots a
    destination, no CSR."""
    slots = n_dst * fanout
    hw = heads * width
    fwd = Work(float(slots) * heads * (2 * width + 4),
               F32 * (slots * hw + slots * heads + n_dst * heads + n_dst * hw))
    bwd = Work(float(slots) * heads * (4 * width + 4),
               F32 * (2 * slots * hw + n_dst * hw + 2 * slots * heads + 2 * n_dst * heads))
    return fwd + bwd


def gat_layer(n_dst, n_src, d_in, heads, d_out, input_grad: bool, *, e=None,
              fanout=None) -> Work:
    """One GATConv, forward and backward, over a whole graph (``e``) or a
    positional block (``fanout``): the projection, both node scores, the
    attention at the narrower of d_in and d_out a head."""
    hd = heads * d_out
    proj_rows = n_src
    # both node scores (a dot a head each), forward and backward
    scores = Work(8.0 * n_src * hd, 2 * F32 * (n_src * hd + 2 * n_src * heads))

    def att(width):
        if e is not None:
            return attention_full(n_dst, e, heads, width)
        return attention_block(n_dst, fanout, heads, width)

    project = linear_fwd_bwd(proj_rows, d_in, hd, input_grad) + scores + att(d_out)
    if d_in >= d_out:
        return project
    # aggregate the input per head, then apply each head's weights
    first = (linear_fwd_bwd(proj_rows, d_in, hd, input_grad) + scores + att(d_in)
             + linear_fwd_bwd(n_dst * heads, d_in, d_out, True))
    return _least(project, first)


def sampling(b, fanouts: Sequence[int]) -> Tuple[Work, List[int]]:
    """Sampling with replacement, innermost layer first: per destination two
    offsets read, per slot one index read and one id written. Returns the
    work and each layer's destination count, innermost first."""
    w, cur, dsts = Work(), b, []
    for f in reversed(list(fanouts)):
        dsts.append(cur)
        w = w + Work(0.0, F32 * (2 * cur + 2 * cur * f))
        cur = cur * (1 + f)
    return w, dsts


def gather_rows(e, row_bytes) -> Work:
    """``x[idx]`` counted without the rows it reads, which depend on the
    draw: the indices read and the output written once."""
    return Work(0.0, float(e) * (F32 + row_bytes))
