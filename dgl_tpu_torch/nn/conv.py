"""Graph convolution layers over ``dgl_tpu_torch.ops``.

Counterpart of ``dgl_tpu/nn/conv.py``; the port has ``SAGEConv``,
``GATConv``, ``GCNConv`` and ``GCNConvEdge``. ``lowering`` (``fused`` or
``scatter``) is handed to every ``gspmm`` a layer calls (``ops/spmm.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph
from ..kernels.gat_attention import gat_attention
from ..ops import edge_softmax, gather_dst, gather_src_rows, gspmm
from ..ops.sddmm import gsddmm
from .init import relu_gain, xavier_uniform_

__all__ = ["SAGEConv", "GATConv", "GCNConv", "GCNConvEdge", "dropout"]


def dropout(
    x: torch.Tensor, p: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator`` (on x's device)."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return x * mask / keep


class SAGEConv(nn.Module):
    """GraphSAGE convolution: ``fc_self(x) + fc_neigh(agg(x)) + bias``.

    The reference's hand-built SAGEConv: mean or sum aggregation of source
    features, xavier-uniform (relu gain) weights, bias only on the neighbour
    term, added after aggregation.

    When ``out_feats < in_feats`` the neighbour term projects first and
    aggregates after (aggregation commutes with the linear map), so the SpMM
    moves ``out_feats``-wide rows. ``x_agg``, a precomputed
    ``gspmm(g, copy_u, aggr, x)``, replaces the aggregation entirely; it is
    invalid with ``feat_drop``, which must act before aggregation.

    ``generator`` (a CPU generator) draws the initial weights.
    """

    def __init__(
        self,
        in_feats: int,
        out_feats: int,
        aggr: str = "mean",
        feat_drop: float = 0.0,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        *,
        lowering: str = "fused",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if aggr not in ("mean", "sum"):
            raise ValueError(f"SAGEConv aggr must be mean|sum, got {aggr!r}")
        dev = resolve_device(device)
        self.in_feats, self.out_feats = in_feats, out_feats
        self.aggr, self.feat_drop, self.activation = aggr, feat_drop, activation
        self.lowering = lowering
        self.fc_self = nn.utils.skip_init(nn.Linear, in_feats, out_feats, bias=False)
        self.fc_neigh = nn.utils.skip_init(nn.Linear, in_feats, out_feats, bias=False)
        self.fc_neigh_bias = nn.Parameter(torch.zeros(out_feats))
        xavier_uniform_(self.fc_self.weight, relu_gain(), generator)
        xavier_uniform_(self.fc_neigh.weight, relu_gain(), generator)
        self.to(dev)

    def forward(
        self,
        g: Graph,
        x: torch.Tensor,
        *,
        x_agg: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if self.feat_drop > 0.0:
            if x_agg is not None:
                raise ValueError(
                    "x_agg (precomputed aggregation) is invalid with feat_drop: "
                    "dropout must be applied before aggregation"
                )
            x = dropout(x, self.feat_drop, self.training, generator)
        if x_agg is not None:
            h_neigh = self.fc_neigh(x_agg)
        elif self.out_feats < self.in_feats:
            h_neigh = gspmm(g, "copy_u", self.aggr, x=self.fc_neigh(x), lowering=self.lowering)
        else:
            h_neigh = self.fc_neigh(gspmm(g, "copy_u", self.aggr, x=x, lowering=self.lowering))
        out = self.fc_self(x) + h_neigh + self.fc_neigh_bias
        if self.activation is not None:
            out = self.activation(out)
        return out


# the edge form's (E, H, D) message buffer above which the JAX package
# switches to its memory-safe form (DGL_TPU_MSG_BUDGET_GB = 4, a quarter of it)
_EDGE_MSG_LIMIT_BYTES = 1 << 30


class GATConv(nn.Module):
    """Multi-head graph attention; returns (N_dst, H, D).

    DGL's GATConv math: logits ``leaky_relu(a_src[s] + a_dst[d])`` with
    ``a_src = Σ_D (W x)[s] · attn_r`` and ``a_dst = Σ_D (W x)[d] · attn_l``
    (the JAX package's pairing: ``attn_r`` scores the source side), softmax
    over each node's in-edges, attention dropout, weighted sum of ``W x``.

    Two forms of the same function, picked by ``fused``:

    * fused (K3, ``kernels/gat_attention.py``): logits, softmax, dropout and
      aggregation in one kernel launch each way, no per-edge tensor. When
      ``in_feats < out_feats`` it aggregates the narrow inputs and applies
      ``W`` per head after (``Σ α·(W x) = W·(Σ α x)``). Attention dropout is
      the hash of the edge id, its seed one int32 drawn from ``generator``.
    * edge: gather ``W x`` per edge, ``edge_softmax`` with the bound shift,
      ``gspmm(copy_e, sum)``; its sums are K2 launches. Attention dropout is
      an ordinary mask from ``generator``.

    Left out: the JAX layer's positional sampled-block path (slice E) and
    its memory-safe form for graphs whose (E, H, D) messages pass the budget
    (slice D's binary ``gspmm``); both raise ``NotImplementedError``.

    ``generator`` (a CPU generator) draws the initial weights: ``fc``
    xavier-uniform (gain 1), ``attn_l``/``attn_r`` uniform in
    ``±sqrt(6 / (H + D))``, flax's xavier-uniform on a (1, H, D) shape.
    """

    def __init__(
        self,
        in_feats: int,
        out_feats: int,
        num_heads: int = 1,
        feat_drop: float = 0.0,
        attn_drop: float = 0.0,
        negative_slope: float = 0.2,
        residual: bool = False,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        *,
        fused: bool = False,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        h, d = num_heads, out_feats
        self.in_feats, self.out_feats, self.num_heads = in_feats, out_feats, num_heads
        self.feat_drop, self.attn_drop, self.negative_slope = feat_drop, attn_drop, negative_slope
        self.activation, self.fused = activation, fused
        self.fc = nn.utils.skip_init(nn.Linear, in_feats, h * d, bias=False)
        xavier_uniform_(self.fc.weight, 1.0, generator)
        bound = math.sqrt(6.0 / (h + d))
        self.attn_l = nn.Parameter(torch.empty(1, h, d).uniform_(-bound, bound, generator=generator))
        self.attn_r = nn.Parameter(torch.empty(1, h, d).uniform_(-bound, bound, generator=generator))
        self.res_fc = None
        if residual and in_feats != h * d:
            self.res_fc = nn.utils.skip_init(nn.Linear, in_feats, h * d, bias=False)
            xavier_uniform_(self.res_fc.weight, 1.0, generator)
        self.residual = residual
        self.to(dev)

    def forward(self, g: Graph, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            raise NotImplementedError("GATConv over sampled blocks (x_src, x_dst) is ported in slice E")
        if self.feat_drop > 0.0:
            x = dropout(x, self.feat_drop, self.training, generator)
        h, d = self.num_heads, self.out_feats
        z = self.fc(x).view(-1, h, d)
        a_src = (z * self.attn_r).sum(-1)  # (N, H)
        a_dst = (z * self.attn_l).sum(-1)
        if self.fused:
            out = self._fused(g, x, z, a_src, a_dst, generator)
        else:
            out = self._edge(g, z, a_src, a_dst, generator)
        if self.residual:
            res = x if self.res_fc is None else self.res_fc(x)
            out = out + res.view(-1, h, d)
        if self.activation is not None:
            out = self.activation(out)
        return out

    def _fused(self, g, x, z, a_src, a_dst, generator):
        h, d, in_d = self.num_heads, self.out_feats, x.shape[-1]
        keep, seed = 1.0, None
        if self.attn_drop > 0.0 and self.training:
            keep = 1.0 - self.attn_drop
            seed = torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32,
                                 device=x.device, generator=generator)
        if in_d >= d:
            return gat_attention(g, z, a_src, a_dst, negative_slope=self.negative_slope,
                                 keep=keep, seed=seed)
        agg = gat_attention(g, x.unsqueeze(1).expand(-1, h, in_d), a_src, a_dst,
                            negative_slope=self.negative_slope, keep=keep, seed=seed)
        return torch.einsum("nhi,hdi->nhd", agg, self.fc.weight.view(h, d, in_d))

    def _edge(self, g, z, a_src, a_dst, generator):
        h, d = self.num_heads, self.out_feats
        if g.num_edges * h * d * z.element_size() > _EDGE_MSG_LIMIT_BYTES:
            raise NotImplementedError(
                "GATConv's memory-safe edge form (per-edge messages over "
                f"{_EDGE_MSG_LIMIT_BYTES >> 30} GiB) is ported in slice D; use fused=True"
            )
        z_e = gather_src_rows(g, z.reshape(-1, h * d)).view(-1, h, d)
        logits = F.leaky_relu((z_e * self.attn_r).sum(-1) + gather_dst(g, a_dst), self.negative_slope)
        bound = F.leaky_relu(a_src.detach().amax(0, keepdim=True) + a_dst, self.negative_slope)
        alpha = edge_softmax(g, logits, dst_bound=bound)
        alpha = dropout(alpha, self.attn_drop, self.training, generator)
        return gspmm(g, "copy_e", "sum", e=z_e * alpha.unsqueeze(-1))


class GCNConv(nn.Module):
    """Symmetric-degree-normalised GCN (the reference's ENZYMES layer,
    ``main_dgl_enzymes_gcn.py:16-39``): ``deg = in_deg + 1``, then
    ``deg^{-1/2} · Σ_{u→v} deg_u^{-1/2} (W x)_u``, a K1 ``copy_u`` sum between
    the two scalings; no self-loop term, no bias. ``fc`` is xavier-uniform
    with the relu gain.
    """

    def __init__(self, in_feats: int, out_feats: int, *, lowering: str = "fused",
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lowering = lowering
        self.fc = nn.utils.skip_init(nn.Linear, in_feats, out_feats, bias=False)
        xavier_uniform_(self.fc.weight, relu_gain(), generator)
        self.to(resolve_device(device))

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        h = self.fc(x)
        dis = (g.in_degrees().to(h.dtype) + 1.0).rsqrt().unsqueeze(1)
        return gspmm(g, "copy_u", "sum", x=h * dis, lowering=self.lowering) * dis


class GCNConvEdge(nn.Module):
    """GCN with edge features and a root embedding (the reference's
    ogbg-molhiv / ogbg-ppa layer, ``main_dgl_molhiv_gcn.py:20-52``): message
    ``norm · relu(h_src + w_edge)`` with ``norm = c_src · c_dst``,
    ``c = (deg + 1)^{-1/2}``, summed by ``gspmm(copy_e, sum)`` (K2), plus the
    self term ``relu(h + root_emb) / (deg + 1)``; ``h = W x``. ``w_edge``
    (E, out) is the encoded edge features in canonical order. ``h_src`` is
    ``gsddmm(copy_u)``, whose adjoint is one K1 launch. ``fc`` is
    xavier-uniform with the relu gain, ``root_emb`` standard normal.
    """

    def __init__(self, in_feats: int, out_feats: int, *, lowering: str = "fused",
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lowering = lowering
        self.fc = nn.utils.skip_init(nn.Linear, in_feats, out_feats, bias=False)
        xavier_uniform_(self.fc.weight, relu_gain(), generator)
        self.root_emb = nn.Parameter(torch.empty(1, out_feats).normal_(generator=generator))
        self.to(resolve_device(device))

    def forward(self, g: Graph, x: torch.Tensor, w_edge: torch.Tensor) -> torch.Tensor:
        h = self.fc(x)
        deg = (g.in_degrees().to(h.dtype) + 1.0).unsqueeze(1)
        c = deg.rsqrt()
        norm = gsddmm(g, "mul", c, c)  # (E, 1)
        msg = norm * F.relu(gsddmm(g, "copy_u", h) + w_edge)
        agg = gspmm(g, "copy_e", "sum", e=msg, lowering=self.lowering)
        return agg + F.relu(h + self.root_emb) / deg
