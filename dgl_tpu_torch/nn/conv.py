"""Graph convolution layers over ``dgl_tpu_torch.ops``.

Counterpart of ``dgl_tpu/nn/conv.py``; the port has ``SAGEConv``,
``GATConv``, ``GCNConv``, ``GCNConvEdge`` and ``RelGraphConv``. ``lowering``
(``fused`` or ``scatter``) is handed to every ``gspmm`` a layer calls
(``ops/spmm.py``).

``SAGEConv`` and ``GATConv`` take a sampled block's features as a pair
``(x_src, x_dst)``, the reference's convention (``ns-gat-dgl.py:51-57``);
a tensor ``x`` stands for ``(x, x)``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph
from ..kernels.gat_attention import gat_attention
from ..ops import edge_softmax, gather_dst, gather_src_rows, gspmm
from ..ops.rel import RelEdgeWeights, gspmm_rel
from ..ops.sddmm import gsddmm
from .init import kaiming_uniform_fan_in, relu_gain, xavier_uniform_

__all__ = ["SAGEConv", "GATConv", "GCNConv", "GCNConvEdge", "RelGraphConv", "dropout"]

Features = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def dropout(
    x: torch.Tensor, p: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator`` (on x's device)."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return x * mask / keep


def _drop_pair(x: Features, p: float, training: bool,
               generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_src, x_dst)`` of a tensor or a pair, each side with its own
    dropout mask (one mask where they are the same tensor)."""
    x_src, x_dst = (x[0], x[1]) if isinstance(x, (tuple, list)) else (x, x)
    dropped = dropout(x_src, p, training, generator)
    return dropped, dropped if x_dst is x_src else dropout(x_dst, p, training, generator)


class SAGEConv(nn.Module):
    """GraphSAGE convolution: ``fc_self(x) + fc_neigh(agg(x)) + bias``.

    The reference's hand-built SAGEConv: mean or sum aggregation of source
    features, xavier-uniform (relu gain) weights, bias only on the neighbour
    term, added after aggregation. On a block ``x`` is ``(x_src, x_dst)``:
    ``feat_drop`` acts on both, ``fc_self`` on ``x_dst``.

    When ``out_feats`` is below ``x_src``'s width the neighbour term projects
    first and aggregates after (aggregation commutes with the linear map), so the SpMM
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
        x: Features,
        *,
        x_agg: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if self.feat_drop > 0.0 and x_agg is not None:
            raise ValueError(
                "x_agg (precomputed aggregation) is invalid with feat_drop: "
                "dropout must be applied before aggregation"
            )
        x_src, x_dst = _drop_pair(x, self.feat_drop, self.training, generator)
        if x_agg is not None:
            h_neigh = self.fc_neigh(x_agg)
        elif self.out_feats < x_src.shape[-1]:
            h_neigh = gspmm(g, "copy_u", self.aggr, x=self.fc_neigh(x_src), lowering=self.lowering)
        else:
            h_neigh = self.fc_neigh(gspmm(g, "copy_u", self.aggr, x=x_src, lowering=self.lowering))
        out = self.fc_self(x_dst) + h_neigh + self.fc_neigh_bias
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
      the hash of each (edge, head) pair's key, its seed one int32 drawn
      from ``generator``.
    * edge: gather ``W x`` per edge, ``edge_softmax`` with the bound shift,
      ``gspmm(copy_e, sum)``; its sums are K2 launches. Attention dropout is
      an ordinary mask from ``generator``. Where the (E, H, D) messages
      would pass ``_EDGE_MSG_LIMIT_BYTES``, the JAX layer's switch, it takes
      the memory-safe form (``dgl_tpu/nn/conv.py:185-203``): the logits from
      the node-side dots gathered per edge, (E, H) only, ``edge_softmax``
      with the bound shift, and the weighted sum with the H heads as H
      relations through ``gspmm_rel`` (weighted K1 launches each way; the
      gradient wrt ``alpha`` from per-edge dots, an (E, D) buffer a head);
      no (E, H, D) tensor.

    ``lowering="scatter"`` (the PyG twin) takes the edge form and runs its
    weighted sum as ``gspmm(..., lowering="scatter")``: ``index_add_`` over
    the messages, where the memory-safe form's sum becomes ``gspmm(mul,
    sum)`` over the materialised messages, as the JAX layer's does under
    ``DGL_TPU_LOWERING=scatter``. That variable changes ``gspmm`` alone
    (``dgl_tpu/ops/spmm.py:605``), so the gathers and the edge softmax (its
    K2 sums) stay. It never takes K3; ``fused=True`` with it raises.

    On a positional sampled block (``g.block_fanout``, ``x`` the pair
    ``(x_src, x_dst)``) both forms give way to the block's own: destination
    ``i``'s ``f`` sources are slots ``nd + i·f ...`` of ``W x_src``, so the
    logits, a softmax over ``f``, attention dropout (a mask from
    ``generator``) and the weighted sum are reshapes and an einsum, no
    kernel, as ``dgl_tpu/nn/conv.py:157-172`` computes them; ``fused`` is
    ignored there.

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
        lowering: str = "fused",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if lowering not in ("fused", "scatter"):
            raise ValueError(f"unknown GATConv lowering: {lowering!r}")
        if fused and lowering == "scatter":
            raise ValueError("the scatter lowering takes the edge form: pass fused=False")
        dev = resolve_device(device)
        h, d = num_heads, out_feats
        self.in_feats, self.out_feats, self.num_heads = in_feats, out_feats, num_heads
        self.feat_drop, self.attn_drop, self.negative_slope = feat_drop, attn_drop, negative_slope
        self.activation, self.fused, self.lowering = activation, fused, lowering
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

    def forward(self, g: Graph, x: Features, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_src, x_dst = _drop_pair(x, self.feat_drop, self.training, generator)
        h, d = self.num_heads, self.out_feats
        z = self.fc(x_src).view(-1, h, d)
        z_dst = z if x_dst is x_src else self.fc(x_dst).view(-1, h, d)
        if g.block_fanout is not None:
            out = self._block(g, z, z_dst, generator)
        else:
            a_src = (z * self.attn_r).sum(-1)  # (N_src, H)
            a_dst = (z_dst * self.attn_l).sum(-1)  # (N_dst, H)
            if self.fused:
                out = self._fused(g, x_src, z, a_src, a_dst, generator)
            else:
                out = self._edge(g, z, a_src, a_dst, generator)
        if self.residual:
            res = x_dst if self.res_fc is None else self.res_fc(x_dst)
            out = out + res.view(-1, h, d)
        if self.activation is not None:
            out = self.activation(out)
        return out

    def _block(self, g, z, z_dst, generator):
        nd, f = g.num_dst_nodes, g.block_fanout
        z_n = z[nd: nd + nd * f].view(nd, f, self.num_heads, self.out_feats)
        logits = F.leaky_relu((z_n * self.attn_r).sum(-1)  # (nd, f, H)
                              + (z_dst[:nd] * self.attn_l).sum(-1).unsqueeze(1),
                              self.negative_slope)
        alpha = dropout(torch.softmax(logits, 1), self.attn_drop, self.training, generator)
        return torch.einsum("nfh,nfhd->nhd", alpha, z_n)

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
        bound = F.leaky_relu(a_src.detach().amax(0, keepdim=True) + a_dst, self.negative_slope)
        if g.num_edges * h * d * z.element_size() > _EDGE_MSG_LIMIT_BYTES:
            return self._memory_safe(g, z, a_src, a_dst, bound, generator)
        z_e = gather_src_rows(g, z.reshape(-1, h * d)).view(-1, h, d)
        logits = F.leaky_relu((z_e * self.attn_r).sum(-1) + gather_dst(g, a_dst), self.negative_slope)
        alpha = edge_softmax(g, logits, dst_bound=bound)
        alpha = dropout(alpha, self.attn_drop, self.training, generator)
        return gspmm(g, "copy_e", "sum", e=z_e * alpha.unsqueeze(-1), lowering=self.lowering)

    def _memory_safe(self, g, z, a_src, a_dst, bound, generator):
        """(E, H) logits, softmax and dropout; the heads' weighted sums as
        the relations of ``gspmm_rel``, on ``z`` laid out head-major."""
        logits = F.leaky_relu(gather_src_rows(g, a_src) + gather_dst(g, a_dst),
                              self.negative_slope)
        alpha = dropout(edge_softmax(g, logits, dst_bound=bound), self.attn_drop, self.training,
                        generator)
        if self.lowering == "scatter":
            return gspmm(g, "mul", "sum", x=z, e=alpha.unsqueeze(-1), lowering="scatter")
        out = gspmm_rel("sum", g, z.permute(1, 0, 2), alpha, per_relation=True)
        return out.permute(1, 0, 2)


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


class RelGraphConv(nn.Module):
    """Relational GCN layer of ogbn-proteins (the reference's
    ``main_dgl_proteins_rgcn_for.py:14-60``): for each relation r,
    ``mean_by_dst(x_src · w_r) @ W_r``, summed over relations, plus a dense
    ``skip`` Linear; then the activation and dropout.

    Two forms of the same function (per-edge scalar weights commute with
    ``W_r``), each R weighted K1 launches each way through ``gspmm_rel``
    (``ops/rel.py``), no per-edge tensor:

    * project first, ``y = x @ W`` (R, N, out) on cuBLAS, then aggregate
      ``y``: the K1 passes move ``out``-wide rows;
    * aggregate first, as the JAX layer's ``fuse_relations`` does
      (``gspmm(g, "mul", "mean", x[:, None], e=w[..., None])``, then
      einsum): ``gspmm_rel(..., per_relation=True)`` on ``x`` expanded
      along R with the graph's weights as laid out once, then the einsum;
      the K1 passes move ``in``-wide rows, and none runs backward where
      ``x`` needs no gradient (layer 1's data).

    A layer aggregates first where ``in_feats < out_feats`` (SAGEConv's
    rule the other way round: aggregate the narrower side), so proteins'
    first layer (1 → 32) and last (32 → 112 tasks) pass 1- and 32-wide rows;
    ``fuse_relations`` makes every layer aggregate first, as the JAX
    driver's ``--fuse-relations`` does.

    ``rel_weights`` (R, in, out) and ``skip``'s weight are drawn with
    torch's ``kaiming_uniform_(a=sqrt(5))`` (torch's fan-in of a (R, in,
    out) tensor is in · out; the JAX package's flax init takes in · R),
    ``skip``'s bias is 0, from the CPU ``generator``.
    """

    def __init__(
        self,
        in_feats: int,
        out_feats: int,
        num_relations: int,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        dropout: float = 0.0,
        *,
        fuse_relations: bool = False,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.activation, self.dropout = activation, dropout
        self.in_feats, self.out_feats = in_feats, out_feats
        self.aggregate_first = fuse_relations or in_feats < out_feats
        self.rel_weights = nn.Parameter(torch.empty(num_relations, in_feats, out_feats))
        kaiming_uniform_fan_in(self.rel_weights, generator=generator)
        self.skip = nn.utils.skip_init(nn.Linear, in_feats, out_feats)
        kaiming_uniform_fan_in(self.skip.weight, generator=generator)
        nn.init.zeros_(self.skip.bias)
        self.to(resolve_device(device))

    def forward(self, g: Graph, x: torch.Tensor, weights: RelEdgeWeights, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``weights``: the graph's ``RelEdgeWeights`` (built once from the
        (E, R) canonical edge weights)."""
        if self.aggregate_first:
            agg = gspmm_rel("mean", g, x.unsqueeze(0).expand(weights.num_relations, -1, -1),
                            weights, per_relation=True)
            out = torch.einsum("rnd,rdo->no", agg, self.rel_weights)
        else:
            y = torch.matmul(x, self.rel_weights)  # (R, N, out), each y[r] contiguous
            out = gspmm_rel("mean", g, y, weights)
        out = out + self.skip(x)
        if self.activation is not None:
            out = self.activation(out)
        return dropout(out, self.dropout, self.training, generator)
