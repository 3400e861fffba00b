"""Full-graph SAGE, GAT and RGCN over the boundary-halo exchange.

Counterpart of ``dgl_tpu/parallel/halo_train.py``. Each model is an
``nn.Module`` whose forward takes a ``HaloShard`` and this rank's rows; its
parameters carry the JAX pytree's names and layouts (``layers.<i>.w_self``
is ``params[i]["w_self"]``, a dense ``(in, out)`` matrix), so
``convert.halo_*_state_dict_from_jax`` copies them across unchanged.
``HaloSAGE`` is ``halo_sage_init`` and ``halo_sage_apply``, and so on. The
initial weights come from a CPU ``torch.Generator`` (xavier-uniform for
SAGE and GAT, kaiming-uniform for RGCN, biases 0); the ranks start equal
when they use the same seed, or after ``spmd.replicated``.

The train steps (``make_halo_*_train_step``) minimise the **global** masked
mean over the ranks' rows: each rank's loss is ``Σ(loss·m) / Σ_all(m)``,
the count added over the ranks, the gradients added over the ranks
(``comm.all_sum``: in rank order, the same bits on every rank), then one
optimiser step, so the parameters stay equal across ranks bit for bit.
SAGE and GAT take ``torch.optim.Adam(weight_decay=wd)`` (coupled L2, the
JAX ``adam_l2``), RGCN plain Adam, as the JAX drivers do. A step returns
the global loss.

SAGE's dropout acts on every layer's input, as JAX's does, with masks from
the rank's own generator; the JAX masks cannot be matched bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..nn.conv import dropout as feature_dropout
from ..ops.rel import RelEdgeWeights
from .comm import all_sum, all_sum_grads_
from .halo import (BoundarySharded, HaloShard, halo_gat_boundary, halo_rgcn_boundary,
                   halo_spmm_boundary)

__all__ = ["HaloSAGE", "HaloGAT", "HaloRGCN", "global_masked_backward", "make_halo_train_step",
           "make_halo_gat_train_step", "make_halo_rgcn_train_step", "exchange_stats"]


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter((torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound)


def _zeros(n: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n))


class HaloSAGE(nn.Module):
    """``fc_self(h) + fc_neigh(mean_agg(h)) + bias`` a layer, ReLU between
    layers (``main_dgl_citation_sage.py:44-86``)."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int, num_layers: int = 2, *,
                 aggr: str = "mean", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        self.aggr, self.dropout = aggr, dropout
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
        self.layers = nn.ModuleList()
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            s = math.sqrt(6.0 / (fan_in + fan_out))
            self.layers.append(nn.ParameterDict({
                "w_self": _uniform((fan_in, fan_out), s, generator),
                "w_neigh": _uniform((fan_in, fan_out), s, generator),
                "bias": _zeros(fan_out),
            }))
        self.to(resolve_device(device))

    def forward(self, shard: HaloShard, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x`` (nps, D) this rank's rows; returns its (nps, C) logits.
        Dropout on every layer's input in training mode."""
        h = x
        for i, layer in enumerate(self.layers):
            h = feature_dropout(h, self.dropout, self.training, generator)
            agg = halo_spmm_boundary(shard, h, self.aggr)
            h = h @ layer["w_self"] + agg @ layer["w_neigh"] + layer["bias"]
            if i < len(self.layers) - 1:
                h = F.relu(h)
        return h


class HaloGAT(nn.Module):
    """Multi-head GAT (``nn.conv.GATConv``'s fused fc and per-head
    attention vectors, no bias): heads concatenated and ELU on hidden
    layers, averaged on the last."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 heads: Sequence[int] = (4, 4, 4), *, negative_slope: float = 0.2,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        self.heads, self.negative_slope = tuple(heads), negative_slope
        dims_in = [in_feats] + [hidden_feats * h for h in heads[:-1]]
        dims_out = [hidden_feats] * (len(heads) - 1) + [out_feats]
        self.layers = nn.ModuleList()
        for h, fan_in, d in zip(heads, dims_in, dims_out):
            s, sa = math.sqrt(6.0 / (fan_in + h * d)), math.sqrt(6.0 / (d + 1))
            self.layers.append(nn.ParameterDict({
                "w": _uniform((fan_in, h * d), s, generator),
                "attn_l": _uniform((1, h, d), sa, generator),
                "attn_r": _uniform((1, h, d), sa, generator),
            }))
        self.to(resolve_device(device))

    def forward(self, shard: HaloShard, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, (layer, nh) in enumerate(zip(self.layers, self.heads)):
            z = (h @ layer["w"]).reshape(h.shape[0], nh, -1)
            agg = halo_gat_boundary(shard, z, layer["attn_r"], layer["attn_l"],
                                    self.negative_slope)
            h = F.elu(agg.reshape(agg.shape[0], -1)) if i < len(self.layers) - 1 else agg.mean(1)
        return h


class HaloRGCN(nn.Module):
    """RGCN (``nn.conv.RelGraphConv``, ``main_dgl_proteins_rgcn_for.py:46-60``):
    per layer the per-relation projections, one exchange and the
    relation-weighted mean, plus the dense skip term; ReLU between layers."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int, num_relations: int,
                 num_layers: int = 3, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        self.num_relations = num_relations
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [out_feats]
        self.layers = nn.ModuleList()
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            s = math.sqrt(6.0 / fan_in)  # kaiming_uniform(a=sqrt(5)) scale
            self.layers.append(nn.ParameterDict({
                "w_rel": _uniform((num_relations, fan_in, fan_out), s, generator),
                "w_skip": _uniform((fan_in, fan_out), s, generator),
                "bias": _zeros(fan_out),
            }))
        self.to(resolve_device(device))

    def forward(self, shard: HaloShard, x: torch.Tensor, weights: RelEdgeWeights) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            r, _, d = layer["w_rel"].shape
            y = torch.einsum("nd,rdo->nro", h, layer["w_rel"]).reshape(h.shape[0], r * d)
            agg = halo_rgcn_boundary(shard, y, weights, self.num_relations, "mean")
            h = agg + h @ layer["w_skip"] + layer["bias"]
            if i < len(self.layers) - 1:
                h = F.relu(h)
        return h


def global_masked_backward(model: nn.Module, group, per_row: Callable[[], torch.Tensor],
                           mask: torch.Tensor) -> torch.Tensor:
    """The gradients of ``Σ_all(loss·m) / Σ_all(m)``, summed over the
    ranks, into ``model``'s ``.grad`` (which must hold none); returns
    the global loss."""
    model.train()
    m = mask.to(torch.float32)
    count = all_sum(m.sum(), group).clamp(min=1.0)
    loss = (per_row() * m).sum() / count
    loss.backward()
    all_sum_grads_(model.parameters(), group)
    return all_sum(loss.detach(), group)


def _global_masked_step(model: nn.Module, opt: torch.optim.Optimizer, group,
                        per_row: Callable[[], torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """One optimiser step on ``Σ_all(loss·m) / Σ_all(m)``; returns it."""
    opt.zero_grad(set_to_none=True)
    loss = global_masked_backward(model, group, per_row, mask)
    opt.step()
    return loss


def make_halo_train_step(model: HaloSAGE, opt: torch.optim.Optimizer):
    """``step(shard, x, y, mask, generator=None) -> global loss``: masked
    cross-entropy over the ranks' rows (dropout masks from ``generator``)."""

    def step(shard: HaloShard, x, y, mask, generator: Optional[torch.Generator] = None):
        return _global_masked_step(
            model, opt, shard.group,
            lambda: F.cross_entropy(model(shard, x, generator=generator), y, reduction="none"),
            mask)

    return step


def make_halo_gat_train_step(model: HaloGAT, opt: torch.optim.Optimizer):
    """``step(shard, x, y, mask) -> global loss`` (masked cross-entropy)."""

    def step(shard: HaloShard, x, y, mask):
        return _global_masked_step(
            model, opt, shard.group,
            lambda: F.cross_entropy(model(shard, x), y, reduction="none"), mask)

    return step


def make_halo_rgcn_train_step(model: HaloRGCN, opt: torch.optim.Optimizer):
    """``step(shard, x, weights, y, mask) -> global loss``: multilabel
    BCE-with-logits, the mean over tasks, over the masked rows
    (``main_dgl_proteins_rgcn_for.py:101``)."""

    def step(shard: HaloShard, x, weights: RelEdgeWeights, y, mask):
        return _global_masked_step(
            model, opt, shard.group,
            lambda: F.binary_cross_entropy_with_logits(model(shard, x, weights), y,
                                                       reduction="none").mean(-1),
            mask)

    return step


def exchange_stats(bs: BoundarySharded, d: int, itemsize: int = 4) -> dict:
    """Per-layer communication accounting: the boundary all_to_all's bytes
    against what the all-gather halo would move (a copy of the JAX function)."""
    k = bs.num_shards
    boundary = k * bs.rows_per_pair * d * itemsize  # per device per layer
    allgather = (k - 1) * bs.nodes_per_shard * d * itemsize
    return {
        "num_shards": k,
        "rows_per_pair": bs.rows_per_pair,
        "boundary_bytes_per_device": boundary,
        "allgather_bytes_per_device": allgather,
        "volume_ratio": boundary / max(allgather, 1),
    }
