"""GCN graph classifiers (ENZYMES and the OGB molecule datasets).

Counterpart of ``dgl_tpu/models/gcn_graph.py``:
* ``GCNGraphClassifier`` (``main_dgl_enzymes_gcn.py:41-89``): GCNConv
  layers with BN, relu and dropout between them, a mean readout, two linear
  layers and a log-softmax;
* ``GCNMolClassifier`` (``main_dgl_molhiv_gcn.py:54-89``,
  ``main_dgl_ppa_gcn.py``): an atom encoder or one shared node embedding,
  per-layer edge encoders (BondEncoder or a Linear) into GCNConvEdge, BN,
  relu and dropout between layers, a mean readout and a linear head.

A batch holds no padding, so the JAX models' node mask is all ones here and
BN runs over every node. Dropout masks come from the ``generator`` passed to
``forward``; the initial weights from the CPU ``generator`` passed to the
constructor. ``lowering`` goes to every layer's ``gspmm``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.batch import GraphBatch, readout
from ..nn import AtomEncoder, BondEncoder, GCNConv, GCNConvEdge, MaskedBatchNorm
from ..nn.conv import dropout as feature_dropout
from ..nn.init import relu_gain, xavier_uniform_

__all__ = ["GCNGraphClassifier", "GCNMolClassifier"]


def _dense(in_feats: int, out_feats: int, bias: bool, generator) -> nn.Linear:
    """A Linear with xavier-uniform (relu gain) weights and zero bias."""
    lin = nn.utils.skip_init(nn.Linear, in_feats, out_feats, bias=bias)
    xavier_uniform_(lin.weight, relu_gain(), generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class GCNGraphClassifier(nn.Module):
    def __init__(
        self,
        in_feats: int,
        hidden_feats: int,
        num_classes: int,
        num_layers: int = 4,
        dropout: float = 0.5,
        *,
        lowering: str = "fused",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.convs = nn.ModuleList(
            GCNConv(in_feats if i == 0 else hidden_feats, hidden_feats, lowering=lowering,
                    device="cpu", generator=generator) for i in range(num_layers))
        self.bns = nn.ModuleList(MaskedBatchNorm(hidden_feats, device="cpu")
                                 for _ in range(num_layers - 1))
        self.graph_fc = nn.ModuleList([_dense(hidden_feats, hidden_feats, True, generator),
                                       _dense(hidden_feats, num_classes, True, generator)])
        self.to(resolve_device(device))

    def forward(self, batch: GraphBatch, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = batch.graph
        for conv, bn in zip(self.convs[:-1], self.bns):
            x = feature_dropout(F.relu(bn(conv(g, x))), self.dropout, self.training, generator)
        xg = readout(batch, self.convs[-1](g, x), "mean")
        xg = feature_dropout(F.relu(self.graph_fc[0](xg)), self.dropout, self.training, generator)
        return F.log_softmax(self.graph_fc[1](xg), dim=-1)


class GCNMolClassifier(nn.Module):
    """``node_encoder``: ``atom`` (AtomEncoder over (N, 9) integer features)
    or ``embed`` (one shared (1, emb) embedding, ppa's). ``edge_encoder``:
    ``bond`` (a BondEncoder per layer over (E, 3) integers) or an int, the
    width of float edge features that a Linear per layer encodes (ppa: 7;
    flax's default init, lecun-normal weights and zero bias)."""

    def __init__(
        self,
        emb_dim: int,
        num_classes: int,
        num_layers: int = 5,
        dropout: float = 0.5,
        node_encoder: str = "atom",
        edge_encoder: Union[str, int] = "bond",
        *,
        lowering: str = "fused",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.atom_encoder, self.node_emb = None, None
        if node_encoder == "atom":
            self.atom_encoder = AtomEncoder(emb_dim, device="cpu", generator=generator)
        elif node_encoder == "embed":
            self.node_emb = nn.Parameter(xavier_uniform_(torch.empty(1, emb_dim), 1.0, generator))
        else:
            raise ValueError(f"unknown node_encoder {node_encoder!r}")
        if edge_encoder == "bond":
            self.edge_encoders = nn.ModuleList(
                BondEncoder(emb_dim, device="cpu", generator=generator) for _ in range(num_layers))
        elif isinstance(edge_encoder, int):
            self.edge_encoders = nn.ModuleList(
                self._lecun_linear(edge_encoder, emb_dim, generator) for _ in range(num_layers))
        else:
            raise ValueError(f"unknown edge_encoder {edge_encoder!r}")
        self.convs = nn.ModuleList(
            GCNConvEdge(emb_dim, emb_dim, lowering=lowering, device="cpu", generator=generator)
            for _ in range(num_layers))
        self.bns = nn.ModuleList(MaskedBatchNorm(emb_dim, device="cpu")
                                 for _ in range(num_layers - 1))
        self.graph_pred_fc = _dense(emb_dim, num_classes, False, generator)
        self.to(resolve_device(device))

    @staticmethod
    def _lecun_linear(in_feats: int, out_feats: int, generator) -> nn.Linear:
        lin = nn.utils.skip_init(nn.Linear, in_feats, out_feats)
        std = 1.0 / math.sqrt(in_feats) / 0.87962566103423978  # truncated at ±2σ
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        nn.init.zeros_(lin.bias)
        return lin

    def forward(self, batch: GraphBatch, atom: torch.Tensor, bond: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = batch.graph
        if self.atom_encoder is not None:
            x = self.atom_encoder(atom)
        else:
            x = self.node_emb.expand(g.num_dst_nodes, -1)
        last = len(self.convs) - 1
        for i, (enc, conv) in enumerate(zip(self.edge_encoders, self.convs)):
            x = conv(g, x, enc(bond))
            if i < last:
                x = feature_dropout(F.relu(self.bns[i](x)), self.dropout, self.training, generator)
        return self.graph_pred_fc(readout(batch, x, "mean"))
