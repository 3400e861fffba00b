"""GCMC end to end: the heterograph encoder and the bilinear decoder.

Counterpart of ``dgl_tpu/models/gcmc.py:GCMCNet`` (``gcmc_dgl/train.py:17-41``,
``Net``): a GCMCLayer encoder (leaky-relu after the relation combine) and a
BiDecoder over the user→movie pair graph, one logit a rating class.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph
from ..graph.hetero import HeteroGraph
from ..nn.gcmc import BiDecoder, GCMCLayer, Norms

__all__ = ["GCMCNet"]


class GCMCNet(nn.Module):
    def __init__(
        self,
        rating_vals: Sequence[str],
        user_in: int,
        movie_in: int,
        msg_units: int = 500,
        out_units: int = 75,
        dropout_rate: float = 0.7,
        agg: str = "stack",
        agg_act: Optional[Callable[[torch.Tensor], torch.Tensor]] = F.leaky_relu,
        num_basis: int = 2,
        share_user_item_param: bool = False,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.encoder = GCMCLayer(rating_vals, user_in, movie_in, msg_units, out_units,
                                 dropout_rate=dropout_rate, agg=agg, agg_act=agg_act,
                                 share_user_item_param=share_user_item_param, device="cpu",
                                 generator=generator)
        self.decoder = BiDecoder(len(rating_vals), out_units, num_basis, device="cpu",
                                 generator=generator)
        self.to(resolve_device(device))

    def forward(self, enc_graph: HeteroGraph, dec_graph: Graph, ufeat: torch.Tensor,
                ifeat: torch.Tensor, norms: Norms, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(E_dec, num_classes) logits in the decoder graph's canonical order."""
        u, i = self.encoder(enc_graph, ufeat, ifeat, norms, generator=generator)
        return self.decoder(dec_graph, u, i, generator=generator)
