"""GCMC (Graph Convolutional Matrix Completion) layers.

Counterpart of ``dgl_tpu/nn/gcmc.py`` (the reference's ``gcmc_dgl/model.py``):
the degree-normalised per-rating graph convolution, the heterograph
encoder layer and the bilinear basis decoders. ``DenseBiDecoder`` has the
JAX package's fix of the reference's ``self.P`` (``model.py:395``; the
parameters are ``Ps``).

Every relation's sum is ``gspmm(g, "copy_u", "sum")``: one K1 launch over
the relation's dst CSR forward and one over its reverse CSR backward
(``ops/spmm.py``). Each decoder basis is one ``u_dot_v``: P1 in source
order for each side's gather, their adjoints K1 by ``rev.eid`` and K2
(``ops/sddmm.py``). The GEMMs are plain products.

Parameters keep the flax layouts where the JAX layer owns a raw parameter
(``weight`` and ``W_r_<rating>`` (in, out), ``Ps`` (bases, d, d)), drawn
with flax's xavier-uniform; ``Dense`` layers are torch ``Linear`` ((out,
in)) with flax's ``lecun_normal`` and zero biases, all from the CPU
``generator``. ``convert.py:gcmc_state_dict_from_flax`` carries JAX
weights over. Dropout masks come from the ``generator`` passed to
``forward``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph
from ..graph.hetero import HeteroGraph
from ..ops import gspmm
from ..ops.sddmm import u_dot_v
from .conv import dropout
from .init import lecun_normal_

__all__ = ["GCMCGraphConv", "GCMCLayer", "BiDecoder", "DenseBiDecoder"]

Norms = Dict[str, Tuple[torch.Tensor, torch.Tensor]]  # node type -> (ci, cj), each (n, 1)


def _flax_xavier(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    """flax's ``variance_scaling(1, fan_avg, uniform)`` on ``shape``: fans
    along the last two axes, the leading ones a receptive field."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


def _dense(in_feats: int, out_feats: int, bias: bool, generator) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, in_feats, out_feats, bias=bias)
    lecun_normal_(lin.weight, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class GCMCGraphConv(nn.Module):
    """Per-rating graph conv: ``ci · sum_by_dst(dropout(cj) · (x W))``
    (``gcmc_dgl/model.py:10-96``): ``cj`` (per source) and ``ci`` (per
    destination) come from the data pipeline; dropout acts on ``cj``, as the
    reference's ``feat * self.dropout(cj)``. Without ``use_weight`` the
    caller passes ``weight`` (a shared one) or none."""

    def __init__(self, in_feats: int, out_feats: int, use_weight: bool = True,
                 dropout_rate: float = 0.0, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.weight = _flax_xavier((in_feats, out_feats), generator) if use_weight else None
        self.to(resolve_device(device))

    def forward(self, g: Graph, x, cj: torch.Tensor, ci: torch.Tensor,
                weight: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = x[0] if isinstance(x, (tuple, list)) else x
        if self.weight is not None:
            if weight is not None:
                raise ValueError("external weight given but use_weight=True")
            weight = self.weight
        if weight is not None:
            feat = feat @ weight
        feat = feat * dropout(cj, self.dropout_rate, self.training, generator)
        return gspmm(g, "copy_u", "sum", x=feat) * ci


class GCMCLayer(nn.Module):
    """The heterograph encoder layer (``gcmc_dgl/model.py:99-271``): one
    GCMCGraphConv per rating relation and its reverse, combined by
    destination type with ``agg`` (``stack``: concatenated along features,
    each relation ``msg_units / len(rating_vals)`` wide; ``sum``), then
    ``agg_act``, dropout and a per-type dense projection (``ufc``, ``ifc``),
    then ``out_act``. ``share_user_item_param``: one ``W_r_<rating>`` per
    rating used by both directions, and one projection (``ufc``) for both
    types; it needs equal user and movie feature widths."""

    def __init__(
        self,
        rating_vals: Sequence[str],
        user_in: int,
        movie_in: int,
        msg_units: int,
        out_units: int,
        dropout_rate: float = 0.0,
        agg: str = "stack",
        agg_act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        out_act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        share_user_item_param: bool = False,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if agg not in ("stack", "sum"):
            raise ValueError(f"unknown agg {agg!r}")
        self.rating_vals = [str(r) for r in rating_vals]
        per_rel = msg_units
        if agg == "stack":
            if msg_units % len(self.rating_vals) != 0:
                raise ValueError("msg_units must divide by number of ratings for stack agg")
            per_rel = msg_units // len(self.rating_vals)
        if share_user_item_param and user_in != movie_in:
            raise ValueError("share_user_item_param requires equal user/movie feature dims, "
                             f"got {user_in} vs {movie_in}")
        self.agg, self.agg_act, self.out_act = agg, agg_act, out_act
        self.dropout_rate, self.share = dropout_rate, share_user_item_param
        in_of = {"user": user_in, "movie": movie_in}
        self.W_r = nn.ParameterDict()
        self.convs = nn.ModuleDict()
        for r in self.rating_vals:
            if share_user_item_param:  # the JAX layer draws W_r_<r> before its convs
                self.W_r[r] = _flax_xavier((user_in, per_rel), generator)
            for rel, stype in ((r, "user"), (f"rev-{r}", "movie")):
                self.convs[rel] = GCMCGraphConv(
                    in_of[stype], per_rel, use_weight=not share_user_item_param,
                    dropout_rate=dropout_rate, device="cpu", generator=generator)
        self.ufc = _dense(msg_units, out_units, True, generator)
        self.ifc = None if share_user_item_param else _dense(msg_units, out_units, True, generator)
        self.to(resolve_device(device))

    def forward(self, hg: HeteroGraph, ufeat: torch.Tensor, ifeat: torch.Tensor, norms: Norms,
                *, generator: Optional[torch.Generator] = None):
        feats = {"user": ufeat, "movie": ifeat}
        outs: Dict[str, list] = {"user": [], "movie": []}
        for r in self.rating_vals:
            for rel, (stype, dtype) in ((r, ("user", "movie")), (f"rev-{r}", ("movie", "user"))):
                out = self.convs[rel](hg[(stype, rel, dtype)], (feats[stype], feats[dtype]),
                                      norms[stype][1], norms[dtype][0],
                                      weight=self.W_r[r] if self.share else None,
                                      generator=generator)
                outs[dtype].append(out)

        def combine(lst):
            if self.agg == "stack":
                return torch.stack(lst, dim=1).reshape(lst[0].shape[0], -1)
            return sum(lst)

        def project(fc, h):
            if self.agg_act is not None:
                h = self.agg_act(h)
            h = fc(dropout(h, self.dropout_rate, self.training, generator))
            return h if self.out_act is None else self.out_act(h)

        ifc = self.ufc if self.ifc is None else self.ifc
        return project(self.ufc, combine(outs["user"])), project(ifc, combine(outs["movie"]))


class BiDecoder(nn.Module):
    """Bilinear basis decoder (``gcmc_dgl/model.py:273-346``) on a
    user→movie pair graph: ``score[e, c] = Σ_s a_{sc} · (u_i P_s) · v_j``,
    (E, num_classes) in the graph's canonical edge order."""

    def __init__(self, num_classes: int, in_units: int, num_basis: int = 2,
                 dropout_rate: float = 0.0, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Ps = _flax_xavier((num_basis, in_units, in_units), generator)
        self.combine_basis = _dense(num_basis, num_classes, False, generator)
        self.to(resolve_device(device))

    def forward(self, dec_graph: Graph, ufeat: torch.Tensor, ifeat: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ufeat = dropout(ufeat, self.dropout_rate, self.training, generator)
        ifeat = dropout(ifeat, self.dropout_rate, self.training, generator)
        basis = [u_dot_v(dec_graph, ufeat @ p, ifeat) for p in self.Ps]
        return self.combine_basis(torch.cat(basis, dim=1))


class DenseBiDecoder(nn.Module):
    """The decoder on aligned pairs ``(ufeat[a], ifeat[a])``:
    ``out[a, s] = u_a P_s · v_a`` combined across bases, (A, num_classes).
    The reference's class uses ``self.P``, which does not exist
    (``model.py:395``); this is the corrected math, as in the JAX package."""

    def __init__(self, num_classes: int, in_units: int, num_basis: int = 2,
                 dropout_rate: float = 0.0, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Ps = _flax_xavier((num_basis, in_units, in_units), generator)
        self.combine_basis = _dense(num_basis, num_classes, False, generator)
        self.to(resolve_device(device))

    def forward(self, ufeat: torch.Tensor, ifeat: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ufeat = dropout(ufeat, self.dropout_rate, self.training, generator)
        ifeat = dropout(ifeat, self.dropout_rate, self.training, generator)
        return self.combine_basis(torch.einsum("ai,sij,aj->as", ufeat, self.Ps, ifeat))
