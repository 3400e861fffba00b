"""Carry GraphSAGE, GAT and GCN weights from the JAX package's flax parameter tree.

The tree is given as nested dicts of numpy arrays (``jax`` is not needed
to call this). A flax ``Dense`` kernel is ``(in, out)``; a torch ``Linear``
weight is ``(out, in)``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["sage_state_dict_from_flax", "gat_state_dict_from_flax",
           "gcn_graph_state_dict_from_flax", "gcn_mol_state_dict_from_flax"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layer(name: str) -> int:
    return int(name.split("_", 1)[1])


def sage_state_dict_from_flax(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> dict:
    """A ``state_dict`` for ``dgl_tpu_torch.models.GraphSAGE`` from the
    ``params`` (and, for the BN variant, ``batch_stats``) of
    ``dgl_tpu.models.GraphSAGE``."""
    sd = {}
    _batch_norms(sd, params, batch_stats)
    for name, sub in params.items():
        if name.startswith("conv_"):
            i = _layer(name)
            sd[f"convs.{i}.fc_self.weight"] = _t(np.asarray(sub["fc_self"]["kernel"]).T)
            sd[f"convs.{i}.fc_neigh.weight"] = _t(np.asarray(sub["fc_neigh"]["kernel"]).T)
            sd[f"convs.{i}.fc_neigh_bias"] = _t(sub["fc_neigh_bias"])
        elif not name.startswith("bn_"):
            raise KeyError(f"unexpected GraphSAGE parameter group {name!r}")
    return sd


def _batch_norms(sd: dict, params: Mapping, batch_stats: Optional[Mapping]) -> None:
    """``bn_<i>``'s scale and bias, and its ``batch_stats`` mean and var."""
    for name, sub in params.items():
        if name.startswith("bn_"):
            i = _layer(name)
            sd[f"bns.{i}.weight"] = _t(sub["scale"])
            sd[f"bns.{i}.bias"] = _t(sub["bias"])
    for name, sub in (batch_stats or {}).items():
        i = _layer(name)
        sd[f"bns.{i}.running_mean"] = _t(sub["mean"])
        sd[f"bns.{i}.running_var"] = _t(sub["var"])


def gat_state_dict_from_flax(params: Mapping) -> dict:
    """A ``state_dict`` for ``dgl_tpu_torch.models.GAT`` from the ``params``
    of ``dgl_tpu.models.GAT``. ``attn_l`` and ``attn_r`` keep the JAX
    package's pairing (``attn_r`` scores the source side, ``attn_l`` the
    destination side); both are (1, H, D) in either package."""
    sd = {}
    for name, sub in params.items():
        if not name.startswith("gat_"):
            raise KeyError(f"unexpected GAT parameter group {name!r}")
        i = _layer(name)
        sd[f"convs.{i}.fc.weight"] = _t(np.asarray(sub["fc"]["kernel"]).T)
        sd[f"convs.{i}.attn_l"] = _t(sub["attn_l"])
        sd[f"convs.{i}.attn_r"] = _t(sub["attn_r"])
        if "res_fc" in sub:
            sd[f"convs.{i}.res_fc.weight"] = _t(np.asarray(sub["res_fc"]["kernel"]).T)
    return sd


def _dense(sd: dict, prefix: str, sub: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(sub["kernel"]).T)
    if "bias" in sub:
        sd[f"{prefix}.bias"] = _t(sub["bias"])


def gcn_graph_state_dict_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None) -> dict:
    """A ``state_dict`` for ``dgl_tpu_torch.models.GCNGraphClassifier`` from
    the ``params`` and ``batch_stats`` of ``dgl_tpu.models.GCNGraphClassifier``."""
    sd = {}
    _batch_norms(sd, params, batch_stats)
    for name, sub in params.items():
        if name.startswith("conv_"):
            _dense(sd, f"convs.{_layer(name)}.fc", sub["fc"])
        elif name.startswith("graph_fc_"):
            _dense(sd, f"graph_fc.{name.rsplit('_', 1)[1]}", sub)
        elif not name.startswith("bn_"):
            raise KeyError(f"unexpected GCNGraphClassifier parameter group {name!r}")
    return sd


def _embeddings(sd: dict, prefix: str, sub: Mapping) -> None:
    for name, emb in sub.items():
        sd[f"{prefix}.embs.{_layer(name)}.weight"] = _t(emb["embedding"])


def gcn_mol_state_dict_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None) -> dict:
    """A ``state_dict`` for ``dgl_tpu_torch.models.GCNMolClassifier`` from
    the ``params`` and ``batch_stats`` of ``dgl_tpu.models.GCNMolClassifier``:
    embedding tables, ``node_emb`` and ``root_emb`` as they are, ``Dense``
    kernels transposed."""
    sd = {}
    _batch_norms(sd, params, batch_stats)
    for name, sub in params.items():
        if name == "atom_encoder":
            _embeddings(sd, "atom_encoder", sub)
        elif name == "node_emb":
            sd["node_emb"] = _t(sub)
        elif name.startswith("bond_encoder_"):
            _embeddings(sd, f"edge_encoders.{name.rsplit('_', 1)[1]}", sub)
        elif name.startswith("edge_fc_"):
            _dense(sd, f"edge_encoders.{name.rsplit('_', 1)[1]}", sub)
        elif name.startswith("conv_"):
            i = _layer(name)
            _dense(sd, f"convs.{i}.fc", sub["fc"])
            sd[f"convs.{i}.root_emb"] = _t(sub["root_emb"])
        elif name == "graph_pred_fc":
            _dense(sd, "graph_pred_fc", sub)
        elif not name.startswith("bn_"):
            raise KeyError(f"unexpected GCNMolClassifier parameter group {name!r}")
    return sd
