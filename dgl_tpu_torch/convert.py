"""Carry GraphSAGE, GAT, GCN, RGCN, link-predictor and GCMC weights from the JAX package's flax
parameter tree, and the halo models' from its ``dgl_tpu.parallel`` pytrees.

The tree is given as nested dicts of numpy arrays (``jax`` is not needed
to call this). A flax ``Dense`` kernel is ``(in, out)``; a torch ``Linear``
weight is ``(out, in)``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["sage_state_dict_from_flax", "gat_state_dict_from_flax",
           "gcn_graph_state_dict_from_flax", "gcn_mol_state_dict_from_flax",
           "rel_graph_conv_state_dict_from_flax", "rgcn_state_dict_from_flax",
           "predictor_state_dict_from_flax", "gcmc_state_dict_from_flax",
           "halo_sage_state_dict_from_jax", "halo_gat_state_dict_from_jax",
           "halo_rgcn_state_dict_from_jax"]


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
    """``bn_<i>``'s scale and bias (where ``use_scale`` / ``use_bias`` keep
    them), and its ``batch_stats`` mean and var."""
    for name, sub in params.items():
        if name.startswith("bn_"):
            i = _layer(name)
            for flax_name, port_name in (("scale", "weight"), ("bias", "bias")):
                if flax_name in sub:
                    sd[f"bns.{i}.{port_name}"] = _t(sub[flax_name])
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


def rel_graph_conv_state_dict_from_flax(params: Mapping, prefix: str = "") -> dict:
    """A ``state_dict`` for ``dgl_tpu_torch.nn.RelGraphConv`` from the
    ``params`` of ``dgl_tpu.nn.RelGraphConv``: ``rel_weights`` (R, in, out)
    as it is, the ``skip`` Dense kernel transposed, its bias."""
    sd = {f"{prefix}rel_weights": _t(params["rel_weights"])}
    _dense(sd, f"{prefix}skip", params["skip"])
    return sd


def rgcn_state_dict_from_flax(params: Mapping) -> dict:
    """A ``state_dict`` for ``dgl_tpu_torch.models.RGCN`` from the ``params``
    of ``dgl_tpu.models.RGCN``."""
    sd = {}
    for name, sub in params.items():
        if not name.startswith("rgcn_"):
            raise KeyError(f"unexpected RGCN parameter group {name!r}")
        sd.update(rel_graph_conv_state_dict_from_flax(sub, f"convs.{_layer(name)}."))
    return sd


def predictor_state_dict_from_flax(params: Mapping) -> dict:
    """A ``state_dict`` for ``dgl_tpu_torch.nn.MLPPredictor`` or
    ``PairMLPPredictor`` from the ``params`` of the JAX package's: ``lin_i``
    to ``lins.i``, ``lin_out`` to ``lin_out``, ``Dense`` kernels transposed.
    ``DotPredictor`` has no parameters."""
    sd = {}
    for name, sub in params.items():
        if name == "lin_out":
            _dense(sd, "lin_out", sub)
        elif name.startswith("lin_"):
            _dense(sd, f"lins.{_layer(name)}", sub)
        else:
            raise KeyError(f"unexpected predictor parameter group {name!r}")
    return sd


def gcmc_state_dict_from_flax(params: Mapping, prefix: str = "") -> dict:
    """A ``state_dict`` for the port's ``GCMCNet``, ``GCMCLayer``,
    ``GCMCGraphConv``, ``BiDecoder`` or ``DenseBiDecoder`` from the
    ``params`` of the JAX package's same module: ``encoder``/``decoder`` to
    their submodules, ``conv_<rel>/weight`` to ``convs.<rel>.weight`` and
    ``W_r_<rating>`` to ``W_r.<rating>`` ((in, out) as they are), ``Ps`` as it
    is, the ``Dense`` layers ``ufc``, ``ifc`` and ``combine_basis``
    transposed."""
    sd = {}
    for name, sub in params.items():
        if name in ("encoder", "decoder"):
            sd.update(gcmc_state_dict_from_flax(sub, f"{prefix}{name}."))
        elif name.startswith("conv_"):
            sd[f"{prefix}convs.{name[len('conv_'):]}.weight"] = _t(sub["weight"])
        elif name.startswith("W_r_"):
            sd[f"{prefix}W_r.{name[len('W_r_'):]}"] = _t(sub)
        elif name in ("weight", "Ps"):
            sd[f"{prefix}{name}"] = _t(sub)
        elif name in ("ufc", "ifc", "combine_basis"):
            _dense(sd, f"{prefix}{name}", sub)
        else:
            raise KeyError(f"unexpected GCMC parameter group {name!r}")
    return sd


def _halo_layers(params, names) -> dict:
    """``params[i][name]`` → ``layers.<i>.<name>``, as it is: the halo
    models keep the JAX pytree's names and (in, out) layouts."""
    sd = {}
    for i, layer in enumerate(params):
        if set(layer) != set(names):
            raise KeyError(f"halo layer {i} holds {sorted(layer)}, expected {sorted(names)}")
        sd.update({f"layers.{i}.{name}": _t(layer[name]) for name in names})
    return sd


def halo_sage_state_dict_from_jax(params) -> dict:
    """A ``state_dict`` for ``parallel.HaloSAGE`` from
    ``dgl_tpu.parallel.halo_sage_init``'s list of layers."""
    return _halo_layers(params, ("w_self", "w_neigh", "bias"))


def halo_gat_state_dict_from_jax(params) -> dict:
    """A ``state_dict`` for ``parallel.HaloGAT`` from ``halo_gat_init``'s."""
    return _halo_layers(params, ("w", "attn_l", "attn_r"))


def halo_rgcn_state_dict_from_jax(params) -> dict:
    """A ``state_dict`` for ``parallel.HaloRGCN`` from ``halo_rgcn_init``'s."""
    return _halo_layers(params, ("w_rel", "w_skip", "bias"))
