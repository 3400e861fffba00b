"""Rank functions that exercise the distributed paths, for ``launch.spawn``.

The CPU tests and ``chip_smoke.py`` run these on k ranks and hold what
they return to single-process results (the JAX package's, or the port's
own on one card). They live in the package because ``spawn`` imports a
rank's function by its module path. Each takes the rank's device and an
``.npz`` of its inputs (every rank reads the same file) and returns numpy
arrays: a rank's own rows, or values that must agree across the ranks.
"""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..data import load_node_dataset
from ..graph import transforms
from ..graph.graph import from_edges
from ..kernels.csr_spmm import csr_spmm
from ..kernels.row_gather import row_gather_async
from ..ops.spmm import gspmm
from ..sampling.neighbor import CSRGraph, MultiLayerNeighborSampler
from .comm import rank_of
from .dp import make_dp_train_step, stack_minibatches
from .halo import (exchange, halo_gat_boundary, halo_rgcn_boundary, halo_spmm,
                   halo_spmm_boundary, place, plan_layout_edata_boundary, relabel, shard_fullgraph,
                   shard_fullgraph_boundary)
from .halo_train import (HaloGAT, HaloRGCN, HaloSAGE, global_masked_backward,
                         make_halo_gat_train_step, make_halo_rgcn_train_step,
                         make_halo_train_step)
from .multihost import global_mesh, initialize
from .spmd import device_mesh, shard_graph, sharded_gspmm

__all__ = ["halo_ops", "halo_models", "halo_grads", "spmd_gspmm", "dp_step", "exchange_times",
           "in_turn", "fail_on", "sleep_for", "multihost_main"]


def _inputs(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _t(a, dev, grad=False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev).requires_grad_(grad)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _rows(a: np.ndarray, r: int, nps: int, n_pad: int) -> np.ndarray:
    """Rank ``r``'s rows of ``a`` padded to ``n_pad`` rows with zeros."""
    out = np.zeros((n_pad,) + a.shape[1:], a.dtype)
    out[:len(a)] = a
    return out[r * nps:(r + 1) * nps]


def halo_ops(dev: torch.device, path: str) -> dict:
    """The four aggregations and their gradients on this rank's rows.

    Inputs: ``src``, ``dst``, ``n``, ``k``; ``x``, ``cot`` (N, D) for
    ``halo_spmm_boundary`` and ``halo_spmm`` (mean); ``y`` (N, R·D),
    ``w`` (E, R), ``cot_rgcn`` for ``halo_rgcn_boundary``; ``z`` (N, H, D),
    the attention vectors ``attn_r``, ``attn_l`` (1, H, D), ``cot_gat`` for
    ``halo_gat_boundary``. Each gradient is of ``Σ out · cot`` wrt this
    rank's rows, or (the attention vectors) this rank's share of it."""
    a = _inputs(path)
    rank, k, n = rank_of(), int(a["k"]), int(a["n"])
    bs, n_pad, leids, heids = shard_fullgraph_boundary(a["src"], a["dst"], n, k, return_eids=True)
    nps = bs.nodes_per_shard
    shard = place(bs, rank, dev)
    rows = {name: _rows(a[name], rank, nps, n_pad)
            for name in ("x", "cot", "y", "cot_rgcn", "z", "cot_gat")}
    out = {}

    def grads(result, cot, *inputs):
        (result * _t(cot, dev)).sum().backward()
        return [_np(t.grad) for t in inputs]

    x = _t(rows["x"], dev, True)
    agg = halo_spmm_boundary(shard, x, "mean")
    out["spmm"], (out["spmm_grad"],) = _np(agg), grads(agg, rows["cot"], x)

    sg, _ = shard_fullgraph(a["src"], a["dst"], n, k)
    x = _t(rows["x"], dev, True)
    agg = halo_spmm(place(sg, rank, dev), x, "mean")
    out["allgather"], (out["allgather_grad"],) = _np(agg), grads(agg, rows["cot"], x)

    w_loc, w_hal = plan_layout_edata_boundary(bs, leids, heids, a["w"])
    weights = shard.edge_weights(w_loc[rank], w_hal[rank])
    y = _t(rows["y"], dev, True)
    agg = halo_rgcn_boundary(shard, y, weights, int(a["w"].shape[1]), "mean")
    out["rgcn"], (out["rgcn_grad"],) = _np(agg), grads(agg, rows["cot_rgcn"], y)

    z = _t(rows["z"], dev, True)
    attn_r, attn_l = (_t(a[name], dev, True) for name in ("attn_r", "attn_l"))
    agg = halo_gat_boundary(shard, z, attn_r, attn_l)
    out["gat"] = _np(agg)
    out["gat_grad_z"], out["gat_grad_attn_r"], out["gat_grad_attn_l"] = grads(
        agg, rows["cot_gat"], z, attn_r, attn_l)
    return out


def _state(a: dict, prefix: str) -> dict:
    return {key[len(prefix):]: torch.from_numpy(v) for key, v in a.items()
            if key.startswith(prefix)}


def halo_models(dev: torch.device, path: str) -> dict:
    """HaloSAGE, HaloGAT and HaloRGCN on this rank's rows at the given
    weights (``sage.*``, ``gat.*``, ``rgcn.*`` state-dict entries): the
    logits, then ``steps`` train steps (dropout 0; Adam(``lr``) with
    ``wd`` for SAGE and GAT), their global losses and the final parameters.

    Inputs: ``src``, ``dst``, ``n``, ``k``, ``x`` (N, D), ``labels`` (N,),
    ``mask`` (N,), ``multi`` (N, T) multilabel targets, ``w`` (E, R),
    ``heads``, ``steps``, ``lr``, ``wd``."""
    a = _inputs(path)
    rank, k, n = rank_of(), int(a["k"]), int(a["n"])
    bs, n_pad, leids, heids = shard_fullgraph_boundary(a["src"], a["dst"], n, k, return_eids=True)
    nps = bs.nodes_per_shard
    shard = place(bs, rank, dev)
    x = _t(_rows(a["x"], rank, nps, n_pad), dev)
    y = _t(_rows(a["labels"], rank, nps, n_pad), dev)
    mask = _t(_rows(a["mask"], rank, nps, n_pad), dev)
    multi = _t(_rows(a["multi"], rank, nps, n_pad), dev)
    w_loc, w_hal = plan_layout_edata_boundary(bs, leids, heids, a["w"])
    weights = shard.edge_weights(w_loc[rank], w_hal[rank])
    n_rel, steps, lr, wd = int(a["w"].shape[1]), int(a["steps"]), float(a["lr"]), float(a["wd"])
    sd = {name: _state(a, f"{name}.") for name in ("sage", "gat", "rgcn")}

    def dims(state, w_in, w_out):
        layers = sorted({key.split(".")[1] for key in state})
        return state[f"layers.0.{w_in}"].shape, state[f"layers.{layers[-1]}.{w_out}"].shape, len(layers)

    (d_in, hid), (_, c), n_layers = dims(sd["sage"], "w_self", "w_self")
    models = {"sage": HaloSAGE(d_in, hid, c, n_layers, device=dev)}
    heads = [int(h) for h in a["heads"]]
    gw = sd["gat"][f"layers.{len(heads) - 1}.w"]
    models["gat"] = HaloGAT(d_in, sd["gat"]["layers.0.w"].shape[1] // heads[0],
                            gw.shape[1] // heads[-1], heads, device=dev)
    r_in, r_out, r_layers = dims(sd["rgcn"], "w_rel", "w_rel")
    models["rgcn"] = HaloRGCN(r_in[1], r_in[2], r_out[2], n_rel, r_layers, device=dev)
    out = {}
    for name, model in models.items():
        model.load_state_dict(sd[name])
        opt = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=0.0 if name == "rgcn"
                               else wd)
        if name == "rgcn":
            logits = model(shard, x, weights)
            step = make_halo_rgcn_train_step(model, opt)
            losses = [step(shard, x, weights, multi, mask) for _ in range(steps)]
        else:
            logits = model(shard, x)
            step = (make_halo_train_step if name == "sage" else make_halo_gat_train_step)(model,
                                                                                        opt)
            losses = [step(shard, x, y, mask) for _ in range(steps)]
        out[f"{name}_logits"] = _np(logits)
        out[f"{name}_losses"] = np.array([float(v) for v in losses])
        out.update({f"{name}.{key}": _np(v) for key, v in model.state_dict().items()})
    return out


def _with_dataset(a: dict) -> dict:
    """``a`` with ``src``, ``dst``, ``n``, ``x``, ``labels`` and ``mask``
    (the training rows) from the dataset it names (``dataset``: the
    loaders' cache), where it names one."""
    if "dataset" not in a:
        return a
    data = load_node_dataset(str(a["dataset"]))
    return {"src": data.src, "dst": data.dst, "n": data.num_nodes, "x": data.features,
            "labels": data.labels, "mask": data.train_mask, **a}


def spmd_gspmm(dev: torch.device, path: str) -> dict:
    """``sharded_gspmm`` mean over the edges split across the ``graph``
    axis of a ``(1, k)`` rank grid: the replicated output, the replicated
    gradient of ``Σ out · cot`` wrt ``x``, and K1's launches. Inputs:
    ``src``, ``dst``, ``n`` (or a ``dataset``), ``x``, ``cot``."""
    a = _with_dataset(_inputs(path))
    mesh = device_mesh((1, dist.get_world_size()), ("data", "graph"))
    sg = shard_graph(a["src"], a["dst"], int(a["n"]), mesh, device=dev)
    x = _t(a["x"], dev, True)
    before = csr_spmm.launches
    out = sharded_gspmm(sg, "copy_u", "mean", x)
    (out * _t(a["cot"], dev)).sum().backward()
    return {"out": _np(out), "grad": _np(x.grad),
            "launches": np.array(csr_spmm.launches - before)}


def dp_step(dev: torch.device, path: str) -> dict:
    """One data-parallel step of a 2-layer GraphSAGE over sampled blocks
    (SGD(``lr``), dropout 0): each rank samples replica ``r`` of the stack
    (its seeds ``seeds_<r>``, its generator state ``rng_<r>``: a numpy
    bit-generator state as JSON), gathers its features with P1 (index order)
    and takes the masked cross-entropy. Returns the mean loss, the new
    parameters, and this rank's own loss and gradient before the average.

    Inputs: ``src``, ``dst``, ``n``, ``x``, ``labels`` (or a ``dataset``),
    ``fanouts``, ``b_pad``, ``k``, ``lr``, ``sage.*`` weights."""
    from ..models import GraphSAGE

    a = _with_dataset(_inputs(path))
    k = int(a["k"])
    csr = CSRGraph.from_edges(a["src"], a["dst"], int(a["n"]), device=dev)
    sampler = MultiLayerNeighborSampler([int(f) for f in a["fanouts"]])
    mbs = []
    for r in range(k):
        rng = np.random.default_rng()
        rng.bit_generator.state = json.loads(str(a[f"rng_{r}"]))
        mbs.append(sampler.sample(csr, a[f"seeds_{r}"], rng, int(a["b_pad"]), device=dev))
    stacked = stack_minibatches(mbs)
    sd = _state(a, "sage.")
    w0 = sd["convs.0.fc_self.weight"]
    model = GraphSAGE(w0.shape[1], w0.shape[0], sd["convs.1.fc_self.weight"].shape[0],
                      num_layers=2, dropout=0.0, device=dev)
    model.load_state_dict(sd)
    x, y = _t(np.asarray(a["x"], np.float32), dev), _t(np.asarray(a["labels"], np.int64), dev)

    def loss_fn(model, mb, x, y):
        logits = model(mb.blocks, row_gather_async(x, mb.input_nodes))
        ce = torch.nn.functional.cross_entropy(logits, y[mb.seeds.long()], reduction="none")
        m = mb.seed_mask.to(ce.dtype)
        return (ce * m).sum() / m.sum().clamp(min=1.0)

    own = loss_fn(model, mbs[rank_of()], x, y)
    own_grads = torch.autograd.grad(own, list(model.parameters()))
    opt = torch.optim.SGD(model.parameters(), lr=float(a["lr"]))
    loss = make_dp_train_step(loss_fn, opt)(model, stacked, x, y)
    out = {f"grad.{name}": _np(g) for (name, _), g in zip(model.named_parameters(), own_grads)}
    out.update({f"sage.{key}": _np(v) for key, v in model.state_dict().items()})
    out["loss"], out["own_loss"] = np.array(float(loss)), np.array(float(own.detach()))
    return out


def _driver_shard(a: dict, dev: torch.device, kind: str = "sage"):
    """This rank's shard of the drivers' plan of ``a``'s graph (bidirected
    where ``a["bidirect"]`` says so, then GAT's self-loops; the ``lp``
    relabel at seed 0): ``(shard, order, n_pad)``."""
    k, rank, n = dist.get_world_size(), rank_of(), int(a["n"])
    src = torch.from_numpy(np.asarray(a["src"], np.int64))
    dst = torch.from_numpy(np.asarray(a["dst"], np.int64))
    if bool(a.get("bidirect", False)):
        src, dst = transforms.to_bidirected(src, dst, n)
    if kind == "gat":
        src, dst = transforms.add_self_loops(src, dst, n)
    src, dst, order = relabel(src.numpy(), dst.numpy(), n, k, 0)
    plan, n_pad = shard_fullgraph_boundary(src, dst, n, k)
    return place(plan, rank, dev), order, n_pad


def exchange_times(dev: torch.device, path: str) -> dict:
    """The boundary exchange alone (``halo.exchange``: the payload's P1,
    the all_to_all, the table's concatenation) on this rank of the
    drivers' plan of a graph (``src``, ``dst``, ``n`` or a ``dataset``) at
    each of ``widths``: the host-clock median of ``reps`` synchronised
    calls (the ranks enter each call together) and the payload bytes a
    rank sends."""
    a = _with_dataset(_inputs(path))
    shard, _, _ = _driver_shard(a, dev)
    out = {}
    for d in (int(w) for w in a["widths"]):
        x = torch.ones(shard.nodes_per_shard, d, device=dev)
        times = []
        for _ in range(int(a["reps"]) + 2):  # two warm-up calls
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            exchange(shard, x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        out[f"ms_d{d}"] = np.array(1e3 * float(np.median(times[2:])))
        out[f"bytes_d{d}"] = np.array(shard.num_shards * shard.rows_per_pair * d * 4)
    return out


def halo_grads(dev: torch.device, path: str) -> dict:
    """One step's gradients of a HaloSAGE (dropout 0) or a HaloGAT at the
    given weights on the drivers' plan of a graph (``_driver_shard``):
    the global masked mean cross-entropy over the ``mask`` rows, the
    gradients summed over the ranks, as the train steps take them; no
    optimiser step. Returns ``grad.<name>`` (equal on every rank), the
    global ``loss`` and this rank's K1 launches in the payloads' adjoints
    (``send_adjoint``).

    Inputs: ``src``, ``dst``, ``n``, ``x``, ``labels``, ``mask`` (or a
    ``dataset``), ``kind`` ("sage" or "gat"), ``bidirect``, ``heads``
    (GAT), the weights as ``p.<name>``."""
    a = _with_dataset(_inputs(path))
    kind = str(a["kind"])
    shard, order, n_pad = _driver_shard(a, dev, kind)
    rank, nps = rank_of(), shard.nodes_per_shard

    def rows(v, dtype):
        return _t(_rows(np.asarray(v, dtype)[order], rank, nps, n_pad), dev)

    x, y, mask = rows(a["x"], np.float32), rows(a["labels"], np.int64), rows(a["mask"], bool)
    sd = _state(a, "p.")
    if kind == "sage":
        layers = len(sd) // 3
        w0, wl = sd["layers.0.w_self"], sd[f"layers.{layers - 1}.w_self"]
        model = HaloSAGE(w0.shape[0], w0.shape[1], wl.shape[1], layers, device=dev)
    else:
        heads = [int(h) for h in a["heads"]]
        w0, wl = sd["layers.0.w"], sd[f"layers.{len(heads) - 1}.w"]
        model = HaloGAT(w0.shape[0], w0.shape[1] // heads[0], wl.shape[1] // heads[-1], heads,
                        device=dev)
    model.load_state_dict(sd)
    before = exchange.send_adjoint_launches
    loss = global_masked_backward(
        model, None, lambda: F.cross_entropy(model(shard, x), y, reduction="none"), mask)
    out = {f"grad.{name}": _np(p.grad) for name, p in model.named_parameters()}
    out["loss"] = np.array(float(loss))
    out["send_adjoint"] = np.array(exchange.send_adjoint_launches - before)
    return out


def in_turn(dev: torch.device, calls) -> dict:
    """Several of this module's rank functions in one start of the ranks:
    ``calls`` a list of ``(key, function name, path)``; returns ``{key:
    its result}``."""
    return {key: globals()[name](dev, path) for key, name, path in calls}


def fail_on(dev: torch.device, failing_rank: int) -> int:
    """Rank ``failing_rank`` raises; the others wait for it in a barrier
    that never completes (the launcher must kill them)."""
    if rank_of() == failing_rank:
        raise ValueError(f"rank {failing_rank} fails on purpose")
    dist.barrier()
    return rank_of()


def sleep_for(dev: torch.device, seconds: float) -> int:
    """Outlast the launcher's time limit."""
    time.sleep(seconds)
    return rank_of()


def multihost_main() -> None:
    """A rank started through the ``DGL_TPU_*`` variables (gloo, CPU): the
    ranks form a (2, 2) ``global_mesh``, shard the edges over its ``graph``
    axis and hold ``sharded_gspmm`` mean to the one-process ``gspmm``, as
    ``tests/test_multihost.py`` does with two JAX processes."""
    initialize(backend="gloo", device="cpu")
    try:
        mesh = global_mesh(("data", "graph"), shape=(2, 2))
        rng = np.random.default_rng(0)
        n, e, d = 64, 256, 8
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
        ref = gspmm(from_edges(src, dst, n, device="cpu"), "copy_u", "mean", x=x)
        out = sharded_gspmm(shard_graph(src, dst, n, mesh, "graph", device="cpu"), "copy_u",
                            "mean", x)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        print(f"rank {dist.get_rank()} at {mesh.coords} of {mesh.shape}: multihost spmm OK",
              flush=True)
    finally:
        dist.destroy_process_group()
