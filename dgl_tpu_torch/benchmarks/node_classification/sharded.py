"""``--shard k``: edge-partitioned full-graph training of SAGE, GAT and RGCN.

Counterpart of ``run_sharded`` in the JAX drivers
(``benchmarks/node_classification/main_sage.py:48-140``, ``main_gat.py:48-130``,
``main_rgcn.py:34-110``), with their steps. In this process (the JAX
driver's host side):
1. the driver's graph transforms: SAGE bidirects where its table says so;
   GAT bidirects where its table says so, then adds self-loops; RGCN takes
   the graph as given;
2. a locality relabel: ``parallel/halo.py:relabel`` (the ``lp`` parts of
   ``graph/partition.py:partition_assignment``, seeded by ``--seed``),
   nodes sorted by part;
3. the boundary plan (``parallel/halo.py``), RGCN's with its edge
   weights laid out; the JAX line ``shard plan: k=… nodes/shard=… H=…
   volume_ratio=… build_s=…``;
4. each rank's rows and plan arrays written to a temporary directory.
Then ``parallel/launch.py`` starts k ranks (``--dist-backend``: ``nccl``
one rank per card, ``gloo`` for the CPU or for ranks sharing a card), and
each trains its rows (``parallel/halo_train.py``): models seeded
``seed * 1000 + run`` on every rank, the global masked loss, the gradients
added over the ranks. Rank 0 prints the reference's lines; accuracies add
hits and counts over the ranks, and RGCN's ROC-AUC is taken on rank 0 over
every rank's rows.

The result holds the losses, the epoch times, the plan's figures, each
rank's kernel launches over its last run's epochs and final parameters,
and the trained model's logits on every node in the input order (an
evaluation forward after the last run).
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ...graph import transforms
from ...kernels.csr_spmm import csr_spmm
from ...kernels.gat_attention import (gat_attention_bwd, gat_attention_fwd, gat_score_grad,
                                     gat_scores, gat_vector_grad)
from ...kernels.row_gather import row_gather_async, row_gather_by_source
from ...kernels.seg_sum import seg_sum
from ...parallel import launch
from ...parallel.comm import all_gather_rows, all_sum
from ...parallel.halo import (HaloShard, exchange, plan_layout_edata_boundary, relabel,
                              shard_fullgraph_boundary)
from ...parallel.halo_train import (HaloGAT, HaloRGCN, HaloSAGE, exchange_stats,
                                    make_halo_gat_train_step, make_halo_rgcn_train_step,
                                    make_halo_train_step)
from ...parallel.multihost import BACKENDS, check_backend
from ...parallel.spmd import replicated
from ...train.timing import synchronize
from ..common import Logger, mean_multilabel_auc

__all__ = ["BACKENDS", "resolve", "run_sharded"]

# the kernel wrappers whose launch counters a rank reports
_KERNELS = {"csr_spmm": csr_spmm, "seg_sum": seg_sum, "gat_attention_fwd": gat_attention_fwd,
           "gat_attention_bwd": gat_attention_bwd, "gat_scores": gat_scores,
           "gat_score_grad": gat_score_grad, "gat_vector_grad": gat_vector_grad,
           "row_gather_async": row_gather_async, "row_gather_by_source": row_gather_by_source}
_PLAN = ("local_src", "local_indptr", "halo_remap", "halo_indptr", "send_row")
_TIMEOUT = 24 * 3600.0  # a run's limit in seconds: past it the ranks are killed


def resolve(k: int, backend: Optional[str], device: str):
    """``(k, backend)`` of ``--shard`` and ``--dist-backend``: k = -1 takes
    every card; the backend defaults to ``nccl`` on ``cuda`` and ``gloo``
    on ``cpu``; raises before anything is loaded when it cannot serve k
    ranks (``multihost.check_backend``)."""
    on_cuda = torch.device(device).type == "cuda"
    if k < 0:
        k = torch.cuda.device_count() if on_cuda and torch.cuda.is_available() else 0
    if k < 1:
        raise ValueError(f"--shard needs k >= 1 ranks, got {k}")
    backend = backend or ("nccl" if on_cuda else "gloo")
    check_backend(backend, device, k)
    return k, backend


def _rows(a: np.ndarray, order: np.ndarray, r: int, nps: int) -> np.ndarray:
    """Rank ``r``'s ``nps`` rows of ``a`` in the new order, zero-padded."""
    rows = order[r * nps:(r + 1) * nps]
    out = np.zeros((nps,) + a.shape[1:], a.dtype)
    out[:len(rows)] = a[rows]
    return out


def _launch_counts() -> dict:
    """The kernel wrappers' counters, and of K1's, those of the exchange's
    payload adjoints (``send_adjoint``)."""
    return {**{name: fn.launches for name, fn in _KERNELS.items()},
            "send_adjoint": exchange.send_adjoint_launches}


def _load(run_dir: str, r: int, name: str) -> np.ndarray:
    return np.load(os.path.join(run_dir, f"r{r}_{name}.npy"))


def _dev(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _model(spec: dict, generator: torch.Generator, dev: torch.device):
    kind = spec["kind"]
    if kind == "sage":
        return HaloSAGE(spec["in_feats"], spec["hidden"], spec["classes"], spec["layers"],
                        aggr=spec["aggr"], dropout=spec["dropout"], generator=generator,
                        device=dev)
    if kind == "gat":
        return HaloGAT(spec["in_feats"], spec["hidden"], spec["classes"], spec["heads"],
                       generator=generator, device=dev)
    return HaloRGCN(1, spec["hidden"], spec["classes"], spec["n_rel"], spec["layers"],
                    generator=generator, device=dev)


def _rank_train(dev: torch.device, run_dir: str, spec: dict) -> dict:
    """One rank's training (``launch.spawn`` runs it on every rank)."""
    rank, kind = dist.get_rank(), spec["kind"]
    lead = rank == 0
    arrays = {name: _load(run_dir, rank, name) for name in _PLAN}
    shard = HaloShard.build(*(arrays[n] for n in _PLAN), rank=rank, num_shards=spec["k"],
                            rows_per_pair=spec["rows_per_pair"], device=dev)
    nps = shard.nodes_per_shard
    y = _dev(_load(run_dir, rank, "y"), dev)
    masks = {m: _dev(_load(run_dir, rank, m), dev) for m in ("train", "val", "test")}
    weights = None
    if kind == "rgcn":
        x = torch.ones((nps, 1), dtype=torch.float32, device=dev)
        weights = shard.edge_weights(_load(run_dir, rank, "w_local"),
                                     _load(run_dir, rank, "w_halo"))
    else:
        x = _dev(_load(run_dir, rank, "x"), dev)

    def forward(model):
        model.eval()
        with torch.no_grad():
            return model(shard, x, weights) if kind == "rgcn" else model(shard, x)

    def evaluate(model):
        if kind != "rgcn":
            pred = forward(model).argmax(-1)
            hits = torch.stack([((pred == y) & masks[m]).sum() for m in ("train", "val", "test")])
            counts = torch.stack([masks[m].sum() for m in ("train", "val", "test")])
            hits, counts = all_sum(hits), all_sum(counts)
            return [float(h) / max(float(c), 1.0) for h, c in zip(hits, counts)]
        scores = all_gather_rows(forward(model)).cpu().numpy()
        return [mean_multilabel_auc(scores[all_masks[m]], all_y[all_masks[m]])
                for m in ("train", "val", "test")] if lead else [0.0, 0.0, 0.0]

    if kind == "rgcn" and spec["eval"]:
        all_y = all_gather_rows(y).cpu().numpy()
        all_masks = {m: all_gather_rows(masks[m]).cpu().numpy() for m in masks}

    logger = Logger(spec["runs"])
    dur, losses = [], []
    for run in range(spec["runs"]):
        seed = spec["seed"] * 1000 + run
        model = replicated(_model(spec, torch.Generator().manual_seed(seed), dev))
        if kind == "rgcn":
            opt = torch.optim.Adam(model.parameters(), lr=spec["lr"])
            train = make_halo_rgcn_train_step(model, opt)

            def step():
                return train(shard, x, weights, y, masks["train"])
        elif kind == "gat":
            opt = torch.optim.Adam(model.parameters(), lr=spec["lr"], weight_decay=spec["wd"])
            train = make_halo_gat_train_step(model, opt)

            def step():
                return train(shard, x, y, masks["train"])
        else:
            opt = torch.optim.Adam(model.parameters(), lr=spec["lr"], weight_decay=spec["wd"])
            train = make_halo_train_step(model, opt)
            drop_gen = torch.Generator(device=dev).manual_seed(
                int(np.random.SeedSequence([seed, rank]).generate_state(1)[0]))

            def step():
                return train(shard, x, y, masks["train"], generator=drop_gen)

        before = _launch_counts()
        run_losses = []
        for epoch in range(spec["epochs"]):
            t0 = time.perf_counter()
            run_losses.append(step())
            synchronize(dev)
            if epoch >= 3:
                dur.append(time.perf_counter() - t0)
                if lead:
                    print("Training time/epoch {}".format(np.mean(dur)), flush=True)
            if spec["eval"] and (kind != "rgcn" or (epoch + 1) % spec["eval_steps"] == 0):
                accs = evaluate(model)
                logger.add_result(run, accs)
                if lead:
                    print("Run {:02d} | Epoch {:05d} | Loss {:.4f} | Train {:.4f} | Val {:.4f} | "
                          "Test {:.4f}".format(run, epoch, float(run_losses[-1]), *accs),
                          flush=True)
        launches = {name: n - before[name] for name, n in _launch_counts().items()}
        run_losses = [float(v) for v in run_losses]
        if not all(math.isfinite(v) for v in run_losses):
            raise FloatingPointError(f"non-finite training loss in run {run}: {run_losses}")
        losses.append(run_losses)
        if spec["eval"] and lead:
            logger.print_statistics(run)
    if spec["eval"] and lead:
        logger.print_statistics()
    logits = all_gather_rows(forward(model))
    return {
        "losses": losses,
        "epochs_s": dur,
        "launches": launches,
        "params": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
        "logits": logits.cpu().numpy() if lead else None,
    }


def _write_inputs(run_dir: str, kind: str, data, plan, order: np.ndarray, w_layout) -> None:
    k, nps = plan.num_shards, plan.nodes_per_shard
    for r in range(k):
        out = {"local_src": plan.local_src[r], "local_indptr": plan.local_indptr[r],
               "halo_remap": plan.halo_remap[r], "halo_indptr": plan.halo_indptr[r],
               "send_row": plan.send_tab[r],
               "y": _rows(np.asarray(data.labels, np.float32 if kind == "rgcn" else np.int64),
                          order, r, nps)}
        for m in ("train", "val", "test"):
            out[m] = _rows(np.asarray(getattr(data, f"{m}_mask"), bool), order, r, nps)
        if kind == "rgcn":
            out["w_local"], out["w_halo"] = w_layout[0][r], w_layout[1][r]
        else:
            out["x"] = _rows(np.asarray(data.features, np.float32), order, r, nps)
        for name, a in out.items():
            np.save(os.path.join(run_dir, f"r{r}_{name}.npy"), a)


def run_sharded(kind: str, data, *, k: int, backend: str, device: str, epochs: int,
                runs: int, eval_acc: bool, seed: int, hidden: int, lr: float, wd: float = 0.0,
                layers: int = 2, dropout: float = 0.0, aggr: str = "mean", heads=(1,),
                bidirect: bool = False, eval_steps: int = 5) -> dict:
    """Train ``kind`` (``sage``, ``gat`` or ``rgcn``) on ``data`` over ``k``
    ranks (see the module docstring)."""
    k, backend = resolve(k, backend, device)
    n = data.num_nodes
    src = torch.from_numpy(np.asarray(data.src, np.int64))
    dst = torch.from_numpy(np.asarray(data.dst, np.int64))
    if bidirect:
        src, dst = transforms.to_bidirected(src, dst, n)
    if kind == "gat":
        src, dst = transforms.add_self_loops(src, dst, n)
    t0 = time.perf_counter()
    src, dst, order = relabel(src.numpy(), dst.numpy(), n, k, seed)
    partition_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_layout = None
    if kind == "rgcn":
        plan, n_pad, leids, heids = shard_fullgraph_boundary(src, dst, n, k, return_eids=True)
        w_layout = plan_layout_edata_boundary(plan, leids, heids,
                                              np.asarray(data.edge_feat, np.float32))
    else:
        plan, n_pad = shard_fullgraph_boundary(src, dst, n, k)
    build_s = time.perf_counter() - t0
    stats = exchange_stats(plan, hidden)
    print("shard plan: k={} nodes/shard={} H={} volume_ratio={:.3f} build_s={:.1f}".format(
        k, plan.nodes_per_shard, plan.rows_per_pair, stats["volume_ratio"], build_s), flush=True)
    labels = np.asarray(data.labels)
    spec = dict(kind=kind, k=k, rows_per_pair=plan.rows_per_pair, epochs=epochs, runs=runs,
                eval=eval_acc, eval_steps=eval_steps, seed=seed, hidden=hidden, lr=lr, wd=wd,
                layers=layers, dropout=dropout, aggr=aggr, heads=tuple(heads),
                in_feats=0 if kind == "rgcn" else int(np.asarray(data.features).shape[1]),
                classes=int(labels.shape[1]) if kind == "rgcn" else int(data.num_classes),
                n_rel=int(np.asarray(data.edge_feat).shape[1]) if kind == "rgcn" else 0)
    run_dir = tempfile.mkdtemp(prefix="dgl_tpu_torch_shard_")
    try:
        t0 = time.perf_counter()
        _write_inputs(run_dir, kind, data, plan, order, w_layout)
        write_s = time.perf_counter() - t0
        del plan, w_layout
        t0 = time.perf_counter()
        out = launch.spawn(_rank_train, k, (run_dir, spec), backend=backend, device=device,
                           timeout=_TIMEOUT)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    logits = np.empty((n,) + out[0]["logits"].shape[1:], np.float32)
    logits[order] = out[0]["logits"][:n]
    dur = out[0]["epochs_s"]
    return {
        "device": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu",
        "synthetic": data.synthetic,
        "k": k,
        "backend": backend,
        "partition_s": partition_s,
        "build_s": build_s,
        "write_s": write_s,
        "ranks_s": ranks_s,
        "num_edges": int(len(src)),
        "nodes_per_shard": int(n_pad // k),
        "rows_per_pair": spec["rows_per_pair"],
        "exchange_stats": stats,
        "losses": out[0]["losses"],
        "epochs_s": dur,
        "epoch_s": float(np.mean(dur)) if dur else None,
        "launches": [o["launches"] for o in out],
        "params": [o["params"] for o in out],
        "logits": logits,
    }
