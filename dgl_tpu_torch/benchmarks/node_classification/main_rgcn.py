"""Full-graph RGCN on ogbn-proteins on one card.

Counterpart of ``benchmarks/node_classification/main_rgcn.py`` (the
reference's ``main_dgl_proteins_rgcn_for.py``), with its defaults: node
features ``ones((N, 1))``, the 8 columns of the edge features as relation
weights, 3 layers, hidden 32, dropout 0, Adam(0.01), multilabel
BCE-with-logits on the train nodes, the mean per-task ROC-AUC every
``--eval_steps`` epochs under ``--eval``. The graph is not bidirected and
has no self-loops. The edge weights are laid out for K1 once, before
training (``ops/rel.py:RelEdgeWeights``); they are constants, so a step
computes no gradient for them. Every epoch ends in a device synchronise;
epochs from the fourth on are timed.

    python -m dgl_tpu_torch.benchmarks.node_classification.main_rgcn
        [--epochs N] [--runs R] [--eval] [--eval_steps K] [--fuse-relations]
        [--scale S] [--device cuda] [--profile EPOCHS] [--shard K [--dist-backend nccl|gloo]]

Prints the reference's lines (``Training time/epoch``, with ``--eval`` the
``Run … | Epoch …`` lines and the logger's statistics); ``--profile`` runs
that many further epochs under ``torch.profiler`` and prints the device
time by kernel as one JSON line on stderr.

``--shard k`` trains over k ranks with the relation-contracted
boundary-halo exchange, as the JAX driver's ``run_sharded`` does
(``sharded.py``: the ``lp`` relabel, the edge weights in each shard's
layout, ``parallel/halo_train.py``'s HaloRGCN through weighted K1, the
ROC-AUC over every rank's rows); ``--dist-backend`` as in ``main_sage``.

Not ported: ``--lane-kernel`` (the TPU's lane plans and locality reorder).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ...data import load_node_dataset
from ...device import DeviceLike, resolve_device
from ...graph import from_edges
from ...models import RGCN
from ...ops.rel import RelEdgeWeights
from ...train.timing import device_profile, synchronize
from ..common import Logger, masked_bce, mean_multilabel_auc, print_data_stats
from . import sharded

__all__ = ["make_train_step", "run", "run_sharded", "parser", "main"]


def make_train_step(model, opt, g, x, weights: RelEdgeWeights, y, train_mask,
                    generator: Optional[torch.Generator] = None) -> Callable[[], torch.Tensor]:
    """One optimiser step on the whole graph; returns the loss on the
    device, so the step makes no host sync."""

    def step():
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = masked_bce(model(g, x, weights, generator=generator), y, train_mask)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def run(
    *,
    epochs: int = 1000,
    runs: int = 10,
    eval_acc: bool = False,
    eval_steps: int = 5,
    lr: float = 0.01,
    num_layers: int = 3,
    hidden: int = 32,
    dropout: float = 0.0,
    fuse_relations: bool = False,
    seed: int = 0,
    device: DeviceLike = None,
    scale: float = 1.0,
    profile_epochs: int = 0,
) -> dict:
    """Train RGCN on ogbn-proteins ``runs`` times from fresh weights, each
    seeded ``seed * 1000 + run``.

    Returns ``{"device", "synthetic", "load_s", "setup_s", "weights_s",
    "num_edges", "epoch_s", "epochs_s", "losses", "profile", "setup_bytes",
    "train_peak_bytes"}``: ``setup_s`` the copies to the device and both
    CSR sorts, ``weights_s`` the layout of the edge weights; on a card
    ``setup_bytes`` is the device memory the graph, the data and the
    weights hold when training starts and ``train_peak_bytes`` the peak
    from there to the end (None on the CPU)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    data = load_node_dataset("ogbn-proteins", seed=seed, scale=scale)
    load_s = time.perf_counter() - t0
    print_data_stats(data)
    t0 = time.perf_counter()
    g = from_edges(data.src, data.dst, data.num_nodes, device=dev)
    x = torch.ones((data.num_nodes, 1), dtype=torch.float32, device=dev)
    y = torch.from_numpy(np.asarray(data.labels, np.float32)).to(dev)
    masks = {k: torch.from_numpy(np.asarray(getattr(data, f"{k}_mask"))).to(dev)
             for k in ("train", "val", "test")}
    edge_feat = torch.from_numpy(np.asarray(data.edge_feat, np.float32)).to(dev)
    synchronize(dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    weights = RelEdgeWeights.build(g, edge_feat.index_select(0, g.eid))
    del edge_feat
    synchronize(dev)
    weights_s = time.perf_counter() - t0
    setup_bytes = None
    if dev.type == "cuda":  # the training's own peak, without the graph build's
        setup_bytes = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    logger = Logger(runs)
    labels_np = np.asarray(data.labels)
    mask_np = {k: np.asarray(getattr(data, f"{k}_mask")) for k in ("train", "val", "test")}
    dur, losses, profile = [], [], None
    for r in range(runs):
        model = RGCN(1, hidden, y.shape[1], weights.num_relations, num_layers, dropout,
                     fuse_relations=fuse_relations, device=dev,
                     generator=torch.Generator().manual_seed(seed * 1000 + r))
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        step = make_train_step(model, opt, g, x, weights, y, masks["train"],
                               torch.Generator(device=dev).manual_seed(seed * 1000 + r))
        run_losses = []
        for epoch in range(epochs):
            t0 = time.perf_counter()
            run_losses.append(step())
            synchronize(dev)
            if epoch >= 3:
                dur.append(time.perf_counter() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if eval_acc and (epoch + 1) % eval_steps == 0:
                model.eval()
                with torch.no_grad():
                    scores = model(g, x, weights).cpu().numpy()
                aucs = [mean_multilabel_auc(scores[mask_np[k]], labels_np[mask_np[k]])
                        for k in ("train", "val", "test")]
                logger.add_result(r, aucs)
                print("Run {:02d} | Epoch {:05d} | Loss {:.4f} | Train {:.4f} | Val {:.4f} | "
                      "Test {:.4f}".format(r, epoch, float(run_losses[-1]), *aucs))
        run_losses = [float(v) for v in run_losses]
        if not all(math.isfinite(v) for v in run_losses):
            raise FloatingPointError(f"non-finite training loss in run {r}: {run_losses}")
        losses.append(run_losses)
        if eval_acc:
            logger.print_statistics(r)
        if profile_epochs and r == runs - 1:
            profile = device_profile(step, profile_epochs, dev)
    if eval_acc:
        logger.print_statistics()
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "synthetic": data.synthetic,
        "load_s": load_s,
        "setup_s": setup_s,
        "weights_s": weights_s,
        "num_edges": g.num_edges,
        "epoch_s": float(np.mean(dur)) if dur else None,
        "epochs_s": dur,
        "losses": losses,
        "profile": profile,
        "setup_bytes": setup_bytes,
        "train_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def run_sharded(
    shard: int = 2,
    *,
    dist_backend: Optional[str] = None,
    epochs: int = 1000,
    runs: int = 10,
    eval_acc: bool = False,
    eval_steps: int = 5,
    lr: float = 0.01,
    num_layers: int = 3,
    hidden: int = 32,
    seed: int = 0,
    device: str = "cuda",
    scale: float = 1.0,
) -> dict:
    """``--shard``: RGCN on ogbn-proteins over ``shard`` ranks
    (``sharded.run_sharded``; -1 takes every card)."""
    shard, backend = sharded.resolve(shard, dist_backend, device)
    data = load_node_dataset("ogbn-proteins", seed=seed, scale=scale)
    print_data_stats(data)
    return sharded.run_sharded(
        "rgcn", data, k=shard, backend=backend,
        device=device, epochs=epochs, runs=runs, eval_acc=eval_acc, eval_steps=eval_steps,
        seed=seed, hidden=hidden, lr=lr, layers=num_layers)


def parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="RGCN ogbn-proteins (dgl_tpu_torch)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--log_steps", type=int, default=1)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--num-layers", type=int, default=3)
    parser.add_argument("--hidden-feats", type=int, default=32)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--eval_steps", type=int, default=5)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--eval", action="store_true",
                        help="If not set, we will only do the training part.")
    parser.add_argument("--fuse-relations", action="store_true",
                        help="every layer aggregates its inputs, then projects (by default "
                             "only layers whose input is narrower than their output do)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scale", type=float, default=1.0,
                        help="shrink factor for the synthetic data (rehearsals)")
    parser.add_argument("--profile", type=int, default=0, metavar="EPOCHS",
                        help="profile this many further epochs after the last run (stderr)")
    parser.add_argument("--shard", type=int, default=0,
                        help="edge-partitioned training over this many ranks (boundary-halo "
                             "exchange); 0 = off, -1 = every card")
    parser.add_argument("--dist-backend", choices=sharded.BACKENDS, default=None,
                        help="--shard's backend: nccl (one rank a card; default on cuda) or "
                             "gloo (default on cpu; ranks sharing a card)")
    return parser


def main(argv: Optional[list] = None) -> dict:
    args = parser().parse_args(argv)
    print(args)
    if args.shard:
        return run_sharded(args.shard, dist_backend=args.dist_backend, epochs=args.epochs,
                           runs=args.runs, eval_acc=args.eval, eval_steps=args.eval_steps,
                           lr=args.lr, num_layers=args.num_layers, hidden=args.hidden_feats,
                           seed=args.seed, device=args.device, scale=args.scale)
    res = run(epochs=args.epochs, runs=args.runs, eval_acc=args.eval, eval_steps=args.eval_steps,
              lr=args.lr, num_layers=args.num_layers, hidden=args.hidden_feats,
              dropout=args.dropout, fuse_relations=args.fuse_relations, seed=args.seed,
              device=args.device, scale=args.scale, profile_epochs=args.profile)
    if res["profile"] is not None:
        print(f"# profile={json.dumps(res['profile'])}", file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
