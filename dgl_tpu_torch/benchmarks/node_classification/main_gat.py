"""Full-graph GAT node classification on one card.

Counterpart of ``benchmarks/node_classification/main_gat.py`` (the
reference's ``main_dgl_{citation,reddit,arxiv}_gat.py``), with its
per-dataset table: citation heads (8, 8, 1), hidden 8, lr 5e-3, wd 5e-4,
dropout 0.6, 200 epochs; reddit heads (1, 1, 1), hidden 16, tuned
lr/wd/dropout, 500 epochs; arxiv heads (4, 4, 4), bidirected. Every graph
gets self-loops. reddit and arxiv run GATConv's fused form (K3), as the
suite's rows run ``--lane-kernel``; cora and pubmed run the edge form (K2).
The loss is masked cross-entropy, the optimiser Adam with coupled L2
(``torch.optim.Adam(weight_decay=wd)``). Every epoch ends in a device
synchronise; epochs from the fourth on are timed.

    python -m dgl_tpu_torch.benchmarks.node_classification.main_gat --dataset reddit
        [--epochs N] [--runs R] [--eval] [--device cuda] [--profile EPOCHS]
        [--shard K [--dist-backend nccl|gloo]]

Prints the reference's lines (``Training time/epoch``, with ``--eval`` the
``Run … | Epoch …`` lines and ``Final Train`` / ``Final Test``).
``--profile`` runs that many further epochs under ``torch.profiler`` and
prints the device time by kernel as one JSON line on stderr.

``--shard k`` trains over k ranks with the boundary-halo exchange, as the
JAX driver's ``run_sharded`` does (``sharded.py``: bidirect where the table
says so, self-loops, the ``lp`` relabel, ``parallel/halo_train.py``'s
HaloGAT through K3, which has no dropout and no bias);
``--dist-backend`` as in ``main_sage``. The JAX driver's ``--scan-epochs``
and locality reorder are TPU workarounds and are not ported.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional

import numpy as np
import torch

from ...data import load_node_dataset
from ...device import DeviceLike, resolve_device
from ...graph import from_edges, transforms
from ...models import GAT
from ...train.timing import device_profile, synchronize
from ..common import Logger, masked_accuracy, masked_softmax_ce, print_data_stats
from . import sharded

__all__ = ["DATASET_CFG", "run", "run_sharded", "main"]

_TUNED = dict(lr=0.0029739421726400865, wd=2.4222556964495987e-05, dropout=0.18074706609292976)

DATASET_CFG = {
    "cora": dict(heads=(8, 8, 1), hidden=8, lr=5e-3, wd=5e-4, dropout=0.6, epochs=200,
                 bidirect=False, fused=False),
    "pubmed": dict(heads=(8, 8, 1), hidden=8, lr=5e-3, wd=5e-4, dropout=0.6, epochs=200,
                   bidirect=False, fused=False),
    "reddit": dict(heads=(1, 1, 1), hidden=16, epochs=500, bidirect=False, fused=True, **_TUNED),
    "ogbn-arxiv": dict(heads=(4, 4, 4), hidden=16, epochs=500, bidirect=True, fused=True,
                       **_TUNED),
}


def _prepare(name: str, cfg: dict, seed: int, dev: torch.device):
    data = load_node_dataset(name, seed=seed)
    print_data_stats(data)
    t0 = time.perf_counter()
    n = data.num_nodes
    src = torch.from_numpy(np.asarray(data.src, np.int64)).to(dev)
    dst = torch.from_numpy(np.asarray(data.dst, np.int64)).to(dev)
    if cfg["bidirect"]:  # on the device, as from_edges sorts there
        src, dst = transforms.to_bidirected(src, dst, n)
    src, dst = transforms.add_self_loops(src, dst, n)
    g = from_edges(src, dst, n, device=dev)
    del src, dst
    x = torch.from_numpy(np.asarray(data.features, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(data.labels)).to(dev)
    masks = {k: torch.from_numpy(np.asarray(getattr(data, f"{k}_mask"))).to(dev)
             for k in ("train", "val", "test")}
    synchronize(dev)
    return data, g, x, y, masks, time.perf_counter() - t0


def _config(dataset: str, epochs: Optional[int], overrides: dict) -> dict:
    if dataset not in DATASET_CFG:
        raise ValueError(f"unknown dataset {dataset!r}; known: {sorted(DATASET_CFG)}")
    cfg = dict(DATASET_CFG[dataset])
    unknown = set(overrides) - {"lr", "wd", "hidden", "dropout"}
    if unknown:
        raise ValueError(f"unknown overrides {sorted(unknown)}")
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    if epochs is not None:
        cfg["epochs"] = epochs
    return cfg


def run(
    dataset: str = "cora",
    *,
    epochs: Optional[int] = None,
    runs: int = 1,
    eval_acc: bool = False,
    seed: int = 0,
    device: DeviceLike = None,
    num_layers: int = 3,
    profile_epochs: int = 0,
    **overrides,
) -> dict:
    """Train the dataset's GAT ``runs`` times from fresh weights.

    ``overrides`` replace entries of ``DATASET_CFG[dataset]`` (``lr``,
    ``wd``, ``hidden``, ``dropout``). Returns ``{"device", "synthetic",
    "setup_s", "fused", "num_edges", "epoch_s", "epochs_s", "losses",
    "profile", "setup_bytes", "train_peak_bytes"}``: ``losses`` holds each
    run's per-epoch losses, ``epoch_s`` the mean of the timed epochs over all
    runs; on a card, ``setup_bytes`` is the device memory the graph and the
    data hold when training starts and ``train_peak_bytes`` the peak from
    there to the end (``None`` on the CPU).
    """
    cfg = _config(dataset, epochs, overrides)
    heads = tuple(cfg["heads"][:num_layers])
    dev = resolve_device(device)
    data, g, x, y, masks, setup_s = _prepare(dataset, cfg, seed, dev)
    setup_bytes = None
    if dev.type == "cuda":  # the training's own peak, without the graph build's
        setup_bytes = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    logger = Logger(runs)
    dur, losses, profile = [], [], None
    for r in range(runs):
        model = GAT(
            x.shape[1], cfg["hidden"], data.num_classes, heads,
            feat_drop=cfg["dropout"], attn_drop=cfg["dropout"], fused=cfg["fused"],
            device=dev, generator=torch.Generator().manual_seed(seed * 1000 + r),
        )
        opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"], weight_decay=cfg["wd"])
        drop_gen = torch.Generator(device=dev).manual_seed(seed * 1000 + r)

        def step():
            model.train()
            opt.zero_grad(set_to_none=True)
            loss = masked_softmax_ce(model(g, x, generator=drop_gen), y, masks["train"])
            loss.backward()
            opt.step()
            return loss.detach()

        run_losses = []
        for epoch in range(cfg["epochs"]):
            t0 = time.perf_counter()
            run_losses.append(step())
            synchronize(dev)
            if epoch >= 3:
                dur.append(time.perf_counter() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if eval_acc:
                model.eval()
                with torch.no_grad():
                    logits = model(g, x)
                accs = [float(masked_accuracy(logits, y, masks[k])) for k in ("train", "val", "test")]
                logger.add_result(r, accs)
                print("Run {:02d} | Epoch {:05d} | Loss {:.4f} | Train {:.4f} | Val {:.4f} | "
                      "Test {:.4f}".format(r, epoch, float(run_losses[-1]), *accs))
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
        "setup_s": setup_s,
        "fused": cfg["fused"],
        "num_edges": g.num_edges,
        "epoch_s": float(np.mean(dur)) if dur else None,
        "epochs_s": dur,
        "losses": losses,
        "profile": profile,
        "setup_bytes": setup_bytes,
        "train_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def run_sharded(
    dataset: str = "cora",
    shard: int = 2,
    *,
    dist_backend: Optional[str] = None,
    epochs: Optional[int] = None,
    runs: int = 1,
    eval_acc: bool = False,
    seed: int = 0,
    device: str = "cuda",
    num_layers: int = 3,
    **overrides,
) -> dict:
    """``--shard``: the dataset's GAT over ``shard`` ranks
    (``sharded.run_sharded``; -1 takes every card)."""
    cfg = _config(dataset, epochs, overrides)
    shard, backend = sharded.resolve(shard, dist_backend, device)
    data = load_node_dataset(dataset, seed=seed)
    print_data_stats(data)
    return sharded.run_sharded(
        "gat", data, k=shard, backend=backend,
        device=device, epochs=cfg["epochs"], runs=runs, eval_acc=eval_acc, seed=seed,
        hidden=cfg["hidden"], lr=cfg["lr"], wd=cfg["wd"], heads=cfg["heads"][:num_layers],
        bidirect=cfg["bidirect"])


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description="GAT (dgl_tpu_torch)")
    parser.add_argument("--dataset", type=str, default="cora", choices=sorted(DATASET_CFG))
    parser.add_argument("--num-layers", type=int, default=3)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--weight-decay", type=float, default=None)
    parser.add_argument("--num-hidden", type=int, default=None)
    parser.add_argument("--dropout", type=float, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--eval", action="store_true",
                        help="If not set, we will only do the training part.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile", type=int, default=0, metavar="EPOCHS",
                        help="profile this many further epochs after the last run (stderr)")
    parser.add_argument("--shard", type=int, default=0,
                        help="edge-partitioned training over this many ranks (boundary-halo "
                             "exchange with the edge softmax across shards); 0 = off, "
                             "-1 = every card")
    parser.add_argument("--dist-backend", choices=sharded.BACKENDS, default=None,
                        help="--shard's backend: nccl (one rank a card; default on cuda) or "
                             "gloo (default on cpu; ranks sharing a card)")
    args = parser.parse_args(argv)
    print(args)
    overrides = dict(lr=args.lr, wd=args.weight_decay, hidden=args.num_hidden,
                     dropout=args.dropout)
    if args.shard:
        return run_sharded(args.dataset, args.shard, dist_backend=args.dist_backend,
                           epochs=args.epochs, runs=args.runs, eval_acc=args.eval, seed=args.seed,
                           device=args.device, num_layers=args.num_layers, **overrides)
    res = run(args.dataset, epochs=args.epochs, runs=args.runs, eval_acc=args.eval,
              seed=args.seed, device=args.device, num_layers=args.num_layers,
              profile_epochs=args.profile, **overrides)
    if res["profile"] is not None:
        print(f"# profile={json.dumps(res['profile'])}", file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
