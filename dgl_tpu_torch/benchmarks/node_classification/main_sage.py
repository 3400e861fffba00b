"""Full-graph GraphSAGE node classification on one card.

Counterpart of ``benchmarks/node_classification/main_sage.py`` (the
reference's ``main_dgl_{citation,reddit,arxiv,product}_sage.py``), with its
per-dataset table: cora, pubmed and reddit 2 layers, hidden 16, wd 5e-4, 200
epochs; ogbn-arxiv 3 layers, hidden 256, BatchNorm, bidirected, 500 epochs;
ogbn-products 3 layers, hidden 64, bidirected, 300 epochs. No self-loops.
The loss is masked cross-entropy, the optimiser Adam with coupled L2
(``torch.optim.Adam(weight_decay=wd)``). Layer 1's aggregation of the
constant inputs, ``x_agg``, is computed once before training (one K1 launch)
unless ``--no-precompute``. Every epoch ends in a device synchronise; epochs
from the fourth on are timed.

    python -m dgl_tpu_torch.benchmarks.node_classification.main_sage --dataset ogbn-products
        [--epochs N] [--runs R] [--eval] [--no-precompute] [--lowering fused|scatter]
        [--aggr mean|sum] [--scale S] [--device cuda] [--profile EPOCHS]

Prints the reference's lines (``Training time/epoch``, with ``--eval`` the
``Run … | Epoch …`` lines and ``Final Train`` / ``Final Test``);
``--profile`` runs that many further epochs under ``torch.profiler`` and
prints the device time by kernel as one JSON line on stderr.
``--lowering scatter`` is the PyG twin (``ops/spmm.py``): no K1 runs.

Not ported: ``--lane-kernel``, ``--lane-force``, ``--scan-epochs``,
``--bf16-messages``, ``DGL_TPU_MSG_BUDGET_GB``, the locality reorder and the
disk caches of the graph and of ``x_agg`` (TPU workarounds: K1 takes the
whole graph in one launch and never builds an (E, D) message); ``--shard``
and ``--ckpt-dir`` raise ``NotImplementedError`` (slice I), which adds
``--ckpt-every`` with checkpointing.
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
from ...models import GraphSAGE
from ...ops import gspmm
from ...train.timing import device_profile, synchronize
from ..common import Logger, masked_accuracy, masked_softmax_ce, print_data_stats

__all__ = ["DATASET_CFG", "run", "main"]

DATASET_CFG = {
    "cora": dict(layers=2, hidden=16, lr=1e-2, wd=5e-4, dropout=0.5, epochs=200, bn=False, bidirect=False),
    "pubmed": dict(layers=2, hidden=16, lr=1e-2, wd=5e-4, dropout=0.5, epochs=200, bn=False, bidirect=False),
    "reddit": dict(layers=2, hidden=16, lr=1e-2, wd=5e-4, dropout=0.5, epochs=200, bn=False, bidirect=False),
    "ogbn-arxiv": dict(layers=3, hidden=256, lr=1e-2, wd=0.0, dropout=0.5, epochs=500, bn=True, bidirect=True),
    "ogbn-products": dict(layers=3, hidden=64, lr=1e-2, wd=0.0, dropout=0.5, epochs=300, bn=False, bidirect=True),
}

_LATER_FLAGS = {"shard": "slice I (distribution)", "ckpt_dir": "slice I (checkpointing)"}


def _prepare(name: str, cfg: dict, seed: int, scale: float, dev: torch.device):
    t0 = time.perf_counter()
    data = load_node_dataset(name, seed=seed, scale=scale)
    load_s = time.perf_counter() - t0
    print_data_stats(data)
    t0 = time.perf_counter()
    n = data.num_nodes
    src = torch.from_numpy(np.asarray(data.src, np.int64)).to(dev)
    dst = torch.from_numpy(np.asarray(data.dst, np.int64)).to(dev)
    if cfg["bidirect"]:  # on the device, as from_edges sorts there
        src, dst = transforms.to_bidirected(src, dst, n)
    g = from_edges(src, dst, n, device=dev)
    del src, dst
    x = torch.from_numpy(np.asarray(data.features, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(data.labels)).to(dev)
    masks = {k: torch.from_numpy(np.asarray(getattr(data, f"{k}_mask"))).to(dev)
             for k in ("train", "val", "test")}
    synchronize(dev)
    return data, g, x, y, masks, load_s, time.perf_counter() - t0


def run(
    dataset: str = "cora",
    *,
    epochs: Optional[int] = None,
    runs: int = 1,
    eval_acc: bool = False,
    seed: int = 0,
    device: DeviceLike = None,
    precompute: bool = True,
    lowering: str = "fused",
    aggr: str = "mean",
    scale: float = 1.0,
    profile_epochs: int = 0,
    **overrides,
) -> dict:
    """Train the dataset's GraphSAGE ``runs`` times from fresh weights, each
    seeded ``seed * 1000 + run``.

    ``overrides`` replace entries of ``DATASET_CFG[dataset]`` (``lr``,
    ``wd``, ``hidden``, ``layers``, ``dropout``). Returns ``{"device",
    "synthetic", "load_s", "setup_s", "precompute_s", "num_edges",
    "epoch_s", "epochs_s", "losses", "profile", "setup_bytes",
    "train_peak_bytes"}``: ``load_s`` the dataset's generation or loading,
    ``setup_s`` the copies to the device, the bidirecting and both CSR
    sorts (on the device) and both row splits (on the host),
    ``precompute_s`` the hoisted ``x_agg`` (None
    without it); ``losses`` each run's per-epoch losses, ``epoch_s`` the
    mean of the timed epochs over all runs; on a card ``setup_bytes`` is
    the device memory the graph, the data and ``x_agg`` hold when training
    starts and ``train_peak_bytes`` the peak from there to the end (None on
    the CPU).
    """
    if dataset not in DATASET_CFG:
        raise ValueError(f"unknown dataset {dataset!r}; known: {sorted(DATASET_CFG)}")
    cfg = dict(DATASET_CFG[dataset])
    unknown = set(overrides) - {"lr", "wd", "hidden", "layers", "dropout"}
    if unknown:
        raise ValueError(f"unknown overrides {sorted(unknown)}")
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    if epochs is not None:
        cfg["epochs"] = epochs
    dev = resolve_device(device)
    data, g, x, y, masks, load_s, setup_s = _prepare(dataset, cfg, seed, scale, dev)

    x_agg, precompute_s = None, None
    if precompute:
        t0 = time.perf_counter()
        with torch.no_grad():
            x_agg = gspmm(g, "copy_u", aggr, x=x, lowering=lowering)
        synchronize(dev)
        precompute_s = time.perf_counter() - t0
    setup_bytes = None
    if dev.type == "cuda":  # the training's own peak, without the graph build's
        setup_bytes = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    logger = Logger(runs)
    dur, losses, profile = [], [], None
    for r in range(runs):
        model = GraphSAGE(
            x.shape[1], cfg["hidden"], data.num_classes, num_layers=cfg["layers"], aggr=aggr,
            dropout=cfg["dropout"], batch_norm=cfg["bn"], lowering=lowering, device=dev,
            generator=torch.Generator().manual_seed(seed * 1000 + r),
        )
        opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"], weight_decay=cfg["wd"])
        drop_gen = torch.Generator(device=dev).manual_seed(seed * 1000 + r)

        def step():
            model.train()
            opt.zero_grad(set_to_none=True)
            logits = model(g, x, x_agg=x_agg, generator=drop_gen)
            loss = masked_softmax_ce(logits, y, masks["train"])
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
                    logits = model(g, x, x_agg=x_agg)
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
        "load_s": load_s,
        "setup_s": setup_s,
        "precompute_s": precompute_s,
        "num_edges": g.num_edges,
        "epoch_s": float(np.mean(dur)) if dur else None,
        "epochs_s": dur,
        "losses": losses,
        "profile": profile,
        "setup_bytes": setup_bytes,
        "train_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description="GraphSAGE (dgl_tpu_torch)")
    parser.add_argument("--dataset", type=str, default="cora", choices=sorted(DATASET_CFG))
    parser.add_argument("--dropout", type=float, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--n-hidden", type=int, default=None)
    parser.add_argument("--num-layers", type=int, default=None)
    parser.add_argument("--aggr", type=str, choices=["sum", "mean"], default="mean")
    parser.add_argument("--weight-decay", type=float, default=None)
    parser.add_argument("--eval", action="store_true",
                        help="If not set, we will only do the training part.")
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-precompute", action="store_true",
                        help="aggregate layer 1's constant inputs in every step")
    parser.add_argument("--lowering", choices=("fused", "scatter"), default="fused",
                        help="fused: K1; scatter: index_select + index_add_ (the PyG twin)")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="shrink factor for the synthetic data (rehearsals)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile", type=int, default=0, metavar="EPOCHS",
                        help="profile this many further epochs after the last run (stderr)")
    parser.add_argument("--shard", type=int, default=0, help="not ported: slice I")
    parser.add_argument("--ckpt-dir", type=str, default=None, help="not ported: slice I")
    args = parser.parse_args(argv)
    for flag, slice_ in _LATER_FLAGS.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is ported in {slice_}")
    print(args)
    res = run(args.dataset, epochs=args.epochs, runs=args.runs, eval_acc=args.eval,
              seed=args.seed, device=args.device, precompute=not args.no_precompute,
              lowering=args.lowering, aggr=args.aggr, scale=args.scale,
              profile_epochs=args.profile, lr=args.lr, wd=args.weight_decay,
              hidden=args.n_hidden, layers=args.num_layers, dropout=args.dropout)
    if res["profile"] is not None:
        print(f"# profile={json.dumps(res['profile'])}", file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
