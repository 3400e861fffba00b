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
        [--aggr mean|sum] [--bf16-messages] [--scale S] [--device cuda] [--profile EPOCHS]
        [--shard K [--dist-backend nccl|gloo]] [--ckpt-dir DIR [--ckpt-every N]]

Prints the reference's lines (``Training time/epoch``, with ``--eval`` the
``Run … | Epoch …`` lines and ``Final Train`` / ``Final Test``);
``--profile`` runs that many further epochs under ``torch.profiler`` and
prints the device time by kernel as one JSON line on stderr.
``--lowering scatter`` is the PyG twin (``ops/spmm.py``): no K1 runs.
``--bf16-messages`` gives every layer ``msg_dtype=torch.bfloat16``, the JAX
driver's flag: each SpMM reads its rows as bfloat16 and sums them in float32
(K1's bfloat16 instantiation forward; the backward's cotangent stays
float32); float32 is the default, DGL's precision.

``--shard k`` trains over k ranks with the boundary-halo exchange, as the
JAX driver's ``run_sharded`` does (``sharded.py``: the ``lp`` relabel, the
plan and its ``shard plan:`` line, ``parallel/halo_train.py``'s HaloSAGE,
dropout on every layer's input); ``--dist-backend`` is ``nccl`` (one rank a
card; the default on ``cuda``) or ``gloo`` (the CPU's default, and ranks
sharing one card). ``--shard -1`` takes every card.

``--ckpt-dir`` saves the first run's state (model, optimiser, the dropout
generator, the epoch) every ``--ckpt-every`` epochs and resumes from the
latest checkpoint there (``train/checkpoint.py``); the resumed epochs give
the losses of an uninterrupted run, bit for bit.

Not ported: ``--lane-kernel``, ``--lane-force``, ``--scan-epochs``,
``DGL_TPU_MSG_BUDGET_GB``, the locality reorder and the disk caches of the
graph and of ``x_agg`` (TPU workarounds: K1 takes the whole graph in one
launch and never builds an (E, D) message).
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
from ...train.checkpoint import CheckpointManager
from ...train.timing import device_profile, synchronize
from ..common import Logger, masked_accuracy, masked_softmax_ce, print_data_stats
from . import sharded

__all__ = ["DATASET_CFG", "run", "run_sharded", "parser", "main"]

DATASET_CFG = {
    "cora": dict(layers=2, hidden=16, lr=1e-2, wd=5e-4, dropout=0.5, epochs=200, bn=False, bidirect=False),
    "pubmed": dict(layers=2, hidden=16, lr=1e-2, wd=5e-4, dropout=0.5, epochs=200, bn=False, bidirect=False),
    "reddit": dict(layers=2, hidden=16, lr=1e-2, wd=5e-4, dropout=0.5, epochs=200, bn=False, bidirect=False),
    "ogbn-arxiv": dict(layers=3, hidden=256, lr=1e-2, wd=0.0, dropout=0.5, epochs=500, bn=True, bidirect=True),
    "ogbn-products": dict(layers=3, hidden=64, lr=1e-2, wd=0.0, dropout=0.5, epochs=300, bn=False, bidirect=True),
}

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


def _config(dataset: str, epochs: Optional[int], overrides: dict) -> dict:
    if dataset not in DATASET_CFG:
        raise ValueError(f"unknown dataset {dataset!r}; known: {sorted(DATASET_CFG)}")
    cfg = dict(DATASET_CFG[dataset])
    unknown = set(overrides) - {"lr", "wd", "hidden", "layers", "dropout"}
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
    precompute: bool = True,
    lowering: str = "fused",
    aggr: str = "mean",
    bf16_messages: bool = False,
    scale: float = 1.0,
    profile_epochs: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    **overrides,
) -> dict:
    """Train the dataset's GraphSAGE ``runs`` times from fresh weights, each
    seeded ``seed * 1000 + run``; with ``ckpt_dir``, the first run resumes
    from and saves to checkpoints there (see the module docstring), and its
    ``losses`` start at the epoch it resumed at. ``bf16_messages``: the
    layers' ``msg_dtype`` is bfloat16 (``x_agg`` stays float32).

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
    cfg = _config(dataset, epochs, overrides)
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

    ckpt = None if ckpt_dir is None else CheckpointManager(ckpt_dir, save_interval=ckpt_every)
    logger = Logger(runs)
    dur, losses, profile = [], [], None
    for r in range(runs):
        model = GraphSAGE(
            x.shape[1], cfg["hidden"], data.num_classes, num_layers=cfg["layers"], aggr=aggr,
            dropout=cfg["dropout"], batch_norm=cfg["bn"],
            msg_dtype=torch.bfloat16 if bf16_messages else None, lowering=lowering, device=dev,
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

        def ckpt_state(epoch):
            return {"model": model.state_dict(), "optimizer": opt.state_dict(),
                    "dropout_rng": drop_gen.get_state(), "epoch": epoch}

        start = 0
        if ckpt is not None and r == 0:
            state, start = ckpt.restore_or(ckpt_state(-1))
            if start:
                model.load_state_dict(state["model"])
                opt.load_state_dict(state["optimizer"])
                drop_gen.set_state(state["dropout_rng"])
                print(f"resumed from checkpoint at epoch {start}")
        run_losses = []
        for epoch in range(start, cfg["epochs"]):
            t0 = time.perf_counter()
            run_losses.append(step())
            synchronize(dev)
            if epoch >= 3:
                dur.append(time.perf_counter() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if ckpt is not None and r == 0:
                ckpt.save(epoch, ckpt_state(epoch))
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
    if ckpt is not None:
        ckpt.close()
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
    aggr: str = "mean",
    scale: float = 1.0,
    **overrides,
) -> dict:
    """``--shard``: the dataset's GraphSAGE over ``shard`` ranks
    (``sharded.run_sharded``; -1 takes every card)."""
    cfg = _config(dataset, epochs, overrides)
    shard, backend = sharded.resolve(shard, dist_backend, device)
    data = load_node_dataset(dataset, seed=seed, scale=scale)
    print_data_stats(data)
    return sharded.run_sharded(
        "sage", data, k=shard, backend=backend,
        device=device, epochs=cfg["epochs"], runs=runs, eval_acc=eval_acc, seed=seed,
        hidden=cfg["hidden"], lr=cfg["lr"], wd=cfg["wd"], layers=cfg["layers"],
        dropout=cfg["dropout"], aggr=aggr, bidirect=cfg["bidirect"])


def parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GraphSAGE (dgl_tpu_torch)")
    parser.add_argument("--dataset", type=str, default="cora", choices=sorted(DATASET_CFG))
    parser.add_argument("--dropout", type=float, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--n-hidden", type=int, default=None)
    parser.add_argument("--num-layers", type=int, default=None)
    parser.add_argument("--aggr", type=str, choices=["sum", "mean"], default="mean")
    parser.add_argument("--weight-decay", type=float, default=None)
    parser.add_argument("--bf16-messages", action="store_true",
                        help="bf16 neighbour messages (the SpMM reads bf16 rows; f32 sums)")
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
    parser.add_argument("--shard", type=int, default=0,
                        help="edge-partitioned training over this many ranks (boundary-halo "
                             "exchange); 0 = off, -1 = every card")
    parser.add_argument("--dist-backend", choices=sharded.BACKENDS, default=None,
                        help="--shard's backend: nccl (one rank a card; default on cuda) or "
                             "gloo (default on cpu; ranks sharing a card)")
    parser.add_argument("--ckpt-dir", type=str, default=None,
                        help="checkpoint and resume the first run in this directory")
    parser.add_argument("--ckpt-every", type=int, default=50)
    return parser


def main(argv: Optional[list] = None) -> dict:
    args = parser().parse_args(argv)
    print(args)
    overrides = dict(lr=args.lr, wd=args.weight_decay, hidden=args.n_hidden,
                     layers=args.num_layers, dropout=args.dropout)
    if args.shard:
        if args.bf16_messages:
            raise ValueError("--bf16-messages applies to one card's run: the sharded "
                             "models take no msg_dtype, as the JAX package's do not")
        return run_sharded(args.dataset, args.shard, dist_backend=args.dist_backend,
                           epochs=args.epochs, runs=args.runs, eval_acc=args.eval, seed=args.seed,
                           device=args.device, aggr=args.aggr, scale=args.scale, **overrides)
    res = run(args.dataset, epochs=args.epochs, runs=args.runs, eval_acc=args.eval,
              seed=args.seed, device=args.device, precompute=not args.no_precompute,
              lowering=args.lowering, aggr=args.aggr, bf16_messages=args.bf16_messages,
              scale=args.scale,
              profile_epochs=args.profile, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              **overrides)
    if res["profile"] is not None:
        print(f"# profile={json.dumps(res['profile'])}", file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
