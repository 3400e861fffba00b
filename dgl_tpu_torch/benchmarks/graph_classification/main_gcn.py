"""Graph classification with GCN on one card: ENZYMES and the OGB molecule
datasets in one driver.

Counterpart of ``benchmarks/graph_classification/main_gcn.py`` (the
reference's ``main_dgl_enzymes_gcn.py``, ``main_dgl_molhiv_gcn.py`` and
``main_dgl_ppa_gcn.py``): ENZYMES 4 layers, hidden 128; the mol datasets 5
layers, hidden 256; ppa evaluates in batches of 512. The split is the
reference's random 80/10/10 with numpy seed 42 (OGB's own split when real
data ships one). Losses: nll on log-softmax (ENZYMES), BCE with ROC-AUC
(molhiv), cross-entropy (ppa); Adam(1e-3). Batches are collated on the host
ahead of the card (``sampling/dataloader.py``) and reshuffled every epoch.
Every epoch ends in a device synchronise; epochs from the third on
(1-based) are timed.

    python -m dgl_tpu_torch.benchmarks.graph_classification.main_gcn --dataset ogbg-molhiv
        [--batch_size 64] [--epochs N] [--runs R] [--eval] [--lowering fused|scatter]
        [--num-graphs G] [--device cuda] [--profile STEPS]

Prints the reference's lines (``Training time/epoch``, with ``--eval`` the
``Run: …, Epoch: …`` lines and the Logger statistics); ``--profile`` runs
that many further train steps (from a fresh shuffle of the train graphs)
under ``torch.profiler`` and prints the device time by kernel, per step, as
one JSON line on stderr. Not ported: ``--scan-steps`` and
``--fetch-every`` (workarounds for the JAX package's host link).
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
import torch.nn.functional as F

from ...data import load_graph_dataset
from ...device import DeviceLike, resolve_device
from ...models import GCNGraphClassifier, GCNMolClassifier
from ...sampling import GraphBatchLoader
from ...train.timing import device_profile
from ..common import Logger, roc_auc, softmax_ce_int

__all__ = ["DATASETS", "make_train_step", "run", "parser", "main"]

DATASETS = ("ENZYMES", "ogbg-molhiv", "ogbg-ppa")


def make_train_step(model, opt, dataset: str, generator: torch.Generator) -> Callable:
    """One optimiser step on a batch on the model's device; returns the loss
    on the device, so the step makes no host sync."""
    is_mol = dataset != "ENZYMES"

    def step(batch, nf, ef, y):
        model.train()
        opt.zero_grad(set_to_none=True)
        out = model(batch, nf, ef, generator=generator) if is_mol else model(
            batch, nf, generator=generator)
        if dataset == "ogbg-molhiv":
            loss = F.binary_cross_entropy_with_logits(out[:, 0], y.to(out.dtype))
        else:
            loss = softmax_ce_int(out, y).mean()
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def _split(data):
    if data.splits is not None:
        return data.splits["train"], data.splits["valid"], data.splits["test"]
    n = len(data.graphs)
    indices = np.arange(n)
    np.random.RandomState(42).shuffle(indices)  # np.random.seed(42); np.random.shuffle
    return indices[: int(n * 0.8)], indices[int(n * 0.8): int(n * 0.9)], indices[int(n * 0.9):]


def run(
    dataset: str = "ENZYMES",
    *,
    batch_size: int = 64,
    epochs: int = 10,
    runs: int = 1,
    eval_acc: bool = False,
    lowering: str = "fused",
    num_graphs: Optional[int] = None,
    num_layers: Optional[int] = None,
    hidden: Optional[int] = None,
    dropout: float = 0.5,
    lr: float = 1e-3,
    eval_batch_size: Optional[int] = None,
    log_steps: int = 1,
    device: DeviceLike = None,
    profile_steps: int = 0,
) -> dict:
    """Train the dataset's GCN ``runs`` times from fresh weights (seeded by
    the run's index).

    Returns ``{"device", "synthetic", "load_s", "num_graphs", "steps",
    "epoch_s", "epochs_s", "losses", "profile"}``: ``steps`` the train steps
    of all runs, profiled steps included; ``profile`` the last run's
    ``profile_steps`` further steps under the profiler, per step; ``losses`` each run's per-epoch
    mean training loss; ``epoch_s`` the mean of the timed epochs over all
    runs.
    """
    if dataset not in DATASETS:
        raise ValueError(f"unknown dataset {dataset!r}; known: {list(DATASETS)}")
    is_mol = dataset != "ENZYMES"
    num_layers = num_layers or (5 if is_mol else 4)
    hidden = hidden or (256 if is_mol else 128)
    eval_batch_size = eval_batch_size or (512 if dataset == "ogbg-ppa" else 2048)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    data = load_graph_dataset(dataset, num_graphs=num_graphs)
    load_s = time.perf_counter() - t0
    if data.synthetic:
        print("  (synthetic fallback data — structural stats matched to the real dataset)")
    tr, va, te = _split(data)

    def loader(idx, bs, shuffle):
        return GraphBatchLoader(
            [data.graphs[i] for i in idx], [data.node_feats[i] for i in idx], data.labels[idx],
            bs, edge_feats=[data.edge_feats[i] for i in idx] if is_mol else None,
            shuffle=shuffle, device=dev)

    train_loader = loader(tr, batch_size, True)
    eval_loaders = [loader(idx, eval_batch_size, False) for idx in (tr, va, te)]

    def evaluate(model, ldr):
        ys, ps = [], []
        model.eval()
        with torch.no_grad():
            for batch, nf, ef, y in ldr:
                out = model(batch, nf, ef) if is_mol else model(batch, nf)
                ys.append(y.cpu().numpy())
                ps.append(out.cpu().numpy())
        y, p = np.concatenate(ys), np.concatenate(ps)
        if dataset == "ogbg-molhiv":
            return roc_auc(p[:, 0], y)
        return float((p.argmax(axis=1) == y).mean())

    logger = Logger(runs, scale=1.0 if dataset.startswith("ogbg") else 100.0)
    dur, losses, profile, steps = [], [], None, 0
    for r in range(runs):
        gen = torch.Generator().manual_seed(r)
        if is_mol:
            model = GCNMolClassifier(
                hidden, 1 if dataset == "ogbg-molhiv" else data.num_classes, num_layers, dropout,
                node_encoder="atom" if dataset == "ogbg-molhiv" else "embed",
                edge_encoder="bond" if dataset == "ogbg-molhiv" else 7,
                lowering=lowering, device=dev, generator=gen)
        else:
            model = GCNGraphClassifier(data.node_feats[0].shape[1], hidden, data.num_classes,
                                       num_layers, dropout, lowering=lowering, device=dev,
                                       generator=gen)
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        step = make_train_step(model, opt, dataset, torch.Generator(device=dev).manual_seed(r))

        def train_epoch():
            nonlocal steps
            total = torch.zeros((), device=dev)
            for batch, nf, ef, y in train_loader:
                total = total + step(batch, nf, ef, y)
                steps += 1
            return total / len(train_loader)

        run_losses = []
        for epoch in range(1, epochs + 1):
            t0 = time.perf_counter()
            loss = float(train_epoch())  # the epoch's device synchronise
            run_losses.append(loss)
            if epoch >= 3:
                dur.append(time.perf_counter() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if not eval_acc:
                continue
            accs = [evaluate(model, ldr) for ldr in eval_loaders]
            logger.add_result(r, accs)
            if epoch % log_steps == 0:
                print(f"Run: {r + 1:02d}, Epoch: {epoch:02d}, Loss: {loss:.4f}, "
                      f"Train: {accs[0] * 100:.4f}% Valid: {accs[1] * 100:.4f}% "
                      f"Test: {accs[2] * 100:.4f}%")
        if not all(math.isfinite(v) for v in run_losses):
            raise FloatingPointError(f"non-finite training loss in run {r}: {run_losses}")
        losses.append(run_losses)
        if eval_acc:
            logger.print_statistics(r)
        if profile_steps and r == runs - 1:
            # a window of steps, not an epoch: the profiler's cost grows with
            # its events, and an epoch of molhiv holds ~500 steps
            def epochs_of_batches():
                while True:
                    yield from train_loader

            batches = epochs_of_batches()

            def train_step():
                nonlocal steps
                step(*next(batches))
                steps += 1

            profile = device_profile(train_step, profile_steps, dev, unit="step")
            batches.close()  # ends the open epoch and its prefetch thread
    if eval_acc:
        logger.print_statistics()
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "synthetic": data.synthetic,
        "load_s": load_s,
        "num_graphs": len(data.graphs),
        "steps": steps,
        "epoch_s": float(np.mean(dur)) if dur else None,
        "epochs_s": dur,
        "losses": losses,
        "profile": profile,
    }


def parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Graph classification GCN (dgl_tpu_torch)")
    parser.add_argument("--dataset", type=str, default="ENZYMES", choices=list(DATASETS))
    parser.add_argument("--log_steps", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_layers", type=int, default=None)
    parser.add_argument("--hidden_size", type=int, default=None)
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--eval", action="store_true",
                        help="If not set, we will only do the training part.")
    parser.add_argument("--eval_batch_size", type=int, default=None,
                        help="2048, or 512 for ogbg-ppa")
    parser.add_argument("--lowering", choices=("fused", "scatter"), default="fused",
                        help="fused: K1 and K2; scatter: index_add_ sums (the PyG twin)")
    parser.add_argument("--num-graphs", type=int, default=None,
                        help="the dataset's first G graphs (a cut of its size)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile", type=int, default=0, metavar="STEPS",
                        help="profile this many further train steps after the last run (stderr)")
    return parser


def main(argv: Optional[list] = None) -> dict:
    args = parser().parse_args(argv)
    print(args)
    res = run(args.dataset, batch_size=args.batch_size, epochs=args.epochs, runs=args.runs,
              eval_acc=args.eval, lowering=args.lowering, num_graphs=args.num_graphs,
              num_layers=args.num_layers, hidden=args.hidden_size, dropout=args.dropout,
              lr=args.lr, eval_batch_size=args.eval_batch_size, log_steps=args.log_steps,
              device=args.device, profile_steps=args.profile)
    if res["profile"] is not None:
        print(f"# profile={json.dumps(res['profile'])}", file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
