"""Cluster-batched SAGE or GAT node classification on one card.

Counterpart of ``benchmarks/sampling/cluster_sage.py`` (the reference's
``ogbn-product/cluster-sage/dgl/main.py`` and ``cluster-gat/dgl/main.py``):
ogbn-products, ``--psize 15000`` parts cached on disk, 32 parts a step, 3
layers of hidden 256 (GAT: 4 heads of 64, the last layer 1 head), lr 0.01,
dropout 0.5, Adam. Each epoch ``ClusterIter`` regroups the parts
(``sampling/cluster.py``: the subgraph and its graphs on the host in a
prefetch thread, the feature gather by P1 on the card); a batch without
training nodes is skipped on the host (``main.py:138``). A step is the
forward on the batch's graph, masked cross-entropy, backward and Adam, with
no read from the card; every epoch ends in a device synchronise, and epochs
from the fourth on are timed (``Training time/epoch``). SAGE aggregates with
K1, GAT runs the fused form (K3), in training and in the full-graph
evaluation on the card (``--eval``: the ``Run .. | Epoch ..`` lines every
epoch and the Logger's statistics).

    python -m dgl_tpu_torch.benchmarks.sampling.cluster_sage [--model sage|gat]
        [--dataset ogbn-products] [--n-epochs N] [--part-method metis|lp|random]
        [--eval] [--save-pred PATH] [--runs R] [--device cuda] [--scale S]
        [--profile STEPS]

``--profile STEPS`` runs that many further steps, the loader included,
under ``torch.profiler`` (JSON on stderr). Not ported: ``--freeze-clusters``
(one frozen grouping, a workaround for the TPU's host link; the reference
regroups every epoch) raises ``NotImplementedError``.
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

from ...data import data_root, load_node_dataset
from ...device import resolve_device
from ...graph import from_edges
from ...models import GAT, GraphSAGE
from ...sampling.cluster import ClusterIter
from ...train.timing import PhaseTimer, device_profile, synchronize
from ..common import Logger, masked_accuracy, masked_softmax_ce, print_data_stats

__all__ = ["parser", "run", "main", "make_model", "make_train_step", "endless"]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Cluster-GCN style SAGE/GAT (dgl_tpu_torch)")
    p.add_argument("--gpu", type=int, default=0, help="kept for the reference's CLI; "
                   "--device picks the card")
    p.add_argument("--dataset", type=str, default="ogbn-products")
    p.add_argument("--model", type=str, default="sage", choices=["sage", "gat"])
    p.add_argument("--n-epochs", type=int, default=30)
    p.add_argument("--n-hidden", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=3)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--psize", type=int, default=15000)
    p.add_argument("--batch-size", type=int, default=32, help="partitions per step")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, default=1.0,
                   help="shrink factor for the synthetic data (rehearsals)")
    p.add_argument("--part-method", type=str, default="metis", choices=["metis", "lp", "random"],
                   help="metis: the native multilevel partitioner; lp: label propagation; "
                        "random: the baseline")
    p.add_argument("--freeze-clusters", action="store_true",
                   help="not ported: a workaround for the TPU's host link")
    p.add_argument("--save-pred", type=str, default=None,
                   help="np.savetxt the final predictions here (main.py:172-173)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile", type=int, default=0, metavar="STEPS",
                   help="profile this many further steps after training (stderr)")
    return p


def make_model(args, in_feats: int, classes: int, dev: torch.device, seed: int) -> torch.nn.Module:
    """The driver's SAGE (mean, relu, dropout on the last layer's input) or
    fused GAT (heads (H,) * (L - 1) + (1,) of hidden // H, elu)."""
    gen = torch.Generator().manual_seed(seed)
    if args.model == "sage":
        return GraphSAGE(in_feats, args.n_hidden, classes, num_layers=args.n_layers,
                         dropout=args.dropout, device=dev, generator=gen)
    heads = (args.num_heads,) * (args.n_layers - 1) + (1,)
    return GAT(in_feats, args.n_hidden // args.num_heads, classes, heads,
               feat_drop=args.dropout, attn_drop=args.dropout, fused=True, device=dev,
               generator=gen)


def make_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                    generator: torch.Generator):
    """``step(batch) -> loss`` (left on the device): the forward on the
    batch's graph with dropout masks from ``generator``, masked
    cross-entropy over its training nodes, backward and an optimiser step."""
    def step(batch):
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(batch.graph, batch.x, generator=generator)
        loss = masked_softmax_ce(logits, batch.y, batch.mask)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def endless(cluster_iter: ClusterIter):
    """Batch after batch over as many epochs as asked for (profiling); close
    it to stop the loader's thread."""
    while True:
        yield from cluster_iter


def run(args: argparse.Namespace) -> dict:
    """Train as the reference's cluster driver does, printing its lines.

    Returns ``{"device", "synthetic", "load_s", "setup_s", "partition",
    "steps", "batches", "steps_per_epoch", "epochs_s", "epoch_s", "phases_s",
    "collate_ms", "max_batch_nodes", "max_batch_edges", "losses", "accs",
    "profile", "setup_bytes", "train_peak_bytes", "eval_peak_bytes"}``:
    ``setup_s`` the partition (or its cache), the extractor and the copies
    to the card; ``batches`` the batches taken from the iterator (skipped
    ones, ``first()`` and the profiled steps' included: one P1 each); ``phases_s`` per epoch the host's seconds waiting for
    batches (``load``), enqueueing steps (``forward_backward``) and in the
    epoch's closing synchronise (``sync``); ``collate_ms`` each batch's
    host collation in the prefetch thread; on a card ``setup_bytes`` the
    device memory held when training starts, ``train_peak_bytes`` the peak
    of the training (evaluations left out), ``eval_peak_bytes`` that of
    the evaluations (None on the CPU).
    """
    if args.freeze_clusters:
        raise NotImplementedError("--freeze-clusters collates one grouping for all epochs to hide "
                                  "the TPU's host link; it is a TPU workaround and is not ported")
    print(args)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    data = load_node_dataset(args.dataset, seed=args.seed, scale=args.scale)
    load_s = time.perf_counter() - t0
    print_data_stats(data)
    t0 = time.perf_counter()
    cluster_iter = ClusterIter(
        f"{args.dataset}_s{args.scale}", data.src, data.dst, data.num_nodes, data.features,
        data.labels, data.train_mask, args.psize, args.batch_size, method=args.part_method,
        seed=args.seed, cache_dir=data_root(), device=dev)
    # the whole graph serves only the evaluation and --save-pred (main.py:91-97)
    g_full = masks = None
    if args.eval or args.save_pred:
        g_full = from_edges(data.src, data.dst, data.num_nodes, device=dev)
        masks = {k: torch.from_numpy(np.asarray(getattr(data, f"{k}_mask"))).to(dev)
                 for k in ("train", "val", "test")}
    x_full, y_full = cluster_iter.features, cluster_iter.labels
    synchronize(dev)
    setup_s = time.perf_counter() - t0
    on_card = dev.type == "cuda"
    setup_bytes = torch.cuda.memory_allocated(dev) if on_card else None
    train_peak = eval_peak = 0

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if on_card else 0

    logger = Logger(args.runs)
    dur, losses, accs, phases = [], [], [], []
    n_steps = n_batches = steps_per_epoch = 0
    max_nodes = max_edges = 0
    for r in range(args.runs):
        model = make_model(args, x_full.shape[1], data.num_classes, dev, args.seed * 1000 + r)
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=args.lr),
                               torch.Generator(device=dev).manual_seed(args.seed * 1000 + r))
        cluster_iter.first()  # the JAX driver's model.init batch: the same stream after it
        n_batches += 1

        def evaluate():
            model.eval()
            with torch.no_grad():
                return model(g_full, x_full)

        run_losses = []
        for epoch in range(args.n_epochs):
            reset_peak()
            timer = PhaseTimer(dev)
            t0 = time.perf_counter()
            loss, n = None, 0
            batches = iter(cluster_iter)
            while True:
                with timer.phase("load", sync=False):
                    batch = next(batches, None)
                if batch is None:
                    break
                n += 1
                max_nodes = max(max_nodes, batch.x.shape[0])
                max_edges = max(max_edges, batch.graph.num_edges)
                if not batch.has_train:
                    continue  # no train nodes in this cluster batch (main.py:138)
                with timer.phase("forward_backward", sync=False):
                    loss = step(batch)
                run_losses.append(loss)
                n_steps += 1
            with timer.phase("sync"):
                pass  # the epoch's one device synchronise
            steps_per_epoch = n
            n_batches += n
            phases.append(dict(timer.totals))
            train_peak = max(train_peak, peak())
            if epoch >= 3 and loss is not None:
                dur.append(time.perf_counter() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if args.eval:
                reset_peak()
                logits = evaluate()
                acc = [float(masked_accuracy(logits, y_full, masks[k]))
                       for k in ("train", "val", "test")]
                del logits
                eval_peak = max(eval_peak, peak())
                logger.add_result(r, acc)
                accs.append(acc)
                print("Run {:02d} | Epoch {:05d} | Loss {:.4f} | Train {:.4f} | Val {:.4f} | "
                      "Test {:.4f}".format(r, epoch, float(loss) if loss is not None else math.nan,
                                           *acc))
        run_losses = [float(v) for v in run_losses]
        if not all(math.isfinite(v) for v in run_losses):
            raise FloatingPointError(f"non-finite training loss in run {r}: {run_losses}")
        losses.append(run_losses)
        if args.eval:
            logger.print_statistics(r)
        if args.save_pred:
            np.savetxt(args.save_pred + f"_{r}", evaluate().argmax(-1).cpu().numpy(), fmt="%d")
    if args.eval:
        logger.print_statistics()
    profile = None
    if args.profile:
        stream = endless(cluster_iter)
        try:
            profile = device_profile(lambda: step(next(stream)), args.profile, dev, unit="step")
        finally:
            stream.close()
        print(f"# profile={json.dumps(profile)}", file=sys.stderr)
    return {
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "synthetic": data.synthetic,
        "load_s": load_s,
        "setup_s": setup_s,
        "partition": cluster_iter.part_stats,
        "steps": n_steps,
        "batches": n_batches + args.profile,
        "steps_per_epoch": steps_per_epoch,
        "epochs_s": dur,
        "epoch_s": float(np.mean(dur)) if dur else None,
        "phases_s": phases,
        "collate_ms": [1e3 * t for t in cluster_iter.collate_s],
        "max_batch_nodes": max_nodes,
        "max_batch_edges": max_edges,
        "losses": losses,
        "accs": accs,
        "profile": profile,
        "setup_bytes": setup_bytes,
        "train_peak_bytes": train_peak if on_card else None,
        "eval_peak_bytes": eval_peak if on_card else None,
    }


def main(argv: Optional[list] = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
