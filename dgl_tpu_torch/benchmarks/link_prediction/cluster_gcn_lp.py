"""Cluster-batched link prediction on one card.

Counterpart of ``benchmarks/link_prediction/cluster_gcn_lp.py`` (the
reference's ``sampling/link-prediction/cluster_gcn_dgl.py`` and
``dgl_cluster_sampler.py``): ogbn-arxiv, 2.5 % of the edges held out for
validation and 2.5 % for test by the driver's own ``rng``, ``--psize 2000``
parts of the training graph, 32 a step, each batch with one uniform negative
destination per edge (``ClusterIter(with_negatives=True)``), a 3-layer SAGE
encoder of hidden 256 (dropout 0.3), lr 5e-4. The loss is
``-logsigmoid(pos) - logsigmoid(-neg)``, each term the mean over the
batch's edges, the scores ``u_dot_v`` (``--predictor dot``: P1 gathers each
way, their adjoints K1 and K2) or the MLP on the gathered pairs
(``--predictor mlp``). ``--eval`` encodes the whole training graph on the
card and ranks each of 200 train, validation and test edges against
``--num-negs`` uniform negative destinations (the ogbl-citation2
protocol), the same ``rng`` draws in the same order as the JAX driver's.

    python -m dgl_tpu_torch.benchmarks.link_prediction.cluster_gcn_lp
        [--dataset ogbn-arxiv] [--n-epochs N] [--predictor dot|mlp] [--eval]
        [--yardsticks] [--device cuda] [--scale S] [--profile STEPS]

``--yardsticks`` (the port's own) first ranks the same edges against the
same negatives with the untrained encoder and with the raw features as
embeddings (``h = x``), from a copy of the ``rng``, so the trained numbers
have their baselines. With ``--predictor mlp`` the port ranks against all
``--num-negs`` negatives; the JAX driver's MLP scores of the negatives keep
only the first of them (``x[:, 0]`` on a (K, num_negs, 1) output).
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...data import data_root, load_node_dataset
from ...device import resolve_device
from ...graph import from_edges
from ...models import GraphSAGE
from ...nn import PairMLPPredictor
from ...ops import gather_dst, gather_src_rows
from ...ops.sddmm import u_dot_v
from ...sampling.cluster import ClusterIter
from ...train.timing import device_profile, synchronize
from ..common import Logger, print_data_stats
from ..sampling.cluster_sage import endless

__all__ = ["parser", "run", "main", "mrr", "make_train_step"]

EVAL_EDGES = 200  # edges ranked a split and an evaluation, as the JAX driver's


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Cluster link prediction (dgl_tpu_torch)")
    p.add_argument("--dataset", type=str, default="ogbn-arxiv",
                   help="any node dataset; 5%% of edges held out as val/test links")
    p.add_argument("--n-epochs", type=int, default=10)
    p.add_argument("--n-hidden", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=3)
    p.add_argument("--psize", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--num-negs", type=int, default=1000, help="negatives per eval positive")
    p.add_argument("--predictor", type=str, default="dot", choices=["dot", "mlp"])
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--yardsticks", action="store_true",
                   help="also rank with the untrained encoder and with h = x")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, default=1.0,
                   help="shrink factor for the synthetic data (rehearsals)")
    p.add_argument("--part-method", type=str, default="metis", choices=["metis", "lp", "random"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile", type=int, default=0, metavar="STEPS",
                   help="profile this many further steps after training (stderr)")
    return p


def mrr(score, h: torch.Tensor, src: np.ndarray, dst: np.ndarray, num_nodes: int, num_negs: int,
        rng: np.random.Generator) -> float:
    """Mean reciprocal rank of each edge ``src -> dst`` among ``num_negs``
    uniform negative destinations drawn from ``rng`` (ties rank the
    positive last), ``score(h_i, h_j)`` on broadcast pairs."""
    dev = h.device
    hs = h[torch.from_numpy(src).to(dev)]
    pos = score(hs, h[torch.from_numpy(dst).to(dev)])
    neg_d = rng.integers(0, num_nodes, size=(len(src), num_negs))
    hneg = h[torch.from_numpy(neg_d.reshape(-1)).to(dev)].view(len(src), num_negs, -1)
    neg = score(hs.unsqueeze(1), hneg)
    ranks = 1.0 / (1 + (neg >= pos.unsqueeze(1)).sum(1).double())
    return float(ranks.mean())


def make_train_step(model: torch.nn.Module, predictor: Optional[torch.nn.Module],
                    opt: torch.optim.Optimizer, generator: torch.Generator):
    """``step(batch) -> loss`` (left on the device): the encoder on the
    batch's graph, the scores of its edges and of its negative graph's
    (``u_dot_v``, or ``predictor`` on the gathered pairs), the loss
    ``-logsigmoid(pos) - logsigmoid(-neg)`` (each the mean over the batch's
    edges), backward and an optimiser step."""
    def scores(g, h):
        if predictor is None:
            return u_dot_v(g, h, h)[:, 0]
        return predictor(gather_src_rows(g, h), gather_dst(g, h), generator=generator)

    def step(batch):
        model.train()
        if predictor is not None:
            predictor.train()
        opt.zero_grad(set_to_none=True)
        h = model(batch.graph, batch.x, generator=generator)
        e = max(batch.graph.num_edges, 1)
        loss = (-F.logsigmoid(scores(batch.graph, h)).sum() / e
                - F.logsigmoid(-scores(batch.neg_graph, h)).sum() / e)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def run(args: argparse.Namespace) -> dict:
    """Train as the JAX driver does, printing its lines. Returns ``{"device",
    "synthetic", "load_s", "setup_s", "partition", "steps", "batches",
    "steps_per_epoch", "epochs_s", "epoch_s", "collate_ms", "losses",
    "mrr", "yardsticks", "profile"}``: ``batches`` the batches taken from
    the iterator (``first()`` and the profiled steps' included: one P1
    each), ``losses`` every step's, ``mrr``
    each evaluation's (train, valid, test), ``yardsticks`` with
    ``--yardsticks`` the (train, valid, test) MRR of the ``untrained``
    encoder and of the ``raw_features``."""
    print(args)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    data = load_node_dataset(args.dataset, seed=args.seed, scale=args.scale)
    load_s = time.perf_counter() - t0
    print_data_stats(data)
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
    n_e = len(data.src)  # held-out edges leave the training graph
    perm = rng.permutation(n_e)
    n_val = n_test = max(1, int(0.025 * n_e))
    val_e, test_e, train_e = perm[:n_val], perm[n_val: n_val + n_test], perm[n_val + n_test:]
    src_tr, dst_tr = data.src[train_e], data.dst[train_e]
    cluster_iter = ClusterIter(
        f"{args.dataset}_lp_s{args.scale}", src_tr, dst_tr, data.num_nodes, data.features,
        data.labels.reshape(len(data.labels), -1)[:, :1], np.ones(data.num_nodes, bool),
        args.psize, args.batch_size, method=args.part_method, seed=args.seed,
        cache_dir=data_root(), with_negatives=True, device=dev)
    g_full = from_edges(src_tr, dst_tr, data.num_nodes, device=dev)
    x_full = cluster_iter.features
    synchronize(dev)
    setup_s = time.perf_counter() - t0

    def score_pairs(predictor, h_i, h_j):
        return (h_i * h_j).sum(-1) if predictor is None else predictor(h_i, h_j)

    def evaluate(h, predictor, eval_rng):
        k = min(EVAL_EDGES, len(val_e))
        out = []
        for eids in (eval_rng.choice(train_e, size=k, replace=False), val_e[:k],
                     test_e[:min(EVAL_EDGES, len(test_e))]):
            out.append(mrr(lambda a, b: score_pairs(predictor, a, b), h, data.src[eids],
                           data.dst[eids], data.num_nodes, args.num_negs, eval_rng))
        return out

    logger = Logger(args.runs, scale=1.0)
    dur, losses, mrrs, yardsticks = [], [], [], None
    n_steps = n_batches = steps_per_epoch = 0
    for r in range(args.runs):
        model = GraphSAGE(x_full.shape[1], args.n_hidden, args.n_hidden, num_layers=args.n_layers,
                          dropout=args.dropout, device=dev,
                          generator=torch.Generator().manual_seed(args.seed * 1000 + r))
        predictor = None
        params = list(model.parameters())
        if args.predictor == "mlp":
            predictor = PairMLPPredictor(args.n_hidden, args.n_hidden, device=dev,
                                         generator=torch.Generator().manual_seed(
                                             args.seed * 1000 + r + 1))
            params += list(predictor.parameters())
        step = make_train_step(model, predictor, torch.optim.Adam(params, lr=args.lr),
                               torch.Generator(device=dev).manual_seed(args.seed * 1000 + r))
        cluster_iter.first()  # the JAX driver's model.init batch: its negatives leave the stream
        n_batches += 1

        def encode_full():
            model.eval()
            with torch.no_grad():
                return model(g_full, x_full)

        if args.yardsticks and r == 0:
            with torch.no_grad():
                yardsticks = {"untrained": evaluate(encode_full(), predictor, copy.deepcopy(rng)),
                              "raw_features": evaluate(x_full, None, copy.deepcopy(rng))}
            print(f"Yardsticks (train, valid, test MRR): {json.dumps(yardsticks)}")

        for epoch in range(args.n_epochs):
            t0 = time.perf_counter()
            n = 0
            for batch in cluster_iter:
                losses.append(step(batch))
                n += 1
            n_steps += n
            n_batches += n
            steps_per_epoch = n
            loss = float(losses[-1])  # the epoch's one read from the card
            if epoch >= 3:
                dur.append(time.perf_counter() - t0)
                print("Training time/epoch {}".format(np.mean(dur)))
            if args.eval:
                if predictor is not None:
                    predictor.eval()
                with torch.no_grad():
                    res = evaluate(encode_full(), predictor, rng)
                logger.add_result(r, res)
                mrrs.append(res)
                print(f"Run: {r + 1:02d}, Epoch: {epoch:02d}, Loss: {loss:.4f}, "
                      f"Train MRR: {res[0]:.4f} Valid MRR: {res[1]:.4f} Test MRR: {res[2]:.4f}")
        if args.eval:
            logger.print_statistics(r)
    if args.eval:
        logger.print_statistics()
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError(f"non-finite training loss: {losses}")
    profile = None
    if args.profile:
        stream = endless(cluster_iter)
        try:
            profile = device_profile(lambda: step(next(stream)), args.profile, dev, unit="step")
        finally:
            stream.close()
        print(f"# profile={json.dumps(profile)}", file=sys.stderr)
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "synthetic": data.synthetic,
        "load_s": load_s,
        "setup_s": setup_s,
        "partition": cluster_iter.part_stats,
        "steps": n_steps,
        "batches": n_batches + args.profile,
        "steps_per_epoch": steps_per_epoch,
        "epochs_s": dur,
        "epoch_s": float(np.mean(dur)) if dur else None,
        "collate_ms": [1e3 * t for t in cluster_iter.collate_s],
        "losses": losses,
        "mrr": mrrs,
        "yardsticks": yardsticks,
        "profile": profile,
    }


def main(argv: Optional[list] = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
