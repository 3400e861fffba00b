"""GCMC matrix completion on MovieLens on one card.

Counterpart of ``benchmarks/link_prediction/gcmc.py`` (the reference's
``gcmc_dgl/train.py``, P1-P4), with its flags and defaults: ml-100k, the
encoder's 500 units stacked over the ratings, 75 output units, 2 basis
functions, dropout 0.7, seed 123. Full-batch iterations up to
``--train_max_iter`` (``train.py:117``): cross-entropy over the rating
classes (``:123``), the gradients clipped to ``--train_grad_clip`` by their
global norm (``:127``) and an Adam step; every ``--train_valid_interval``
iterations the expected-rating RMSE on the valid split (``:137-141``), and
on the test split at each new best; the learning rate decays by
``--train_lr_decay_factor`` after ``--train_decay_patience`` validations
without a better one, through the optimiser's ``param_groups``, so Adam's
moments are kept (``:152-178``), and the run stops early after
``--train_early_stopping_patience``. ``train_metrics.csv`` (iter, loss,
rmse) and ``valid_metrics.csv`` (iter, rmse) go to ``--save_dir``
(``:93-98``). The reference's lines: ``Training time/iter`` (the mean from
the fourth iteration; each iteration ends in its loss's read-back, a
synchronise) and ``Best valid RMSE: … Test RMSE: …``.

    python -m dgl_tpu_torch.benchmarks.link_prediction.gcmc
        [--data_name ml-100k] [--train_max_iter N] [--device cuda]
        [--profile ITERS] [--save_dir DIR]

The train RMSE column is the expected-rating RMSE of each step's own
logits (the reference's ``train.py:137-141``), read back with the loss;
the JAX driver logs 0.0 there. ``--profile`` (the port's own) runs that
many further iterations under ``torch.profiler`` after training (stderr).
The JAX driver's ``--scan-iters`` is a TPU dispatch workaround and is not
ported.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...data.movielens import load_movielens
from ...device import resolve_device
from ...models import GCMCNet
from ...train import MetricLogger
from ...train.timing import device_profile, synchronize
from ..common import softmax_ce_int

__all__ = ["parser", "run", "main", "expected_rmse", "make_train_step"]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GCMC (dgl_tpu_torch)")
    p.add_argument("--data_name", type=str, default="ml-100k")
    p.add_argument("--gcn_agg_units", type=int, default=500)
    p.add_argument("--gcn_out_units", type=int, default=75)
    p.add_argument("--gcn_dropout", type=float, default=0.7)
    p.add_argument("--gen_r_num_basis_func", type=int, default=2)
    p.add_argument("--train_max_iter", type=int, default=2000)
    p.add_argument("--train_lr", type=float, default=0.01)
    p.add_argument("--train_grad_clip", type=float, default=1.0)
    p.add_argument("--train_valid_interval", type=int, default=5)
    p.add_argument("--train_lr_decay_factor", type=float, default=0.5)
    p.add_argument("--train_decay_patience", type=int, default=50)
    p.add_argument("--train_early_stopping_patience", type=int, default=100)
    p.add_argument("--share_param", action="store_true")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--save_dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "gcmc_logs"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile", type=int, default=0, metavar="ITERS",
                   help="profile this many further iterations after training (stderr)")
    return p


def expected_rmse(logits: torch.Tensor, labels: torch.Tensor,
                  rating_vals: torch.Tensor) -> torch.Tensor:
    """RMSE of the expected rating ``softmax(logits) · rating_vals`` against
    the rating of each label class, a 0-d tensor on the logits' device."""
    expected = torch.softmax(logits, dim=-1) @ rating_vals
    return torch.sqrt(torch.mean((expected - rating_vals[labels]) ** 2))


def make_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, grad_clip: float,
                    graphs, feats, labels: torch.Tensor, rating_vals: torch.Tensor,
                    generator: torch.Generator):
    """``step() -> (loss, train RMSE)``, both 0-d tensors left on the device:
    one full-batch forward on ``graphs`` (encoder graph, decoder graph) and
    ``feats`` (user and movie features, norms), the mean cross-entropy over
    the decoder graph's edges, backward, the clip and the optimiser step.
    The RMSE is the expected-rating RMSE of the same logits.

    ``clip_grad_norm_`` scales by ``max / (norm + 1e-6)`` where the norm
    exceeds ``max``; optax's ``clip_by_global_norm`` (the JAX driver's) by
    ``max / norm``: the clipped step is smaller here by the factor
    ``norm / (norm + 1e-6)``, within 1e-6 of 1 at a norm over 1."""
    params = [p for p in model.parameters() if p.requires_grad]
    enc, dec = graphs
    ufeat, ifeat, norms = feats

    def step():
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(enc, dec, ufeat, ifeat, norms, generator=generator)
        loss = softmax_ce_int(logits, labels).mean()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, grad_clip)
        opt.step()
        return loss.detach(), expected_rmse(logits.detach(), labels, rating_vals)
    return step


def run(args: argparse.Namespace) -> dict:
    """Train as the JAX driver does, printing its lines. Returns ``{"device",
    "synthetic", "load_s", "num_users", "num_movies", "train_ratings",
    "iters", "evals", "losses", "train_rmse", "valid_rmse", "best_valid",
    "best_test", "iters_s", "iter_s", "profile"}``: ``iters`` the training
    iterations run (the profiled ones not included), ``evals`` the RMSE
    evaluations of each split ({"valid": n, "test": m}), ``valid_rmse``
    each validation's (iter, rmse)."""
    print(args)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    data = load_movielens(args.data_name, seed=args.seed, device=dev)
    synchronize(dev)
    load_s = time.perf_counter() - t0
    print(f"users={data.num_users} movies={data.num_movies} "
          f"ratings={len(data.train[2])} classes={data.rating_vals} "
          f"synthetic={data.synthetic}")
    rating_arr = torch.tensor(data.rating_vals, dtype=torch.float32, device=dev)
    ufeat = torch.from_numpy(data.user_feat).to(dev)
    ifeat = torch.from_numpy(data.movie_feat).to(dev)
    labels = {k: torch.from_numpy(getattr(data, k)[2]).to(dev)
              for k in ("train", "valid", "test")}

    model = GCMCNet([str(r) for r in data.rating_vals], ufeat.shape[1], ifeat.shape[1],
                    msg_units=args.gcn_agg_units, out_units=args.gcn_out_units,
                    dropout_rate=args.gcn_dropout, agg_act=F.leaky_relu,
                    num_basis=args.gen_r_num_basis_func,
                    share_user_item_param=args.share_param, device=dev,
                    generator=torch.Generator().manual_seed(args.seed))
    lr = args.train_lr
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = make_train_step(model, opt, args.train_grad_clip, data.train[:2],
                           (ufeat, ifeat, data.norms), labels["train"], rating_arr,
                           torch.Generator(device=dev).manual_seed(args.seed))
    evals = {"valid": 0, "test": 0}

    def rmse_eval(split):
        evals[split] += 1
        enc, dec, _ = getattr(data, split)
        model.eval()
        with torch.no_grad():
            logits = model(enc, dec, ufeat, ifeat, data.norms)
            return float(expected_rmse(logits, labels[split], rating_arr))

    logger = MetricLogger(args.save_dir, "train_metrics.csv", ["iter", "loss", "rmse"])
    vlogger = MetricLogger(args.save_dir, "valid_metrics.csv", ["iter", "rmse"])
    best_valid = best_test = np.inf
    no_better = 0
    dur, losses, train_rmse, valid_rmse = [], [], [], []
    for it in range(args.train_max_iter):
        if it >= 3:
            t0 = time.perf_counter()
        loss, rmse = torch.stack(step()).tolist()  # the iteration's one read-back
        if it >= 3:
            dur.append(time.perf_counter() - t0)
        losses.append(loss)
        train_rmse.append(rmse)
        if (it + 1) % args.train_valid_interval == 0:
            v = rmse_eval("valid")
            vlogger.log(iter=it, rmse=v)
            valid_rmse.append((it, v))
            if v < best_valid:
                best_valid = v
                no_better = 0
                best_test = rmse_eval("test")
            else:
                no_better += 1
                if no_better == args.train_decay_patience:
                    lr *= args.train_lr_decay_factor
                    print(f"decay lr to {lr}")
                    for group in opt.param_groups:  # Adam's moments are kept
                        group["lr"] = lr
                if no_better >= args.train_early_stopping_patience:
                    print("early stop")
                    break
            print(f"Iter={it}, loss={loss:.4f}, valid_rmse={v:.4f}, "
                  f"best_valid={best_valid:.4f}, best_test={best_test:.4f}")
        logger.log(iter=it, loss=loss, rmse=rmse)
    logger.close()
    vlogger.close()
    if dur:
        print("Training time/iter {}".format(np.mean(dur)))
    print(f"Best valid RMSE: {best_valid:.4f}  Test RMSE: {best_test:.4f}")
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError(f"non-finite training loss: {losses}")
    profile = None
    if args.profile:
        profile = device_profile(step, args.profile, dev, unit="iter")
        print(f"# profile={json.dumps(profile)}", file=sys.stderr)
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "synthetic": data.synthetic,
        "load_s": load_s,
        "num_users": data.num_users,
        "num_movies": data.num_movies,
        "train_ratings": len(data.train[2]),
        "iters": len(losses),
        "evals": evals,
        "losses": losses,
        "train_rmse": train_rmse,
        "valid_rmse": valid_rmse,
        "best_valid": best_valid,
        "best_test": best_test,
        "iters_s": dur,
        "iter_s": float(np.mean(dur)) if dur else None,
        "profile": profile,
    }


def main(argv: Optional[list] = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
