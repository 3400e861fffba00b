"""Shared plumbing of the port's benchmark drivers.

Counterpart of ``benchmarks/common.py``: masked loss and accuracy over the
train/val/test masks, integer-label cross-entropy, the rank ROC-AUC, the
data-statistics banner, and the reference's ``Logger``
(``node_classification/utils.py``), whose ``Final Train`` / ``Final Test``
lines the suite's harness parses. Adam with coupled L2
(``adam_l2``) is ``torch.optim.Adam(weight_decay=wd)`` and needs no helper.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["softmax_ce_int", "masked_softmax_ce", "masked_accuracy", "roc_auc",
           "print_data_stats", "Logger"]


def softmax_ce_int(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy of ``logits`` against integer ``labels``."""
    return F.cross_entropy(logits, labels, reduction="none")


def masked_softmax_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows where ``mask`` is set."""
    ce = softmax_ce_int(logits, labels)
    m = mask.to(ce.dtype)
    return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)
    hit = (logits.argmax(-1) == labels).to(torch.float32) * m
    return torch.sum(hit) / torch.clamp(torch.sum(m), min=1.0)


def roc_auc(scores, labels) -> float:
    """Binary ROC-AUC by the rank statistic, tied scores given their average
    rank; nan when one class is absent."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    pos, neg = scores[labels == 1], scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    allv = np.concatenate([pos, neg])
    uniq, counts = np.unique(allv, return_counts=True)
    avg_rank = np.cumsum(counts) - (counts - 1) / 2.0
    r_pos = avg_rank[np.searchsorted(uniq, allv)][: len(pos)].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2.0) / (len(pos) * len(neg)))


def print_data_stats(data) -> None:
    print(
        "----Data statistics------'\n"
        f"  #Edges {len(data.src)}\n"
        f"  #Classes {data.num_classes}\n"
        f"  #Train samples {int(data.train_mask.sum())}\n"
        f"  #Val samples {int(data.val_mask.sum())}\n"
        f"  #Test samples {int(data.test_mask.sum())}"
    )
    if data.synthetic:
        print("  (synthetic fallback data — structural stats matched to the real dataset)")


class Logger:
    """Per-run (train, valid, test) results; the test number reported is the
    one at the best validation epoch, times ``scale`` (100 for accuracies,
    as the node drivers and ENZYMES print them; 1 for the ogbg drivers)."""

    def __init__(self, runs: int, scale: float = 100.0):
        self.scale = scale
        self.results = [[] for _ in range(runs)]

    def add_result(self, run: int, result: Sequence[float]) -> None:
        if len(result) != 3:
            raise ValueError("result must be (train, valid, test)")
        self.results[run].append(tuple(float(v) for v in result))

    def print_statistics(self, run: Optional[int] = None) -> None:
        if run is not None:
            result = self.scale * np.asarray(self.results[run])
            argmax = int(result[:, 1].argmax())
            print(f"Run {run + 1:02d}:")
            print(f"Highest Train: {result[:, 0].max():.2f}")
            print(f"Highest Valid: {result[:, 1].max():.2f}")
            print(f"  Final Train: {result[argmax, 0]:.2f}")
            print(f"   Final Test: {result[argmax, 2]:.2f}")
            return
        best = []
        for r in self.scale * np.asarray(self.results):
            am = int(r[:, 1].argmax())
            best.append((r[:, 0].max(), r[:, 1].max(), r[am, 0], r[am, 2]))
        best = np.asarray(best)
        ddof = 1 if best.shape[0] > 1 else 0  # torch.std over >1 runs
        print("All runs:")
        print(f"Highest Train: {best[:, 0].mean():.2f} ± {best[:, 0].std(ddof=ddof):.2f}")
        print(f"Highest Valid: {best[:, 1].mean():.2f} ± {best[:, 1].std(ddof=ddof):.2f}")
        print(f"  Final Train: {best[:, 2].mean():.2f} ± {best[:, 2].std(ddof=ddof):.2f}")
        print(f"   Final Test: {best[:, 3].mean():.2f} ± {best[:, 3].std(ddof=ddof):.2f}")
