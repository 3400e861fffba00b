"""Shared plumbing of the port's benchmark drivers.

Counterpart of ``benchmarks/common.py``: masked loss and accuracy over the
train/val/test masks, integer-label cross-entropy, the multilabel BCE and
the rank ROC-AUC with its per-task mean (ogbn-proteins), the
data-statistics banner, and the reference's ``Logger``
(``node_classification/utils.py``; it lives in ``train/logger.py``, as
in the JAX package), whose ``Final Train`` / ``Final Test`` lines the
suite's harness parses. Adam with coupled L2
(``adam_l2``) is ``torch.optim.Adam(weight_decay=wd)`` and needs no helper.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..train.logger import Logger

__all__ = ["softmax_ce_int", "masked_softmax_ce", "masked_bce", "masked_accuracy", "roc_auc",
           "mean_multilabel_auc", "print_data_stats", "Logger"]


def softmax_ce_int(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy of ``logits`` against integer ``labels``."""
    return F.cross_entropy(logits, labels, reduction="none")


def masked_softmax_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows where ``mask`` is set."""
    ce = softmax_ce_int(logits, labels)
    m = mask.to(ce.dtype)
    return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)


def masked_bce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multilabel BCE-with-logits, averaged over the tasks of a row, then
    over the rows where ``mask`` is set (ogbn-proteins)."""
    per = F.binary_cross_entropy_with_logits(logits, labels, reduction="none").mean(-1)
    m = mask.to(per.dtype)
    return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)


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


def mean_multilabel_auc(scores, labels) -> float:
    """Mean per-task ROC-AUC over the tasks where both classes occur (the
    OGB proteins evaluator); nan when none does."""
    scores, labels = np.asarray(scores), np.asarray(labels)
    aucs = [a for a in (roc_auc(scores[:, t], labels[:, t]) for t in range(labels.shape[1]))
            if not np.isnan(a)]
    return float(np.mean(aucs)) if aucs else float("nan")


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
