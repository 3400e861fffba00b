"""CSV metric logging.

Counterpart of ``dgl_tpu/train/logger.py:MetricLogger`` (the reference's
``gcmc_dgl/utils.py:9-23``): one CSV file with a header row, a row a
``log`` call, flushed at once. The reference's ``Logger`` of run results
lives in ``benchmarks/common.py``.
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, save_dir: str, filename: str, fieldnames: Sequence[str]):
        os.makedirs(save_dir, exist_ok=True)
        self._f = open(os.path.join(save_dir, filename), "w", newline="")
        self._writer = csv.DictWriter(self._f, fieldnames=list(fieldnames))
        self._writer.writeheader()

    def log(self, **kwargs):
        self._writer.writerow(kwargs)
        self._f.flush()

    def close(self):
        self._f.close()
