"""Run logging with the reference's stdout format, and CSV metric logging.

Counterpart of ``dgl_tpu/train/logger.py``:

* ``Logger``: per-run (train, valid, test) results and the reference's
  statistics (``node_classification/utils.py:3-43``): the test number at
  the best validation epoch, mean ± std over runs, times ``scale``. The
  suite's harness parses its ``Final Train`` / ``Final Test`` lines.
* ``MetricLogger``: one CSV file with a header row, a row a ``log`` call,
  flushed at once (``gcmc_dgl/utils.py:9-23``).
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["Logger", "MetricLogger"]


class Logger:
    """Per-run (train, valid, test) results; the test number reported is the
    one at the best validation epoch, times ``scale`` (100 for accuracies,
    as the node drivers and ENZYMES print them; 1 for the ogbg drivers)."""

    def __init__(self, runs: int, info=None, scale: float = 100.0):
        self.info = info
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
