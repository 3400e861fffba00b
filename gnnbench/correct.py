"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, number by number, each against the
cell's limit (``gnnbench/limits/<cell>.json``).

* ``loss_gap``: the largest relative gap of a step's loss;
  ``loss_gap_first``, the first step's alone (the forward from the same
  weights, before any update can carry round-off on);
* ``grad_gap``: the first gradient as the optimiser got it, by the worst
  leaf: the gap between the two sides' norms of the leaf, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
  ``grad_gap_median``, the same by the median leaf;
* ``change_gap`` (``change_gap_median``): the same of each leaf's change
  over the steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under Adam by round-off alone);
* whatever else the loop's reference counts, such as ``bad_samples``.

A cell compares the numbers its limits file names.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

__all__ = ["STEPS", "LIVE_SHARE", "leaf_gaps", "gaps", "judge"]

STEPS = 3  # the steps the reference follows
LIVE_SHARE = 1e-3  # a leaf whose reference gradient is below this share of the median is left out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    if not keys:
        return {}
    med = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        denom = max(ref[k], med)
        out[k] = abs(prog[k] - ref[k]) / denom if denom > 0 else (0.0 if prog[k] == 0
                                                                    else math.inf)
    return out


def _worst_and_median(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]):
    gaps = list(leaf_gaps(prog, ref, keys).values()) or [0.0]
    return max(gaps), statistics.median(gaps)


def gaps(prog, ref) -> Tuple[Dict[str, float], List[str]]:
    """The numbers of two ``Readings``, and the leaves left out of the
    change: each leaf gap by the worst leaf and by the median leaf
    (``*_median``, steady where a few small leaves swing)."""
    loss = max((abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf)
               for a, b in zip(prog.losses, ref.losses))
    keys = sorted(ref.grad_norms)
    if sorted(prog.grad_norms) != keys or sorted(prog.change_norms) != keys:
        raise ValueError(f"the two sides' leaves differ: {sorted(prog.grad_norms)} / {keys}")
    med = statistics.median(ref.grad_norms[k] for k in keys)
    live = [k for k in keys if ref.grad_norms[k] >= LIVE_SHARE * med]
    grad, grad_med = _worst_and_median(prog.grad_norms, ref.grad_norms, keys)
    change, change_med = _worst_and_median(prog.change_norms, ref.change_norms, live)
    first = prog.losses[0], ref.losses[0]
    out = {"loss_gap": loss,
           "loss_gap_first": (abs(first[0] - first[1]) / max(abs(first[1]), 1e-30)
                              if math.isfinite(first[0]) else math.inf),
           "grad_gap": grad, "grad_gap_median": grad_med,
           "change_gap": change, "change_gap_median": change_med}
    return out, [k for k in keys if k not in live]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Tuple]]:
    """``(correct, [(name, value, limit), ...])`` over the numbers the cell's
    limits name: each within its limit; a limit without its number fails."""
    rows, ok = [], True
    for name in sorted(limits):
        value, limit = numbers.get(name, math.nan), limits[name]
        rows.append((name, value, limit))
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, rows
