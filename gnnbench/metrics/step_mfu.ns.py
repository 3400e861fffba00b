"""step_mfu: the whole training step's least time on the card, from the
model's math at the cell's shapes (``counts.py``: GEMMs, aggregated edge
elements and attention work at 67 TFLOP/s; CSRs, rows, operands, results,
parameters and Adam's state once at 3.35 TB/s, whichever is longer), over
the step's measured time in the unprofiled window, in %."""

from gnnbench.metrics._shares import step_mfu


def read(t):
    return step_mfu(t)
