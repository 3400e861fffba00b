"""k1_roofline: the frozen bound of the step's K1 launches (CSR SpMM at
the configuration's widths, inputs read once, output written once) over
K1's device time, in %. None where K1 did not run."""

from gnnbench.metrics._shares import k1_bound_s


def read(t):
    spent = t.device_s("K1")
    return 100.0 * k1_bound_s(t) * t.steps / spent if spent > 0 else None
