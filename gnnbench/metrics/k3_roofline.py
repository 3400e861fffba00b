"""k3_roofline: the frozen bounds of the step's K3 launches (forward and
b2; the outputs the current K3 writes: w1 and the row scalars) over K3's
device time, in %. None where K3 did not run."""

from gnnbench.metrics._shares import k3_bound_s


def read(t):
    spent = t.device_s("K3")
    return 100.0 * k3_bound_s(t) * t.steps / spent if spent > 0 else None
