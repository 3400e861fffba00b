"""k3_device_ms: K3's device time a step (forward and b2), ms."""

from gnnbench.metrics._shares import per_step_ms


def read(t):
    spent = t.device_s("K3")
    return per_step_ms(spent, t) if spent > 0 else None
