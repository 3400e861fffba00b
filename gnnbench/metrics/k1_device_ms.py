"""k1_device_ms: K1's device time a step (an epoch), ms."""

from gnnbench.metrics._shares import per_step_ms


def read(t):
    spent = t.device_s("K1")
    return per_step_ms(spent, t) if spent > 0 else None
