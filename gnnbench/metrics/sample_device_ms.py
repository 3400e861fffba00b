"""sample_device_ms: device time a step of the operations launched inside
the benchmark's ``sample`` span (``DeviceNeighborSampler``'s draws and
gathers), ms."""

from gnnbench.metrics._shares import per_step_ms


def read(t):
    spent = t.profile.span_device_s.get("sample", 0.0)
    return per_step_ms(spent, t) if spent > 0 else None
