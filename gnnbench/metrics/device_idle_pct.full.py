"""device_idle_pct: one minus the device's busy time a step (the union of
its operations in the profiled stretch) over the step time of the
unprofiled window of the same run, in %."""

from gnnbench.metrics._shares import idle_pct


def read(t):
    return idle_pct(t)
