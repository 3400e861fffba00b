"""dense_device_ms: device time a step of every operation that is not one
of the port's own kernels (``gnnbench/kernels/``): cuBLAS GEMMs,
elementwise work, dropout, the loss, Adam, copies; ms."""

from gnnbench.metrics._shares import per_step_ms


def read(t):
    return per_step_ms(t.device_total_s() - t.own_s(), t)
