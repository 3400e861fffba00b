"""host_enqueue_ms: host time of one step's enqueue (sampling, gather,
forward, backward and Adam dispatched, no synchronise inside), each timed
after a synchronise, averaged over the traced run's enqueue stretch; ms."""


def read(t):
    return None if t.host_enqueue_s is None else 1e3 * t.host_enqueue_s
