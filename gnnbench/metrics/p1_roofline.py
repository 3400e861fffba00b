"""p1_roofline: the frozen ``gather_bound`` of each profiled step's
feature gather ``x[input_nodes]`` (its distinct rows read once, the indices
read once, the output written once) over P1's device time, in %."""

from gnnbench import counts


def read(t):
    spent = t.device_s("P1")
    if spent <= 0 or not t.gathers:
        return None
    row = t.stats["row_bytes"]
    bound_ms = sum(counts.gather_bound(e, touched, 4, row)[0] for e, touched in t.gathers)
    return 100.0 * bound_ms / 1e3 / spent
