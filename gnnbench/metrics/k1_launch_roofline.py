"""k1_launch_roofline: the least time of each K1 launch the profiled
stretch made, at the shapes its launch record holds (rows, source rows,
edges, D, the bytes of an indptr offset and of a row's value), over K1's
device time in the stretch, in %. The least time is the frozen
``spmm_bound``'s; a weighted launch also reads one float32 weight an edge,
which that bound leaves out, so its bytes are counted here. None where K1
did not run, the program keeps no launch records, or their count differs
from K1's launch counter."""

from gnnbench import counts
from gnnbench.metrics._launches import records


def bound_ms(r):
    """One launch's least time, ms."""
    if not r.weighted:
        return counts.spmm_bound(r.rows, r.src_rows, r.edges, r.d, r.index_bytes,
                                 r.value_bytes)[0]
    # spmm_bound's bytes, and the weights
    moved = (r.edges * counts.F32 + (r.rows + 1) * r.index_bytes
             + r.src_rows * r.d * r.value_bytes + r.rows * r.d * counts.F32
             + r.edges * counts.F32)
    return counts._bound_ms(moved, 2 * r.edges * r.d)[0]


def read(t):
    recs = records(t, "K1")
    spent = t.device_s("K1")
    if recs is None or spent <= 0:
        return None
    return 100.0 * sum(bound_ms(r) for r in recs) / 1e3 / spent
