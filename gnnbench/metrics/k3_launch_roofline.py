"""k3_launch_roofline: the frozen ``k3_fwd_bound`` or ``k3_bwd_bound`` of
each K3 launch the profiled stretch made, at the shapes its launch record
holds (forward: dst rows, source rows; b2: source rows, dst rows; edges,
heads, D, v's value bytes, b2's dropout), over K3's device time in the
stretch, in %. Those bounds count a 4-byte indptr offset, so a launch over
an int64 indptr gives no number. None where K3 did not run, the program
keeps no launch records, or their count differs from K3's launch
counters."""

from gnnbench import counts
from gnnbench.metrics._launches import records


def _bound_ms(r):
    if r.pass_ == "fwd":
        return counts.k3_fwd_bound(r.rows, r.src_rows, r.edges, r.heads, r.d, r.value_bytes)[0]
    return counts.k3_bwd_bound(r.rows, r.src_rows, r.edges, r.heads, r.d, dropout=r.dropout,
                               v_bytes=r.value_bytes)[0]


def read(t):
    recs = records(t, "K3")
    spent = t.device_s("K3")
    if recs is None or spent <= 0 or any(r.index_bytes != counts.F32 for r in recs):
        return None
    return 100.0 * sum(_bound_ms(r) for r in recs) / 1e3 / spent
