"""port_launch_host_us: the mean host time of one launch of the port's own
kernels over the profiled stretch, us: each launch record's time from its
wrapper's entry to its return (checks, the row split, allocations and the
ctypes call). It is read under the profiler, so it holds the profiler's cost
and that of the wrapper's span; it compares two programs traced alike. The
ctypes call waits where the launch queue is full, as it is where the host
runs ahead of a device-bound step, so only cells whose host keeps the queue
short under the profiler list it. None where there is no record, a record
lacks its time, or a count differs from its kernel's launch counter."""

from gnnbench.metrics._launches import port_trace


def read(t):
    trace = port_trace(t)
    if trace is None:
        return None
    recs = trace.launches()
    if not recs or any(r.host_ns is None for r in recs):
        return None
    return sum(r.host_ns for r in recs) / len(recs) / 1e3
