"""What the readers of the port's own trace have in common.

``dgl_tpu_torch/trace.py`` keeps spans and one record a kernel launch, only
while a profiler records: in a run, the profiled stretch's. The readers read
them and never clear them, so a process holds one profiled stretch, as a run
of the harness does. A program without that module gives these readers
nothing to read, and they return None.
"""


def port_trace(t):
    """The port's trace module, where for every kernel of the kernel table
    its launch records count what its wrappers' launch counters counted over
    the stretch (``t.launches`` a step, times ``t.steps``); None where the
    program keeps no trace or a count differs: a partial record never becomes
    a number."""
    try:
        from dgl_tpu_torch import trace
    except ImportError:
        return None
    recs = trace.launches()
    for kid, entry in t.table.entries.items():
        counted = sum(t.launches.get(ref, 0.0) for ref in entry.get("counters", []))
        if sum(1 for r in recs if r.kernel == kid) != round(counted * t.steps):
            return None
    return trace


def records(t, kernel):
    """The stretch's launch records of ``kernel``, or None (none, or
    ``port_trace`` refuses)."""
    trace = port_trace(t)
    if trace is None:
        return None
    return [r for r in trace.launches() if r.kernel == kernel] or None
