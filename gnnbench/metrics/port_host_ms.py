"""port_host_ms: host time a step inside the port's outermost spans, ms:
the union of the intervals of every span with no port parent on its own
thread (a conv layer's forward, an autograd Function's backward on
autograd's thread, a sampler's draw), over all threads, so a nested span or
two threads at once count once, over the profiled stretch's steps. It is
read under the profiler, so it holds the profiler's cost and that of the
spans; it compares two programs traced alike. A span also holds the time
its CUDA calls wait for room in the launch queue, which fills where the
host runs ahead of a device-bound step: there the reading follows the
device, so only cells whose host keeps the queue short under the profiler
list it. None where the program keeps no spans or its launch records
disagree with the launch counters."""

from gnnbench.metrics._launches import port_trace


def union_ns(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return total if cur_b is None else total + cur_b - cur_a


def read(t):
    trace = port_trace(t)
    if trace is None:
        return None
    roots = [(s.start_ns, s.end_ns) for s in trace.spans() if s.parent < 0 and s.end_ns >= 0]
    if not roots:
        return None
    return union_ns(roots) / 1e6 / t.steps
