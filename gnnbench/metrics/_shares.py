"""Shares the per-layer readers have in common."""

from gnnbench import counts


def step_mfu(t):
    """The step's least time on the card (its model work, ``counts.Work``)
    over its measured time, in %."""
    return 100.0 * t.work.least_s() / t.step_s


def idle_pct(t):
    """One minus the profiled device busy time a step over the unprofiled
    step time, in %."""
    return 100.0 * (1.0 - t.profile.busy_s / t.steps / t.step_s)


def per_step_ms(seconds, t):
    return 1e3 * seconds / t.steps


def k1_bound_s(t):
    """The frozen ``spmm_bound`` of every K1 launch a full-graph GraphSAGE
    step makes at the configuration's widths (``sage_k1_launches``,
    unhoisted), seconds."""
    m = t.cfg["model"]
    n, e = t.stats["nodes"], t.stats["edges"]
    launches = counts.sage_k1_launches(m["in_feats"], m["hidden"], m["classes"], m["layers"],
                                       hoisted=False)
    return sum(counts.spmm_bound(n, n, e, d, 4)[0] for _, _, d in launches) / 1e3


def k3_bound_s(t):
    """The frozen ``k3_fwd_bound`` and ``k3_bwd_bound`` of every K3 launch a
    full-graph GAT step makes (``gat_k3_launches``), seconds."""
    m = t.cfg["model"]
    n, e = t.stats["nodes"], t.stats["edges"]
    total = 0.0
    for _, kind, h, d, drop in counts.gat_k3_launches(m["in_feats"], m["hidden"], m["classes"],
                                                      m["heads"], m["dropout"]):
        if kind == "fwd":
            total += counts.k3_fwd_bound(n, n, e, h, d)[0]
        else:
            total += counts.k3_bwd_bound(n, n, e, h, d, dropout=drop)[0]
    return total / 1e3
