"""The readers of the port's own trace (``k1_launch_roofline``,
``k3_launch_roofline``, ``port_launch_host_us``, ``port_host_ms``) on a
hand-built ``Traced`` and hand-built spans and launch records."""

from __future__ import annotations

import json
import os
import sys

import pytest

import dgl_tpu_torch
from dgl_tpu_torch import trace
from gnnbench import counts, run
from gnnbench.tests.conftest import PKG, REPO
from gnnbench.trace import KernelTable, Profile, Traced

STEPS = 3
K1_COUNTER = "dgl_tpu_torch.kernels.csr_spmm:csr_spmm.launches"
K3_COUNTERS = ("dgl_tpu_torch.kernels.gat_attention:gat_attention_fwd.launches",
               "dgl_tpu_torch.kernels.gat_attention:gat_attention_bwd.launches")
NEW = ("k1_launch_roofline", "k3_launch_roofline", "port_launch_host_us", "port_host_ms")


def _read(name, t):
    return run.metric_reader(REPO, name)(t)


def _cfg(name):
    with open(os.path.join(PKG, "configs", f"{name}.json")) as f:
        return json.load(f)


def _traced(cfg, nodes, edges, kernels, launches):
    profile = Profile(STEPS, 1.0, 0.9, kernels, {}, {})
    return Traced(cfg, {"loop": "full"}, {"nodes": nodes, "edges": edges}, 0.3, profile,
                  KernelTable(os.path.join(PKG, "kernels")), launches, counts.Work(), None,
                  0.0, [])


def _launch(kernel, pass_, n, e, d, heads=1, dropout=False, host_ns=1000):
    return trace.Launch(kernel, pass_, n, n, e, d, heads, 4, 4, False, dropout, -1, host_ns)


def _sage():
    """sage_products' step as records, three steps of them."""
    m = _cfg("sage_products")["model"]
    n, e = 2_449_029, 123_718_280
    recs = [_launch("K1", "spmm", n, e, d)
            for _ in range(STEPS)
            for _, _, d in counts.sage_k1_launches(m["in_feats"], m["hidden"], m["classes"],
                                                   m["layers"], hoisted=False)]
    t = _traced(_cfg("sage_products"), n, e, {"void csr_spmm_kernel<4, 1>": (0.181, 18)},
                {K1_COUNTER: 6.0})
    return t, recs


def _gat():
    m = _cfg("gat_arxiv")["model"]
    n, e = 169_343, 2_484_941
    recs = [_launch("K3", "fwd" if kind == "fwd" else "b2", n, e, d, h, drop)
            for _ in range(STEPS)
            for _, kind, h, d, drop in counts.gat_k3_launches(m["in_feats"], m["hidden"],
                                                              m["classes"], m["heads"],
                                                              m["dropout"])]
    t = _traced(_cfg("gat_arxiv"), n, e, {"void gat_fwd_kernel<4, 1>": (0.0054, 9),
                                          "void gat_b2_kernel<4, 1>": (0.0044, 9)},
                {K3_COUNTERS[0]: 3.0, K3_COUNTERS[1]: 3.0})
    return t, recs


def _spans(n_steps):
    """Per step: a root of 100 ns with a nested child on the main thread, a
    root of 60 ns on another thread overlapping it by 20 ns: 140 ns once."""
    out = []
    for s in range(n_steps):
        base = 1000 * (s + 1)
        root = len(out)
        out += [trace.Span("dgl_tpu_torch.SAGEConv.forward", base, base + 100, -1, 1),
                trace.Span("dgl_tpu_torch.K1", base + 10, base + 50, root, 1),
                trace.Span("dgl_tpu_torch._CopyU.backward", base + 80, base + 140, -1, 2)]
    return out


@pytest.fixture
def kept():
    """Fill the port's trace lists with a test's spans and records."""
    trace.clear()

    def fill(spans, recs):
        trace.spans().extend(spans)
        trace.launches().extend(recs)

    yield fill
    trace.clear()


def test_launch_rooflines_equal_the_configuration_rooflines(kept):
    t, recs = _sage()
    kept([], recs)
    assert _read("k1_launch_roofline", t) == pytest.approx(_read("k1_roofline", t), rel=1e-12)
    trace.clear()
    t, recs = _gat()
    kept([], recs)
    assert _read("k3_launch_roofline", t) == pytest.approx(_read("k3_roofline", t), rel=1e-12)


def test_a_wider_launch_moves_the_launch_roofline_alone(kept):
    t, recs = _sage()
    recs[0].d = 100  # a launch at D = 100 where the configuration lists 64
    kept([], recs)
    assert _read("k1_launch_roofline", t) > _read("k1_roofline", t)


def test_a_weighted_k1_launch_also_reads_its_weights(kept):
    t, recs = _sage()
    kept([], recs)
    plain = _read("k1_launch_roofline", t)
    total_ms = sum(counts.spmm_bound(r.rows, r.src_rows, r.edges, r.d, r.index_bytes,
                                     r.value_bytes)[0] for r in recs)
    r = recs[0]
    assert counts.spmm_bound(r.rows, r.src_rows, r.edges, r.d, r.index_bytes,
                             r.value_bytes)[1] == "bytes"
    r.weighted = True  # one float32 an edge more, at HBM's rate
    weights_ms = 1e3 * r.edges * counts.F32 / counts.HBM_BYTES_PER_S
    assert _read("k1_launch_roofline", t) == pytest.approx(
        plain * (total_ms + weights_ms) / total_ms, rel=1e-12)


def test_a_k3_launch_over_an_int64_indptr_gives_no_number(kept):
    t, recs = _gat()
    kept([], recs)
    assert _read("k3_launch_roofline", t) is not None
    recs[0].index_bytes = 8
    assert _read("k3_launch_roofline", t) is None


@pytest.mark.parametrize("name, cell", [("k1_launch_roofline", "sage"),
                                        ("k3_launch_roofline", "gat"),
                                        ("port_launch_host_us", "sage"),
                                        ("port_launch_host_us", "gat"),
                                        ("port_host_ms", "sage"), ("port_host_ms", "gat")])
def test_each_reader_refuses_records_that_disagree_with_the_counters(kept, name, cell):
    t, recs = _sage() if cell == "sage" else _gat()
    kept(_spans(STEPS), recs)
    assert _read(name, t) is not None
    trace.launches().pop()
    assert _read(name, t) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_without_the_port_trace(kept, name, monkeypatch):
    t, recs = _sage()
    kept(_spans(STEPS), recs)
    # a program without the module, as before it was written
    monkeypatch.delattr(dgl_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "dgl_tpu_torch.trace", None)
    assert _read(name, t) is None


def test_host_readers(kept):
    t, recs = _sage()
    for i, r in enumerate(recs):
        r.host_ns = 1000 + 100 * (i % 2)
    kept(_spans(STEPS), recs)
    assert _read("port_launch_host_us", t) == pytest.approx(1.05)
    # each step 140 ns once: the nested K1 and the overlap of the two threads
    assert _read("port_host_ms", t) == pytest.approx(140e-6)
    recs[0].host_ns = None
    assert _read("port_launch_host_us", t) is None


def test_host_readers_read_nothing_from_an_empty_trace(kept):
    t = _traced(_cfg("sage_products"), 10, 20, {}, {K1_COUNTER: 0.0})
    assert _read("port_launch_host_us", t) is None and _read("port_host_ms", t) is None
    assert _read("k1_launch_roofline", t) is None
