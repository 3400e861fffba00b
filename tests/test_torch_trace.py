"""dgl_tpu_torch.trace: spans and launch records, kept only while a profiler
records.

On the CPU: with no profiler the port enters no ``record_function`` and
keeps nothing; under ``torch.profiler`` a training step of a tiny GraphSAGE
and a tiny fused GAT shows the port's spans in the exported trace, the
in-memory spans nest by thread, and ``clear`` empties both lists; a second
profiling session holds only its own records, and a profiler that hands
its ranges on at once (nvtx, itt) leaves nothing kept. On a card
(``-m cuda``): one step of each benchmark cell's model records one K1 or K3
launch for each increment of the wrapper's counter, at the tensors' shapes.

This file imports no JAX:
    python -m pytest --noconftest tests/test_torch_trace.py
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import ActiveProfilerType
from torch.profiler import ProfilerActivity, profile

from dgl_tpu_torch import from_edges, trace
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.kernels.gat_attention import (gat_attention_bwd, gat_attention_fwd,
                                                  gat_score_grad, gat_scores, gat_vector_grad)
from dgl_tpu_torch.models import GAT, GraphSAGE

PREFIX = "dgl_tpu_torch."
SAGE_SPANS = {"SAGEConv.forward", "_CopyU.forward", "_CopyU.backward", "K1"}
GAT_SPANS = {"GATConv.forward", "_GATAttention.forward", "_GATAttention.backward", "K3.fwd",
             "K3.b2", "K3N.scores", "K3N.score_grad", "K3N.vector_grad"}


def _graph(n, e, device, seed=0):
    rng = np.random.default_rng(seed)
    return from_edges(rng.integers(0, n, e), rng.integers(0, n, e), n, device=device)


def _models(device):
    gen = torch.Generator().manual_seed(0)
    sage = GraphSAGE(12, 8, 5, num_layers=3, dropout=0.5, device=device, generator=gen)
    gat = GAT(12, 4, 5, (2, 2), feat_drop=0.2, attn_drop=0.2, fused=True, device=device,
              generator=gen)
    return sage, gat


def _step(model, g, x, y):
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(g, x, generator=torch.Generator(device=x.device).manual_seed(1))
    torch.nn.functional.cross_entropy(out, y).backward()


@pytest.fixture
def tiny():
    g = _graph(60, 240, "cpu")
    x = torch.randn(60, 12, generator=torch.Generator().manual_seed(0))
    y = torch.randint(0, 5, (60,), generator=torch.Generator().manual_seed(0))
    return g, x, y


@pytest.fixture(autouse=True)
def _empty():
    trace.clear()
    yield
    trace.clear()


def test_no_profiler_no_span_no_record(tiny, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("dgl_tpu_torch.a") is trace.span("dgl_tpu_torch.b")
    g, x, y = tiny
    for model in _models("cpu"):
        _step(model, g, x, y)
    trace.launch("K1", "spmm", g.indptr, g.src, x)
    assert trace.spans() == [] and trace.launches() == []


def test_profiled_step_shows_the_port_spans(tiny, tmp_path):
    g, x, y = tiny
    sage, gat = _models("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(sage, g, x, y)
        _step(gat, g, x, y)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    exported = [e["name"] for e in events
                if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]
    wanted = {PREFIX + s for s in SAGE_SPANS | GAT_SPANS}
    assert wanted <= set(exported)
    kept = [s.name for s in trace.spans()]
    assert sorted(kept) == sorted(exported)
    assert all(s.end_ns >= s.start_ns > 0 for s in trace.spans())
    # three SAGE layers, each one K1 forward and one backward (layer 1
    # projects first, so its aggregation needs a gradient)
    assert kept.count(PREFIX + "SAGEConv.forward") == 3
    assert kept.count(PREFIX + "K1") == 6
    assert trace.launches() == []  # CPU tensors launch no kernel


def test_spans_nest_on_their_own_thread(tiny):
    g, x, y = tiny
    _, gat = _models("cpu")
    gat.train()
    errors = []

    def backward(loss):
        try:
            loss.backward()
        except BaseException as exc:  # reported on the test's thread
            errors.append(exc)
            raise

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("dgl_tpu_torch.test.outer"):
            out = gat(g, x, generator=torch.Generator().manual_seed(1))
            loss = torch.nn.functional.cross_entropy(out, y)
            worker = threading.Thread(target=backward, args=(loss,))
            worker.start()
            worker.join(timeout=60)
    assert not worker.is_alive() and not errors
    spans = trace.spans()
    by_name = {}
    for i, s in enumerate(spans):
        by_name.setdefault(s.name, []).append(i)
    outer = by_name[PREFIX + "test.outer"][0]
    main, other = spans[outer].thread, worker.ident
    for i in by_name[PREFIX + "GATConv.forward"]:
        assert spans[i].parent == outer
    for i in by_name[PREFIX + "_GATAttention.forward"]:
        assert spans[spans[i].parent].name == PREFIX + "GATConv.forward"
    for i in by_name[PREFIX + "K3.fwd"]:
        assert spans[spans[i].parent].name == PREFIX + "_GATAttention.forward"
    assert len(by_name[PREFIX + "_GATAttention.backward"]) == 2
    for i in by_name[PREFIX + "_GATAttention.backward"]:
        assert spans[i].thread == other and spans[i].parent == -1
    for i in by_name[PREFIX + "K3.b2"]:
        assert spans[i].thread == other
        assert spans[spans[i].parent].name == PREFIX + "_GATAttention.backward"
    for s in spans:
        assert s.parent == -1 or spans[s.parent].thread == s.thread
        assert s.thread in (main, other)


def test_launch_record_takes_its_span_time_and_clear_empties_both():
    indptr = torch.tensor([0, 2, 3, 3], dtype=torch.int32)
    indices = torch.tensor([0, 4, 1], dtype=torch.int32)
    x = torch.zeros(5, 7, dtype=torch.bfloat16)
    v = torch.zeros(5, 3, 6)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("dgl_tpu_torch.K1"):
            trace.launch("K1", "spmm", indptr, indices, x, weighted=True)
            assert trace.launches()[0].host_ns is None
        with trace.span("dgl_tpu_torch.K3.b2"):
            trace.launch("K3", "b2", indptr, indices, v, value_dtype=torch.bfloat16,
                         dropout=True)
        trace.launch("P1", "index", None, indices.long(), x)
    k1, k3, p1 = trace.launches()
    assert (k1.kernel, k1.pass_, k1.rows, k1.src_rows, k1.edges, k1.d, k1.heads) == (
        "K1", "spmm", 3, 5, 3, 7, 1)
    assert (k1.value_bytes, k1.index_bytes, k1.weighted, k1.dropout) == (2, 4, True, False)
    assert k1.span == 0 and k1.host_ns == trace.spans()[0].end_ns - trace.spans()[0].start_ns
    assert (k3.pass_, k3.src_rows, k3.d, k3.heads, k3.value_bytes, k3.dropout) == (
        "b2", 5, 6, 3, 2, True)
    assert k3.span == 1 and k3.host_ns > 0
    assert (p1.rows, p1.edges, p1.index_bytes, p1.span, p1.host_ns) == (3, 3, 8, -1, None)
    trace.clear()
    assert trace.spans() == [] and trace.launches() == []


def _names():
    return [s.name for s in trace.spans()]


def test_a_second_session_holds_only_its_own_records(tiny):
    g, x, y = tiny
    sage, gat = _models("cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        _step(gat, g, x, y)
    alone = sorted(_names())
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _step(sage, g, x, y)
        trace.launch("K1", "spmm", g.indptr, g.src, x)
    assert PREFIX + "SAGEConv.forward" in _names() and len(trace.launches()) == 1
    _step(sage, g, x, y)  # unprofiled steps between the sessions
    with profile(activities=[ProfilerActivity.CPU]):
        _step(gat, g, x, y)
    assert sorted(_names()) == alone and trace.launches() == []
    assert all(s.parent < len(trace.spans()) for s in trace.spans())


def test_a_profiler_that_hands_its_ranges_on_keeps_nothing(tiny, monkeypatch):
    g, x, y = tiny
    _, gat = _models("cpu")
    # nvtx and itt ranges go to their tools at once: nothing to keep here
    monkeypatch.setattr(trace, "_profiler_type", lambda: ActiveProfilerType.NVTX)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(gat, g, x, y)
        trace.launch("K3", "fwd", g.indptr, g.src, x)
    assert trace.spans() == [] and trace.launches() == []
    ranges = {e.name for e in prof.events()}
    assert {PREFIX + s for s in GAT_SPANS} <= ranges


def test_a_span_opened_before_clear_is_nobodys_parent():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("dgl_tpu_torch.test.outer"):
            trace.clear()
            with trace.span("dgl_tpu_torch.test.inner"):
                trace.launch("P1", "index", None, torch.zeros(3, dtype=torch.int32),
                             torch.zeros(4, 2))
    (inner,) = trace.spans()
    assert inner.name == PREFIX + "test.inner" and inner.parent == -1
    assert trace.launches()[0].span == 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_step_records_each_counted_launch(tmp_path):
    dev = _card()
    g = _graph(3000, 40_000, dev)
    x = torch.randn(3000, 12, device=dev)
    y = torch.randint(0, 5, (3000,), device=dev)
    sage, gat = _models(dev)
    counters = (csr_spmm, gat_attention_fwd, gat_attention_bwd, gat_scores, gat_score_grad,
                gat_vector_grad)
    _step(sage, g, x, y)  # builds the kernels outside the profiled step
    _step(gat, g, x, y)
    torch.cuda.synchronize()
    before = [c.launches for c in counters]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _step(sage, g, x, y)
        _step(gat, g, x, y)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    exported = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
                if e.get("cat") == "user_annotation"}
    # the backward spans run on autograd's device thread
    assert {PREFIX + s for s in SAGE_SPANS | GAT_SPANS} <= exported
    counted = [c.launches - b for c, b in zip(counters, before)]
    recs = trace.launches()
    k1 = [r for r in recs if r.kernel == "K1"]
    fwd = [r for r in recs if r.kernel == "K3" and r.pass_ == "fwd"]
    b2 = [r for r in recs if r.kernel == "K3" and r.pass_ == "b2"]
    # K3's node passes, one record each a layer under their own id
    nodes = [[r for r in recs if r.kernel == "K3N" and r.pass_ == p]
             for p in ("scores", "score_grad", "vector_grad")]
    assert [len(k1), len(fwd), len(b2)] + [len(x) for x in nodes] == counted == [6, 2, 2, 2, 2, 2]
    assert len(recs) == sum(counted)
    n, e, ib = g.num_dst_nodes, g.num_edges, g.indptr.element_size()
    for r in recs:
        if r.kernel == "K3N":  # a node pass reads N rows of (H, D) floats
            assert (r.rows, r.src_rows, r.edges, r.value_bytes) == (n, n, n, 4)
        else:
            assert (r.rows, r.src_rows, r.edges, r.index_bytes, r.value_bytes) == (n, n, e, ib, 4)
        assert r.host_ns > 0 and trace.spans()[r.span].name.startswith(PREFIX + r.kernel)
    # SAGE 12 -> 8 -> 8 -> 5: layers 1 and 3 project first, layer 2
    # aggregates its input; each way
    assert sorted(r.d for r in k1) == [5, 5, 8, 8, 8, 8]
    assert not any(r.weighted for r in k1)
    # GAT: 12 -> 2 heads of 4 -> 2 heads of 5; attention dropout from layer 2
    assert [(r.heads, r.d, r.dropout) for r in fwd] == [(2, 4, False), (2, 5, True)]
    assert sorted((r.heads, r.d, r.dropout) for r in b2) == [(2, 4, False), (2, 5, True)]
