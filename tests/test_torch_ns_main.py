"""The port's neighbour-sampling drivers, rehearsed on the CPU at a tiny
--scale: ns_sage with the device sampler, --host-sampler, --no-replace and
--inductive, ns_gat with the device and the host sampler. They print the
reference's lines, their losses are finite and fall, and spies on the
kernels' wrappers see one P1 (index order) feature gather a step, no K1, K2
or K3 inside a step, and the evaluations' K1 or K3 calls (K3's with its
scores) that chip_smoke.ns_launches derives from the code."""

import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dgl_tpu_torch.benchmarks.sampling import ns_gat, ns_sage, pipeline
from dgl_tpu_torch.kernels import csr_spmm as k1_mod
from dgl_tpu_torch.kernels import gat_attention as k3_mod
from dgl_tpu_torch.kernels import row_gather as p1_mod
from dgl_tpu_torch.kernels import seg_sum as k2_mod

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SCALE = 0.002
EPOCHS = 7  # one evaluation (epoch 5) and two epochs in "Avg epoch time"
FLAGS = ["--device", "cpu", "--scale", str(SCALE), "--num-epochs", str(EPOCHS),
         "--batch-size", "50", "--log-every", "2"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the machine's cores (see
    test_torch_sage_main.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The synthetic cache in the test's own directory."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))


@pytest.fixture
def events(monkeypatch):
    """The order of the step's P1 gathers, its losses and every K1, K2, K3
    and P1-in-source-order call (each wrapper's plain version, which CPU
    tensors take)."""
    log = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            log.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pipeline, "row_gather_async", spy("P1", pipeline.row_gather_async))
    monkeypatch.setattr(pipeline, "masked_softmax_ce", spy("loss", pipeline.masked_softmax_ce))
    monkeypatch.setattr(k1_mod, "csr_spmm_plain", spy("csr_spmm", k1_mod.csr_spmm_plain))
    monkeypatch.setattr(k2_mod, "seg_sum_plain", spy("seg_sum", k2_mod.seg_sum_plain))
    monkeypatch.setattr(p1_mod, "row_gather_by_source_plain",
                        spy("row_gather_by_source", p1_mod.row_gather_by_source_plain))
    monkeypatch.setattr(k3_mod, "gat_attention_fwd_plain",
                        spy("gat_attention_fwd", k3_mod.gat_attention_fwd_plain))
    monkeypatch.setattr(k3_mod, "gat_attention_bwd_plain",
                        spy("gat_attention_bwd", k3_mod.gat_attention_bwd_plain))
    for name in ("gat_scores", "gat_score_grad", "gat_vector_grad"):
        monkeypatch.setattr(k3_mod, f"{name}_plain", spy(name, getattr(k3_mod, f"{name}_plain")))
    return log


def _check_run(res, out, log, kind, layers=2):
    for line in ("Epoch 00000 | Step 00000 | Loss ", "| Train Acc ", "| Speed (samples/sec) ",
                 "| GPU 0.0 MiB", "Epoch Time(s): ", "Eval Acc ", "Test Acc: ",
                 "Avg epoch time: "):
        assert line in out, line
    assert out.count("Epoch Time(s):") == EPOCHS and out.count("Eval Acc") == 1
    assert res["eval_epochs"] == [5] and len(res["epochs_s"]) == EPOCHS
    assert res["avg_epoch_s"] == pytest.approx(np.mean(res["epochs_s"][5:]))
    losses = res["losses"]
    assert len(losses) == res["steps"] == EPOCHS * res["steps_per_epoch"]
    assert all(math.isfinite(v) for v in losses)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert res["device"] == "cpu" and res["setup_bytes"] is None
    # inside a step (its P1 gather to its loss) no K1, K2 or K3 runs
    step, inside = False, []
    for ev in log:
        if ev == "P1":
            step = True
        elif ev == "loss":
            step = False
        elif step:
            inside.append(ev)
    assert not inside, inside
    counts = {k: log.count(k) for k in ("csr_spmm", "seg_sum", "row_gather_by_source",
                                        *chip_smoke.K3_COUNTERS)}
    counts["row_gather_async"] = log.count("P1")
    steps = res["steps"] + (res["profile"]["steps"] if res["profile"] else 0)
    assert log.count("loss") == steps
    assert counts == chip_smoke.ns_launches(kind, layers, steps, len(res["eval_epochs"]))


@pytest.mark.parametrize("extra", [[], ["--host-sampler"], ["--no-replace"],
                                   ["--inductive"], ["--inductive", "--host-sampler"],
                                   ["--host-sampler", "--profile", "9"]])
def test_ns_sage_prints_the_reference_lines_and_gathers_once_a_step(cache, capsys, events,
                                                                   extra):
    threads = threading.active_count()
    res = ns_sage.main(FLAGS + extra)
    _check_run(res, capsys.readouterr().out, events, "sage")
    if "--profile" in extra:  # 9 steps past the end of an epoch of 7, a step each
        assert res["profile"]["steps"] == 9 and res["steps_per_epoch"] < 9
    for _ in range(50):  # the host loader's prefetch threads have ended
        if threading.active_count() <= threads:
            break
        time.sleep(0.1)
    assert threading.active_count() <= threads


@pytest.mark.parametrize("extra", [[], ["--host-sampler"]])
def test_ns_gat_prints_the_reference_lines_and_gathers_once_a_step(cache, capsys, events, extra):
    res = ns_gat.main(FLAGS + ["--num-heads", "3"] + extra)
    _check_run(res, capsys.readouterr().out, events, "gat")


def test_the_samplers_see_the_same_seeds_each_epoch(cache, monkeypatch):
    """Both samplers shuffle the training ids with the seed's numpy
    generator, one permutation an epoch: every training node is a seed once
    an epoch, and --inductive samples only edges between training nodes."""
    seen = []

    def spy(x, idx):
        seen.append(idx.clone())
        return x[idx]

    monkeypatch.setattr(pipeline, "row_gather_async", spy)
    res = ns_sage.main(["--device", "cpu", "--scale", str(SCALE), "--num-epochs", "1",
                        "--batch-size", "40", "--inductive", "--host-sampler"])
    from dgl_tpu_torch.data import load_node_dataset
    data = load_node_dataset("reddit", scale=SCALE)
    train = set(np.flatnonzero(data.train_mask).tolist())
    assert len(seen) == res["steps_per_epoch"] == -(-len(train) // 40)
    for idx in seen:  # every sampled node is a training node or a padding seed 0
        assert set(idx.tolist()) <= train | {0}


def test_left_out_and_bad_flags_raise(cache):
    with pytest.raises(NotImplementedError, match="TPU"):
        ns_sage.main(FLAGS + ["--scan-steps"])
    with pytest.raises(NotImplementedError, match="TPU"):
        ns_gat.main(FLAGS + ["--scan-steps"])
    with pytest.raises(ValueError, match="--fan-out length"):
        ns_sage.main(FLAGS + ["--fan-out", "10,25,5"])
    with pytest.raises(SystemExit):
        ns_gat.main(FLAGS + ["--inductive"])  # the JAX ns_gat has no such flag
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ns_sage.main(["--scale", str(SCALE), "--num-epochs", "1"])
