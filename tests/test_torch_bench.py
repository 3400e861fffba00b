"""The port's entry point, rehearsed on the CPU at a tiny scale."""

import json
import math

from dgl_tpu_torch import bench
from dgl_tpu_torch.data import load_node_dataset
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.train import EpochTimer, PhaseTimer, time_fn


def test_run_trains_both_modes_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(bench, "load_node_dataset", _tiny)
    before = csr_spmm.launches
    res = bench.run("reddit", epochs=2, warmup=1, device="cpu", profile_epochs=1)
    assert csr_spmm.launches == before  # CPU tensors never launch the kernel
    assert res["device"] == "cpu" and res["synthetic"]
    for mode in ("unhoisted", "hoisted"):
        losses = res[mode]["losses"]
        assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
        assert losses[-1] < losses[0]
        assert len(res[mode]["epochs_s"]) == 2
        prof = res[mode]["profile"]  # no device events on the CPU
        assert prof["epochs"] == 1 and prof["kernels"] == [] and prof["wall_ms_per_epoch"] > 0
    # same weights and dropout seed: the modes agree on the first step
    assert abs(res["unhoisted"]["losses"][0] - res["hoisted"]["losses"][0]) < 1e-4


def test_main_prints_one_json_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(bench, "load_node_dataset", _tiny)
    bench.main(["--device", "cpu", "--epochs", "1", "--warmup", "0", "--unhoisted-only"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "reddit_sage_epoch_time" and line["unit"] == "s"
    assert line["backend"] == "torch-cpu" and line["device"] == "cpu"
    assert line["value"] > 0 and "hoisted_s" not in line


def _tiny(name):
    """The entry point always loads at full scale; the tests shrink it."""
    return load_node_dataset(name, scale=0.002)


def test_timers_on_cpu():
    calls = []
    assert time_fn(lambda: calls.append(1), reps=3, warmup=2, device="cpu") >= 0
    assert len(calls) == 5
    pt = PhaseTimer(device="cpu")
    with pt.phase("forward"):
        calls.append(1)
    with pt.phase("forward"):
        pass
    assert set(pt.totals) == {"forward"} and pt.summary().startswith("forward: ")
    et = EpochTimer(warmup=1, device="cpu")
    for _ in range(3):
        et.start()
        et.stop()
    assert len(et.durations) == 2 and et.mean >= 0
