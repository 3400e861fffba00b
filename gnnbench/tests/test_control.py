"""The comparison catches the control and the faults a cell can have.

Each fault is planted underneath the timed path and a whole run is driven
on the CPU at the tiny size (the look for a card skipped), which has to
come out not correct: a step that leaves the state unchanged; half of the
batch left out, the mean taken over the rest; a sampled neighbour altered
where the sampler produces it. The control, the float32 reference with
its GEMMs in TF32 (rounded operands on the CPU) put in the program's place,
has to fail the real cell's limits, which the tiny cells carry. The cells run on
one card, so no exchange between cards can be left out.
"""

from __future__ import annotations

import pytest
import torch

from gnnbench import correct
from gnnbench.run import make_cell, run_cell

CPU = torch.device("cpu")
CELLS = ["tiny_sage.full", "tiny_gat.full", "tiny_sage.tiny_ns"]


def _half(fn):
    def half(logits, labels, mask):
        keep = torch.zeros_like(mask)
        idx = torch.nonzero(mask).flatten()
        keep[idx[::2]] = True
        return fn(logits, labels, keep)
    return half


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result, rows = run_cell(tiny_root, cell, 31, 0.2, False, CPU)
    assert not result["correct"]
    change = [v["value"] for k, v in result["compared"].items() if k.startswith("change_gap")]
    assert change and all(v == pytest.approx(1.0) for v in change)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_is_not_correct(tiny_root, cell, monkeypatch):
    from dgl_tpu_torch.benchmarks import common
    from dgl_tpu_torch.benchmarks.sampling import pipeline

    monkeypatch.setattr(common, "masked_softmax_ce", _half(common.masked_softmax_ce))
    monkeypatch.setattr(pipeline, "masked_softmax_ce", _half(pipeline.masked_softmax_ce))
    result, _ = run_cell(tiny_root, cell, 32, 0.2, False, CPU)
    assert not result["correct"]


def test_an_altered_sample_is_not_correct(tiny_root, monkeypatch):
    from dgl_tpu_torch.sampling import DeviceNeighborSampler

    sample = DeviceNeighborSampler.input_nodes

    def altered(self, seeds, generator):
        ids = sample(self, seeds, generator)
        n = self.indptr.numel() - 1
        out = ids.clone()
        tail = out[-seeds.numel():]
        out[-seeds.numel():] = (tail + 1) % n
        return out

    monkeypatch.setattr(DeviceNeighborSampler, "input_nodes", altered)
    result, _ = run_cell(tiny_root, "tiny_sage.tiny_ns", 33, 0.2, False, CPU)
    assert not result["correct"] and result["compared"]["bad_samples"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS + ["tiny_gat.tiny_ns"])
def test_the_control_fails_the_limits(tiny_root, cell):
    c, _, limits, _, _ = make_cell(tiny_root, cell, 34, CPU)
    prog = c.loop.Program(c)
    prog.keep_steps = correct.STEPS
    for _ in range(correct.STEPS):
        prog.step()
    record = prog.record()
    ref, extra = c.loop.reference(c, record, steps=correct.STEPS)
    tf32, _ = c.loop.reference(c, record, steps=correct.STEPS, tf32=True, dtype=torch.float32)
    numbers, _ = correct.gaps(tf32, ref)
    numbers.update(extra)
    ok, rows = correct.judge(numbers, limits)
    assert not ok, rows
