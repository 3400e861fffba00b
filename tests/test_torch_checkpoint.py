"""The port's CheckpointManager (torch.save) against the JAX package's
(orbax): fed the same saves, both keep the same steps and report the same
latest step and resume step; restored state equals the saved; a
half-written checkpoint is never picked up."""

import os

import numpy as np
import pytest
import torch

from dgl_tpu.train import CheckpointManager as JaxCheckpointManager

from dgl_tpu_torch.train import CheckpointManager


@pytest.mark.parametrize("interval,keep", [(2, 3), (1, 2), (3, 1)])
def test_the_steps_kept_are_orbaxs(tmp_path, interval, keep):
    ours = CheckpointManager(str(tmp_path / "torch"), max_to_keep=keep, save_interval=interval)
    theirs = JaxCheckpointManager(str(tmp_path / "orbax"), max_to_keep=keep,
                                  save_interval=interval)
    saved_t, saved_j = [], []
    for step in list(range(10)) + [9, 4]:  # a repeated and an older step are refused
        saved_t.append(ours.save(step, {"w": torch.full((3,), float(step)), "step": step}))
        saved_j.append(bool(theirs.save(step, {"w": np.full(3, float(step)), "step": step})))
    theirs.wait()
    assert saved_t == saved_j
    assert ours.all_steps() == sorted(theirs._mgr.all_steps())
    assert ours.latest_step() == theirs.latest_step()
    state, start = ours.restore_or({"w": torch.zeros(3), "step": -1})
    state_j, start_j = theirs.restore_or({"w": np.zeros(3), "step": -1})
    assert start == start_j == ours.latest_step() + 1
    assert torch.equal(state["w"], torch.from_numpy(np.asarray(state_j["w"], np.float32)))
    assert state["step"] == int(state_j["step"]) == ours.latest_step()
    ours.close()
    theirs.close()


def test_forced_saves_and_restore(tmp_path):
    ours = CheckpointManager(str(tmp_path), max_to_keep=3, save_interval=5)
    fresh = {"w": torch.zeros(2)}
    assert ours.restore_or(fresh) == (fresh, 0)
    with pytest.raises(FileNotFoundError):
        ours.restore()
    assert ours.save(0, {"w": torch.ones(2)})  # nothing saved yet: saved
    assert not ours.save(3, {"w": torch.ones(2)})
    assert ours.save(3, {"w": torch.full((2,), 3.0)}, force=True)
    assert ours.all_steps() == [0, 3]
    assert torch.equal(ours.restore(step=3)["w"], torch.full((2,), 3.0))
    with pytest.raises(KeyError):
        ours.restore({"other": 1})


def test_a_half_written_checkpoint_is_never_picked_up(tmp_path):
    ours = CheckpointManager(str(tmp_path), max_to_keep=3)
    ours.save(1, {"w": torch.ones(1)})
    os.makedirs(tmp_path / "7")  # a step directory without its file
    os.makedirs(tmp_path / ".8.tmp-123")  # a write cut off before the rename
    torch.save({"w": torch.zeros(1)}, tmp_path / ".8.tmp-123" / "state.pt")
    (tmp_path / "9").write_text("not a directory")
    assert ours.all_steps() == [1] and ours.latest_step() == 1
    state, start = ours.restore_or({"w": torch.zeros(1)})
    assert start == 2 and torch.equal(state["w"], torch.ones(1))
    assert CheckpointManager(str(tmp_path)).latest_step() == 1  # a new manager agrees
