"""Checkpoint and resume with ``torch.save``.

Counterpart of ``dgl_tpu/train/checkpoint.py`` (orbax there), with its
interface and its choice of which steps to keep:

* ``save(step, state)`` writes when ``step`` is a multiple of
  ``save_interval`` or nothing is saved yet, and never for a step at or
  below the latest one (orbax's ``save_interval_steps`` and initial-save
  policies); ``force=True`` writes regardless. It returns whether it wrote.
* After a write only the ``max_to_keep`` highest steps remain.
* ``restore_or(state)`` gives ``(latest state, latest step + 1)``, or
  ``(state, 0)`` with nothing saved.

``state`` is whatever ``torch.load(weights_only=True)`` reads back:
nested dicts, lists and tuples of tensors and numbers, such as the model's,
the optimiser's and a batch norm's state dicts, a ``torch.Generator``'s
state and the epoch. Step ``s`` lives in ``<directory>/<s>/state.pt``. It
is written into a temporary directory beside it and renamed when complete,
so a reader never finds half a checkpoint: a directory whose name is not a
step, or that holds no ``state.pt``, is no checkpoint. Writes are
synchronous, so ``wait`` has nothing to wait for.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional, Tuple

import torch

__all__ = ["CheckpointManager"]

_FILE = "state.pt"


class CheckpointManager:
    """``ckpt = CheckpointManager(dir, max_to_keep=3)``; ``state, start =
    ckpt.restore_or(state)``; ``ckpt.save(step, state)`` periodically;
    ``ckpt.close()``."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval: int = 1):
        if max_to_keep < 1 or save_interval < 1:
            raise ValueError("max_to_keep and save_interval must be at least 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep, self.save_interval = max_to_keep, save_interval
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        """The complete checkpoints' steps, ascending."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(self._path(int(name))))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval == 0 or latest is None

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        if not force and not self.should_save(step):
            return False
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} exists under {self.directory}")
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _FILE))
        os.rename(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, state_template: Any = None, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (default: the latest), on the CPU.
        With a dict ``state_template``, its keys must be the saved ones."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if isinstance(state_template, dict) and set(state_template) != set(state):
            raise KeyError(f"checkpoint {step} holds {sorted(state)}, expected "
                           f"{sorted(state_template)}")
        return state

    def restore_or(self, state: Any) -> Tuple[Any, int]:
        """(state, start_step): restored if a checkpoint exists, else as given."""
        step = self.latest_step()
        if step is None:
            return state, 0
        return self.restore(state, step), step + 1

    def wait(self) -> None:
        """Writes are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.wait()
