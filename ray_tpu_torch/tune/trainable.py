"""The class Trainable (port of the ``Trainable`` class of
ray_tpu/tune/trainable.py): the setup/step/save_checkpoint/load_checkpoint
surface that RLlib's Algorithm subclasses. The rest of Tune (function
trainables, the trial actor, the controller) waits for the runtime core:
ROADMAP.md §1 item 6f.
"""

from __future__ import annotations

import os
from typing import Optional

DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Class trainable (reference: tune/trainable/trainable.py:57)."""

    def __init__(self, config: dict | None = None, trial_dir: str | None = None):
        self.config = config or {}
        self.trial_dir = trial_dir or os.getcwd()
        self.iteration = 0
        self.setup(self.config)

    # --- subclass surface ---

    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[dict]:
        raise NotImplementedError(f"{type(self).__name__} does not implement save_checkpoint")

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not implement load_checkpoint")

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        """Return True if the trainable can hot-swap configs (PBT exploit
        without an actor restart). Default: not supported."""
        return False

    # --- driver surface ---

    def train(self) -> dict:
        result = self.step() or {}
        self.iteration += 1
        result.setdefault(TRAINING_ITERATION, self.iteration)
        return result

    def save(self, checkpoint_dir: str | None = None) -> str:
        """Checkpoint to ``checkpoint_dir`` (default: a fresh
        ``checkpoint_{iteration:06d}`` under the trial dir) and return
        the path (reference: Trainable.save, trainable.py:467)."""
        dest = checkpoint_dir or os.path.join(
            self.trial_dir, f"checkpoint_{self.iteration:06d}")
        os.makedirs(dest, exist_ok=True)
        self.save_checkpoint(dest)
        return dest

    def restore(self, checkpoint_path: str) -> None:
        """Load state saved by :meth:`save` (reference:
        Trainable.restore, trainable.py:507)."""
        self.load_checkpoint(checkpoint_path)
