"""ray_tpu_torch.tune: the class Trainable that RLlib's algorithms
subclass. Tuner, the schedulers and the trial actors wait for the runtime
core (ROADMAP.md §1 item 6f)."""

from ray_tpu_torch.tune.trainable import DONE, TRAINING_ITERATION, Trainable

__all__ = ["DONE", "TRAINING_ITERATION", "Trainable"]
