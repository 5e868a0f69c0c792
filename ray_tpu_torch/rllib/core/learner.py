"""TorchLearner + LearnerGroup: the update path (port of
ray_tpu/rllib/core/learner.py, whose JaxLearner runs one jitted step).

One update is autograd over the algorithm's loss, the optimizer's
transforms (the port's optax-style ``ops/optim.py``: adam with optional
global-norm clipping, in optax's order) and the parameters updated IN
PLACE (ray_tpu donates the old buffers and returns new ones).

The learner lives in the driver process, on the module's device.
Learner actors (``num_learners > 0``) and a learner sharded over a mesh
wait for ROADMAP.md §1 item 7 part 2 and the next RLlib slice.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ray_tpu_torch.ops import optim
from ray_tpu_torch.ops.tree import flatten, tree_map, unflatten
from ray_tpu_torch.rllib.core.rl_module import to_tensor
from ray_tpu_torch.rllib.sample_batch import SampleBatch

REMOTE_LEARNERS = ("num_learners > 0 (learner actors) waits for the runtime core: "
                   "ROADMAP.md §1 item 7, part 2")


def make_optimizer(cfg) -> optim.GradientTransformation:
    """The shared algorithm optimizer: adam(lr) with optional global-norm
    clipping (reference: Learner._configure_optimizers default)."""
    tx = optim.adam(cfg.lr)
    if cfg.grad_clip is not None:
        tx = optim.chain(optim.clip_by_global_norm(cfg.grad_clip), tx)
    return tx


class TorchLearner:
    """Owns the module's parameters, the optimizer state and the update.

    ``loss_fn(params, apply_fn, batch) -> (loss, metrics_dict)`` is
    supplied by the algorithm; ``batch`` holds tensors on the learner's
    device. The optimizer works on the parameters flattened to {dotted
    path: tensor} in jax's sorted-key order, so that the global norm sums
    the leaves in the reference's order."""

    def __init__(self, module, loss_fn: Callable, optimizer: optim.GradientTransformation,
                 seed: int = 0):
        self.module = module
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.device = module.device
        self.opt_state = optimizer.init(flatten(module.params))
        self._metrics: dict = {}
        # Advances across update_epochs calls: fresh minibatch permutations
        # every training_step.
        self._rng = np.random.default_rng(seed)

    def update(self, batch: SampleBatch) -> dict:
        """One gradient step on ``batch`` (already minibatched by the
        algorithm; values may be nested trees of arrays)."""
        tbatch = {k: tree_map(lambda a: to_tensor(a, self.device), v)
                  for k, v in batch.items()}
        flat = flatten(self.module.params)
        live = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        with torch.enable_grad():
            loss, metrics = self.loss_fn(unflatten(self.module.params, live),
                                         self.module.apply, tbatch)
        grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        # A parameter the loss does not reach has a zero gradient (JAX's).
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(live.items(), grads)}
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state, flat)
        optim.apply_updates(flat, updates)
        metrics["total_loss"] = loss
        metrics["grad_norm"] = optim.global_norm(grads)
        # One copy to the host for all of them.
        values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
        self._metrics = dict(zip(metrics, values))
        return self._metrics

    def update_epochs(self, batch: SampleBatch, *, num_epochs: int, minibatch_size: int,
                      rng: np.random.Generator | None = None) -> dict:
        """SGD epochs over shuffled minibatches (reference: Learner.update
        with minibatching)."""
        rng = rng or self._rng
        last: dict = {}
        for _ in range(num_epochs):
            shuffled = batch.shuffle(rng)
            for mb in shuffled.minibatches(minibatch_size):
                last = self.update(mb)
        return last

    def get_weights(self):
        return self.module.get_weights()

    def set_weights(self, weights) -> None:
        # The optimizer's moments keep their values (meant for a weight
        # broadcast where the structure is unchanged).
        self.module.set_weights(weights)

    def get_state(self) -> dict:
        return {"params": self.module.get_weights(),
                "opt_state": tree_map(lambda t: t.detach().cpu().numpy(), self.opt_state)}

    def set_state(self, state: dict) -> None:
        self.module.set_weights(state["params"])
        self.opt_state = tree_map(lambda a: to_tensor(a, self.device).clone(),
                                  state["opt_state"])


class LearnerGroup:
    """The local learner (reference: rllib/core/learner/learner_group.py:72
    with num_learners == 0: the learner lives in the driver process)."""

    def __init__(self, learner_factory: Callable[[], TorchLearner], num_learners: int = 0):
        if num_learners > 0:
            raise NotImplementedError(REMOTE_LEARNERS)
        self.num_learners = 0
        self.local = learner_factory()

    def update_epochs(self, batch: SampleBatch, **kw) -> dict:
        return self.local.update_epochs(batch, **kw)

    def get_weights(self):
        return self.local.get_weights()

    def set_weights(self, weights) -> None:
        self.local.set_weights(weights)

    def get_state(self) -> dict:
        return self.local.get_state()

    def set_state(self, state: dict) -> None:
        self.local.set_state(state)

    def stop(self) -> None:
        pass
