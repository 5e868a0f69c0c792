"""TorchLearner + LearnerGroup: the update path (port of
ray_tpu/rllib/core/learner.py, whose JaxLearner runs one jitted step).

One update is autograd over the algorithm's loss, the optimizer's
transforms (the port's optax-style ``ops/optim.py``: adam with optional
global-norm clipping, in optax's order) and the parameters updated IN
PLACE (ray_tpu donates the old buffers and returns new ones).

With ``num_learners == 0`` the learner lives in the driver process, on
the module's device. With N > 0 it lives in N actors of the port's core
(``LearnerGroup``): each updates on its shard of the batch and the
group averages the weights on the host, as the reference does. A
learner whose device is CUDA needs a GPU lease (a worker without one
sees no card): each actor asks for ``num_gpus=min(1, 1/N)``, so N
learners share one card through fractional leases, or take a card each
once N cards... (see ``learner_resources``). The reference has no
per-learner chip option, and this derives the lease from the device
instead of adding one.

With ``mesh`` (a one-dimensional DeviceMesh with a ``data`` dimension)
the update is ray_tpu's SPMD program over that mesh: the parameters
and the optimizer state replicated, the minibatch sharded over
``data``. Every rank runs the same algorithm from the same seed, so
every rank is handed the same whole minibatch; each keeps its own
contiguous block of rows (``P("data")``'s layout) and computes the
update of the WHOLE minibatch: the losses take their means with
``batch_mean``, which all-reduces the rank's partial sum (so the
advantage normalisation, every loss term and every metric are of the
whole minibatch), and the ranks' gradients are averaged in one
all-reduce before the optimizer, so every rank ends with the same
parameters and optimizer state, bit for bit. Only ``all_reduce`` is
needed, which gloo takes on CUDA tensors as well (the functional
collectives that DTensor's redistributions use are not). A minibatch
whose rows do not divide over the ranks raises ValueError, as jit's
``in_shardings`` does.
"""

from __future__ import annotations

import contextvars
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.ops import optim
from ray_tpu_torch.ops.tree import flatten, tree_map, unflatten
from ray_tpu_torch.rllib.core.rl_module import to_numpy, to_tensor
from ray_tpu_torch.rllib.sample_batch import SampleBatch

# The process group of the ``data`` dimension while a learner with a mesh
# computes its loss; None otherwise (batch_mean is then a plain mean).
_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_group", default=None)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) of each rank's partial sum. Every rank computes the
    same loss from the total and the learner averages the ranks'
    gradients, so the backward gives each rank world_size times the
    incoming gradient: the ranks' mean of the parameters' gradients is
    then the gradient of the one loss, terms that reach a parameter
    without passing through the batch (SAC's temperature) included."""

    @staticmethod
    def forward(ctx, partial, group):
        ctx.world = dist.get_world_size(group)
        total = partial.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.world, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x``, a tensor of per-row values, over
    the whole minibatch: the sum of this rank's rows over all ranks of the
    learner's ``data`` mesh, divided by the whole count. Without a mesh it
    is this tensor's mean, by the same formula (sum, then divide), so
    that a mesh of one rank gives the same bits."""
    total, count = x.sum(), x.numel()
    group = _DATA_GROUP.get()
    if group is not None:
        total = _SumOverRanks.apply(total, group)
        count *= dist.get_world_size(group)
    return total / count


def batch_std(x: torch.Tensor) -> torch.Tensor:
    """The population standard deviation (jnp.std's) of ``x`` over the
    whole minibatch."""
    return torch.sqrt(batch_mean(torch.square(x - batch_mean(x))))


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
    the leaves in the reference's order.

    ``mesh``: a one-dimensional DeviceMesh whose dimension is named
    ``data_axis``; see the module's docstring. ``time_major_T``: the
    rollout length of a loss that reads its rows as t-major [T, B]
    (V-trace's); with a mesh, each rank then keeps a contiguous block of
    the B columns (the whole of each of its trajectories), where the
    reference keeps a block of the flat rows and XLA moves the rows the
    time recursion needs."""

    def __init__(self, module, loss_fn: Callable, optimizer: optim.GradientTransformation,
                 seed: int = 0, mesh=None, data_axis: str = "data",
                 time_major_T: int | None = None):
        self.module = module
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.device = module.device
        self.opt_state = optimizer.init(flatten(module.params))
        self._metrics: dict = {}
        # Advances across update_epochs calls: fresh minibatch permutations
        # every training_step.
        self._rng = np.random.default_rng(seed)
        self.mesh = mesh
        self._group = None
        self._time_major_T = time_major_T
        if mesh is not None:
            if mesh.ndim != 1 or tuple(mesh.mesh_dim_names or ()) != (data_axis,):
                raise ValueError(
                    f"the learner's mesh must have the one dimension {data_axis!r}, got "
                    f"dimensions {mesh.mesh_dim_names} of shape {tuple(mesh.shape)}")
            self._group = mesh.get_group(data_axis)
            self._rank = mesh.get_local_rank(data_axis)
            self._world = mesh.size()

    def _local_rows(self, batch: dict) -> dict:
        """This rank's block of every column (leaves of rank 0, such as
        CQL's ``use_bc``, are replicated)."""
        n, r, T = self._world, self._rank, self._time_major_T

        def block(a):
            if not hasattr(a, "shape"):
                a = np.asarray(a)
            if a.ndim == 0:
                return a
            if T is not None:  # [T*B] t-major: a block of the B columns
                cols = a.reshape((T, -1) + a.shape[1:])
                if cols.shape[1] % n:
                    raise ValueError(f"{cols.shape[1]} columns of a t-major batch do not "
                                     f"divide over the {n} ranks of the data mesh")
                b = cols.shape[1] // n
                return cols[:, r * b:(r + 1) * b].reshape((-1,) + a.shape[1:])
            if a.shape[0] % n:
                raise ValueError(f"a minibatch of {a.shape[0]} rows does not divide over "
                                 f"the {n} ranks of the data mesh")
            b = a.shape[0] // n
            return a[r * b:(r + 1) * b]

        return {k: tree_map(block, v) for k, v in batch.items()}

    def update(self, batch: SampleBatch) -> dict:
        """One gradient step on ``batch`` (already minibatched by the
        algorithm; values may be nested trees of arrays). With a mesh,
        every rank passes the whole minibatch and keeps its block."""
        if self._group is not None:
            batch = self._local_rows(batch)
        tbatch = {k: tree_map(lambda a: to_tensor(a, self.device), v)
                  for k, v in batch.items()}
        flat = flatten(self.module.params)
        live = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        token = _DATA_GROUP.set(self._group)
        try:
            with torch.enable_grad():
                loss, metrics = self.loss_fn(unflatten(self.module.params, live),
                                             self.module.apply, tbatch)
        finally:
            _DATA_GROUP.reset(token)
        grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        # A parameter the loss does not reach has a zero gradient (JAX's).
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(live.items(), grads)}
        if self._group is not None:
            grads = self._mean_over_ranks(grads)
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state, flat)
        optim.apply_updates(flat, updates)
        metrics["total_loss"] = loss
        metrics["grad_norm"] = optim.global_norm(grads)
        # One copy to the host for all of them.
        values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
        self._metrics = dict(zip(metrics, values))
        return self._metrics

    def _mean_over_ranks(self, grads: dict) -> dict:
        """The ranks' mean of each gradient, in one all-reduce of them all."""
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        dist.all_reduce(flat, group=self._group)
        flat = flat / self._world
        parts = torch.split(flat, [g.numel() for g in grads.values()])
        return {k: p.view_as(g) for (k, g), p in zip(grads.items(), parts)}

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
                "opt_state": tree_map(to_numpy, self.opt_state)}

    def set_state(self, state: dict) -> None:
        self.module.set_weights(state["params"])
        self.opt_state = tree_map(lambda a: to_tensor(a, self.device).clone(),
                                  state["opt_state"])


def learner_lease(device, num_learners: int) -> dict:
    """The actor options of one of ``num_learners`` learner actors: one
    CPU, as the reference's, and for a CUDA device a GPU lease of
    1/num_learners of a card (a whole card for one learner)."""
    opts = {"num_cpus": 1}
    if torch.device(device).type == "cuda":
        opts["num_gpus"] = min(1.0, 1.0 / num_learners)
    return opts


class LearnerGroup:
    """Local learner or remote learner actors (reference:
    rllib/core/learner/learner_group.py:72 — update :194).

    With num_learners == 0 the learner lives in the driver process. With
    N > 0, N actors each update on a batch shard and the group averages
    the resulting weights on the host. ``device`` is the learners'
    device (their modules'), which decides the actors' lease."""

    def __init__(self, learner_factory: Callable[[], TorchLearner], num_learners: int = 0,
                 *, device="cuda"):
        import ray_tpu_torch

        self.num_learners = num_learners
        if num_learners == 0:
            self.local = learner_factory()
            self.remotes = []
        else:
            self.local = None
            actor_cls = ray_tpu_torch.remote(**learner_lease(device, num_learners))(
                _LearnerActor)
            self.remotes = [actor_cls.remote(learner_factory) for _ in range(num_learners)]

    def update_epochs(self, batch: SampleBatch, **kw) -> dict:
        import ray_tpu_torch

        if self.local is not None:
            return self.local.update_epochs(batch, **kw)
        n = self.num_learners
        if len(batch) < n:
            # Too few rows to shard: replicate (identical updates beat
            # empty shards whose mean() would be NaN).
            refs = [r.update_epochs.remote(batch, **kw) for r in self.remotes]
        else:
            # np.array_split-style bounds: remainder rows spread over the
            # first shards, nothing dropped.
            bounds = np.linspace(0, len(batch), n + 1, dtype=int)
            refs = [r.update_epochs.remote(batch.slice(int(bounds[i]), int(bounds[i + 1])), **kw)
                    for i, r in enumerate(self.remotes)]
        metrics = ray_tpu_torch.get(refs)
        self._average_weights()
        return metrics[0]

    def _average_weights(self) -> None:
        import ray_tpu_torch

        all_w = ray_tpu_torch.get([r.get_weights.remote() for r in self.remotes])
        avg = tree_map(lambda *xs: np.mean(np.stack(xs), axis=0), *all_w)
        ref = ray_tpu_torch.put(avg)
        ray_tpu_torch.get([r.set_weights.remote(ref) for r in self.remotes])

    def get_weights(self):
        import ray_tpu_torch

        if self.local is not None:
            return self.local.get_weights()
        return ray_tpu_torch.get(self.remotes[0].get_weights.remote())

    def set_weights(self, weights) -> None:
        import ray_tpu_torch

        if self.local is not None:
            self.local.set_weights(weights)
        else:
            ray_tpu_torch.get([r.set_weights.remote(weights) for r in self.remotes])

    def get_state(self) -> dict:
        import ray_tpu_torch

        if self.local is not None:
            return self.local.get_state()
        return ray_tpu_torch.get(self.remotes[0].get_state.remote())

    def set_state(self, state: dict) -> None:
        import ray_tpu_torch

        if self.local is not None:
            self.local.set_state(state)
        else:
            ray_tpu_torch.get([r.set_state.remote(state) for r in self.remotes])

    def stop(self) -> None:
        import ray_tpu_torch

        for r in self.remotes:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass


class _LearnerActor:
    """Actor wrapper so a TorchLearner can live in a worker process."""

    def __init__(self, factory: Callable[[], TorchLearner]):
        self.learner = factory()

    def update_epochs(self, batch, **kw):
        return self.learner.update_epochs(batch, **kw)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, w):
        self.learner.set_weights(w)

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, s):
        self.learner.set_state(s)
