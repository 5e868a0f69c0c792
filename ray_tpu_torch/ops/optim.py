"""Optimizers for the training step (port of ray_tpu/ops/optim.py, and
of the optax transforms the repo's callers use).

``FusedClipAdamW``: the same semantics as ray_tpu's (and so as
optax.chain(clip_by_global_norm(c), adamw(...))): one global gradient
norm, each gradient clipped inline to (g / norm) · clip where the norm
is not below clip (optax's order of operations: ray_tpu's FusedClipAdamW
and optax's chain give the same bits under jit, and so do the port's
two), the bias-corrected Adam direction, and decoupled weight decay
added after it, NOT rescaled by the clip. The norm is returned so the step's metric costs
nothing more. The reference is an XLA fusion, not a Pallas kernel; here it
is plain PyTorch. Unlike the reference, ``apply`` updates the parameters
and the moments IN PLACE (JAX returns new arrays): the returned trees are
the ones passed in.

The optax-style transforms (``GradientTransformation``: ``init(params)``
-> state, ``update(updates, state, params)`` -> (updates, state)):
``clip_by_global_norm``, ``adam``, ``adamw``, ``sgd`` and ``chain``, with
``global_norm`` and ``apply_updates``. The port keeps its own copy of
optax 0.2.x's numerics for scalar learning rates: the same order of
operations, states of the same shape (an int32 ``count``), tensors on the
parameters' device. ``update`` returns new tensors; ``apply_updates``
adds the updates to the parameters IN PLACE (optax returns new arrays).

Sharded parameters (DTensors): the global norms sum over every shard,
and FusedClipAdamW updates each rank's shards in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.ops.tree import tree_leaves, tree_map, tree_unflatten, zeros_like


@dataclass(frozen=True)
class FusedClipAdamW:
    """AdamW with inline global-norm clipping.

    ``init`` mirrors optax's state shape {m, v, count}; ``apply(grads,
    state, params)`` returns (params, state, grad_norm) after updating
    params, m and v in place. ``mu_dtype`` (a torch dtype, e.g.
    torch.bfloat16) stores the first moment in fewer bits.
    """

    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0
    mu_dtype: torch.dtype | None = None

    def init(self, params):
        device = next(tree_leaves(params)).device
        return {
            "m": zeros_like(params, self.mu_dtype),
            "v": zeros_like(params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def apply(self, grads, state, params):
        gnorm = global_norm(grads)
        # A clipped gradient is (g / norm) * clip, in optax's order of
        # operations, and an unclipped one (g / 1) * 1: the bits of
        # chain(clip_by_global_norm, adamw), as ray_tpu's two give under jit.
        one = torch.ones((), dtype=torch.float32, device=gnorm.device)
        div, mul = one, one
        if self.clip_norm is not None:
            clipped = gnorm >= self.clip_norm
            div = torch.where(clipped, gnorm, one)
            mul = torch.where(clipped, self.clip_norm * one, one)
        count = state["count"] + 1
        c = count.float()
        # optax's bias correction: m̂ = m/(1-b1^t), v̂ = v/(1-b2^t).
        bc1 = 1.0 - torch.pow(self.b1, c)
        bc2 = 1.0 - torch.pow(self.b2, c)
        for p, g, m, v in zip(*(map(_local, tree_leaves(t))
                                for t in (params, grads, state["m"], state["v"]))):
            gf = (g.float() / div) * mul
            m_new = self.b1 * m.float() + (1.0 - self.b1) * gf
            v_new = self.b2 * v.float() + (1.0 - self.b2) * (gf * gf)
            update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p.float()
            p.copy_(p.float() - self.learning_rate * update)
            m.copy_(m_new)
            v.copy_(v_new)
        return params, {"m": state["m"], "v": state["v"], "count": count}, gnorm


# -- optax-style gradient transformations -------------------------------------

class GradientTransformation(NamedTuple):
    """optax's protocol: ``init(params)`` -> state; ``update(updates,
    state, params=None)`` -> (updates, state)."""

    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


class EmptyState(NamedTuple):
    """The state of a transformation that keeps none."""


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar: steps taken
    mu: Any
    nu: Any


class TraceState(NamedTuple):
    trace: Any


def _map2(fn, a, b):
    """``fn`` leaf by leaf over two trees of one structure."""
    return tree_unflatten(a, [fn(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))])


def _stateless(update) -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(), update)


def _square_sum(x) -> torch.Tensor:
    """Σ x² in float32 over every element of ``x``; a DTensor's over all
    of its shards (each rank's own, reduced), as a plain tensor."""
    s = x.float().square().sum()
    return s.full_tensor() if isinstance(s, DTensor) else s


def _local(x):
    """A DTensor's shard on this rank (the tensor itself, so an in-place
    update of it updates the DTensor), or ``x``."""
    return x.to_local() if isinstance(x, DTensor) else x


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in float32 (over every shard of a
    DTensor leaf)."""
    return torch.sqrt(sum(_square_sum(x) for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u`` (u cast to p's dtype) for every leaf, IN PLACE; returns
    ``params`` (optax.apply_updates returns new arrays)."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))
    return params


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Apply ``transforms`` in order; the state is the tuple of theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        if len(state) != len(transforms):
            raise ValueError("chain: one state per transformation is needed; "
                             "call init first")
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale the updates by max_norm / norm when their global norm is not
    below max_norm."""

    @torch.no_grad()
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return tree_map(lambda t: torch.where(trigger, t,
                                              (t / g_norm.to(t.dtype)) * max_norm),
                        updates), state

    return _stateless(update)


def _identity() -> GradientTransformation:
    return _stateless(lambda updates, state, params=None: (updates, state))


def _scale(step_size: float) -> GradientTransformation:
    """updates · step_size (optax.scale; −learning_rate in the optimizers)."""

    @torch.no_grad()
    def update(updates, state, params=None):
        return tree_map(lambda g: g * step_size, updates), state

    return _stateless(update)


def _scale_by_adam(b1: float, b2: float, eps: float,
                   eps_root: float) -> GradientTransformation:
    """Adam's direction m̂ / (sqrt(v̂ + eps_root) + eps), bias-corrected."""

    def init(params):
        device = next(tree_leaves(params)).device
        return ScaleByAdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                                mu=zeros_like(params), nu=zeros_like(params))

    @torch.no_grad()
    def update(updates, state, params=None):
        mu = _map2(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = _map2(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates, state.nu)
        count = state.count + 1  # stays int32
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        updates = _map2(
            lambda m, v: (m / bc1.to(m.dtype))
            / (torch.sqrt(v / bc2.to(v.dtype) + eps_root) + eps), mu, nu)
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def _add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """updates + weight_decay · params."""

    @torch.no_grad()
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("adamw's weight decay needs the params")
        return _map2(lambda g, p: g + weight_decay * p, updates, params), state

    return _stateless(update)


def _trace(decay: float, nesterov: bool) -> GradientTransformation:
    """Momentum: t = g + decay·t; the update is t (g + decay·t with
    Nesterov)."""

    def init(params):
        return TraceState(trace=zeros_like(params))

    @torch.no_grad()
    def update(updates, state, params=None):
        new_trace = _map2(lambda g, t: g + decay * t, updates, state.trace)
        if nesterov:
            updates = _map2(lambda g, t: g + decay * t, updates, new_trace)
        else:
            updates = new_trace
        return updates, TraceState(trace=new_trace)

    return GradientTransformation(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    return chain(_scale_by_adam(b1, b2, eps, eps_root), _scale(-learning_rate))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """Adam with decoupled weight decay: −lr · (Adam's direction + wd · p)."""
    return chain(_scale_by_adam(b1, b2, eps, eps_root),
                 _add_decayed_weights(weight_decay), _scale(-learning_rate))


def sgd(learning_rate: float, momentum: float | None = None,
        nesterov: bool = False) -> GradientTransformation:
    return chain(_identity() if momentum is None else _trace(momentum, nesterov),
                 _scale(-learning_rate))
