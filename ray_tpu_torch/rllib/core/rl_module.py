"""RLModule: the policy-network container (port of
ray_tpu/rllib/core/rl_module.py).

Parameters are an explicit tree of tensors on the module's device (dicts
and lists, as ray_tpu's pytree: ``{"torso": [{"w", "b"}, ...], ...}``),
and ``apply(params, obs)`` is a pure function of them: the env runner
calls it under no_grad, the learner under autograd, and weight sync is
shipping the tree as numpy.

Initialisation: orthogonal weights of scale sqrt(2) and zero biases from
a ``torch.Generator`` seeded by ``seed``. jax.random and torch draw
different numbers, so the two packages' modules start from different
weights for the same seed; the tests carry weights across instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from ray_tpu_torch.ops.tree import tree_map


def to_tensor(x, device) -> torch.Tensor:
    """A numpy array, scalar or tensor as a tensor on ``device``; float64
    becomes float32 (jax's arrays without x64 do the same)."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``, never a view of it: the learner updates its
    tensors in place, also on the CPU, where ``.cpu().numpy()`` would
    share their memory."""
    return t.detach().to("cpu", copy=True).numpy()


@dataclasses.dataclass
class RLModuleSpec:
    """Reference: rllib/core/rl_module/rl_module.py RLModuleSpec; with the
    ``device`` its module's parameters live on."""

    observation_dim: int
    action_dim: int
    hidden: Sequence[int] = (64, 64)
    module_class: "type[RLModule] | None" = None
    device: str = "cuda"

    def build(self, seed: int = 0) -> "RLModule":
        cls = self.module_class or DiscreteActorCriticModule
        return cls(self, seed)


class RLModule:
    """Holds a parameter tree and pure apply functions. Subclasses define
    the net."""

    def __init__(self, spec: RLModuleSpec, seed: int = 0):
        self.spec = spec
        self.device = torch.device(spec.device)
        gen = torch.Generator().manual_seed(seed)
        self.params = tree_map(lambda t: t.to(self.device), self.init_params(gen))

    # --- subclass surface (pure functions of (params, obs)) ---

    def init_params(self, gen: torch.Generator) -> Any:
        raise NotImplementedError

    def apply(self, params, obs: torch.Tensor) -> dict:
        """Returns at least {"action_dist_inputs": logits, "vf_preds": v}."""
        raise NotImplementedError

    # --- shared ---

    @torch.no_grad()
    def forward_inference(self, obs: np.ndarray) -> dict:
        """One batched forward on the module's device; numpy out."""
        out = self.apply(self.params, to_tensor(obs, self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    forward_exploration = forward_inference

    def get_weights(self) -> Any:
        return tree_map(to_numpy, self.params)

    def set_weights(self, weights: Any) -> None:
        # A copy: the module updates its tensors in place (the learner),
        # so it must not share them with the caller's.
        self.params = tree_map(lambda a: to_tensor(a, self.device).clone(), weights)


def _mlp_init(gen: torch.Generator, sizes: Sequence[int]) -> list:
    params = []
    for m, n in zip(sizes[:-1], sizes[1:]):
        w = torch.empty(m, n)
        # Orthogonal init, standard for PPO stability.
        torch.nn.init.orthogonal_(w, gain=math.sqrt(2), generator=gen)
        params.append({"w": w, "b": torch.zeros(n)})
    return params


def _mlp_apply(layers, x, activate_last: bool = False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or activate_last:
            x = torch.tanh(x)
    return x


class DiscreteActorCriticModule(RLModule):
    """Shared-torso MLP with categorical policy + value heads (reference
    analogue: rllib default MLP catalog for PPO)."""

    def init_params(self, gen: torch.Generator) -> Any:
        s = self.spec
        torso = _mlp_init(gen, [s.observation_dim, *s.hidden])
        pi_head = _mlp_init(gen, [s.hidden[-1], s.action_dim])
        vf_head = _mlp_init(gen, [s.hidden[-1], 1])
        # Small final policy layer -> near-uniform initial policy.
        pi_head[-1]["w"] = pi_head[-1]["w"] * 0.01
        return {"torso": torso, "pi": pi_head, "vf": vf_head}

    def apply(self, params, obs) -> dict:
        h = _mlp_apply(params["torso"], obs, activate_last=True)
        logits = _mlp_apply(params["pi"], h)
        value = _mlp_apply(params["vf"], h)[..., 0]
        return {"action_dist_inputs": logits, "vf_preds": value}


def categorical_logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, actions[..., None].long())[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -(torch.exp(logp) * logp).sum(-1)
