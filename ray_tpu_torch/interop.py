"""Carry parameters across from the JAX package.

``params_from_jax`` takes a ray_tpu parameter pytree already brought to
the host as numpy arrays (``jax.device_get(params)``) and returns the
same tree of torch tensors on ``device``. The layouts are the same in
both packages (stacked ``[n_layers, ...]`` leaves, einsum weight
layouts), so the conversion is a pure copy. It is dtype-exact: bfloat16
arrays (ml_dtypes, which ``torch.from_numpy`` rejects) go through a
``uint16`` view of the same bits.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy the tensor may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device="cuda"):
    """Nested dicts, lists and tuples of numpy arrays -> the same tree of
    tensors (RLlib's trees hold lists of layers)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _leaf(tree, device)
