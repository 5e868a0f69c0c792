"""Parameter trees: nested dicts with tensor leaves.

The model, the train step and the optimizer pair gradients, parameters
and moments leaf by leaf, so all of them walk a tree through these
helpers, in one order: the dicts' insertion order, depth first.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def zeros_like(tree, dtype: torch.dtype | None = None):
    return tree_map(lambda t: torch.zeros_like(t, dtype=dtype or t.dtype), tree)
