"""Parameter trees: nested dicts, lists and tuples with tensor leaves.

The model, the train step, the optimizer, the sync helpers and RLlib
pair gradients, parameters and moments leaf by leaf, so all of them walk
a tree through these helpers. As in jax's pytrees, dicts, lists, plain
tuples and NamedTuples are nodes, and a tensor or a tuple subclass (a
partition spec, a torch.Size) is a leaf; unlike jax's, so is None.
``is_leaf`` makes a node a leaf, for trees whose leaves are plain
tuples.

Two orders: ``tree_leaves`` walks the dicts' insertion order, depth
first; ``flatten`` sorts dict keys, as jax does, for code whose sums
must follow the reference's order (RLlib's learner).
"""

from __future__ import annotations

import torch


def _is_node(x, is_leaf) -> bool:
    if is_leaf is not None and is_leaf(x):
        return False
    return (isinstance(x, (dict, list)) or type(x) is tuple
            or (isinstance(x, tuple) and hasattr(x, "_fields")))


def _items(tree):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def _rebuild(tree, children: list):
    """A node of ``tree``'s type holding ``children`` in ``_items`` order."""
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), children))
    if hasattr(tree, "_fields"):
        return type(tree)(*children)
    return type(tree)(children)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree``; the ``rest`` trees, of the same
    structure, give further arguments."""
    if not _is_node(tree, is_leaf):
        return fn(tree, *rest)
    return _rebuild(tree, [tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                           for k, v in _items(tree)])


def tree_leaves(tree, is_leaf=None):
    if _is_node(tree, is_leaf):
        for _, v in _items(tree):
            yield from tree_leaves(v, is_leaf)
    else:
        yield tree


def tree_unflatten(tree, leaves, is_leaf=None):
    """A tree shaped like ``tree`` holding ``leaves`` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree, is_leaf=is_leaf)


def flatten(tree, prefix: str = "") -> dict:
    """{dotted path: leaf}: dict keys sorted (jax's order, whatever the
    insertion order), list and tuple items by index."""
    if not _is_node(tree, None):
        return {prefix: tree}
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(tree, flat: dict, prefix: str = ""):
    """``tree``'s structure holding ``flat``'s leaves (``flatten``'s
    paths)."""
    if not _is_node(tree, None):
        return flat[prefix]
    return _rebuild(tree, [unflatten(v, flat, f"{prefix}.{k}" if prefix else str(k))
                           for k, v in _items(tree)])


def zeros_like(tree, dtype: torch.dtype | None = None):
    return tree_map(lambda t: torch.zeros_like(t, dtype=dtype or t.dtype), tree)
