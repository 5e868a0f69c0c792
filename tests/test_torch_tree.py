"""The port's tree walkers (ray_tpu_torch/ops/tree.py) against jax's
pytrees: the same nodes (dicts, lists, tuples, NamedTuples) and leaves
(tensors, None, tuple subclasses), ``flatten`` in jax's sorted-key
order, and ``is_leaf``."""

from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import tree as T
from ray_tpu_torch.parallel.sharding import P


class State(NamedTuple):
    count: object
    mu: object


def _tree(seed):
    rng = np.random.default_rng(seed)
    a = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"z": [{"w": a(3, 2), "b": a(2)}, {"w": a(2, 1), "b": a(1)}],
            "a": (a(4), State(count=a(), mu={"y": a(2), "x": a(3)})),
            "m": a(5)}


def _as_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def test_flatten_follows_jax_leaf_order():
    tree = _tree(0)
    got = list(T.flatten(_as_torch(tree)).values())
    want = jax.tree_util.tree_leaves(tree)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_unflatten_rebuilds_every_node_type():
    tree = _as_torch(_tree(1))
    back = T.unflatten(tree, T.flatten(tree))
    assert type(back["a"]) is tuple and type(back["a"][1]) is State
    assert isinstance(back["z"], list) and list(back) == list(tree)
    for g, w in zip(T.tree_leaves(back), T.tree_leaves(tree)):
        assert g is w


def test_tree_map_takes_further_trees_and_keeps_structure():
    a, b = _as_torch(_tree(2)), _as_torch(_tree(3))
    out = T.tree_map(lambda x, y: x - y, a, b)
    want = jax.tree_util.tree_map(lambda x, y: x - y, _tree(2), _tree(3))
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, out)) \
        == jax.tree_util.tree_structure(want)
    for g, w in zip(T.flatten(out).values(), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_tree_unflatten_inverts_tree_leaves():
    tree = _as_torch(_tree(4))
    leaves = [t * 2 for t in T.tree_leaves(tree)]
    out = T.tree_unflatten(tree, leaves)
    assert all(g is w for g, w in zip(T.tree_leaves(out), leaves))


@pytest.mark.parametrize("leaf", [None, P("data", None), torch.Size([2, 3])],
                         ids=["none", "spec", "size"])
def test_none_and_tuple_subclasses_are_leaves(leaf):
    assert list(T.tree_leaves({"a": leaf, "b": [leaf]})) == [leaf, leaf]
    assert T.tree_map(repr, {"a": leaf}) == {"a": repr(leaf)}


def test_is_leaf_stops_at_plain_tuples():
    specs = {"w": ((2, 3), "normal"), "b": ((3,), "zeros")}
    assert T.tree_map(lambda s: s[0], specs, is_leaf=lambda x: type(x) is tuple) \
        == {"w": (2, 3), "b": (3,)}
    assert list(T.tree_leaves(specs)) == [2, 3, "normal", 3, "zeros"]
