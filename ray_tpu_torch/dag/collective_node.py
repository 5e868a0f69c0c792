"""Collective nodes inside DAGs: allreduce across actor outputs (port of
ray_tpu/dag/collective_node.py).

The DAG-level collective is a host-plane reduction: gather the N bound
outputs through the object store, reduce them once in a task, and hand
every downstream consumer the same reduced object. Collectives inside
one program belong to ``ray_tpu_torch.parallel``. Tensors reduce as
ray_tpu reduces arrays (torch's elementwise ops; numpy leaves stay
numpy):

    with InputNode() as x:
        outs = [w.grad.bind(x) for w in workers]
        reduced = AllReduceNode(outs, op="sum")
        dag = MultiOutputNode([w.apply.bind(reduced) for w in workers])
"""

from __future__ import annotations

import sys
from typing import Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.dag.nodes import DAGNode


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _add(a, b):
    return a + b if _is_tensor(a) or _is_tensor(b) else np.add(a, b)


def _maximum(a, b):
    if _is_tensor(a) or _is_tensor(b):
        import torch

        return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))
    return np.maximum(a, b)


def _minimum(a, b):
    if _is_tensor(a) or _is_tensor(b):
        import torch

        return torch.minimum(torch.as_tensor(a), torch.as_tensor(b))
    return np.minimum(a, b)


_OPS = {
    "sum": lambda xs: _tree_reduce(xs, _add),
    "mean": lambda xs: _tree_scale(_tree_reduce(xs, _add), 1.0 / len(xs)),
    "max": lambda xs: _tree_reduce(xs, _maximum),
    "min": lambda xs: _tree_reduce(xs, _minimum),
}


def _leaf(x):
    return x if _is_tensor(x) else np.asarray(x)


def _tree_reduce(values, op):
    """Reduce a list of (nested) tensors or arrays elementwise with `op`."""
    first = values[0]
    if isinstance(first, dict):
        return {k: _tree_reduce([v[k] for v in values], op) for k in first}
    if isinstance(first, (list, tuple)):
        red = [_tree_reduce([v[i] for v in values], op)
               for i in range(len(first))]
        return type(first)(red)
    out = _leaf(first)
    for v in values[1:]:
        out = op(out, _leaf(v))
    return out


def _tree_scale(value, s):
    if isinstance(value, dict):
        return {k: _tree_scale(v, s) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_tree_scale(v, s) for v in value)
    return _leaf(value) * s


def _allreduce_task(op: str, *values):
    return _OPS[op](list(values))


class AllReduceNode(DAGNode):
    """All-reduce the outputs of `nodes`; the node's value is the reduced
    tree. op: sum | mean | max | min."""

    def __init__(self, nodes: Sequence[DAGNode], op: str = "sum"):
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if not nodes:
            raise ValueError("AllReduceNode needs at least one input node")
        super().__init__(args=tuple(nodes))
        self.op = op

    def _submit(self, args: list, kwargs: dict, input_values: tuple):
        # Reduce in a task, so the reduced object lives in the store and
        # each consumer reads the same copy.
        return ray_tpu_torch.remote(_allreduce_task).remote(self.op, *args)


def allreduce(nodes: Sequence[DAGNode], op: str = "sum") -> AllReduceNode:
    """Functional spelling (ray.experimental.collective.allreduce.bind)."""
    return AllReduceNode(nodes, op=op)
