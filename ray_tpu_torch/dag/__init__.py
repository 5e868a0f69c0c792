"""ray_tpu_torch.dag: static dataflow graphs over actors (compiled graphs;
port of ray_tpu.dag).

A DAG of actor-method calls is captured once with ``.bind()`` and run
many times. Compiled (``experimental_compile()``), each execution writes
one input channel and reads the output channels: intermediate values
flow actor to actor through reusable shm channels (TCP across nodes),
and CUDA tensors on an edge declared ``with_tensor_transport("device")``
move device to device by CUDA IPC.
"""

from ray_tpu_torch.dag.channel_exec import DeviceEdgeError
from ray_tpu_torch.dag.collective_node import AllReduceNode, allreduce
from ray_tpu_torch.dag.nodes import (
    ClassMethodNode,
    CompiledDAG,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "AllReduceNode",
    "allreduce",
    "ClassMethodNode",
    "DeviceEdgeError",
    "CompiledDAG",
    "DAGNode",
    "FunctionNode",
    "InputNode",
    "MultiOutputNode",
]
