"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. Ported so far: the task/actor core
(``init / remote / get / put / wait / kill / cancel / get_actor /
shutdown`` over a single-node cluster whose workers hold the card under
``GPU`` leases and pass torch tensors as objects), compiled DAGs over
shm, TCP and CUDA IPC channels, host collective groups, the ops (attention
with hand-written Hopper flash-attention kernels, forward and backward;
MoE routing; the optimizers; ring attention), the transformer model
family (dense and MoE; inference and training, on one device or sharded
over a DeviceMesh: data, fsdp, tensor, expert), the parallel layer
(meshes, sharding rules, the SPMD pipeline, multi-slice meshes; over
torch.distributed and DTensor), the LLM engine (on one device, or
tensor- or pipeline-parallel over a process group, or disaggregated
into prefill and decode engines), Serve (a controller, replicas,
handles, batching, multiplexing, an HTTP/SSE/WebSocket and gRPC proxy)
with OpenAI-style LLM serving over it, Data (streaming datasets over the
core's tasks and actor pools) with batch LLM inference over it, Train
(the trainer and its worker group on the core, process-group setup,
gradient and parameter sync, checkpoints), RLlib (env runners and
learners local or as actors of the core), Tune (trial actors, searchers,
schedulers, over functions, Trainables and the trainer), durable
workflows, the state API, job submission and the dashboard.
``interop.params_from_jax`` carries a JAX parameter tree across.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.

Importing the package loads the core only, as ``ray_tpu/__init__.py``
does: every worker process imports it, and a worker that runs plain
tasks never loads torch. The libraries (``data``, ``llm``, ``models``,
``ops``, ``parallel``, ``serve``, ``train``, ...) load on first attribute
access.
"""

# Arm the lock-order witness FIRST when RAY_TPU_LOCK_WITNESS=1: the
# factories must be patched before any runtime module allocates its
# locks. Spawned workers inherit the env var and arm themselves here
# too. No-op (nothing patched, zero overhead) when the knob is unset.
from ray_tpu_torch._private import lockwitness as _lockwitness

_lockwitness.maybe_install()
del _lockwitness

import importlib as _importlib

from ray_tpu_torch._version import __version__
from ray_tpu_torch._private.ids import ObjectRef
from ray_tpu_torch._private.scheduler import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
from ray_tpu_torch.api import (
    available_resources,
    cancel,
    cluster_resources,
    free,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.actor import method
from ray_tpu_torch import exceptions

# Submodules loaded on first attribute access (PEP 562).
_LAZY = ("accelerators", "dag", "data", "experimental", "interop", "kernel_report", "llm",
         "models", "ops", "parallel", "rllib", "serve", "train", "tune", "util",
         "workflow")


def __getattr__(name):
    if name in _LAZY:
        return _importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "method",
    "__version__",
    "ObjectRef",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "free",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "wait",
    "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
    "interop",
    "llm",
    "models",
    "ops",
    "parallel",
    "serve",
    "train",
    "data",
]
