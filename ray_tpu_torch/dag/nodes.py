"""DAG nodes and compiled execution (port of ray_tpu/dag/nodes.py).

``actor.method.bind(...)`` / ``fn.bind(...)`` capture a static graph;
``experimental_compile()`` freezes it: an actor-only graph compiles to
resident loops on its actors connected by reusable channels (shm on one
host, TCP across nodes, CUDA IPC for ``with_tensor_transport("device")``
edges); anything else falls back to one wave of ObjectRef-chained calls
per ``execute()``.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Optional

class DAGNode:
    """A node in a static dataflow graph. Args may reference upstream
    DAGNodes (top-level positions)."""

    def __init__(self, args: tuple = (), kwargs: dict | None = None):
        self._bound_args = args
        self._bound_kwargs = kwargs or {}
        self._uuid = uuid.uuid4().hex[:8]

    def _upstream(self) -> list["DAGNode"]:
        ups = [a for a in self._bound_args if isinstance(a, DAGNode)]
        ups += [v for v in self._bound_kwargs.values() if isinstance(v, DAGNode)]
        return ups

    # -- eager one-shot execution (reference: DAGNode.execute) -------------

    def execute(self, *input_values) -> Any:
        """Run the whole upstream graph once; returns ObjectRef(s)."""
        memo: dict[str, Any] = {}
        return self._execute_into(memo, input_values)

    def _execute_into(self, memo: dict, input_values: tuple):
        if self._uuid in memo:
            return memo[self._uuid]
        resolved_args = [
            a._execute_into(memo, input_values) if isinstance(a, DAGNode) else a
            for a in self._bound_args
        ]
        resolved_kwargs = {
            k: (v._execute_into(memo, input_values) if isinstance(v, DAGNode) else v)
            for k, v in self._bound_kwargs.items()
        }
        out = self._submit(resolved_args, resolved_kwargs, input_values)
        memo[self._uuid] = out
        return out

    def _submit(self, args: list, kwargs: dict, input_values: tuple):
        raise NotImplementedError

    def experimental_compile(self) -> "CompiledDAG":
        """Freeze the graph for repeated execution (reference:
        dag.experimental_compile(), compiled_dag_node.py:806)."""
        return CompiledDAG(self)

    def with_tensor_transport(self, transport: str = "auto") -> "DAGNode":
        """Declare the tensor transport for this node's output.

          - "auto"/"shm": the host channel (default): a CUDA tensor
            crosses as host bytes; one that is the whole value lands on
            the reader's current CUDA device, one nested in a list, a
            dict or a tuple arrives as a CPU tensor.
          - "device": a device-resident edge: this node's CUDA tensors
            stay in the producing actor's memory and the consumer copies
            them device to device through CUDA IPC
            (experimental/device_channel.py); only a descriptor crosses
            the host. Same host only; one reader, and a graph that
            cannot compile to channels: both raise DeviceEdgeError at
            compile time rather than carry the tensors through the host.
          - "nccl": refused (see below).
        """
        if transport == "nccl":
            raise ValueError(
                "NCCL tensor transport is not available: an NCCL edge needs "
                "its two actors on two cards (one card cannot hold two NCCL "
                "ranks); use with_tensor_transport('device') for a "
                "device-resident edge between actors on one host (CUDA IPC), "
                "or ray_tpu_torch.parallel's collectives inside one program."
            )
        if transport not in ("auto", "shm", "device"):
            raise ValueError(f"unknown tensor transport {transport!r}")
        self._tensor_transport = transport
        return self

    def __reduce__(self):  # DAG nodes are driver-side only
        raise TypeError("DAGNode is not serializable; pass ObjectRefs instead")


class InputNode(DAGNode):
    """Placeholder for the per-execution input (reference:
    dag/input_node.py). Usable as a context manager:

        with InputNode() as inp:
            out = actor.fn.bind(inp)
    """

    def __init__(self):
        super().__init__()

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def _submit(self, args, kwargs, input_values):
        if len(input_values) == 1:
            return input_values[0]
        return input_values


class ClassMethodNode(DAGNode):
    """actor.method.bind(...) (reference: dag/class_node.py)."""

    def __init__(self, actor_method, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._method = actor_method

    def _submit(self, args, kwargs, input_values):
        return self._method.remote(*args, **kwargs)


class FunctionNode(DAGNode):
    """fn.bind(...) on a @remote function (reference: dag/function_node.py)."""

    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _submit(self, args, kwargs, input_values):
        return self._remote_fn.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundle several leaves into one execute() result (reference:
    dag/output_node.py)."""

    def __init__(self, outputs: list[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _submit(self, args, kwargs, input_values):
        return list(args)


def _has_device_edge(root: DAGNode) -> bool:
    seen, todo = set(), [root]
    while todo:
        n = todo.pop()
        if n._uuid in seen:
            continue
        seen.add(n._uuid)
        if getattr(n, "_tensor_transport", "auto") == "device":
            return True
        todo += n._upstream()
    return False


class CompiledDAGRef:
    """Result handle for one channel-compiled execution (reference:
    CompiledDAGRef, compiled_dag_node.py). Results are a stream: get()
    must be called in submission order (each ref carries its execution
    index and fails loudly on a mismatch rather than silently returning
    another execution's result)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._value: Any = None
        self._error: Exception | None = None
        self._done = False

    def get(self, timeout_s: "float | None" = 60.0) -> Any:
        if timeout_s is None:
            timeout_s = float("inf")
        if not self._done:
            if self._dag._next_read_seq != self._seq:
                raise RuntimeError(
                    f"compiled-DAG results must be consumed in submission "
                    f"order: this ref is execution #{self._seq}, the next "
                    f"unread result is #{self._dag._next_read_seq}"
                )
            from ray_tpu_torch.experimental.channel import ChannelTimeout

            try:
                self._value = self._dag._read_output(timeout_s)
            except ChannelTimeout:
                raise  # nothing consumed: the same ref may retry
            except Exception as e:  # noqa: BLE001
                # Execution error: its outputs were fully drained, so
                # the stream stays aligned; this ref re-raises forever.
                self._error = e
                self._done = True
                self._dag._next_read_seq += 1
                raise
            self._done = True
            self._dag._next_read_seq += 1
        if self._error is not None:
            raise self._error
        return self._value


class CompiledDAG:
    """A frozen DAG handle for repeated execution.

    Channel mode (the reference's design — pinned per-actor execution
    loops + reusable mutable channels, compiled_dag_node.py:806 +
    experimental_mutable_object_manager.h:44): compile() spawns a
    resident loop task on every participating actor, connected by
    shared-memory Channels; execute() writes the input channel and
    returns a CompiledDAGRef whose get() reads the output channel. No
    per-execution task submission at all.

    Fallback: graphs with non-actor nodes, or actors that cannot reach
    the driver's /dev/shm (ready handshake timeout), run as one wave of
    ObjectRef-chained actor calls per execute() — the pre-channel
    behavior (execute then returns ObjectRef(s) directly)."""

    def __init__(self, root: DAGNode, channel_capacity: int = 8 << 20):
        self._root = root
        self._destroyed = False
        self._mode = "legacy"
        self._compile_failure: str | None = None
        self._channels: dict = {}
        self._loop_refs: list = []
        self._exec_seq = 0
        self._next_read_seq = 0
        self._partial_outs: list = []
        from ray_tpu_torch.dag.channel_exec import DeviceEdgeError

        try:
            self._try_compile_channels(channel_capacity)
        except DeviceEdgeError:
            raise
        except Exception as e:  # noqa: BLE001
            self._compile_failure = repr(e)
            self._teardown_channels()
            self._mode = "legacy"
        if self._mode != "channels" and _has_device_edge(root):
            # The legacy path would carry the edge's tensors through the
            # object store, that is through host memory.
            raise DeviceEdgeError(
                "a graph with a device edge must compile to channels; it "
                f"fell back to the legacy ObjectRef path: {self._compile_failure}")

    # -- channel mode ------------------------------------------------------

    @staticmethod
    def _actor_nodes(aids) -> "dict | None":
        """actor_id -> node_id for the participating actors (the head's
        actor table). Polls briefly for actors still being placed;
        returns None when placement stays unknown: build_plan then
        assumes a same-host shm graph and the ready-handshake timeout is
        the safety net."""
        import time as _time

        from ray_tpu_torch._private.worker_context import global_runtime

        deadline = _time.monotonic() + 5.0
        while True:
            try:
                actors = global_runtime().conn.call("list_actors", {})["actors"]
                rows = {a["actor_id"]: a.get("node_id") for a in actors}
            except Exception:
                return None
            nodes = {aid: rows.get(aid) for aid in aids}
            if all(v is not None for v in nodes.values()):
                return nodes
            if _time.monotonic() > deadline:
                return None
            _time.sleep(0.2)

    def _try_compile_channels(self, capacity: int) -> None:
        from ray_tpu_torch._private.worker_context import global_runtime
        from ray_tpu_torch.actor import ActorMethod
        from ray_tpu_torch.dag import channel_exec
        from ray_tpu_torch.experimental.channel import Channel, ChannelTimeout

        driver_node = global_runtime().node_id
        plan = channel_exec.build_plan(self._root, capacity,
                                       self._actor_nodes, driver_node)
        if plan is None:
            self._compile_failure = (
                "graph is not channel-compilable (non-actor nodes or "
                "const-only sources)")
            return
        if not plan["local"]:
            self._compile_mixed(plan)
            return
        # Driver creates every channel up front; actors open by name.
        from ray_tpu_torch.dag.channel_exec import maybe_device_wrap

        for name, spec in plan["channels"].items():
            ch = Channel(
                capacity=spec["capacity"], num_readers=spec["num_readers"],
                name=name)
            # The driver only READS device-typed edges (outputs).
            if name in plan["output_chans"]:
                ch = maybe_device_wrap(ch, spec, writer=False)
            self._channels[name] = ch
        self._plan = plan
        self._loop_refs = [
            ActorMethod(plan["handles"][aid],
                        channel_exec.LOOP_METHOD).remote(aplan)
            for aid, aplan in plan["plans"].items()
        ]
        # Ready handshake: every loop opened its channels. A timeout
        # (off-host actor: no shared /dev/shm) falls back to legacy.
        try:
            for aplan in plan["plans"].values():
                ch = self._channels[aplan["ready_channel"]]
                ch.begin_read(timeout_s=20.0)
                ch.end_read()
        except ChannelTimeout:
            raise RuntimeError("compiled-DAG ready handshake timed out")
        self._mode = "channels"

    def _compile_mixed(self, plan) -> None:
        """Cross-node compile (reference: cross-host channels,
        torch_tensor_nccl_channel.py:44): shm where writer+readers share
        a node, TCP elsewhere. Two phases — every actor first creates
        the channels it WRITES (returning TCP endpoints), then starts
        its loop with the merged dial map. Task returns are the
        handshake."""
        import ray_tpu_torch
        from ray_tpu_torch.actor import ActorMethod
        from ray_tpu_torch.dag import channel_exec
        from ray_tpu_torch.experimental.channel import Channel
        from ray_tpu_torch.experimental.tcp_channel import (
            TcpChannelReader,
            TcpChannelServer,
        )

        endpoints: dict = {}
        for name, spec in plan["channels"].items():
            if spec["writer"] != "driver":
                continue
            if spec["transport"] == "tcp":
                ch = TcpChannelServer(name, num_readers=spec["num_readers"])
                endpoints[name] = ch.endpoint
            else:
                ch = Channel(capacity=spec["capacity"],
                             num_readers=spec["num_readers"], name=name)
            self._channels[name] = ch
        setup_refs = {
            aid: ActorMethod(plan["handles"][aid],
                             channel_exec.LOOP_METHOD).remote(
                                 {**aplan, "phase": "setup"})
            for aid, aplan in plan["plans"].items()
        }
        try:
            for aid, ref in setup_refs.items():
                endpoints.update(ray_tpu_torch.get(ref, timeout=30))
            self._plan = plan
            self._loop_refs = [
                ActorMethod(plan["handles"][aid],
                            channel_exec.LOOP_METHOD).remote(
                                {**aplan, "phase": "run",
                                 "dial": endpoints})
                for aid, aplan in plan["plans"].items()
            ]
            for ref in self._loop_refs:
                started = ray_tpu_torch.get(ref, timeout=30)
                if started != "started":
                    raise RuntimeError(f"loop start returned {started!r}")
        except BaseException:
            # Partner actors that DID finish setup hold parked channels
            # (TCP listeners, shm segments): release them, or repeated
            # failed compiles leak sockets for the actors' lifetimes.
            for aid, aplan in plan["plans"].items():
                try:
                    ActorMethod(plan["handles"][aid],
                                channel_exec.LOOP_METHOD).remote(
                                    {"phase": "cleanup",
                                     "setup_key": aplan["setup_key"]})
                except Exception:
                    pass
            raise
        # Open the driver's read side of the output channels.
        from ray_tpu_torch.dag.channel_exec import maybe_device_wrap

        for name in plan["output_chans"]:
            if name in self._channels:
                continue
            spec = plan["channels"][name]
            if spec["transport"] == "tcp":
                ch = TcpChannelReader(name, endpoints[name])
            else:
                ch = Channel(name=name, _create=False)
            self._channels[name] = maybe_device_wrap(ch, spec,
                                                     writer=False)
        self._mode = "channels"

    def _read_output(self, timeout_s: float) -> Any:
        from ray_tpu_torch.dag.channel_exec import _DagError
        from ray_tpu_torch.experimental.channel import ChannelTimeout

        import time as _time

        deadline = _time.monotonic() + timeout_s
        # Resumable drain: on ChannelTimeout the already-read outputs of
        # this execution stay in _partial_outs, so a retried get()
        # continues with the REMAINING channels instead of re-reading a
        # drained one (which would consume the next execution's message
        # and misalign every later result).
        outs = self._partial_outs
        for name in self._plan["output_chans"][len(outs):]:
            ch = self._channels[name]
            if outs:
                # Later outputs of the SAME execution wave arrive almost
                # together; a fresh allowance keeps one slow-first-read
                # timeout from leaving the stream half-drained.
                deadline = max(deadline, _time.monotonic() + 10.0)
            while True:
                try:
                    value = ch.begin_read(
                        timeout_s=min(0.5, max(0.05, deadline - _time.monotonic())))
                    break
                except ChannelTimeout:
                    self._raise_if_loop_crashed()
                    if _time.monotonic() > deadline:
                        raise
            try:
                if not getattr(ch, "owns_payload", False):
                    # shm slot: the view dies at end_read — copy out.
                    # TCP readers own their recv buffer; no copy needed.
                    import copy

                    value = copy.deepcopy(value)
            finally:
                ch.end_read()
            outs.append(value)
        self._partial_outs = []
        # EVERY output channel drained; only now surface branch errors,
        # keeping later executions' streams aligned.
        first_error = next((v for v in outs if isinstance(v, _DagError)),
                           None)
        if first_error is not None:
            first_error.raise_()
        return outs if self._plan["multi_output"] else outs[0]

    def _raise_if_loop_crashed(self) -> None:
        """Surface loop-start failures (the loop tasks seal 'started'
        after moving to their background thread; an error there means
        channel setup failed on the actor)."""
        import ray_tpu_torch

        for ref in self._loop_refs:
            done, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0.0)
            if done:
                ray_tpu_torch.get(done[0])  # raises if the loop failed to start

    # -- public ------------------------------------------------------------

    def execute(self, *input_values) -> Any:
        if self._destroyed:
            raise RuntimeError("CompiledDAG was torn down")
        if self._mode != "channels":
            return self._root._execute_into({}, input_values)
        if self._plan["input_chan"] is not None:
            value = input_values[0] if len(input_values) == 1 else input_values
            self._channels[self._plan["input_chan"]].write(value)
        ref = CompiledDAGRef(self, self._exec_seq)
        self._exec_seq += 1
        return ref

    def ensure_compiled(self) -> "CompiledDAG":
        """Assert the channel fast path was taken. The compiler silently
        falls back to per-call ObjectRef execution for shapes it cannot
        compile; callers that DEPEND on channel performance (pipelines
        sized around the ~order-of-magnitude win) use this to turn the
        silent degradation into an error."""
        if self._mode != "channels":
            raise RuntimeError(
                "compiled DAG fell back to the legacy ObjectRef path: "
                + (self._compile_failure or "unknown reason"))
        return self

    def teardown(self) -> None:
        self._teardown_channels()
        self._destroyed = True

    def _teardown_channels(self) -> None:
        for ch in self._channels.values():
            try:
                ch.close()
            except Exception:
                pass
        # Remove the shm names now that every loop thread has been woken
        # with ChannelClosed: live mappings stay valid while they drain,
        # and channels of crashed actors (attach count stuck > 0) are
        # reclaimed instead of leaking in /dev/shm.
        for ch in self._channels.values():
            try:
                ch.unlink()
            except Exception:
                pass
        self._channels = {}
