"""Channel-compiled DAG execution (port of ray_tpu/dag/channel_exec.py).

``experimental_compile`` turns an actor DAG into RESIDENT PER-ACTOR
LOOPS connected by reusable channels. An execution submits no task:
the driver writes the input channel, every actor's loop reads its input
channels, runs its bound methods, writes its output channels, and the
driver reads the output channel.

Topology:
- every ClassMethodNode output that crosses an actor boundary becomes a
  channel sized ``channel_capacity``, with one reader per consuming
  process (distinct downstream actors, plus the driver for outputs);
- values consumed on the SAME actor pass through a per-iteration local
  memo, never a channel;
- the driver's input lands in one input channel read by every actor
  that binds InputNode;
- an edge declared ``with_tensor_transport("device")`` wraps its channel
  in the CUDA IPC adapter (device_channel.py); it takes one reader, and
  one with more raises DeviceEdgeError at compile time (ray_tpu quietly
  makes it a host channel).

Scope: actor-only graphs (ClassMethodNode / InputNode / MultiOutputNode).
Anything else, or a failed ready handshake, falls back to the per-call
ObjectRef path.

The loop runs on a thread of its own in the actor. torch keeps the
current CUDA device and the grad mode per thread, so the loop takes the
device current where the loop was started (the actor's executor thread)
and runs its steps with grad mode off, as the AsyncLLMEngine's stepping
thread does; a method that trains turns it on itself
(``torch.enable_grad()``).
"""

from __future__ import annotations

import uuid
from typing import Any

INPUT_CHAN = "input"
LOOP_METHOD = "__rtpu_dag_loop__"


class DeviceEdgeError(ValueError):
    """A device edge the compiler cannot keep on the device: raised at
    compile time instead of a fall back to host memory."""


class _DagError:
    """A step failure traveling through the pipeline (reference:
    compiled DAG execution propagates per-execution errors downstream
    and stays usable). Downstream steps pass it through instead of
    computing; the driver re-raises it from get()."""

    def __init__(self, message: str, tb: str):
        self.message = message
        self.tb = tb

    def raise_(self):
        from ray_tpu_torch.exceptions import TaskError

        raise TaskError(self.message, self.tb, "compiled_dag")


def build_plan(root, channel_capacity: int,
               placement=None,
               driver_node: "str | None" = None) -> "dict | None":
    """Analyze the graph; returns {actors, plans, channels, output} or
    None when the graph shape is not channel-compilable.

    ``placement`` is a callable ``(actor_ids) -> dict | None`` invoked
    ONCE with the participating actor ids; with it (and
    ``driver_node``) every channel is assigned a transport: "shm" when
    the writer and ALL readers share a node, else "tcp" (a DCN streamed
    channel, reference: torch_tensor_nccl_channel.py:44 cross-host
    channels). When placement is unavailable (callable absent, lookup
    failed, or an actor unplaced) the plan assumes a same-host shm
    graph — ``plan["local"]`` True — and the driver's ready-handshake
    timeout remains the safety net for actors that turn out to be
    off-host."""
    from ray_tpu_torch.dag.nodes import (
        ClassMethodNode,
        DAGNode,
        InputNode,
        MultiOutputNode,
    )

    # Topo-collect nodes (args before consumers).
    order: list = []
    seen: set[str] = set()

    def visit(node) -> bool:
        if node._uuid in seen:
            return True
        for up in node._upstream():
            if not visit(up):
                return False
        if not isinstance(node, (ClassMethodNode, InputNode, MultiOutputNode)):
            return False  # FunctionNode etc: not channel-compilable
        seen.add(node._uuid)
        order.append(node)
        return True

    if not visit(root):
        return None
    if isinstance(root, InputNode):
        return None  # degenerate echo graph; legacy path handles it

    method_nodes = [n for n in order if isinstance(n, ClassMethodNode)]
    if not method_nodes:
        return None
    output_nodes = (list(root._bound_args) if isinstance(root, MultiOutputNode)
                    else [root])
    if not all(isinstance(n, ClassMethodNode) for n in output_nodes):
        return None

    def actor_of(node) -> str:
        return node._method._handle._actor_id

    # Distinct consumer actors per produced node (+ driver for outputs).
    consumers: dict[str, set[str]] = {}
    input_consumers: set[str] = set()
    for n in method_nodes:
        for dep in n._upstream():
            if isinstance(dep, InputNode):
                input_consumers.add(actor_of(n))
            elif isinstance(dep, ClassMethodNode):
                if actor_of(dep) != actor_of(n):
                    consumers.setdefault(dep._uuid, set()).add(actor_of(n))
    out_uuids = {n._uuid for n in output_nodes}

    actor_nodes = None
    if placement is not None and driver_node is not None:
        actor_nodes = placement(sorted({actor_of(n) for n in method_nodes}))
    nodes_known = actor_nodes is not None and driver_node is not None

    def node_of(aid: str) -> "str | None":
        if aid == "driver":
            return driver_node
        return (actor_nodes or {}).get(aid)

    def transport_for(writer: str, reader_aids) -> str:
        if not nodes_known:
            return "shm"  # legacy assumption: same-host graph
        home = node_of(writer)
        if home is None:
            return "tcp"  # unknown placement: the safe transport
        return "shm" if all(node_of(r) == home for r in reader_aids) \
            else "tcp"

    tag = uuid.uuid4().hex[:8]
    channels: dict[str, dict] = {}  # name -> {capacity, num_readers, ...}
    chan_of: dict[str, str] = {}  # producing node uuid -> channel name
    for n in method_nodes:
        reader_aids = list(consumers.get(n._uuid, ()))
        if n._uuid in out_uuids:
            reader_aids.append("driver")
        device = getattr(n, "_tensor_transport", "auto") == "device"
        if device and len(reader_aids) > 1:
            raise DeviceEdgeError(
                f"the device edge out of {n._method._name}() (node "
                f"{n._uuid}) has {len(reader_aids)} readers "
                f"({', '.join(sorted(reader_aids))}); a device edge takes one "
                f"reader: bind one consumer to it, or declare one device edge "
                f"per consumer")
        if reader_aids:
            name = f"/ray_tpu_torch-dag-{tag}-{n._uuid}"
            chan_of[n._uuid] = name
            channels[name] = {
                "capacity": channel_capacity,
                "num_readers": len(reader_aids),
                "writer": actor_of(n),
                "transport": transport_for(actor_of(n), reader_aids),
                # with_tensor_transport("device"): CUDA tensors move
                # device to device by CUDA IPC; the channel below
                # carries only descriptors (one reader: the reader's
                # copy out of the writer's memory is the one transfer).
                "device": device,
            }
    input_chan = None
    if input_consumers:
        input_chan = f"/ray_tpu_torch-dag-{tag}-input"
        channels[input_chan] = {
            "capacity": channel_capacity,
            "num_readers": len(input_consumers),
            "writer": "driver",
            "transport": transport_for("driver", input_consumers),
        }

    def src_of(dep) -> tuple:
        if isinstance(dep, InputNode):
            return ("chan", input_chan)
        if isinstance(dep, ClassMethodNode):
            return ("local", dep._uuid)  # rewritten below if cross-actor
        return ("const", dep)

    # Per-actor step lists in global topo order.
    plans: dict[str, dict] = {}
    handles: dict[str, Any] = {}
    for n in method_nodes:
        aid = actor_of(n)
        handles[aid] = n._method._handle
        plan = plans.setdefault(aid, {
            "steps": [], "read_channels": set(), "write_channels": set(),
            "ready_channel": f"/ray_tpu_torch-dag-{tag}-ready-{aid}",
        })

        def operand(dep):
            if not isinstance(dep, DAGNode):
                return ("const", dep)
            src = src_of(dep)
            if (src[0] == "local"
                    and actor_of(dep) != aid):  # crosses actors: channel
                src = ("chan", chan_of[dep._uuid])
            if src[0] == "chan":
                plan["read_channels"].add(src[1])
            return src

        step = {
            "uuid": n._uuid,
            "method": n._method._name,
            "args": [operand(a) for a in n._bound_args],
            "kwargs": {k: operand(v) for k, v in n._bound_kwargs.items()},
            "out_chan": chan_of.get(n._uuid),
        }
        if step["out_chan"]:
            plan["write_channels"].add(step["out_chan"])
        plan["steps"].append(step)
    for plan in plans.values():
        # A step list with no channel reads would free-run decoupled
        # from execute() calls (source actors with const-only args):
        # not channel-compilable.
        if not plan["read_channels"]:
            return None
        # Each channel is acquired just before its FIRST consuming step
        # (not all up front): an actor revisited later in the graph
        # (A->B->A) must run its early steps before blocking on inputs
        # produced downstream, or the pipeline deadlocks.
        assigned: set[str] = set()
        for step in plan["steps"]:
            step["acquire"] = []
            for src in list(step["args"]) + list(step["kwargs"].values()):
                if (src[0] == "chan" and src[1] not in assigned):
                    assigned.add(src[1])
                    step["acquire"].append(src[1])
        plan["read_channels"] = sorted(plan["read_channels"])
        plan["write_channels"] = sorted(plan["write_channels"])

    local = (not nodes_known) or all(
        node_of(aid) == driver_node for aid in plans)
    for aid, plan in plans.items():
        if local:
            # Single-phase shm flow: ready-channel handshake.
            channels[plan["ready_channel"]] = {
                "capacity": 1 << 16, "num_readers": 1,
                "writer": aid, "transport": "shm"}
            plan["channel_specs"] = {
                name: channels[name]
                for name in plan["read_channels"] + plan["write_channels"]
            }
        else:
            # Two-phase flow: per-actor channel specs travel with the
            # plan; the task returns are the handshake.
            plan.pop("ready_channel", None)
            plan["setup_key"] = f"{tag}-{aid}"
            plan["channel_specs"] = {
                name: channels[name]
                for name in plan["read_channels"] + plan["write_channels"]
            }

    return {
        "plans": plans,
        "handles": handles,
        "channels": channels,
        "input_chan": input_chan,
        "local": local,
        "output_chans": [chan_of[u] for u in
                         [n._uuid for n in output_nodes]],
        "multi_output": isinstance(root, MultiOutputNode),
    }


def maybe_device_wrap(ch, spec: "dict | None", *, writer: bool):
    """Wrap a meta channel in the device-transport adapter when the
    edge was declared with_tensor_transport("device")."""
    if not spec or not spec.get("device"):
        return ch
    from ray_tpu_torch.experimental.device_channel import (
        DeviceChannelReader,
        DeviceChannelWriter,
    )

    return DeviceChannelWriter(ch) if writer else DeviceChannelReader(ch)


# Channels created in the setup phase, parked until the run phase
# arrives with the dial map (keyed by the plan's setup_key).
_DAG_SETUP: dict[str, dict] = {}


def actor_dag_loop(instance, plan: dict):
    """Start the resident loop ON the actor's worker (dispatched by
    worker._run_task under the reserved method name LOOP_METHOD —
    reference: the pinned actor executables of compiled_dag_node.py,
    which run on a dedicated execution thread so the actor keeps serving
    normal method calls).

    Single-phase (plan without "phase"): the driver created every shm
    channel; open by name, ready-handshake, spawn the loop.

    Two-phase (cross-node graphs): "setup" creates the channels this
    actor WRITES (shm homed here, or TCP listeners — reference:
    torch_tensor_nccl_channel.py:44 cross-host channels) and returns
    their endpoints; "run" receives the merged dial map, opens the read
    side, and spawns the loop. The task returns are the handshake."""
    import threading

    from ray_tpu_torch.experimental.channel import Channel

    phase = plan.get("phase")
    if phase == "cleanup":
        # A partner actor's setup failed and the driver is falling back:
        # release this actor's parked channels (TCP listeners, shm
        # segments) instead of leaking them for the process lifetime.
        stash = _DAG_SETUP.pop(plan["setup_key"], None)
        if stash:
            for ch in stash["writes"].values():
                try:
                    ch.close()
                except Exception:
                    pass
                try:
                    ch.unlink()
                except Exception:
                    pass
        return "cleaned"
    if phase == "setup":
        from ray_tpu_torch.experimental.tcp_channel import TcpChannelServer

        writes: dict[str, Any] = {}
        endpoints: dict[str, tuple] = {}
        for name in plan["write_channels"]:
            spec = plan["channel_specs"][name]
            if spec["transport"] == "tcp":
                ch = TcpChannelServer(name, num_readers=spec["num_readers"])
                endpoints[name] = ch.endpoint
            else:
                ch = Channel(capacity=spec["capacity"],
                             num_readers=spec["num_readers"], name=name)
            writes[name] = maybe_device_wrap(ch, spec, writer=True)
        _DAG_SETUP[plan["setup_key"]] = {"writes": writes}
        return endpoints
    if phase == "run":
        from ray_tpu_torch.experimental.tcp_channel import TcpChannelReader

        stash = _DAG_SETUP.pop(plan["setup_key"])
        writes = stash["writes"]
        dial = plan["dial"]
        reads = {}
        for name in plan["read_channels"]:
            spec = plan["channel_specs"][name]
            if spec["transport"] == "tcp":
                ch = TcpChannelReader(name, dial[name])
            else:
                ch = Channel(name=name, _create=False)
            reads[name] = maybe_device_wrap(ch, spec, writer=False)
        threading.Thread(
            target=_run_dag_loop,
            args=(instance, plan, reads, writes, _current_cuda_device()),
            daemon=True, name="dag-loop",
        ).start()
        return "started"

    specs = plan.get("channel_specs", {})
    reads = {name: maybe_device_wrap(
                 Channel(name=name, _create=False),
                 specs.get(name), writer=False)
             for name in plan["read_channels"]}
    writes = {name: maybe_device_wrap(
                  Channel(name=name, _create=False),
                  specs.get(name), writer=True)
              for name in plan["write_channels"]}
    ready = Channel(name=plan["ready_channel"], _create=False)
    ready.write(b"ok")
    threading.Thread(
        target=_run_dag_loop,
        args=(instance, plan, reads, writes, _current_cuda_device()),
        daemon=True, name="dag-loop",
    ).start()
    return "started"


def _current_cuda_device() -> "int | None":
    """The calling thread's current CUDA device, where this process has
    loaded torch and started CUDA; None otherwise."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_device()


class _ThreadMode:
    """Puts this thread on ``device`` with grad mode off, once torch is
    loaded: at the first step if the actor had loaded it, else after
    the step that loads it."""

    def __init__(self, device: "int | None"):
        self.device = device
        self.done = False

    def apply(self) -> None:
        if self.done:
            return
        import sys

        torch = sys.modules.get("torch")
        if torch is None:
            return
        torch.set_grad_enabled(False)
        if self.device is not None:
            torch.cuda.set_device(self.device)
        self.done = True


def _run_dag_loop(instance, plan: dict, reads: dict, writes: dict,
                  device: "int | None" = None) -> str:
    from ray_tpu_torch.experimental.channel import ChannelClosed

    mode = _ThreadMode(device)

    def resolve(src, values, memo):
        kind = src[0]
        if kind == "const":
            return src[1]
        if kind == "chan":
            return values[src[1]]
        return memo[src[1]]  # local

    try:
        while True:
            mode.apply()
            values: dict[str, Any] = {}
            acquired: list[str] = []
            memo: dict[str, Any] = {}
            try:
                for step in plan["steps"]:
                    # Acquire lazily (topological order): inputs an
                    # earlier step of THIS actor produces for other
                    # actors must go out before blocking on channels
                    # those actors feed back.
                    for name in step["acquire"]:
                        values[name] = reads[name].begin_read(
                            timeout_s=3600.0)
                        acquired.append(name)
                    args = [resolve(s, values, memo) for s in step["args"]]
                    kwargs = {k: resolve(s, values, memo)
                              for k, s in step["kwargs"].items()}
                    err = next(
                        (a for a in list(args) + list(kwargs.values())
                         if isinstance(a, _DagError)), None)
                    if err is None:
                        try:
                            out = getattr(instance,
                                          step["method"])(*args, **kwargs)
                        except Exception as e:  # noqa: BLE001
                            import traceback

                            out = _DagError(repr(e), traceback.format_exc())
                        mode.apply()
                    else:
                        out = err
                    memo[step["uuid"]] = out
                    if step["out_chan"]:
                        # Long timeout, like the reads: a driver sitting
                        # on unconsumed results must stall the pipeline,
                        # not kill the loop thread.
                        writes[step["out_chan"]].write(out, timeout_s=3600.0)
            finally:
                for name in acquired:
                    reads[name].end_read()
    except ChannelClosed:
        return "closed"
    except Exception:  # noqa: BLE001 — log; a silent thread death hangs the DAG
        import traceback

        traceback.print_exc()
        return "crashed"
    finally:
        # Propagate teardown: closing this loop's endpoints wakes peers
        # up/downstream (a TCP close frame or the shm closed flag), so
        # one closed edge drains the whole pipeline.
        for ch in list(reads.values()) + list(writes.values()):
            try:
                ch.close()
            except Exception:
                pass
