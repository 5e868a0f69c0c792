"""Public core API: init / remote / get / put / wait / actors / cluster info.

Counterpart of the reference's top-level API (reference:
python/ray/_private/worker.py — ray.init :1285, ray.get :2660, ray.put :2814,
ray.wait :2879, ray.remote :3267, ray.shutdown :1895, ray.kill, ray.cancel,
ray.get_actor).
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Any, Sequence

from ray_tpu_torch._private import profplane, worker_context
from ray_tpu_torch._private.config import GLOBAL_CONFIG, Config
from ray_tpu_torch._private.ids import ObjectRef
from ray_tpu_torch._private.runtime import CoreRuntime
from ray_tpu_torch._private.worker_context import global_runtime

_init_lock = threading.Lock()
_namespace = ""
_log_monitor = None


def init(
    address: str | None = None,
    *,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    num_tpus: float | None = None,
    resources: dict[str, float] | None = None,
    object_store_memory: int | None = None,
    namespace: str = "",
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    runtime_env: dict | None = None,
    _system_config: dict | None = None,
) -> dict:
    """Start (or connect to) a cluster and attach this process as driver.

    With no address, starts an in-process head (the GCS/raylet/object-store
    roles — see _private/gcs.py) exactly like the reference's single-node
    ``ray.init()`` starts a head node. ``address="host:port"`` connects to an
    existing head started by another driver or `ray-tpu start`.

    ``num_gpus`` counts the node's CUDA devices; left out, they are
    detected from the driver's device files (never through CUDA, so the
    driver's own CUDA visibility stays untouched). ``num_tpus`` is taken
    as an alias of ``num_gpus``, as ray_tpu takes ``num_gpus`` for its
    chip.
    """
    global _namespace
    with _init_lock:
        if worker_context.is_initialized():
            if ignore_reinit_error:
                return context_info()
            raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
        _namespace = namespace
        cfg = Config().apply_overrides(_system_config)
        if object_store_memory:
            cfg.object_store_memory = int(object_store_memory)
        if address is None:
            # Job drivers inherit their cluster (reference: RAY_ADDRESS).
            address = os.environ.get("RAY_TPU_ADDRESS") or None
        if address == "auto":
            env_addr = os.environ.get("RAY_TPU_ADDRESS")
            if not env_addr or env_addr == "auto":
                raise ConnectionError(
                    "address='auto' requires RAY_TPU_ADDRESS to hold a "
                    "host:port cluster address"
                )
            address = env_addr
        if address is None:
            # create_head: a plain Head at head_shards==1, the router +
            # shard-process directory above (see _private/head_shards.py).
            from ray_tpu_torch._private.head_shards import create_head

            head = create_head(cfg, num_cpus=num_cpus,
                               num_gpus=num_tpus if num_gpus is None else num_gpus,
                               resources=resources)
            rt = CoreRuntime(head.address, client_type="driver")
            worker_context.set_runtime(rt, head)
            if log_to_driver:
                # Reference: log_monitor.py streaming worker logs to the
                # driver console (ray.init(log_to_driver=True) default).
                from ray_tpu_torch._private.log_monitor import LogMonitor

                global _log_monitor
                _log_monitor = LogMonitor(
                    os.path.join(head.session_dir, "logs"))
                _log_monitor.start()
        else:
            # "ray://host:port" — Ray-Client-style remote driver
            # (reference: util/client, ray.init("ray://...")): same wire
            # protocol, but the shm fast path is skipped up front (the
            # driver is assumed off-host; objects ship inline).
            force_remote = False
            if address.startswith("ray://"):
                address = address[len("ray://"):]
                force_remote = True
            host, port = address.rsplit(":", 1)
            rt = CoreRuntime((host, int(port)), client_type="driver",
                             force_remote=force_remote)
            worker_context.set_runtime(rt, None)
        if runtime_env:
            # Packed once here (uploads working_dir/py_modules into the
            # cluster KV); per-task envs overlay on top of it. Nested
            # submissions inherit through the PARENT task's merged env
            # (worker_context.TaskContext.runtime_env) — race-free and
            # driver-scoped, no shared mutable key.
            try:
                from ray_tpu_torch._private.runtime_env import pack

                worker_context.set_default_runtime_env(
                    pack(runtime_env, worker_context.global_runtime()))
            except Exception:
                # A bad env must not leave a half-initialized session
                # (head + monitor alive, atexit unregistered, re-init
                # refused).
                _teardown_locked()
                raise
        atexit.register(shutdown)
        return context_info()


def auto_init() -> None:
    if not worker_context.is_initialized():
        init()


def context_info() -> dict:
    rt = global_runtime()
    return {"node_id": rt.node_id, "session_dir": rt.session_dir, "client_id": rt.client_id}


def _teardown_locked() -> None:
    """Tear the session down; caller holds _init_lock."""
    global _log_monitor
    rt = worker_context.try_runtime()
    head = worker_context.get_head()
    if _log_monitor is not None:
        _log_monitor.stop()
        _log_monitor = None
    if rt is None:
        return
    worker_context.set_runtime(None, None)
    worker_context.set_default_runtime_env(None)
    try:
        rt.close()
    except Exception:
        pass
    if head is not None:
        head.shutdown()
    # The driver's continuous profiler stands down with its runtime: a
    # process that is no longer attached must not keep a sampler thread
    # (init() re-arms).
    profplane.disarm()


def shutdown() -> None:
    with _init_lock:
        _teardown_locked()
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass


def is_initialized() -> bool:
    return worker_context.is_initialized()


def get_namespace() -> str:
    return _namespace


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_gpus=..., ...)``."""
    from ray_tpu_torch.remote_function import make_remote

    if len(args) == 1 and not kwargs and callable(args[0]):
        return make_remote(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")

    def decorator(fn_or_class):
        return make_remote(fn_or_class, kwargs)

    return decorator


def put(value: Any) -> ObjectRef:
    auto_init()
    return global_runtime().put(value)


def get(refs: ObjectRef | Sequence[ObjectRef], *, timeout: float | None = None):
    auto_init()
    from ray_tpu_torch.dag.nodes import CompiledDAGRef

    # Channel-compiled DAG results resolve through their channel, not
    # the object store (reference: ray.get on CompiledDAGRef).
    if isinstance(refs, CompiledDAGRef):
        # timeout=None blocks indefinitely, matching ObjectRef gets.
        return refs.get(timeout_s=timeout)
    if isinstance(refs, (list, tuple)) and any(
            isinstance(r, CompiledDAGRef) for r in refs):
        return [get(r, timeout=timeout) for r in refs]
    return global_runtime().get(refs, timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    auto_init()
    return global_runtime().wait(refs, num_returns=num_returns, timeout=timeout)


def kill(actor_handle, *, no_restart: bool = True) -> None:
    rt = global_runtime()
    rt.conn.call("kill_actor", {"actor_id": actor_handle._actor_id, "no_restart": no_restart})


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    rt = global_runtime()
    # Direct-plane tasks first: a call queued owner-side in the direct
    # window, or pushed owner→worker before the batched task_started
    # lands, is invisible to the head's cancel scan — the owner's own
    # direct plane removes it (owner queue) or signals the worker over
    # the peer connection it was pushed on.
    if rt._direct is not None:
        outcome = rt._direct.cancel_local(ref.hex())
        if outcome == "cancelled":
            return  # removed + error-sealed locally; head never saw it
        # "signalled": the worker will drop it at pickup — still fall
        # through so the head's record (if any) is signalled too, and
        # to cover a task that re-routed head-ward in the race window.
    # Map the return ref back to its task via the head's task table.
    rt.conn.call("cancel_task", {"task_id": ref.hex(), "force": force})


def get_actor(name: str, namespace: str | None = None):
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch.actor import ActorHandle

    rt = global_runtime()
    try:
        reply = rt.conn.call(
            "get_named_actor",
            {"name": name, "namespace": namespace if namespace is not None else _namespace},
        )
    except rpc.RpcError as e:
        if "no actor named" in str(e):
            # Reference behavior: ray.get_actor raises ValueError.
            raise ValueError(str(e)) from None
        raise
    return ActorHandle(reply["actor_id"])


def cluster_resources() -> dict[str, float]:
    return global_runtime().conn.call("cluster_resources", {})["total"]


def available_resources() -> dict[str, float]:
    return global_runtime().conn.call("cluster_resources", {})["available"]


def nodes() -> list[dict]:
    return global_runtime().conn.call("get_nodes", {})["nodes"]


def free(refs: Sequence[ObjectRef], *, force: bool = False) -> None:
    global_runtime().free(refs, force=force)


class RuntimeContext:
    """Reference analogue: ray.runtime_context.RuntimeContext."""

    @property
    def node_id(self) -> str:
        ctx = worker_context.get_task_context()
        return ctx.node_id or global_runtime().node_id

    def get_task_id(self) -> str:
        return worker_context.get_task_context().task_id

    def get_actor_id(self) -> str | None:
        return worker_context.get_task_context().actor_id

    def get_node_id(self) -> str:
        return self.node_id

    def get_worker_id(self) -> str:
        """Worker process id, or 'driver' in the driver (reference:
        RuntimeContext.get_worker_id)."""
        return os.environ.get("RAY_TPU_WORKER_ID", "driver")

    def get_job_id(self) -> str:
        """Submitted-job id, or 'driver' for a bare driver (reference:
        RuntimeContext.get_job_id; set by the job supervisor for
        entrypoint processes and inherited by their tasks)."""
        return os.environ.get("RAY_TPU_JOB_ID", "driver")

    def get_task_name(self) -> str | None:
        ctx = worker_context.get_task_context()
        return getattr(ctx, "task_name", None) or ctx.task_id

    def get_runtime_env(self) -> dict:
        """The merged runtime env in effect for the current task/actor
        (reference: RuntimeContext.runtime_env)."""
        ctx = worker_context.get_task_context()
        return dict(getattr(ctx, "runtime_env", None) or {})

    @property
    def gcs_address(self) -> str:
        host, port = global_runtime().address
        return f"{host}:{port}"

    @property
    def namespace(self) -> str:
        return _namespace


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
