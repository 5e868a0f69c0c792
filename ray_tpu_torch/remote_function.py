"""@ray_tpu_torch.remote on functions.

Counterpart of the reference's RemoteFunction
(reference: python/ray/remote_function.py:303 `_remote`; decorator at
python/ray/_private/worker.py:3267).
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectRef
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch._private.worker_context import global_runtime


def _pack_env(runtime_env: dict | None, rt) -> dict | None:
    from ray_tpu_torch._private.worker_context import (
        get_default_runtime_env,
        get_process_runtime_env,
        get_task_context,
    )

    # Driver: the init()-level default. Worker: the executing (parent)
    # task's merged env — nested submissions inherit it (reference:
    # runtime_env inheritance). The process-level fallback covers
    # submissions from user-spawned threads inside a task.
    default = (get_default_runtime_env() or get_task_context().runtime_env
               or get_process_runtime_env())
    if not runtime_env:
        return dict(default) if default else runtime_env
    from ray_tpu_torch._private.runtime_env import pack

    packed = pack(runtime_env, rt)
    if default:
        merged = dict(default)
        # Per-task keys win; env_vars merge key-wise (reference:
        # runtime_env inheritance semantics).
        for k, v in packed.items():
            if k == "env_vars" and "env_vars" in merged:
                merged["env_vars"] = {**merged["env_vars"], **v}
            else:
                merged[k] = v
        return merged
    return packed


def _check_gpus(gpus) -> None:
    """A GPU request is a share of one device (0 < n < 1) or a whole
    number of devices, as in Ray: 1.5 GPUs would need half of a device
    the lease cannot pin."""
    if gpus is None:
        return
    n = float(gpus)
    if n < 0 or (n > 1 and not n.is_integer()):
        raise ValueError(
            f"num_gpus={gpus}: a GPU request is a fraction of one device "
            f"(0 < n < 1) or a whole number of devices")


def _check_gpu_options(opts: dict) -> None:
    """Validate the GPU request in task or actor options (num_gpus=,
    its alias num_tpus=, or resources={"GPU": n})."""
    for key in ("num_gpus", "num_tpus"):
        _check_gpus(opts.get(key))
    _check_gpus((opts.get("resources") or {}).get("GPU"))


def _normalize_resources(
    num_cpus: float | None,
    num_gpus: float | None,
    memory: float | None,
    resources: dict[str, float] | None,
    default_cpus: float = 1.0,
) -> dict[str, float]:
    res = dict(resources or {})
    res["CPU"] = float(default_cpus if num_cpus is None else num_cpus)
    if num_gpus:
        res["GPU"] = float(num_gpus)
    _check_gpus(res.get("GPU"))
    if memory:
        res["memory"] = float(memory)
    return {k: v for k, v in res.items() if v}


class RemoteFunction:
    def __init__(self, fn, **task_options):
        self._fn = fn
        self._opts = task_options
        self.__name__ = getattr(fn, "__name__", "remote_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def options(self, **overrides) -> "RemoteFunction":
        _check_gpu_options(overrides)
        opts = dict(self._opts)
        opts.update(overrides)
        return RemoteFunction(self._fn, **opts)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self.__name__} cannot be called directly; "
            f"use {self.__name__}.remote()"
        )

    def bind(self, *args, **kwargs):
        """Capture this call as a DAG node (reference: dag/function_node.py)."""
        from ray_tpu_torch.dag.nodes import FunctionNode

        return FunctionNode(self, args, kwargs)

    def _invariants(self) -> tuple:
        """Options-derived fields computed once per RemoteFunction (the
        reference caches the same way: RemoteFunction pre-computes its
        TaskSpec template in remote_function.py:303 so per-call work is
        args + ids only)."""
        inv = self.__dict__.get("_inv")
        if inv is None:
            import inspect

            opts = self._opts
            nr_opt = opts.get("num_returns", 1)
            # Generator functions stream by default (reference:
            # _raylet.pyx streaming generators;
            # num_returns="streaming"/"dynamic").
            streaming = nr_opt in ("streaming", "dynamic") or (
                nr_opt == 1 and inspect.isgeneratorfunction(self._fn)
            )
            inv = self._inv = (
                streaming,
                1 if streaming else int(nr_opt),
                opts.get("name", self.__name__),
                _normalize_resources(
                    opts.get("num_cpus"),
                    # num_tpus= is taken as an alias, as ray_tpu takes
                    # num_gpus= for its chip.
                    opts.get("num_gpus") or opts.get("num_tpus"),
                    opts.get("memory"),
                    opts.get("resources"),
                ),
                int(opts.get("max_retries",
                             GLOBAL_CONFIG.task_max_retries_default)),
                opts.get("scheduling_strategy"),
                int(opts.get("max_calls", 0)),
                # Overload protection: .options(timeout_s=...) stamps a
                # deadline on the spec at submit; 0/None = the
                # task_timeout_s_default knob (0 = no deadline).
                float(opts.get("timeout_s")
                      or GLOBAL_CONFIG.task_timeout_s_default or 0.0),
            )
        return inv

    def remote(self, *args, **kwargs):
        from ray_tpu_torch import api
        from ray_tpu_torch._private.ids import fast_hex_id

        api.auto_init()
        rt = global_runtime()
        opts = self._opts
        (streaming, num_returns, name, resources, max_retries, strategy,
         max_calls, timeout_s) = self._invariants()
        func_id = rt.register_function(self._fn)
        packed, deps, borrowed = rt.pack_args(args, kwargs)
        return_ids = [fast_hex_id() for _ in range(num_returns)]
        spec = TaskSpec(
            task_id="task-" + fast_hex_id(),
            name=name,
            func_id=func_id,
            args=packed,
            deps=deps,
            borrowed_ids=borrowed,
            return_ids=return_ids,
            resources=resources,
            owner_id=rt.client_id,
            max_retries=max_retries,
            scheduling_strategy=strategy,
            runtime_env=_pack_env(opts.get("runtime_env"), rt),
            streaming=streaming,
            max_calls=max_calls,
        )
        if timeout_s:
            import time as _time

            spec.deadline = _time.time() + timeout_s
        rt.submit_task(spec)
        if streaming:
            from ray_tpu_torch.generator import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, ObjectRef(return_ids[0], _owned=True))
        refs = [ObjectRef(oid, _owned=True) for oid in return_ids]
        return refs[0] if num_returns == 1 else refs


def make_remote(fn_or_class: Any, options: dict):
    import inspect

    from ray_tpu_torch.actor import ActorClass

    if inspect.isclass(fn_or_class):
        return ActorClass(fn_or_class, **options)
    return RemoteFunction(fn_or_class, **options)
