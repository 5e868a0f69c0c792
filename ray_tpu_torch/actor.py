"""@ray_tpu_torch.remote on classes: actors.

Counterpart of the reference's actor frontend (reference:
python/ray/actor.py — ActorClass ``remote`` :752, ActorHandle, ActorMethod)
over the head's actor table (GcsActorManager analogue in _private/gcs.py).
Calls are routed by the head to the actor's dedicated worker and executed
FIFO (or concurrently with ``max_concurrency`` > 1 — threaded actors).
"""

from __future__ import annotations



from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import fast_hex_id, ActorID, ObjectRef
from ray_tpu_torch._private.task_spec import ActorSpec, TaskSpec
from ray_tpu_torch._private.worker_context import global_runtime
from ray_tpu_torch.remote_function import _check_gpu_options, _normalize_resources, _pack_env


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns=1,
                 concurrency_group: str | None = None,
                 timeout_s: float | None = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group
        self._timeout_s = timeout_s

    def options(self, num_returns=None, concurrency_group=None,
                timeout_s=None, **_):
        return ActorMethod(
            self._handle, self._name,
            self._num_returns if num_returns is None else num_returns,
            concurrency_group or self._concurrency_group,
            self._timeout_s if timeout_s is None else timeout_s)

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._name, args, kwargs, self._num_returns,
            self._concurrency_group, self._timeout_s)

    def bind(self, *args, **kwargs):
        """Capture this call as a DAG node (reference: dag/class_node.py)."""
        from ray_tpu_torch.dag.nodes import ClassMethodNode

        return ClassMethodNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name} cannot be called directly; use .remote()"
        )


class ActorHandle:
    def __init__(
        self,
        actor_id: str,
        method_names: tuple[str, ...] = (),
        gen_methods: tuple[str, ...] = (),
        method_meta: dict | None = None,
    ):
        self._actor_id = actor_id
        self._method_names = method_names
        self._gen_methods = gen_methods
        # {name: (num_returns, concurrency_group)} from @ray_tpu_torch.method.
        self._method_meta = method_meta or {}
        self._seq = 0

    @property
    def actor_id(self) -> ActorID:
        return ActorID(self._actor_id)

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        nr, group = self._method_meta.get(name, (1, None))
        if name in self._gen_methods:
            nr = "streaming"
        m = ActorMethod(self, name, nr, group)
        # Cache on the instance: ``handle.method`` in a hot submit loop
        # resolves from __dict__ from now on, skipping this method and
        # the per-call ActorMethod allocation. (__reduce__ rebuilds
        # handles from ids only, so the cache never rides a pickle.)
        self.__dict__[name] = m
        return m

    def _submit_method(self, method: str, args, kwargs, num_returns,
                       concurrency_group: str | None = None,
                       timeout_s: float | None = None):
        rt = global_runtime()
        packed, deps, borrowed = rt.pack_args(args, kwargs)
        streaming = num_returns in ("streaming", "dynamic")
        if streaming:
            num_returns = 1
        return_ids = [fast_hex_id() for _ in range(num_returns)]
        self._seq += 1
        spec = TaskSpec(
            task_id="task-" + fast_hex_id(),
            name=f"actor.{method}",
            func_id="",  # resolved from the actor instance worker-side
            args=packed,
            deps=deps,
            borrowed_ids=borrowed,
            return_ids=return_ids,
            resources={},
            owner_id=rt.client_id,
            actor_id=self._actor_id,
            method_name=method,
            seq_no=self._seq,
            streaming=streaming,
            concurrency_group=concurrency_group,
        )
        timeout_s = (timeout_s if timeout_s is not None
                     else GLOBAL_CONFIG.task_timeout_s_default)
        if timeout_s:
            import time as _time

            spec.deadline = _time.time() + float(timeout_s)
        rt.submit_actor_task(spec)
        if streaming:
            from ray_tpu_torch.generator import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, ObjectRef(return_ids[0], _owned=True))
        refs = [ObjectRef(oid, _owned=True) for oid in return_ids]
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_names,
                              self._gen_methods, self._method_meta))

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:16]})"


class ActorClass:
    def __init__(self, cls, **actor_options):
        self._cls = cls
        self._opts = actor_options
        self.__name__ = getattr(cls, "__name__", "Actor")

    def options(self, **overrides) -> "ActorClass":
        _check_gpu_options(overrides)
        opts = dict(self._opts)
        opts.update(overrides)
        return ActorClass(self._cls, **opts)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()"
        )

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch import api

        api.auto_init()
        rt = global_runtime()
        opts = self._opts
        cls_func_id = rt.register_function(self._cls)
        packed, deps, borrowed = rt.pack_args(args, kwargs)
        actor_id = "actor-" + fast_hex_id()
        # Actors hold 0 CPUs while idle by default (many actors per node),
        # mirroring the reference's default actor resource semantics.
        spec = ActorSpec(
            actor_id=actor_id,
            name=opts.get("name"),
            namespace=opts.get("namespace", api.get_namespace()),
            cls_func_id=cls_func_id,
            init_args=packed,
            deps=deps,
            borrowed_ids=borrowed,
            resources=_normalize_resources(
                opts.get("num_cpus"),
                opts.get("num_gpus") or opts.get("num_tpus"),
                opts.get("memory"),
                opts.get("resources"),
                default_cpus=0.0,
            ),
            max_restarts=int(opts.get("max_restarts", GLOBAL_CONFIG.actor_max_restarts_default)),
            max_task_retries=int(opts.get("max_task_retries", 0)),
            # 0 = unset: async actors then default to 1000-way
            # concurrency, while an EXPLICIT max_concurrency=1 really
            # serializes their coroutines (reference semantics).
            max_concurrency=int(opts.get("max_concurrency") or 0),
            concurrency_groups=_validate_concurrency_groups(
                opts.get("concurrency_groups")),
            owner_id=rt.client_id,
            scheduling_strategy=opts.get("scheduling_strategy"),
            runtime_env=_pack_env(opts.get("runtime_env"), rt),
            lifetime=opts.get("lifetime"),
            allow_out_of_order=bool(
                opts.get("allow_out_of_order_execution", False)),
        )
        rt.create_actor(spec)
        import inspect

        methods = tuple(
            n for n in dir(self._cls) if callable(getattr(self._cls, n, None)) and not n.startswith("_")
        )
        gen_methods = tuple(
            n for n in methods
            if inspect.isgeneratorfunction(getattr(self._cls, n, None))
            or inspect.isasyncgenfunction(getattr(self._cls, n, None))
        )
        meta = {}
        for n in methods:
            fn = getattr(self._cls, n, None)
            nr = getattr(fn, "__ray_tpu_num_returns__", 1)
            cg = getattr(fn, "__ray_tpu_concurrency_group__", None)
            if nr != 1 or cg is not None:
                meta[n] = (nr, cg)
        return ActorHandle(actor_id, methods, gen_methods, meta)


def _validate_concurrency_groups(groups) -> dict | None:
    """{"name": limit} (reference: concurrency_group_manager.h:37 via
    @ray.remote(concurrency_groups={...}))."""
    if groups is None:
        return None
    if not isinstance(groups, dict) or not all(
        isinstance(k, str) and int(v) >= 1 for k, v in groups.items()
    ):
        raise ValueError(
            "concurrency_groups must be a dict of group name -> positive "
            f"max concurrency, got {groups!r}"
        )
    return {k: int(v) for k, v in groups.items()}


def method(num_returns=1, concurrency_group: str | None = None):
    """Per-method defaults (reference: python/ray/actor.py ray.method):

        @ray_tpu_torch.remote(concurrency_groups={"io": 2})
        class A:
            @ray_tpu_torch.method(concurrency_group="io")
            async def fetch(self): ...
    """

    def decorator(fn):
        fn.__ray_tpu_num_returns__ = num_returns
        fn.__ray_tpu_concurrency_group__ = concurrency_group
        return fn

    return decorator


def creation_ref(handle: ActorHandle) -> ObjectRef:
    """ObjectRef sealed when the actor finishes __init__ (or fails)."""
    return ObjectRef(handle._actor_id + ":creation")
