"""Model multiplexing — many models behind one deployment.

Counterpart of the reference's python/ray/serve/multiplex.py +
serve.get_multiplexed_model_id(): a deployment declares an async model
loader with ``@serve.multiplexed(max_num_models_per_replica=N)``; each
replica keeps an LRU cache of N loaded models, and requests carry a
``multiplexed_model_id`` (set via
``handle.options(multiplexed_model_id=...)``) that the replica exposes
through ``serve.get_multiplexed_model_id()``.

Routing affinity: the handle routes a model id to a stable replica via
rendezvous (highest-random-weight) hashing over the current replica set,
so repeated requests for one model land where it is already loaded while
different models spread across replicas — no control-plane reporting
loop needed (design difference vs the reference's pushed model-id
state; same cache-hit outcome under a stable replica set).

    @serve.deployment(num_replicas=2)
    class LoRAServer:
        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id: str):
            return load_lora(model_id)

        async def __call__(self, payload):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return model(payload)
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import weakref
from collections import OrderedDict
from typing import Callable

_request_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id of the request being handled (reference:
    serve.get_multiplexed_model_id)."""
    return _request_model_id.get()


def _set_request_model_id(model_id: str):
    return _request_model_id.set(model_id)


class _ModelCache:
    """Per-(instance, loader) LRU of loaded models; one load at a time
    per model id (concurrent requests for the same id await one load)."""

    def __init__(self, max_models: int):
        self.max_models = max_models
        self.models: OrderedDict = OrderedDict()
        self.loading: dict[str, asyncio.Future] = {}

    async def get(self, loader, bound_args, model_id: str):
        if model_id in self.models:
            self.models.move_to_end(model_id)
            return self.models[model_id]
        pending = self.loading.get(model_id)
        if pending is not None:
            return await asyncio.shield(pending)
        fut = asyncio.get_running_loop().create_future()
        self.loading[model_id] = fut
        try:
            model = await loader(*bound_args, model_id)
            while len(self.models) >= self.max_models:
                # LRU eviction: dropping our reference lets CPython
                # finalize the model (its __del__ runs then, matching
                # the reference's eviction hook timing).
                self.models.popitem(last=False)
            self.models[model_id] = model
            fut.set_result(model)
            return model
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)
            raise
        finally:
            self.loading.pop(model_id, None)
            if not fut.done():  # defensive: never leave waiters hanging
                fut.cancel()


class _InstanceRegistry(weakref.WeakKeyDictionary):
    """Weakref-keyed cache registry that pickles as EMPTY: caches are
    per-process state (weakrefs and loaded models don't travel), and a
    deployment class defined in a driver script is shipped to replicas
    by value — the registry must not drag dead-process caches along."""

    def __reduce__(self):
        return (self.__class__, ())


class _FallbackRegistry(dict):
    """id()-keyed fallback registry; same pickle-as-empty contract."""

    def __reduce__(self):
        return (self.__class__, ())


def multiplexed(_fn: Callable | None = None, *,
                max_num_models_per_replica: int = 3):
    """Decorate an async model loader taking a model id (reference:
    serve/multiplex.py @serve.multiplexed)."""

    def decorator(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError(
                "@serve.multiplexed requires an async def loader; got "
                f"{fn!r}"
            )
        # Bound loaders key their cache by a weakref to the instance:
        # an id()-keyed dict is never pruned, so entries leak across
        # replica instance lifetimes, and a recycled id() can hand a
        # fresh instance a dead instance's cache. The id-keyed fallback
        # survives only for unbound loaders (key 0) and instances that
        # cannot be weak-referenced (e.g. __slots__ without __weakref__).
        caches: _InstanceRegistry = _InstanceRegistry()
        fallback_caches: _FallbackRegistry = _FallbackRegistry()

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:
                bound_args, model_id = (args[0],), args[1]
                registry, key = caches, args[0]
            elif len(args) == 1:
                bound_args, model_id = (), args[0]
                registry, key = fallback_caches, 0
            else:
                raise TypeError(
                    "@serve.multiplexed loaders take exactly one model id"
                )
            if not model_id:
                raise ValueError(
                    "no model id: pass one explicitly or set it on the "
                    "handle via .options(multiplexed_model_id=...)"
                )
            try:
                cache = registry.get(key)
            except TypeError:  # non-weakrefable instance
                registry, key = fallback_caches, id(args[0])
                cache = registry.get(key)
            if cache is None:
                cache = _ModelCache(max_num_models_per_replica)
                registry[key] = cache
            return await cache.get(fn, bound_args, model_id)

        wrapper._ray_tpu_serve_multiplexed = True
        wrapper._model_caches = caches
        wrapper._model_caches_fallback = fallback_caches
        return wrapper

    if _fn is not None:
        return decorator(_fn)
    return decorator


def rendezvous_pick(replicas: list, model_id: str):
    """Highest-random-weight choice of replica for a model id — stable
    under replica-set changes (only keys owned by a removed replica
    move)."""
    import hashlib

    def weight(rid: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(f"{rid}|{model_id}".encode(),
                            digest_size=8).digest(), "big")

    return max(replicas, key=lambda r: weight(r[0]))
