"""Custom serializer registration.

Counterpart of the reference's ray.util.serialization
(reference: python/ray/util/serialization.py — register_serializer /
deregister_serializer installing per-class reducers into the worker's
serialization context). The reducer embeds the deserializer (cloudpickle
serializes it by value), so workers reconstruct objects without any
receiver-side registration step.

Scoping matches the reference: the reducer lives in the runtime's own
serialization context (`_private.serialization.custom_reducers`), NOT in
the process-global copyreg dispatch table — `copy.deepcopy` and user
`pickle.dumps` of the class are unaffected.

    class Conn: ...                      # unpicklable (sockets inside)
    ray_tpu_torch.util.register_serializer(
        Conn,
        serializer=lambda c: c.address,
        deserializer=lambda addr: Conn(addr),
    )
"""

from __future__ import annotations

from typing import Any, Callable

from ray_tpu_torch._private.serialization import custom_reducers


def _reconstruct(deserializer: Callable, payload: Any):
    return deserializer(payload)


def register_serializer(cls: type, *, serializer: Callable[[Any], Any],
                        deserializer: Callable[[Any], Any]) -> None:
    """Route object-store serialization of ``cls`` instances through
    ``serializer`` (must return something picklable); workers rebuild via
    ``deserializer``. Only ray_tpu_torch transfers are affected — in-process
    pickling of the class keeps its normal behavior."""

    def reducer(obj):
        return _reconstruct, (deserializer, serializer(obj))

    custom_reducers[cls] = reducer


def deregister_serializer(cls: type) -> None:
    custom_reducers.pop(cls, None)
