"""gRPC ingress for Serve.

Counterpart of the reference's gRPCProxy (reference: serve/_private/
proxy.py:534 gRPCProxy; user-defined protos served next to HTTP). Here
the service is schema-light: one unary-unary method

    /ray_tpu.serve.Ingress/Predict

with JSON (or cloudpickle) request bytes and the target deployment given
in request metadata (``deployment`` key) or as a JSON envelope
{"deployment": ..., "payload": ...}. Responses mirror the request
encoding. Runs inside the same proxy actor as the HTTP ingress, sharing
its DeploymentHandle routing (power-of-two replica choice).
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Any

from ray_tpu_torch.serve.handle import DeploymentHandle

# The reference's service name: a client of either package reaches both.
SERVICE = "ray_tpu.serve.Ingress"
METHOD = "Predict"


def _json_default(o):
    """numpy-aware JSON fallback, mirroring HTTPProxy._encode."""
    import numpy as np

    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o)}")


class GrpcIngress:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import grpc

        self._handles: dict[str, DeploymentHandle] = {}
        self._routes: dict[str, str] = {}

        def predict(request: bytes, context) -> bytes:
            meta = dict(context.invocation_metadata())
            encoding = meta.get("encoding", "json")
            deployment = meta.get("deployment")
            payload: Any
            try:
                if encoding == "pickle":
                    import cloudpickle

                    payload = cloudpickle.loads(request)
                else:
                    payload = json.loads(request) if request else {}
            except Exception as e:  # noqa: BLE001
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"bad {encoding} request body: {e}")
            # Envelope form ONLY when the dict explicitly carries a
            # 'deployment' key — a user payload that merely contains a
            # 'payload' key must pass through untouched.
            if (deployment is None and isinstance(payload, dict)
                    and "deployment" in payload):
                deployment = payload["deployment"]
                payload = payload.get("payload", {})
            handle = self._resolve(deployment)
            if handle is None:
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"no deployment {deployment!r}; known: {sorted(self._routes.values())}",
                )
            # Per-request deadline rides the gRPC deadline when the
            # client set one (context.time_remaining), default 60 s —
            # stamped onto the TaskSpec like the HTTP ingress does.
            remaining = None
            try:
                remaining = context.time_remaining()
            except Exception:  # noqa: BLE001
                pass
            timeout_s = min(remaining, 600.0) if remaining else 60.0
            try:
                result = handle.options(timeout_s=timeout_s).remote(
                    payload).result(timeout_s=timeout_s + 5.0)
            except Exception as e:  # noqa: BLE001
                context.abort(*self._classify(grpc, e))
            try:
                if encoding == "pickle":
                    from ray_tpu_torch._private.serialization import dumps_scoped

                    return dumps_scoped(result)
                return json.dumps(result, default=_json_default).encode()
            except Exception as e:  # noqa: BLE001
                context.abort(grpc.StatusCode.INTERNAL,
                              f"response not {encoding}-serializable: {e}")

        handler = grpc.method_handlers_generic_handler(
            SERVICE,
            {
                METHOD: grpc.unary_unary_rpc_method_handler(
                    predict,
                    request_deserializer=None,  # raw bytes
                    response_serializer=None,
                ),
            },
        )
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((handler,))
        self._port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()

    @staticmethod
    def _classify(grpc, e: Exception):
        """Typed overload mapping, mirroring HTTPProxy._error_response:
        admission sheds → RESOURCE_EXHAUSTED, deadline sheds →
        DEADLINE_EXCEEDED, everything else INTERNAL. Replica-raised
        errors arrive as TaskError (sealed repr), hence the string
        match beside the isinstance checks."""
        from ray_tpu_torch.exceptions import (
            PendingCallsLimitError,
            TaskTimeoutError,
        )

        msg = str(e)
        if isinstance(e, PendingCallsLimitError) \
                or "PendingCallsLimitError" in msg:
            return grpc.StatusCode.RESOURCE_EXHAUSTED, msg
        if isinstance(e, (TaskTimeoutError, TimeoutError)) \
                or "TaskTimeoutError" in msg:
            return grpc.StatusCode.DEADLINE_EXCEEDED, msg
        return grpc.StatusCode.INTERNAL, msg

    def _resolve(self, deployment: str | None) -> DeploymentHandle | None:
        if deployment is None:
            # Single-route apps: default to the only deployment.
            targets = set(self._routes.values())
            if len(targets) == 1:
                deployment = next(iter(targets))
            else:
                return None
        if deployment not in set(self._routes.values()):
            return None
        h = self._handles.get(deployment)
        if h is None:
            h = self._handles[deployment] = DeploymentHandle(deployment)
        return h

    def update_routes(self, routes: dict[str, str]) -> None:
        self._routes = dict(routes)
        for name in list(self._handles):
            if name not in set(routes.values()):
                del self._handles[name]

    def get_port(self) -> int:
        return self._port

    def stop(self) -> None:
        self._server.stop(grace=0.5)


def grpc_request(address: str, payload: Any, *, deployment: str | None = None,
                 encoding: str = "json", timeout_s: float = 60.0) -> Any:
    """Client helper (the reference exposes generated stubs; this is the
    stub equivalent for the schema-light service)."""
    import grpc

    channel = grpc.insecure_channel(address)
    try:
        if encoding == "pickle":
            from ray_tpu_torch._private.serialization import dumps_scoped

            body = dumps_scoped(payload)
        else:
            body = json.dumps(payload).encode()
        callable_ = channel.unary_unary(f"/{SERVICE}/{METHOD}")
        metadata = [("encoding", encoding)]
        if deployment:
            metadata.append(("deployment", deployment))
        reply = callable_(body, metadata=metadata, timeout=timeout_s)
        if encoding == "pickle":
            import cloudpickle

            return cloudpickle.loads(reply)
        return json.loads(reply)
    finally:
        channel.close()
