"""HTTP proxy: the ingress actor.

Counterpart of the reference's HTTPProxy/ProxyActor (serve/_private/proxy.py
:754,:1131 — uvicorn/ASGI). Here: an aiohttp server on its own event-loop
thread inside a proxy actor. Routes come from the controller's route table
(route_prefix → deployment); requests are routed through a DeploymentHandle
(power-of-two choices) and awaited without blocking the loop.

Serving-plane duties at the ingress hop:

* deadline stamping — ``X-Request-Timeout-S`` (default 30 s) becomes the
  request deadline the handle stamps onto the TaskSpec, so expired work
  sheds at every hop (owner queue, head, worker pickup, batch queue);
* typed overload mapping — ``PendingCallsLimitError`` (admission shed)
  → HTTP 503 with Retry-After, ``TaskTimeoutError`` (deadline shed) →
  HTTP 408; everything else stays 500;
* client-disconnect propagation — when the HTTP client goes away the
  awaiting coroutine is cancelled and the proxy forwards the cancel to
  the in-flight replica call (``ray_tpu_torch.cancel``), so abandoned work
  stops burning replica capacity (reference: serve/_private/proxy.py
  disconnect handling)."""

from __future__ import annotations

import asyncio
import json
import os
import socket
import threading
import time
from typing import Any

from ray_tpu_torch._private import traceplane, worker_context
from ray_tpu_torch.serve.handle import DeploymentHandle


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._handles: dict[str, DeploymentHandle] = {}
        self._routes: dict[str, str] = {}
        self._port = port
        self._ready = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        # Bind the socket synchronously so get_port is correct immediately.
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True, name="http-proxy")
        self._thread.start()
        self._ready.wait(timeout=10)
        # gRPC ingress beside HTTP (reference: gRPCProxy in the same
        # proxy actor, serve/_private/proxy.py:534); optional — absent
        # grpcio just disables the listener.
        self._grpc = None
        try:
            from ray_tpu_torch.serve.grpc_proxy import GrpcIngress

            self._grpc = GrpcIngress(host)
        except ImportError:
            pass  # grpcio not installed: HTTP-only
        except Exception as e:  # noqa: BLE001 — real failures must be visible
            import sys

            print(f"[serve] gRPC ingress failed to start: {e!r}", file=sys.stderr)

    # -- control -----------------------------------------------------------

    def get_port(self) -> int:
        return self._port

    def get_grpc_port(self) -> int:
        return self._grpc.get_port() if self._grpc is not None else -1

    def update_routes(self, routes: dict) -> None:
        """route_prefix -> {"name", "sse_method"} (pushed by
        serve.run/delete; legacy plain-string values are normalized).
        Handles are populated BEFORE the route table swap (requests
        racing this update must never see a route without a handle),
        and stale handles are dropped."""
        routes = {prefix: (v if isinstance(v, dict)
                           else {"name": v, "sse_method": None})
                  for prefix, v in routes.items()}
        handles = {
            v["name"]: self._handles.get(v["name"])
            or DeploymentHandle(v["name"])
            for v in routes.values()
        }
        self._handles.update(handles)
        self._routes = dict(routes)
        for name in list(self._handles):
            if name not in handles:
                del self._handles[name]
        if self._grpc is not None:
            self._grpc.update_routes(
                {prefix: v["name"] for prefix, v in routes.items()})

    def ping(self) -> str:
        return "pong"

    # -- server ------------------------------------------------------------

    def _serve(self) -> None:
        from aiohttp import web

        async def handle(request: "web.Request") -> "web.Response":
            path = request.path.rstrip("/") or "/"
            meta = self._match_route(path)
            if meta is None:
                return web.json_response(
                    {"error": f"no route for {path}"}, status=404
                )
            name = meta["name"]
            if request.method == "POST":
                raw = await request.read()
                try:
                    payload = json.loads(raw) if raw else {}
                except json.JSONDecodeError:
                    payload = raw.decode()
            else:
                payload = dict(request.query)
            handle_ = self._handles.get(name)
            if handle_ is None:
                # Route table swapped concurrently (serve.delete race).
                return web.json_response(
                    {"error": f"no route for {path}"}, status=404
                )
            if (request.headers.get("Upgrade", "").lower() == "websocket"
                    and meta.get("ws_method")):
                return await self._handle_ws(web, request, handle_, meta)
            # Request tracing: mint (or adopt X-Request-Id as) the trace
            # at the ingress hop; the context rides every nested
            # .remote() via the ambient contextvar, and the trace id is
            # echoed back as X-Trace-Id for client-side correlation.
            trace_ctx = traceplane.mint_trace(
                request.headers.get("X-Request-Id"))
            t0 = time.time()
            wants_sse = ("text/event-stream" in request.headers.get("Accept", "")
                         or (isinstance(payload, dict)
                             and payload.get("stream") is True
                             and meta.get("sse_method")))
            if wants_sse:
                # SSE streaming: each yielded item becomes one `data:`
                # event as produced. Deployments declaring a dedicated
                # async-generator protocol handler (sse_method, e.g.
                # the OpenAI `stream_events`) get SSE routed there —
                # their __call__ stays a plain JSON method; otherwise
                # __call__ itself must be a generator.
                return await self._stream_sse(
                    web, request, handle_, payload,
                    method=meta.get("sse_method"), trace_ctx=trace_ctx,
                    t0=t0)
            # Per-request deadline: the handle stamps it onto the
            # TaskSpec so expired requests shed at every hop instead of
            # completing into the void.
            try:
                timeout_s = float(
                    request.headers.get("X-Request-Timeout-S", 30.0))
            except (TypeError, ValueError):
                timeout_s = 30.0
            timeout_s = max(0.001, min(timeout_s, 600.0))
            resp_obj = None
            try:
                # Submit via a SHORT executor hop (routing can hit a
                # blocking controller refresh ~1/s), then await the
                # result fully async: an in-flight request holds no
                # thread (reference: serve/_private/proxy.py:754 async
                # proxy). Concurrency is bounded by memory, not pool
                # size.
                loop = asyncio.get_running_loop()
                if meta.get("path_method"):
                    # Path-aware deployment: it receives the subpath
                    # below its route prefix plus the payload — real
                    # URL routing (reference: serve's ASGI app routes).
                    prefix = meta.get("_prefix", "/")
                    sub = path[len(prefix):] if prefix != "/" else path
                    sub = sub or "/"
                    resp_obj = await loop.run_in_executor(
                        None, lambda: self._with_trace(
                            trace_ctx, lambda: handle_.options(
                                method_name=meta["path_method"],
                                timeout_s=timeout_s).remote(sub, payload)))
                else:
                    resp_obj = await loop.run_in_executor(
                        None, lambda: self._with_trace(
                            trace_ctx, lambda: handle_.options(
                                timeout_s=timeout_s).remote(payload)))
                result = await resp_obj._result_async(
                    timeout_s=timeout_s + 5.0)
            except asyncio.CancelledError:
                # Client disconnected while we awaited the replica:
                # propagate the cancel so the in-flight call stops
                # burning replica capacity, then let aiohttp tear the
                # transport down.
                if resp_obj is not None:
                    loop = asyncio.get_running_loop()
                    loop.run_in_executor(None, resp_obj.cancel)
                raise
            except Exception as e:  # noqa: BLE001 — surface to the client
                # Shed/error responses close the trace too — 503/408
                # exemplars are exactly what tail-based retention keeps.
                return self._finish_trace(
                    trace_ctx, request, self._error_response(web, e),
                    t0, error=e)
            return self._finish_trace(
                trace_ctx, request, self._encode(web, result), t0)

        async def run():
            app = web.Application()
            app.router.add_route("*", "/{tail:.*}", handle)
            # handler_cancellation: aiohttp >= 3.9 stopped cancelling
            # handlers on client disconnect by default — the serving
            # plane WANTS the cancel (it propagates to the in-flight
            # replica call so abandoned work is dropped).
            try:
                runner = web.AppRunner(app, handler_cancellation=True)
            except TypeError:  # older aiohttp: cancellation is the default
                runner = web.AppRunner(app)
            await runner.setup()
            site = web.SockSite(runner, self._sock)
            await site.start()
            self._ready.set()
            while True:  # park forever; actor kill tears the process down
                await asyncio.sleep(3600)

        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(run())

    async def _stream_sse(self, web, request, handle_, payload,
                          method: "str | None" = None, trace_ctx=None,
                          t0: float = 0.0):
        """Fully async SSE: submit via a short executor hop, then
        async-iterate the response generator — each item awaits a
        head-pushed readiness notification, so a stream in flight holds
        NO thread (the old design parked one pump thread per stream,
        capping concurrent streams at the pool size). Backpressure is
        inherent: the next item is requested only after the previous
        write completes."""
        loop = asyncio.get_running_loop()
        headers = {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        }
        if trace_ctx is not None:
            headers["X-Trace-Id"] = trace_ctx[0]
        resp = web.StreamResponse(headers=headers)
        await resp.prepare(request)
        gen = None
        try:
            opts = {"stream": True}
            if method:
                opts["method_name"] = method
            gen = await loop.run_in_executor(
                None, lambda: self._with_trace(
                    trace_ctx,
                    lambda: handle_.options(**opts).remote(payload)))
            async for item in gen:
                if item == "[DONE]":
                    # OpenAI stream terminator: literal, not JSON.
                    await resp.write(b"data: [DONE]\n\n")
                    continue
                await resp.write(
                    f"data: {json.dumps(item, default=str)}\n\n".encode())
            await resp.write_eof()
        except Exception as e:  # noqa: BLE001
            # Replica error mid-stream (surface to the client) or the
            # client disconnected (write raised — nothing to surface).
            try:
                await resp.write(
                    f"event: error\ndata: {json.dumps(str(e))}\n\n".encode())
                await resp.write_eof()
            except Exception:
                pass
        finally:
            # Early termination must release routing accounting.
            if gen is not None and hasattr(gen, "close"):
                gen.close()
            self._record_root_span(trace_ctx, request, 200, t0)
        return resp

    async def _handle_ws(self, web, request, handle_, meta):
        """WebSocket ingress (reference: serve's FastAPI websocket
        routes through the ASGI proxy; here the deployment declares a
        ``ws_message`` handler). Per inbound frame: JSON-decode when
        possible, dispatch to the replica, and send the reply — every
        yielded item of an async-generator handler becomes one outbound
        frame, so token-streaming chat works over one socket. The
        connection closes when the client closes; a replica error
        surfaces as an error frame, not a dropped socket."""
        from aiohttp import WSMsgType

        loop = asyncio.get_running_loop()
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        method = meta["ws_method"]
        streaming = bool(meta.get("ws_stream"))
        async for msg in ws:
            if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING,
                            WSMsgType.ERROR):
                break
            if msg.type == WSMsgType.BINARY:
                # The contract is one reply per inbound frame — an
                # unsupported frame type gets an error reply, never
                # silence (the client would block on its receive).
                try:
                    await ws.send_str(json.dumps(
                        {"error": "binary frames not supported; "
                                  "send JSON text frames"}))
                except Exception:
                    break
                continue
            if msg.type != WSMsgType.TEXT:
                continue  # ping/pong handled by aiohttp
            try:
                payload = json.loads(msg.data)
            except json.JSONDecodeError:
                payload = msg.data
            gen = None
            try:
                if streaming:
                    gen = await loop.run_in_executor(
                        None, lambda: handle_.options(
                            stream=True, method_name=method).remote(payload))
                    async for item in gen:
                        await ws.send_str(json.dumps(item, default=str))
                else:
                    resp_obj = await loop.run_in_executor(
                        None, lambda: handle_.options(
                            method_name=method).remote(payload))
                    result = await resp_obj._result_async(timeout_s=30.0)
                    await ws.send_str(json.dumps(result, default=str))
            except Exception as e:  # noqa: BLE001 — surface per-frame
                try:
                    await ws.send_str(json.dumps({"error": str(e)}))
                except Exception:
                    break  # client gone mid-reply
            finally:
                if gen is not None and hasattr(gen, "close"):
                    gen.close()
        return ws

    def _match_route(self, path: str) -> "dict | None":
        # Longest-prefix match (reference: proxy route matching). The
        # matched prefix rides along so path-aware deployments receive
        # the subpath below their mount point.
        best, best_len, best_prefix = None, -1, "/"
        for prefix, meta in self._routes.items():
            p = prefix.rstrip("/") or "/"
            if (path == p or path.startswith(p + "/") or p == "/") and len(p) > best_len:
                best, best_len, best_prefix = meta, len(p), p
        if best is None:
            return None
        return {**best, "_prefix": best_prefix}

    @staticmethod
    def _with_trace(trace_ctx, fn):
        """Run the submit closure with the request's trace context
        ambient. Contextvars don't cross run_in_executor, and executor
        threads are REUSED — push/pop (not set) so the context can't
        leak into the thread's next unrelated request."""
        if trace_ctx is None:
            return fn()
        tok = worker_context.push_trace_context(trace_ctx)
        try:
            return fn()
        finally:
            worker_context.pop_trace_context(tok)

    def _finish_trace(self, trace_ctx, request, resp, t0,
                      error: "Exception | None" = None):
        """Echo X-Trace-Id and close the request's root span. Runs on
        the success AND error/shed paths — a 503/408 response is
        exactly the tail exemplar the head's trace table retains."""
        if trace_ctx is None:
            return resp
        resp.headers["X-Trace-Id"] = trace_ctx[0]
        self._record_root_span(trace_ctx, request,
                               getattr(resp, "status", 200), t0,
                               error=error)
        return resp

    @staticmethod
    def _record_root_span(trace_ctx, request, status, t0, error=None):
        if trace_ctx is None or not int(trace_ctx[2] or 0):
            return
        attrs = {"method": request.method, "path": request.path,
                 "status": status}
        if error is not None:
            attrs["error"] = repr(error)
        traceplane.buffer_span({
            "event": "span",
            "name": "http.request",
            "kind": "proxy",
            "trace_id": trace_ctx[0],
            "span_id": trace_ctx[1],
            "parent_span_id": "",
            "pid": os.getpid(),
            "start": t0,
            "end": time.time(),
            "failed": status >= 500,
            "status": status,
            "attributes": attrs,
        })

    @staticmethod
    def _error_response(web, e: Exception):
        """Typed overload mapping. Replica-raised errors cross the wire
        as TaskError (the worker seals repr(exc)), so classification
        string-matches the type name in the message alongside the
        isinstance checks for locally-raised instances."""
        from ray_tpu_torch.exceptions import (
            PendingCallsLimitError,
            TaskTimeoutError,
        )

        msg = str(e)
        if isinstance(e, PendingCallsLimitError) \
                or "PendingCallsLimitError" in msg:
            return web.json_response(
                {"error": msg, "type": "PendingCallsLimitError",
                 "retry_after_s": 0.5},
                status=503, headers={"Retry-After": "1"})
        if isinstance(e, (TaskTimeoutError, TimeoutError, asyncio.TimeoutError)) \
                or "TaskTimeoutError" in msg:
            return web.json_response(
                {"error": msg, "type": "TaskTimeoutError"}, status=408)
        return web.json_response(
            {"error": msg, "type": type(e).__name__}, status=500)

    @staticmethod
    def _encode(web, result: Any):
        import numpy as np

        def default(o):
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, np.generic):
                return o.item()
            raise TypeError(f"not JSON serializable: {type(o)}")

        if isinstance(result, (bytes, bytearray)):
            return web.Response(body=bytes(result))
        if isinstance(result, str):
            return web.Response(text=result)
        return web.Response(
            text=json.dumps(result, default=default),
            content_type="application/json",
        )
