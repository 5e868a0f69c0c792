"""Durable workflows: checkpointed DAG execution with resume (port of
ray_tpu/workflow).

Counterpart of the reference's python/ray/workflow (api.py `workflow.run`
/ `run_async` / `resume` / `get_output` / `list_all`; step results
durably logged to storage so a crashed driver resumes where it left off;
dynamic workflows via `workflow.continuation`). Implementation here:

  - A DAG built with ``fn.bind(...)`` is *frozen* into a JSON-safe spec
    (functions cloudpickled, upstream edges by step id) and persisted, so
    resume does not need the original driver process.
  - Steps execute as cluster tasks (``fn.remote``) level-by-level
    (independent steps run in parallel); each result is written to
    storage before any dependent is submitted — the workflow is
    re-entrant at step granularity.
  - A step returning ``workflow.continuation(dag)`` splices the new
    sub-DAG in durably (dynamic workflows).

Step values are stored through the runtime's pickler
(``serialization.dumps_scoped``): a torch tensor, a CUDA one too, is
stored as its host bytes and loads as a CPU tensor, so a stored step
value loads in a process that sees no card.

Storage layout (filesystem; base dir from RAY_TPU_WORKFLOW_DIR, else
``$TMPDIR/ray_tpu_torch/workflows``, beside the port's session
directories; the reference's default is /tmp/ray_tpu/workflows):
    {base}/{workflow_id}/dag.pkl         frozen spec (grows with continuations)
    {base}/{workflow_id}/meta.json       status: RUNNING | SUCCESS | FAILED
    {base}/{workflow_id}/steps/{sid}.pkl durable step results
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Any

import cloudpickle

from ray_tpu_torch._private.serialization import dumps_scoped

import ray_tpu_torch
from ray_tpu_torch.dag.nodes import DAGNode, FunctionNode

__all__ = [
    "run", "run_async", "resume", "resume_async", "get_output",
    "get_status", "list_all", "delete", "continuation", "Continuation",
    "EventListener", "KVEventListener", "TimerListener", "trigger_event",
    "wait_for_event", "sleep",
]


def _base_dir() -> str:
    d = (os.environ.get("RAY_TPU_WORKFLOW_DIR")
         or os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "workflows"))
    os.makedirs(d, exist_ok=True)
    return d


class Continuation:
    """Marker returned by a step to splice a sub-DAG into the workflow."""

    def __init__(self, dag: DAGNode):
        if not isinstance(dag, DAGNode):
            raise TypeError("continuation() takes a DAG node (fn.bind(...))")
        self.dag = dag

    def __reduce__(self):
        # Travels worker→driver as its frozen spec (DAGNodes themselves
        # are not serializable).
        return (_rebuild_continuation, (_freeze(self.dag),))


def _rebuild_continuation(spec):
    c = Continuation.__new__(Continuation)
    c.dag = None
    c.spec = spec
    return c


def continuation(dag: DAGNode) -> Continuation:
    """Dynamic workflows (reference: workflow.continuation)."""
    return Continuation(dag)


# -- freezing ---------------------------------------------------------------

def _freeze(root: DAGNode) -> dict:
    """DAG → durable spec {steps: {sid: {fn, args, kwargs, deps}}, output}.

    Only FunctionNode graphs are durable (actor methods hold process
    state that cannot be replayed from storage — same restriction as the
    reference's workflow steps being task-based).
    """
    steps: dict[str, dict] = {}
    ids: dict[str, str] = {}  # node uuid -> step id
    counter = [0]

    def visit(node: DAGNode) -> str:
        if node._uuid in ids:
            return ids[node._uuid]
        if not isinstance(node, FunctionNode):
            raise TypeError(
                f"workflows support function steps only (fn.bind); got "
                f"{type(node).__name__}"
            )
        for up in node._upstream():
            visit(up)
        fn = node._remote_fn
        sid = f"{counter[0]:04d}_{getattr(fn, '__name__', 'step')}"
        counter[0] += 1
        ids[node._uuid] = sid

        def enc(v):
            if isinstance(v, DAGNode):
                return {"__step__": ids[v._uuid]}
            return {"__val__": dumps_scoped(v).hex()}

        steps[sid] = {
            "fn": dumps_scoped(fn._fn).hex(),
            "opts": fn._opts,
            "args": [enc(a) for a in node._bound_args],
            "kwargs": {k: enc(v) for k, v in node._bound_kwargs.items()},
            "deps": sorted({ids[u._uuid] for u in node._upstream()}),
        }
        return sid

    out = visit(root)
    return {"steps": steps, "output": out}


# -- storage ----------------------------------------------------------------

class _Store:
    def __init__(self, workflow_id: str):
        self.dir = os.path.join(_base_dir(), workflow_id)
        self.steps_dir = os.path.join(self.dir, "steps")
        os.makedirs(self.steps_dir, exist_ok=True)

    def save_spec(self, spec: dict) -> None:
        _atomic_write(os.path.join(self.dir, "dag.pkl"),
                      dumps_scoped(spec))

    def load_spec(self) -> dict:
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return cloudpickle.loads(f.read())

    def save_meta(self, **kw) -> None:
        meta = self.load_meta()
        meta.update(kw)
        _atomic_write(os.path.join(self.dir, "meta.json"),
                      json.dumps(meta).encode())

    def load_meta(self) -> dict:
        try:
            with open(os.path.join(self.dir, "meta.json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def step_path(self, sid: str) -> str:
        return os.path.join(self.steps_dir, f"{sid}.pkl")

    def has_step(self, sid: str) -> bool:
        return os.path.exists(self.step_path(sid))

    def save_step(self, sid: str, value: Any) -> None:
        _atomic_write(self.step_path(sid), dumps_scoped(value))

    def load_step(self, sid: str) -> Any:
        with open(self.step_path(sid), "rb") as f:
            return cloudpickle.loads(f.read())


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


# -- execution --------------------------------------------------------------

def _reachable(steps: dict, target: str) -> set[str]:
    needed: set[str] = set()
    frontier = [target]
    while frontier:
        s = frontier.pop()
        if s in needed:
            continue
        needed.add(s)
        frontier.extend(steps[s]["deps"])
    return needed


def _execute(spec: dict, store: _Store) -> Any:
    """Run the steps reachable from spec['output'] that are not yet in
    storage, deps-first, parallel within a level. Returns the output
    step's value.

    Only the reachable subgraph runs here: spliced continuation steps
    are NOT dependency-linked to the outer output and execute exclusively
    through their parent step's continuation marker (below) — running
    them at this level too would double-execute them on resume."""
    import ray_tpu_torch.remote_function as rf

    steps = spec["steps"]
    done: dict[str, Any] = {}
    pending = _reachable(steps, spec["output"])

    for sid in list(pending):
        if store.has_step(sid):
            value = store.load_step(sid)
            if isinstance(value, dict) and "__continuation__" in value:
                # The step durably resolved to a continuation before the
                # crash: finish (or load) its subgraph instead of
                # re-running the step.
                value = _execute(
                    {"steps": steps, "output": value["__continuation__"]},
                    store,
                )
                store.save_step(sid, value)
            done[sid] = value
            pending.discard(sid)

    while pending:
        ready = [s for s in pending
                 if all(d in done for d in steps[s]["deps"])]
        if not ready:
            raise RuntimeError(
                f"workflow deadlock: pending={sorted(pending)} with no "
                f"satisfiable dependencies"
            )
        refs = {}
        for sid in ready:
            st = steps[sid]
            fn = cloudpickle.loads(bytes.fromhex(st["fn"]))

            def dec(v):
                if "__step__" in v:
                    return done[v["__step__"]]
                return cloudpickle.loads(bytes.fromhex(v["__val__"]))

            args = [dec(a) for a in st["args"]]
            kwargs = {k: dec(v) for k, v in st["kwargs"].items()}
            remote = rf.RemoteFunction(fn, **(st.get("opts") or {}))
            refs[sid] = remote.remote(*args, **kwargs)
        first_error: BaseException | None = None
        for sid, ref in refs.items():
            # Persist every successful sibling even when another step in
            # the same level fails — resume must never replay a step that
            # already ran (side effects would double-fire).
            try:
                value = ray_tpu_torch.get(ref)
                if isinstance(value, Continuation):
                    value = _splice_continuation(spec, store, sid, value)
            except BaseException as e:  # noqa: BLE001
                first_error = first_error or e
                continue
            store.save_step(sid, value)
            done[sid] = value
            pending.discard(sid)
        if first_error is not None:
            raise first_error
    return done[spec["output"]]


def _splice_continuation(spec: dict, store: _Store, sid: str,
                         cont: Continuation) -> Any:
    """Execute a continuation sub-DAG durably; its output becomes the
    step's value. The merged spec is persisted so resume replays it."""
    sub = getattr(cont, "spec", None) or _freeze(cont.dag)
    prefixed = {}
    for ssid, st in sub["steps"].items():
        st = dict(st)
        st["deps"] = [f"{sid}.{d}" for d in st["deps"]]
        st["args"] = [_prefix_ref(a, sid) for a in st["args"]]
        st["kwargs"] = {k: _prefix_ref(v, sid) for k, v in st["kwargs"].items()}
        prefixed[f"{sid}.{ssid}"] = st
    spec["steps"].update(prefixed)
    # Persist the FULL merged graph, not the (possibly truncated) spec
    # this nested _execute is running — a crash between here and the
    # final save must leave dag.pkl resumable to the real output.
    full = store.load_spec()
    full["steps"].update(spec["steps"])
    store.save_spec(full)
    # Durably mark the step as resolved-to-a-continuation BEFORE running
    # the subgraph: a crash mid-subgraph then resumes INTO the subgraph
    # instead of re-running this step (whose side effects already fired).
    target = f"{sid}.{sub['output']}"
    store.save_step(sid, {"__continuation__": target})
    return _execute({"steps": spec["steps"], "output": target}, store)


def _prefix_ref(v: dict, prefix: str) -> dict:
    if "__step__" in v:
        return {"__step__": f"{prefix}.{v['__step__']}"}
    return v


# -- public API -------------------------------------------------------------

def run(dag: DAGNode, *, workflow_id: str | None = None) -> Any:
    """Execute a DAG durably; blocks until the result is available.

    Re-running a SUCCESS id returns the stored result. Re-running a
    FAILED/RUNNING id with the *same* DAG resumes it; with a *different*
    DAG it raises (stale step results from the old graph must not leak
    into the new one — delete() or pick a fresh id)."""
    workflow_id = workflow_id or f"workflow-{_uuid_hex()}"
    store = _Store(workflow_id)
    meta = store.load_meta()
    spec = _freeze(dag)
    fp = _fingerprint(spec)
    # Fingerprint check FIRST: a SUCCESS entry for a different DAG must
    # raise, not silently return the other DAG's output.
    if meta and meta.get("fingerprint") not in (None, fp):
        raise ValueError(
            f"workflow id {workflow_id!r} already exists with a different "
            f"DAG (status={meta.get('status')}); workflow.delete() it or "
            f"use a new id (same-DAG reruns resume; workflow.resume() "
            f"skips this check)"
        )
    if meta.get("status") == "SUCCESS":
        return store.load_step(meta["output"])
    if meta.get("fingerprint") == fp:
        # Same-DAG rerun of a FAILED/RUNNING workflow: resume from the
        # STORED spec — it may contain continuation splices the freshly
        # frozen dag doesn't; overwriting it would orphan stored
        # continuation markers (their targets live only in the merged
        # graph).
        spec = store.load_spec()
    else:
        store.save_spec(spec)
    store.save_meta(status="RUNNING", output=spec["output"],
                    fingerprint=fp, created_at=time.time())
    return _finish(store, spec)


def _fingerprint(spec: dict) -> str:
    import hashlib

    # Hash graph structure + bound argument values but NOT the function
    # bytecode: cloudpickle bytes are not guaranteed stable across driver
    # restarts, and a re-run after a code fix SHOULD resume (same
    # semantics as resume()). Changed args/structure are the hazard.
    # Caveat: args whose pickling is order-unstable (sets under a new
    # PYTHONHASHSEED) can fingerprint differently across processes —
    # resume(workflow_id) bypasses this check for exactly that case.
    h = hashlib.sha256()
    for sid in sorted(spec["steps"]):
        st = spec["steps"][sid]
        h.update(sid.encode())
        for a in st["args"]:
            h.update(json.dumps(a, sort_keys=True).encode())
        for k in sorted(st["kwargs"]):
            h.update(k.encode())
            h.update(json.dumps(st["kwargs"][k], sort_keys=True).encode())
    return h.hexdigest()[:32]


def _finish(store: _Store, spec: dict) -> Any:
    try:
        result = _execute(spec, store)
    except Exception as e:  # noqa: BLE001
        store.save_meta(status="FAILED", error=repr(e))
        raise
    store.save_meta(status="SUCCESS", output=spec["output"])
    return result


def _uuid_hex() -> str:
    import uuid

    return uuid.uuid4().hex[:16]


def run_async(dag: DAGNode, *, workflow_id: str | None = None) -> Future:
    workflow_id = workflow_id or f"workflow-{_uuid_hex()}"
    fut: Future = Future()

    def target():
        try:
            fut.set_result(run(dag, workflow_id=workflow_id))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    t = threading.Thread(target=target, daemon=True,
                         name=f"workflow-{workflow_id}")
    t.start()
    fut.workflow_id = workflow_id  # type: ignore[attr-defined]
    return fut


def resume(workflow_id: str) -> Any:
    """Re-run a FAILED/RUNNING workflow from its durable state: completed
    steps load from storage, the rest re-execute."""
    store = _Store(workflow_id)
    meta = store.load_meta()
    if not meta:
        raise ValueError(f"no workflow {workflow_id!r} in storage")
    spec = store.load_spec()
    store.save_meta(status="RUNNING")
    return _finish(store, spec)


def resume_async(workflow_id: str) -> Future:
    fut: Future = Future()

    def target():
        try:
            fut.set_result(resume(workflow_id))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(target=target, daemon=True).start()
    return fut


def get_output(workflow_id: str) -> Any:
    store = _Store(workflow_id)
    meta = store.load_meta()
    if meta.get("status") != "SUCCESS":
        raise ValueError(
            f"workflow {workflow_id!r} status={meta.get('status')}; "
            f"output only available after SUCCESS (use resume())"
        )
    return store.load_step(meta["output"])


def get_status(workflow_id: str) -> str | None:
    return _Store(workflow_id).load_meta().get("status")


def list_all(status_filter: str | None = None) -> list[tuple[str, str]]:
    out = []
    base = _base_dir()
    for wid in sorted(os.listdir(base)):
        meta_path = os.path.join(base, wid, "meta.json")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path) as f:
            status = json.load(f).get("status", "UNKNOWN")
        if status_filter is None or status == status_filter:
            out.append((wid, status))
    return out


def delete(workflow_id: str) -> None:
    import shutil

    shutil.rmtree(os.path.join(_base_dir(), workflow_id), ignore_errors=True)


# -- events (reference: python/ray/workflow/api.py wait_for_event +
#    workflow/event_listener.py EventListener; events are delivered
#    exactly-once because the receiving step's result is checkpointed) ----


class EventListener:
    """Poll-based event provider (reference: event_listener.py — the
    reference's is coroutine-based; polling maps better onto checkpointed
    task steps). Subclass and implement ``poll_for_event``."""

    def poll_for_event(self) -> Any:
        """Block until the event arrives; return its payload."""
        raise NotImplementedError


class KVEventListener(EventListener):
    """Default listener: waits for a key in the cluster KV (events are
    posted with ``workflow.trigger_event``)."""

    def __init__(self, event_key: str, poll_interval_s: float = 0.1,
                 timeout_s: float | None = None):
        self.event_key = event_key
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s

    def poll_for_event(self) -> Any:
        import time as _time

        from ray_tpu_torch._private.worker_context import global_runtime
        from ray_tpu_torch._private import serialization

        rt = global_runtime()
        deadline = (_time.time() + self.timeout_s) if self.timeout_s is not None else None
        while True:
            raw = rt.kv_get(self.event_key, ns="__wf_events__")
            if raw:
                # Consume-once: the receiving step checkpoints the payload,
                # so the KV copy is deleted — a later workflow reusing the
                # key waits for a FRESH event instead of reading a stale
                # one (and the namespace doesn't grow unboundedly).
                # kv_del is atomic head-side: with concurrent waiters on
                # one key, exactly the deleting winner delivers; losers
                # keep waiting for the next event.
                if rt.kv_del(self.event_key, ns="__wf_events__"):
                    return serialization.loads(raw)
            if deadline is not None and _time.time() > deadline:
                raise TimeoutError(
                    f"no event {self.event_key!r} within {self.timeout_s}s")
            _time.sleep(self.poll_interval_s)


def trigger_event(event_key: str, payload: Any = True) -> None:
    """Post an event for KVEventListener waiters (works from any driver
    or task in the cluster)."""
    from ray_tpu_torch._private.worker_context import global_runtime
    from ray_tpu_torch._private import serialization

    global_runtime().kv_put(event_key, serialization.dumps(payload),
                            ns="__wf_events__")


class TimerListener(EventListener):
    """Event at a wall-clock timestamp (reference: event_listener.py
    TimerListener)."""

    def __init__(self, timestamp: float):
        self.timestamp = float(timestamp)

    def poll_for_event(self) -> float:
        time.sleep(max(0.0, self.timestamp - time.time()))
        return self.timestamp


def sleep(duration: float) -> DAGNode:
    """A workflow step resolving ``duration`` seconds after it first
    runs (reference: workflow/api.py sleep). The deadline is computed in
    its own checkpointed step, so a crash/resume waits out the ORIGINAL
    deadline instead of restarting the clock."""
    import ray_tpu_torch as _rt

    def _end_time(d):
        return time.time() + d

    return wait_for_event(TimerListener, _rt.remote(_end_time).bind(duration))


def _poll_listener(listener_cls, *args, **kwargs):
    return listener_cls(*args, **kwargs).poll_for_event()


def wait_for_event(listener_cls_or_key, *args, **kwargs) -> DAGNode:
    """A workflow step that completes when the event arrives (reference:
    workflow/api.py wait_for_event). Pass an EventListener subclass plus
    its constructor args, or just a string key for the KV listener:

        gate = workflow.wait_for_event("deploy-approved", timeout_s=60)
        dag = finalize.bind(gate)

    Exactly-once: after the event is first received, the step's
    checkpointed result replays on resume without re-waiting."""
    import ray_tpu_torch as _rt

    if isinstance(listener_cls_or_key, str):
        return _rt.remote(_poll_listener).bind(
            KVEventListener, listener_cls_or_key, *args, **kwargs)
    if not (isinstance(listener_cls_or_key, type)
            and issubclass(listener_cls_or_key, EventListener)):
        raise TypeError(
            "wait_for_event takes an event key string or an EventListener "
            f"subclass, got {listener_cls_or_key!r}")
    return _rt.remote(_poll_listener).bind(listener_cls_or_key, *args, **kwargs)
