"""Worker process: executes tasks and hosts actors.

Counterpart of the reference's default_worker.py main loop + the executor
half of CoreWorker (reference:
python/ray/_private/workers/default_worker.py:194 `worker.main_loop()`;
src/ray/core_worker/transport/task_receiver.cc:38 HandleTask;
core_worker.cc:3253 ExecuteTask; actor concurrency via
transport/concurrency_group_manager.h:37).

The head pushes `push_task` / `become_actor` messages over the registered
connection; a FIFO thread-pool executor runs them (pool size 1 for normal
workers and ordered actors, `max_concurrency` for concurrent actors —
threaded-actor semantics).
"""

from __future__ import annotations

import asyncio
import inspect
import os
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import cloudpickle

from ray_tpu_torch._private import forensics, worker_context
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectRef
from ray_tpu_torch._private.runtime import CoreRuntime
from ray_tpu_torch._private.task_spec import TaskSpec, spec_from_body
from ray_tpu_torch.exceptions import TaskError


def _cuda_initialized() -> bool:
    """Whether this process has initialised CUDA (after which
    CUDA_VISIBLE_DEVICES no longer changes what it sees). Never imports
    torch: a process that has not loaded it has not touched CUDA."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


class _AsyncActorExecutor:
    """Event loop hosting an async actor's method calls (reference:
    boost::fiber execution for async actors, transport/fiber.h:17 +
    ConcurrencyGroupManager, concurrency_group_manager.h:37).

    All coroutines run on ONE loop thread — methods interleave at await
    points, bounded per concurrency group by an asyncio.Semaphore. Sync
    methods of an async actor run inline on the loop (reference
    semantics: they block it)."""

    def __init__(self, groups: dict[str, int], default_limit: int):
        self.loop = asyncio.new_event_loop()
        self._limits = dict(groups or {})
        self._default_limit = default_limit
        self._sems: dict[str, asyncio.Semaphore] = {}
        threading.Thread(target=self._run, daemon=True,
                         name="actor-asyncio").start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def semaphore(self, group: str | None) -> asyncio.Semaphore:
        """Loop-thread only (single-threaded: no lock needed)."""
        key = group or "_default"
        sem = self._sems.get(key)
        if sem is None:
            limit = self._limits.get(key, self._default_limit)
            sem = self._sems[key] = asyncio.Semaphore(limit)
        return sem

    def submit(self, coro, on_error=None) -> None:
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)

        def _done(f):
            exc = f.exception()
            if exc is not None and on_error is not None:
                on_error(exc)

        # The guarded coroutine reports task_finished itself; this
        # callback only catches failures BEFORE its try block (or loop
        # rejection), which would otherwise hang the caller's get.
        fut.add_done_callback(_done)


class Worker:
    def __init__(self, head_addr: tuple[str, int], worker_id: str, node_id: str):
        self.worker_id = worker_id
        self.node_id = node_id
        # Executor and actor state MUST exist before the runtime connects:
        # the head may push a task the instant registration lands, racing
        # Worker.__init__'s remaining lines on the reader thread.
        self.executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="task-exec")
        self.actor_instance = None
        self.actor_id: str | None = None
        # Async-actor event loop (set after creation when the class has
        # coroutine methods) and threaded per-concurrency-group pools.
        self.async_exec: _AsyncActorExecutor | None = None
        self.group_execs: dict[str, ThreadPoolExecutor] = {}
        self.actor_concurrency_groups: dict | None = None
        self.actor_max_concurrency = 1
        # Two pools for coroutine-side blocking IO. Fetch (arg
        # resolution) can block on objects produced by this actor's OWN
        # pending calls; stores must never queue behind those blocked
        # threads or the actor deadlocks — hence a dedicated store pool.
        self._fetch_pool = ThreadPoolExecutor(max_workers=8,
                                              thread_name_prefix="actor-fetch")
        self._store_pool = ThreadPoolExecutor(max_workers=4,
                                              thread_name_prefix="actor-store")
        self._exit = threading.Event()
        self._cancelled_ids: set[str] = set()
        # Per-function execution counts for @remote(max_calls=N) worker
        # recycling (reference: remote_function.py max_calls — the
        # standard lever against native-memory leaks/fragmentation).
        self._calls_by_func: dict[str, int] = {}
        # Normal-task fast path: pushes land in this deque and ONE
        # drainer job runs them serially — a Future + work-item per task
        # (~20 us of executor machinery) is pure overhead when the head
        # pipelines a window of tasks onto this worker.
        self._task_q: deque = deque()
        # Per-owner buffered seals (flood batching, _route_results).
        # Guarded by _seal_lock: the drainer thread fills it, and the
        # runtime's release loop drains stale batches (bounded latency
        # when a long task follows a burst).
        self._seal_buf: dict = {}
        self._seal_lock = threading.Lock()
        self._drain_scheduled = False
        self._drain_lock = threading.Lock()
        self._drainer_tls = threading.local()
        # Direct-call plane: tasks pushed owner→worker without a head
        # hop, counted for worker-side back-pressure (_on_direct_push).
        self._direct_inflight = 0
        # Retirement latches, initialized here so the per-push accept
        # check in _on_direct_push reads plain attributes — it runs
        # once per frame of a native-reader delivery batch, and a
        # defensive getattr chain there is measurable at 100k pushes/s.
        self._recycle_pending = False
        self._retiring_sent = False
        # Head-pushed normal tasks queued or running here. The head
        # grants a lease on the very push that makes this worker busy,
        # so the owner's lease can look idle while a head task runs —
        # a lease push accepted then would QUEUE behind it (a 30 s head
        # task serializing a 1 ms leased one). While this is non-zero,
        # _on_direct_push bounces lease pushes back to the head path.
        self._head_busy = 0
        self.runtime = CoreRuntime(
            head_addr,
            client_type="worker",
            worker_id=worker_id,
            message_handler=self._on_message,
        )
        worker_context.set_runtime(self.runtime)
        # Accept direct submissions on the runtime's peer server (the
        # same socket owners fetch objects from).
        self.runtime._peer_task_handler = self._on_direct_push
        # Direct-plane cancellation (owner→worker "cancel_direct" over
        # the same peer conn): queued-but-not-started tasks are dropped
        # at pickup, exactly like the head's cancel cast.
        self.runtime._peer_cancel_handler = (
            lambda body: self._cancelled_ids.add(body["task_id"]))
        # Overload plane: cached host-memory soft-watermark gauge —
        # while this node is pressured, direct pushes bounce (direct_rej
        # → head path) so owners stop deepening queues on a node the
        # memory monitor is about to defend by killing.
        from ray_tpu_torch._private.memory_monitor import PressureGauge

        self._pressure = PressureGauge()
        # The runtime's adaptive release loop also drains stale seal
        # batches (a burst buffered before a long task must not wait
        # for the task to end).
        self.runtime._aux_flush = self._flush_stale_seals
        self.runtime._pre_block = self._on_will_block
        # Driver/head gone -> exit (the connection is our lease).
        self.runtime.conn._on_close = lambda conn: os._exit(0)
        # Two-phase registration: the head dispatches nothing until this
        # lands, guaranteeing __init__ finished before the first push_task.
        self.runtime.conn.cast("worker_ready", {"worker_id": self.worker_id})

    # ------------------------------------------------------------------

    def _on_message(self, kind: str, body: dict):
        if kind == "exit_worker":
            # max_calls handshake phase 2: every delivered result is
            # owner-confirmed; safe to recycle this process.
            t = getattr(self, "_retire_timer", None)
            if t is not None:
                t.cancel()
            self._exit.set()
            return
        if kind == "push_task":
            spec = spec_from_body(body)
            self._stamp_recv(spec, body)
            if spec.actor_id is None and not spec.actor_creation:
                with self._drain_lock:
                    self._head_busy += 1
            self._dispatch_spec(spec, body.get("gpu_ids"))
        elif kind == "become_actor":
            # An actor conversion reprieves any pending max_calls
            # retirement (the head ignores worker_retiring from actor
            # workers; the local timer must not kill the live actor).
            t = getattr(self, "_retire_timer", None)
            if t is not None:
                t.cancel()
                self._retire_timer = None
            self._retiring_sent = False
            self._recycle_pending = False
            self.actor_id = body["actor_id"]
            # Actor-lifetime env: actor METHOD tasks carry no runtime_env
            # of their own; nested submissions inherit the creation env.
            self.actor_runtime_env = body["spec"].runtime_env
            worker_context.set_process_base_runtime_env(self.actor_runtime_env)
            # 0 = unset (see ActorClass.remote): threaded actors treat it
            # as 1; async actors treat it as the 1000 default.
            maxc = int(body.get("max_concurrency") or 0)
            self.actor_max_concurrency = maxc
            self.actor_concurrency_groups = body.get("concurrency_groups")
            if maxc > 1:
                self.executor = ThreadPoolExecutor(
                    max_workers=maxc, thread_name_prefix="actor-exec"
                )
            self._set_gpu_env(body.get("gpu_ids"))
            self.executor.submit(self._run_task_guarded, body["spec"], None)
        elif kind == "profile_start":
            # Sampling profiler (reference: reporter/profile_manager.py
            # :191 — py-spy record). Runs on its own thread so task
            # execution AND message dispatch continue while sampling.
            threading.Thread(target=self._sample_profile, args=(body,),
                             daemon=True, name="profiler").start()
        elif kind == "kill":
            self._exit.set()
            dump = globals().get("_profile_dump")
            if dump is not None:
                # os._exit skips atexit: dump the cProfile output here.
                try:
                    dump()
                except Exception:
                    pass
            os._exit(0)
        elif kind == "cancel":
            # Queued-but-not-started tasks (actor calls wait in this
            # worker's executor, reference: actor_scheduling_queue.h) are
            # dropped at pickup: _run_task_guarded checks this set before
            # executing and stores TaskCancelledError instead. RUNNING
            # tasks are not interrupted (reference recursive=False
            # semantics: running actor tasks need force/kill).
            self._cancelled_ids.add(body["task_id"])
        return None

    @staticmethod
    def _stamp_recv(spec, body: dict) -> None:
        """Flight recorder: adopt the phase stamps that rode the push
        (owner submit / head dispatch / direct push) and add the arrival
        stamp. The full timeline returns to the head inside the
        task_finished event — no extra frames anywhere."""
        evt = body.get("evt")
        if evt is None and not GLOBAL_CONFIG.task_events_enabled:
            return
        evt = dict(evt) if evt is not None else {}
        evt["recv"] = time.time()
        spec._evt = evt

    def _dispatch_spec(self, spec, gpu_ids) -> None:
        """Route one spec into the execution machinery — shared by
        head pushes (push_task) and direct owner pushes (direct_push):
        async-actor loop, the serial drainer deque, or the
        (concurrency-group) thread pools.

        The drainer deque covers BOTH pipelined normal tasks and
        ordered (max_concurrency 1, ungrouped) actor method calls: a
        Future + work-item per call (~10 us of ThreadPoolExecutor
        machinery) is pure overhead when the owner pipelines a window
        of calls — one drainer job runs them serially in arrival
        order, which is exactly the ordered-actor contract."""
        if (self.async_exec is not None and spec.actor_id is not None
                and not spec.actor_creation):
            self.async_exec.submit(
                self._run_task_async_guarded(spec),
                on_error=lambda exc, s=spec: self._async_task_crashed(
                    s, exc))
        elif (not spec.actor_creation
                and spec.concurrency_group is None
                and not self.group_execs
                and ((spec.actor_id is None
                      and self.actor_instance is None)
                     or (spec.actor_id is not None
                         and self.actor_instance is not None
                         and self.actor_max_concurrency <= 1))):
            with self._drain_lock:
                self._task_q.append((spec, gpu_ids))
                start = not self._drain_scheduled
                if start:
                    self._drain_scheduled = True
            if start:
                self.executor.submit(self._drain_tasks)
        else:
            self._executor_for(spec).submit(
                self._run_task_guarded, spec, gpu_ids)

    def _on_direct_push(self, body: dict, conn) -> None:
        """Direct-call plane receiver (reference: task_receiver.cc:38
        HandleTask — workers accept submissions straight from owners).
        Ordering rides the peer connection's FIFO (this handler runs on
        its reader thread, in arrival order, into FIFO executors);
        ``direct_ack`` is the owner's delivery receipt (its watchdog
        re-routes unacked calls through the head), and past the
        inflight high-water mark — or while retiring — pushes are
        REJECTED so the owner spills back to the head path instead of
        deepening an unbounded queue on a dying/overloaded worker."""
        spec = spec_from_body(body)
        self._stamp_recv(spec, body)
        limit = GLOBAL_CONFIG.direct_worker_inflight_max
        if (self._exit.is_set()
                or self._recycle_pending
                or self._retiring_sent
                or self._direct_inflight >= limit
                # A lease task must not queue behind head-pushed work
                # the owner cannot see (lease window accounting only
                # covers the owner's OWN direct pushes) — bounce it so
                # the head dispatches it on a genuinely idle worker.
                or (spec.actor_id is None and self._head_busy > 0)
                # Memory-aware backpressure: past the soft watermark
                # this node must shed load, not accumulate it — the
                # bounce re-routes through the head, which stopped
                # placing onto pressured nodes.
                or (spec.actor_id is None and self._pressure.pressured())):
            try:
                conn.cast_buffered("direct_rej", {"task_id": spec.task_id})
            except Exception:
                pass
            return
        spec._direct = True
        self._direct_inflight += 1
        try:
            conn.cast_buffered("direct_ack", {"task_ids": [spec.task_id]})
        except Exception:
            pass
        self._dispatch_spec(spec, body.get("gpu_ids"))

    def _sample_profile(self, body: dict) -> None:
        """Where does time GO (not just where is it stuck): sample every
        thread's stack at ``hz`` for ``duration_s`` via
        sys._current_frames(), fold into collapsed-stack counts
        (flamegraph input format), and cast the aggregate back to the
        head. Pure-Python py-spy analogue — no ptrace, no py-spy
        dependency (reference: profile_manager.py:191). mode="memory"
        instead traces allocations for the window via tracemalloc (the
        memray-attach analogue, profile_manager.py memory profiling).

        Unified with the continuous profiling plane (profplane.py):
        when the armed sampler exists, the probe BORROWS its stream —
        the sampler's rate is raised for the window and each sample is
        teed to this probe — so on-demand + continuous sampling never
        run two sampler threads or double-count. The pre-profplane
        inline loop survives only as the kill-switch fallback."""
        import collections as _collections
        import time as _time
        import traceback as _traceback

        from ray_tpu_torch._private import profplane

        duration = min(30.0, max(0.1, float(body.get("duration_s", 5.0))))
        hz = min(200, max(1, int(body.get("hz", 50))))
        if body.get("mode") == "memory":
            self._sample_memory(body, duration)
            return
        include_idle = bool(body.get("include_idle", False))
        armed = profplane.sampler()
        if armed is not None:
            res = armed.borrow(duration, hz=hz, include_idle=include_idle)
            samples, folded_out = res["samples"], res["folded"]
        else:
            me = threading.get_ident()
            folded: _collections.Counter = _collections.Counter()
            samples = 0
            deadline = _time.time() + duration
            while _time.time() < deadline:
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    stack = _traceback.extract_stack(frame)
                    if not stack:
                        continue
                    if not include_idle and \
                            profplane.is_idle_leaf(stack[-1]):
                        continue
                    folded[profplane.fold_stack(stack)] += 1
                samples += 1
                _time.sleep(1.0 / hz)
            folded_out = dict(folded.most_common(500))
        # Top 500 folded stacks: "file:func;file:func;..." -> hits.
        if len(folded_out) > 500:
            folded_out = dict(sorted(folded_out.items(),
                                     key=lambda kv: kv[1],
                                     reverse=True)[:500])
        try:
            self.runtime.conn.cast("profile_result", {
                "req_id": body.get("req_id"),
                "worker_id": self.worker_id,
                "samples": samples,
                "duration_s": duration,
                "hz": hz,
                "folded": folded_out,
            })
        except Exception:
            pass

    def _sample_memory(self, body: dict, duration: float) -> None:
        """Allocation tracing for one window: tracemalloc on, wait,
        snapshot, report the top allocating stacks (bytes + counts)."""
        import time as _time
        import tracemalloc

        was_tracing = tracemalloc.is_tracing()
        if not was_tracing:
            tracemalloc.start(16)
        try:
            base = tracemalloc.take_snapshot()
            _time.sleep(duration)
            snap = tracemalloc.take_snapshot()
            stats = snap.compare_to(base, "traceback")
            folded = {}
            for st in stats[:200]:
                if st.size_diff <= 0:
                    continue
                key = ";".join(
                    f"{os.path.basename(f.filename)}:{f.lineno}"
                    for f in reversed(st.traceback))
                folded[key] = {"bytes": st.size_diff,
                               "count": st.count_diff}
        finally:
            if not was_tracing:
                tracemalloc.stop()
        try:
            self.runtime.conn.cast("profile_result", {
                "req_id": body.get("req_id"),
                "worker_id": self.worker_id,
                "mode": "memory",
                "duration_s": duration,
                "allocations": folded,
            })
        except Exception:
            pass

    @staticmethod
    def _set_gpu_env(gpu_ids) -> None:
        """GPU visibility pinning for the actor lifetime (reference
        semantics: _private/accelerators/nvidia_gpu.py
        set_current_process_visible_accelerator_ids). Actors without a
        GPU lease see no device (CUDA_VISIBLE_DEVICES=""): parallel
        actors must not contend for the devices the driver owns. Only
        effective before this process's first CUDA call (the normal
        case — user code is imported lazily). Every thread of the
        actor's pool then sees the leased devices as cuda:0..n-1, and
        torch's per-thread current device defaults to cuda:0, a leased
        one. Normal tasks get the same pinning per-task with
        save/restore in _run_task."""
        if gpu_ids:
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(c) for c in gpu_ids)
        elif not _cuda_initialized():
            os.environ["CUDA_VISIBLE_DEVICES"] = ""

    # ------------------------------------------------------------------
    # actor concurrency plumbing

    def _task_group(self, spec: TaskSpec) -> str | None:
        """Per-call group override, else the method's @ray_tpu_torch.method
        annotation, else the default group."""
        if spec.concurrency_group:
            return spec.concurrency_group
        fn = getattr(type(self.actor_instance), spec.method_name, None) \
            if self.actor_instance is not None else None
        return getattr(fn, "__ray_tpu_concurrency_group__", None)

    def _executor_for(self, spec: TaskSpec) -> ThreadPoolExecutor:
        if spec.actor_id is None or spec.actor_creation or not self.group_execs:
            return self.executor
        group = self._task_group(spec)
        return self.group_execs.get(group, self.executor)

    def _setup_actor_executor(self) -> None:
        """After __init__ of the actor instance (the head holds method
        calls until creation completes, so the mode switch cannot race a
        push): async actors get an event loop; threaded actors with
        concurrency_groups get one pool per group (reference:
        concurrency_group_manager.h:37)."""
        cls = type(self.actor_instance)
        is_async = any(
            inspect.iscoroutinefunction(getattr(cls, n, None))
            or inspect.isasyncgenfunction(getattr(cls, n, None))
            for n in dir(cls) if not n.startswith("_")
        )
        groups = self.actor_concurrency_groups
        if is_async:
            # Reference default: async actors run up to 1000 concurrent
            # calls unless max_concurrency narrows it — including an
            # EXPLICIT max_concurrency=1 (0 means the user never set it).
            limit = (self.actor_max_concurrency
                     if self.actor_max_concurrency >= 1 else 1000)
            self.async_exec = _AsyncActorExecutor(groups or {}, limit)
        elif groups:
            self.group_execs = {
                name: ThreadPoolExecutor(
                    max_workers=limit,
                    thread_name_prefix=f"actor-cg-{name}")
                for name, limit in groups.items()
            }

    def _route_results(self, spec, buffer: bool = False
                       ) -> "tuple[list, list | None]":
        """Owner-resident result routing shared by the sync drainer,
        the async-actor path, and the coroutine-failure fallback:
        deliver inline results + big-object markers straight to the
        submitting runtime (verified by owner id), returning what must
        still ride task_finished — (head_routed_results,
        sealed_pending).

        buffer=True (the drainer's flood path) coalesces many tasks'
        seals into ONE seal_objects message per owner — the owner then
        stores + confirms a whole batch in one dispatch. Safe to defer:
        the head marks entries SEALED only on the owner's confirmation,
        and a worker death with buffered seals error-seals the pending
        ids (the sealed_pending backstop)."""
        results = getattr(spec, "_deferred_results", None) or []
        markers = getattr(spec, "_remote_markers", None) or []
        sealed_pending = None
        if (results or markers) and getattr(spec, "owner_addr", None):
            addr = tuple(spec.owner_addr)
            delivered = False
            if buffer:
                with self._seal_lock:
                    buf = self._seal_buf.get(addr)
                    if buf is None:
                        buf = self._seal_buf[addr] = {
                            "owner": spec.owner_id, "items": [],
                            "t0": time.time()}
                    if buf["owner"] == spec.owner_id:
                        if not buf["items"]:
                            buf["t0"] = time.time()
                        buf["items"].extend(results + markers)
                        delivered = True
                flush = delivered and (
                    len(buf["items"]) >= 64
                    or time.time() - buf["t0"] > 0.05)
                if flush:
                    self._flush_seals(addr)
            if not delivered:
                delivered = self.runtime.seal_to_owner(
                    addr, results + markers, expect_owner=spec.owner_id)
            if delivered:
                # contained_ids ride along so the head can pin container
                # contents EAGERLY — this worker's del_ref for a
                # returned-inside-a-container ref must not race the
                # owner's (slower) seal confirmation and free the inner
                # object.
                sealed_pending = [
                    {"object_id": b["object_id"],
                     "contained_ids": b.get("contained_ids") or []}
                    for b in results]
                results = []
        return results, sealed_pending

    def _flush_stale_seals(self) -> None:
        with self._seal_lock:
            stale = [a for a, b in self._seal_buf.items()
                     if b["items"] and time.time() - b["t0"] > 0.05]
        for a in stale:
            self._flush_seals(a)

    def _flush_seals(self, addr=None) -> None:
        """Ship buffered owner seals. On delivery failure the payloads
        head-route via put_inline casts (entries seal there; the head's
        marker push resolves the owner's local wait)."""
        with self._seal_lock:
            addrs = [addr] if addr is not None else list(self._seal_buf)
            bufs = [(a, self._seal_buf.pop(a, None)) for a in addrs]
        for a, buf in bufs:
            if not buf or not buf["items"]:
                continue
            if not self.runtime.seal_to_owner(a, buf["items"],
                                              expect_owner=buf["owner"]):
                for item in buf["items"]:
                    if item.get("remote"):
                        continue  # already in the head/agent store
                    try:
                        self.runtime.conn.cast_buffered("put_inline", item)
                    except Exception:
                        pass

    def _async_task_crashed(self, spec: TaskSpec, exc: BaseException) -> None:
        """A coroutine failed outside its own error handling (before the
        guarded try, or the loop rejected it): store the error and report
        completion so the caller's get never hangs."""
        traceback.print_exception(type(exc), exc, exc.__traceback__)
        try:
            self._store_error(spec, TaskError(repr(exc), "", spec.name))
        except Exception:
            traceback.print_exc()
        try:
            # The error objects may have been deferred into the spec
            # buffer by _store_error — without delivering them (owner
            # plane, or head fallback) the caller's get would hang.
            # Buffered like the sync path: flush_casts runs ~1ms behind
            # and cast() flushes the buffer first, so ordering against
            # any later immediate frame is preserved.
            results, sealed_pending = self._route_results(spec)
            self.runtime.conn.cast_buffered(
                "task_finished",
                {"worker_id": self.worker_id, "task_id": spec.task_id,
                 "failed": True,
                 "results": results,
                 "sealed_pending": sealed_pending},
            )
        except Exception:
            pass

    def _lifecycle_events(self, spec: TaskSpec, start: float, end: float,
                          failed: bool) -> "list | None":
        """The task_finished event payload: the classic exec span plus
        the flight-recorder phase stamps accumulated along the task's
        route (owner submit, head enqueue/dispatch or direct push, our
        recv) completed with exec/seal. None when events are disabled —
        the completion cast is then byte-identical to the pre-tracing
        wire format."""
        if not GLOBAL_CONFIG.task_events_enabled:
            return None
        phases = dict(spec._evt) if spec._evt is not None else {}
        phases.setdefault("exec_start", start)
        phases["exec_end"] = end
        # Results were just routed to the owner plane (or deferred into
        # this very cast): stamp the seal hand-off.
        phases["seal"] = time.time()
        ev = {
            "task_id": spec.task_id,
            "name": spec.name,
            "worker_id": self.worker_id,
            "node_id": self.node_id,
            "pid": os.getpid(),
            "owner_id": spec.owner_id,
            "start": start,
            "end": end,
            "failed": failed,
            "phases": phases,
        }
        if spec.actor_id is not None:
            ev["actor_id"] = spec.actor_id
        if getattr(spec, "_direct", None):
            ev["direct"] = True
        # Executor-thread CPU seconds for the exec span: wall >> cpu
        # reads as GIL starvation or blocking IO in summarize_tasks().
        cpu = getattr(spec, "_cpu_time", None)
        if cpu is not None:
            ev["cpu_time"] = cpu
        # Request tracing: a sampled trace context turns this lifecycle
        # event into a trace span (the task's span id IS its task id;
        # the parent rode the spec). The fields ride the SAME
        # task_finished cast — traceless events stay byte-identical.
        tc = getattr(spec, "trace_ctx", None)
        if tc and int(tc[2] or 0):
            ev["trace_id"] = tc[0]
            ev["span_id"] = spec.task_id
            ev["parent_span_id"] = tc[1]
        return [ev]

    async def _run_task_async_guarded(self, spec: TaskSpec) -> None:
        import time

        start = time.time()
        failed = False
        spec._deferred_results = []
        spec._remote_markers = []
        # Interleaved coroutines share one beacon: last writer wins,
        # which is exactly the "what was it doing at the instant of
        # death" question the beacon answers.
        forensics.beacon_update(spec.task_id, spec.name, "exec")
        sem = self.async_exec.semaphore(self._task_group(spec))
        shed = None
        async with sem:
            try:
                if spec.deadline and time.time() > spec.deadline:
                    from ray_tpu_torch.exceptions import TaskTimeoutError

                    self._cancelled_ids.discard(spec.task_id)
                    self._store_error(
                        spec,
                        TaskTimeoutError(
                            f"task {spec.name} exceeded its deadline "
                            f"before execution (shed in worker "
                            f"{self.worker_id} executor queue)",
                            task_id=spec.task_id, where="worker_queue"))
                    failed = True
                    shed = "worker_queue"
                elif spec.task_id in self._cancelled_ids:
                    self._cancelled_ids.discard(spec.task_id)
                    self._store_error(
                        spec,
                        TaskError("TaskCancelledError: cancelled before "
                                  "execution", "", spec.name))
                    failed = True
                else:
                    failed = not await self._run_task_async(spec)
            except Exception:
                traceback.print_exc()
                failed = True
        forensics.beacon_update(phase="idle")
        self._cancelled_ids.discard(spec.task_id)
        self._release_slot(spec)
        try:
            results, sealed_pending = self._route_results(spec)
            done = {"worker_id": self.worker_id, "task_id": spec.task_id,
                    "failed": failed,
                    "results": results,
                    "sealed_pending": sealed_pending,
                    "events": self._lifecycle_events(
                        spec, start, time.time(), failed)}
            if shed is not None:
                done["shed"] = shed
            # Buffered like the sync path (_run_task_guarded): the
            # async plane was paying a per-call head frame here for no
            # ordering benefit — cast() flushes the buffer first, so
            # buffered frames never reorder against immediate ones.
            self.runtime.conn.cast_buffered("task_finished", done)
        except Exception:
            pass
        self._count_call(spec)

    async def _run_task_async(self, spec: TaskSpec) -> bool:
        """Async-actor method execution: coroutines await on the loop;
        blocking IO offloads to the fetch/store pools. The
        task context rides a ContextVar, so interleaved calls each keep
        their own across awaits."""
        loop = asyncio.get_running_loop()
        inherited = getattr(self, "actor_runtime_env", None)
        env_token = worker_context.push_process_runtime_env(inherited)
        worker_context.set_task_context(
            worker_context.TaskContext(spec.task_id, self.actor_id,
                                       self.node_id, inherited))
        self._adopt_trace(spec)
        try:
            args, kwargs = await loop.run_in_executor(
                self._fetch_pool, self._load_args, spec)
            if spec.method_name == "__rtpu_dag_loop__":
                from functools import partial

                from ray_tpu_torch.dag.channel_exec import actor_dag_loop

                # Fully blocking resident loop: give it its own default-
                # executor thread, never the event loop.
                result = await loop.run_in_executor(
                    None, partial(actor_dag_loop, self.actor_instance,
                                  *args, **kwargs))
            else:
                method = getattr(self.actor_instance, spec.method_name)
                result = method(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            if spec.streaming:
                if hasattr(result, "__anext__"):
                    await self._store_async_gen(spec, result)
                else:
                    await loop.run_in_executor(
                        self._store_pool, self._store_generator_items, spec,
                        result)
            else:
                await loop.run_in_executor(
                    self._store_pool, self._store_returns, spec, result)
            return True
        except Exception as e:  # noqa: BLE001
            err = TaskError(repr(e), traceback.format_exc(), spec.name)
            await loop.run_in_executor(
                self._store_pool, self._store_error, spec, err)
            return False
        finally:
            worker_context.set_task_context(None)
            worker_context.set_trace_context(None)
            worker_context.pop_process_runtime_env(env_token)

    @staticmethod
    def _adopt_trace(spec: TaskSpec) -> None:
        """Request tracing: adopt the trace context that rode the spec,
        with this task's span (= its task id) as the new parent — any
        nested .remote() from the user code chains causally. Cleared in
        the caller's finally alongside the task context."""
        tc = getattr(spec, "trace_ctx", None)
        worker_context.set_trace_context(
            (tc[0], spec.task_id, tc[2]) if tc else None)

    async def _store_async_gen(self, spec: TaskSpec, agen) -> None:
        """Streaming async generator (reference: async generators over
        ReportGeneratorItemReturns): items stored as produced."""
        from functools import partial

        from ray_tpu_torch.generator import item_object_id

        loop = asyncio.get_running_loop()
        count = 0
        async for item in agen:
            await loop.run_in_executor(
                self._store_pool,
                partial(self.runtime.put, item,
                        _object_id=item_object_id(spec.task_id, count)))
            count += 1
        await loop.run_in_executor(
            self._store_pool,
            partial(self.runtime.put, count, _object_id=spec.return_ids[0]))

    # ------------------------------------------------------------------

    def _on_will_block(self):
        """Called by the runtime just before a blocking get/wait from a
        task-executing thread; returns the unblock callback. Two escape
        hatches against nested-get deadlocks (reference: core_worker
        task-blocked protocol — blocked workers release their slot):
          1. queued pipelined tasks hand off to an overflow drainer
             (the head may have parked the awaited child HERE);
          2. the head is told to release this worker's allocation so
             the child can be placed when this was the last capacity."""
        # Completed tasks' buffered owner seals must not wait out this
        # block: whoever awaits those results gets them now.
        try:
            self._flush_seals()
        except Exception:
            pass
        if not getattr(self._drainer_tls, "active", False):
            return None
        if self.actor_instance is not None:
            # Ordered-actor semantics: a method blocked in a nested get
            # blocks the calls queued behind it (reference: threaded
            # actors with max_concurrency=1 do not interleave). The
            # drainer hand-off below is the NORMAL-task deadlock
            # escape; handing off here would let a later call overtake
            # the blocked one.
            return None
        # This thread RETIRES as the active drainer either way (it
        # finishes only its current task after unblocking): exactly one
        # drainer executes queued tasks at any time, preserving the
        # serial-execution invariant pipelined allocations rely on.
        self._drainer_tls.retired = True
        with self._drain_lock:
            start = bool(self._task_q)
            if not start:
                # Queue empty now — but a task pushed while this thread
                # is parked must start a FRESH drainer, not wait on us.
                self._drain_scheduled = False
        if start:
            threading.Thread(target=self._drain_tasks, daemon=True,
                             name="task-exec-overflow").start()
        try:
            self.runtime.conn.cast("worker_blocked",
                                   {"worker_id": self.worker_id})
        except Exception:
            return None

        def _unblock():
            try:
                self.runtime.conn.cast("worker_unblocked",
                                       {"worker_id": self.worker_id})
            except Exception:
                pass

        return _unblock

    def _drain_tasks(self) -> None:
        """Runs queued normal tasks until the deque empties (then the
        next push schedules a fresh drainer) or until this thread is
        retired by a nested-get hand-off (see _on_will_block).

        Per-task CPU time is stamped into the lifecycle event plane
        (``cpu_time`` on the task_finished event, _run_task_guarded) —
        wall-vs-CPU skew shows up in summarize_tasks() instead of the
        old RAY_TPU_WORKER_TASK_TIMING stderr prints."""
        self._drainer_tls.active = True
        self._drainer_tls.retired = False
        while True:
            with self._drain_lock:
                if not self._task_q:
                    if not self._drainer_tls.retired:
                        self._drain_scheduled = False
                    return
                spec, chips = self._task_q.popleft()
            self._run_task_guarded(spec, chips)
            if self._drainer_tls.retired:
                # A successor drainer owns the queue now.
                return

    def _run_task_guarded(self, spec: TaskSpec, gpu_ids) -> None:
        import time

        failed = False
        start = time.time()
        mono0 = time.monotonic()
        # Wall-vs-CPU skew stamp (GIL-starved / IO-blocked tasks): two
        # thread_time() reads per task, carried on the lifecycle event.
        cpu0 = time.thread_time() if GLOBAL_CONFIG.task_events_enabled \
            else None
        forensics.beacon_update(spec.task_id, spec.name, "exec")
        spec._deferred_results = []
        spec._remote_markers = []
        shed = None
        try:
            # Deadline first: the head's in-flight expiry signal rides
            # the cancel cast, so an expired task may be BOTH cancelled
            # and past deadline — the typed TaskTimeoutError is the
            # truthful outcome either way.
            if spec.deadline and time.time() > spec.deadline:
                # Overload plane: the deadline expired while this task
                # sat in the executor queue — shed it (typed error)
                # instead of burning the worker on a result nobody can
                # use anymore.
                from ray_tpu_torch.exceptions import TaskTimeoutError

                self._cancelled_ids.discard(spec.task_id)
                self._store_error(
                    spec,
                    TaskTimeoutError(
                        f"task {spec.name} exceeded its deadline before "
                        f"execution (shed in worker "
                        f"{self.worker_id} executor queue)",
                        task_id=spec.task_id, where="worker_queue"))
                failed = True
                shed = "worker_queue"
            elif spec.task_id in self._cancelled_ids:
                self._cancelled_ids.discard(spec.task_id)
                self._store_error(
                    spec,
                    TaskError("TaskCancelledError: cancelled before "
                              "execution", "", spec.name))
                failed = True
            else:
                failed = not self._run_task(spec, gpu_ids)
        except Exception:
            traceback.print_exc()
            failed = True
        finally:
            if cpu0 is not None:
                spec._cpu_time = time.thread_time() - cpu0
                # GIL/IO starvation join: a task whose wall time dwarfs
                # its CPU time gets a profile exemplar pinned to the
                # current sampling window (profplane.note_task_cpu).
                from ray_tpu_torch._private import profplane

                profplane.note_task_cpu(
                    spec.task_id, spec.name,
                    time.monotonic() - mono0, spec._cpu_time)
            forensics.beacon_update(phase="idle")
            # A cancel that raced an already-running task left its id in
            # the set (running tasks are not interrupted); clear it so
            # the set stays bounded by the queue depth.
            self._cancelled_ids.discard(spec.task_id)
            # Inflight accounting BEFORE the results ship: a sync caller
            # wakes the instant the seal lands and may push its next
            # direct call immediately — that push must not bounce off a
            # stale _head_busy/_direct_inflight for work that already
            # finished (the bounce costs a head spill + lease cooldown).
            self._release_slot(spec)
            try:
                # Owner-resident result delivery (reference ownership
                # model, core_worker.h:172): inline results go STRAIGHT
                # to the submitting runtime's owner plane; the head gets
                # only the ids to expect ("sealed_pending" — its
                # directory seals when the OWNER confirms receipt, so a
                # lost seal can never strand a waiter). Falls back to
                # head-routed payloads when the owner is unreachable.
                results, sealed_pending = self._route_results(spec, buffer=True)
                # Completion + profile event in ONE cast (reference:
                # core_worker/task_event_buffer.h:225 batches events for
                # the same reason — the completion path is the control
                # plane's hottest message).
                done = {
                    "worker_id": self.worker_id,
                    "task_id": spec.task_id,
                    "failed": failed,
                    "results": results,
                    "sealed_pending": sealed_pending,
                    "events": self._lifecycle_events(
                        spec, start, time.time(), failed),
                }
                if shed is not None:
                    # Shed attribution rides the completion cast that
                    # already flows (ray_tpu_tasks_shed_total{where=...}).
                    done["shed"] = shed
                self.runtime.conn.cast_buffered("task_finished", done)
                # Draining a backlog: completions coalesce into one
                # frame. Idle (nothing else queued on this executor):
                # flush now so single-task latency stays sub-ms — the
                # global ~1 ms flusher is only the backstop.
                if (not self._task_q
                        and self._executor_for(spec)._work_queue.empty()):
                    self._flush_seals()
                    self.runtime.conn.flush_casts()
            except Exception:
                pass
            self._count_call(spec)

    def _release_slot(self, spec: TaskSpec) -> None:
        """Release this task's inflight-window accounting (direct-plane
        back-pressure window / head-busy gate). Called exactly once per
        task from the completion paths, BEFORE results ship, so an owner
        reacting to the seal never races stale accounting into a
        direct_rej bounce for work that already finished."""
        if getattr(spec, "_direct", None):
            # Direct-plane inflight accounting (back-pressure window).
            self._direct_inflight = max(0, self._direct_inflight - 1)
        elif spec.actor_id is None and not spec.actor_creation:
            with self._drain_lock:
                self._head_busy = max(0, self._head_busy - 1)

    def _count_call(self, spec: TaskSpec) -> None:
        """@remote(max_calls=N): after the Nth completed call of a
        function, this worker exits — results were already delivered
        and sealed, so the head sees a clean death with no inflight
        work. Pipelined tasks already queued on this worker DRAIN
        first (a max_retries=0 task must never be lost to a recycle);
        fresh processes replace it through the normal pool path."""
        mc = getattr(spec, "max_calls", 0)
        if mc:
            n = self._calls_by_func.get(spec.func_id, 0) + 1
            self._calls_by_func[spec.func_id] = n
            if n >= mc:
                self._recycle_pending = True
        if not self._recycle_pending or self._retiring_sent:
            return
        try:
            # Sent IMMEDIATELY once the budget trips — not gated on an
            # empty pipeline queue: under sustained dispatch the head
            # keeps the queue non-empty at nearly every completion, so
            # the old gate could defer retirement for a whole flood
            # (exactly the native-leak workload max_calls bounds). The
            # head stops dispatching to a retiring worker and its
            # _maybe_release_retiree waits for the inflight window AND
            # pending owner-seal confirmations to drain before casting
            # exit_worker, so already-queued tasks still complete.
            self._flush_seals()
            self.runtime.conn.flush_casts()
            # Handshake, not immediate exit: dying before the OWNER
            # confirms the just-delivered results would make the head
            # treat them as lost-with-the-worker and re-execute the
            # tasks through lineage recovery (observed as double
            # execution). The head stops dispatching to us now and
            # casts exit_worker once every pending seal is confirmed;
            # the timer is the backstop against a head that never
            # answers (kill -9 mid-handshake).
            self._retiring_sent = True
            self.runtime.conn.cast("worker_retiring",
                                   {"worker_id": self.worker_id})
            # Long LEAK backstop only — not a liveness mechanism. A
            # live head always answers with exit_worker (and a dead
            # head's conn-close already os._exits us); a short timer
            # would re-create the exit-before-seal-confirm double
            # execution whenever an owner confirms slowly. Daemon +
            # cancellable: it must neither pin the dying process open
            # nor fire after an actor conversion reprieves us.
            self._retire_timer = threading.Timer(120.0, self._exit.set)
            self._retire_timer.daemon = True
            self._retire_timer.start()
        except Exception:
            self._exit.set()  # can't reach the head: just go

    def _run_task(self, spec: TaskSpec, gpu_ids) -> bool:
        """Returns True on success. Stores results/errors for return ids."""
        saved_env: dict[str, str | None] = {}
        inherited_env = spec.runtime_env or getattr(
            self, "actor_runtime_env", None)
        env_vars = (spec.runtime_env or {}).get("env_vars", {})
        if gpu_ids:
            env_vars = dict(env_vars)
            env_vars["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(c) for c in gpu_ids)
        elif (spec.actor_id is None and not spec.actor_creation
              and not _cuda_initialized()
              and "CUDA_VISIBLE_DEVICES" not in env_vars
              and os.environ.get("CUDA_VISIBLE_DEVICES") != ""):
            # (the != "" check: GPU-hidden pool workers already carry
            # the pin — skip the per-task set/restore entirely; an actor's
            # creation task keeps the pin become_actor set for its
            # lifetime — ray_tpu pins its constructor to the CPU here)
            # Chipless task: keep this worker's (first) CUDA call off
            # the devices. Applied on the executor thread with
            # save/restore, so a later GPU-leased task on this worker is
            # unaffected.
            env_vars = dict(env_vars)
            env_vars["CUDA_VISIBLE_DEVICES"] = ""
        for k, v in env_vars.items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = str(v)
        worker_context.set_task_context(
            worker_context.TaskContext(spec.task_id, self.actor_id,
                                       self.node_id, inherited_env)
        )
        self._adopt_trace(spec)
        # Thread-local context misses user-spawned threads; keep a
        # process-level fallback too, refcounted so a finished task's env
        # never lingers (restored to the actor-lifetime env in finally).
        env_token = worker_context.push_process_runtime_env(inherited_env)
        applied_env = None
        try:
            # working_dir / py_modules (runtime_env.py): applied per task
            # with undo; actors keep theirs for life (no undo on the
            # creation task). INSIDE the try: a materialization failure
            # must store a TaskError into the return ids like any other
            # task failure (or the driver's get would hang forever).
            if spec.runtime_env and (
                spec.runtime_env.get("working_dir")
                or spec.runtime_env.get("py_modules")
                or spec.runtime_env.get("pip")
                or spec.runtime_env.get("conda")
                or spec.runtime_env.get("uv")
            ):
                from ray_tpu_torch._private.runtime_env import AppliedEnv

                applied_env = AppliedEnv()
                cache = os.path.join(self.runtime.session_dir, "runtime_env_cache")
                os.makedirs(cache, exist_ok=True)
                applied_env.apply(spec.runtime_env, self.runtime, cache)
            args, kwargs = self._load_args(spec)

            if spec.actor_creation:
                cls = self.runtime.get_function(spec.func_id)
                self.actor_instance = cls(*args, **kwargs)
                self._setup_actor_executor()
                self._put_result(spec, "ok", spec.return_ids[0])
                return True
            if spec.actor_id is not None:
                if spec.method_name == "__rtpu_dag_loop__":
                    # Reserved: the compiled-DAG resident loop runs the
                    # instance's bound methods off channels (reference:
                    # pinned actor executables, compiled_dag_node.py:806).
                    from ray_tpu_torch.dag.channel_exec import actor_dag_loop

                    result = actor_dag_loop(self.actor_instance, *args,
                                            **kwargs)
                else:
                    method = getattr(self.actor_instance, spec.method_name)
                    result = method(*args, **kwargs)
            else:
                result = self.runtime.get_function(spec.func_id)(*args, **kwargs)
            if spec.streaming:
                self._store_generator_items(spec, result)
            else:
                self._store_returns(spec, result)
            return True
        except Exception as e:  # noqa: BLE001
            self._store_error(
                spec, TaskError(repr(e), traceback.format_exc(), spec.name))
            return False
        finally:
            worker_context.set_task_context(None)
            worker_context.set_trace_context(None)
            worker_context.pop_process_runtime_env(env_token)
            if spec.actor_creation:
                # The actor's runtime env (working_dir, env_vars) lives for
                # the actor's lifetime — this worker is dedicated to it.
                pass
            else:
                if applied_env is not None and spec.actor_id is None:
                    applied_env.undo()
                for k, v in saved_env.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v

    def _load_args(self, spec: TaskSpec):
        args, kwargs = cloudpickle.loads(spec.args)
        return ([self._resolve(a) for a in args],
                {k: self._resolve(v) for k, v in kwargs.items()})

    def _put_result(self, spec: TaskSpec, value, oid: str,
                    is_error: bool = False) -> None:
        """Store one task return: deferred into the task_finished cast
        when small (one message carries results + completion; reference
        rationale: task_event_buffer.h batching on the hottest path),
        normal put() otherwise (shm/p2p objects need registration)."""
        buf = getattr(spec, "_deferred_results", None)
        if buf is not None:
            body = self.runtime.put_deferred(value, oid, is_error)
            markers = getattr(spec, "_remote_markers", None)
            if body is not None and body.get("remote"):
                # Metadata-only seal: the payload stays in this node's
                # arena; the marker carries the holder location (+
                # dtype/shape/sharding for tensors) so the owner
                # resolves getters straight from here — zero payload
                # bytes on the owner/head control planes.
                if markers is not None:
                    markers.append(body)
            elif body is not None:
                buf.append(body)
            elif markers is not None:
                # Stored big through the head-arena shm path: tell the
                # owner to resolve this id via a head meta (its local
                # wait must not stall on a payload that will never be
                # delivered).
                markers.append({"object_id": oid, "remote": True})
            return  # big values were stored by put_deferred itself
        self.runtime.put(value, _object_id=oid, _is_error=is_error)

    def _store_error(self, spec: TaskSpec, err: TaskError) -> None:
        for oid in spec.return_ids:
            try:
                self._put_result(spec, err, oid, is_error=True)
            except Exception:
                traceback.print_exc()

    def _resolve(self, value):
        if isinstance(value, ObjectRef):
            return self.runtime.get(value)
        return value

    def _store_generator_items(self, spec: TaskSpec, result) -> None:
        """Streaming generator: store each yielded item under its
        deterministic id as produced, then seal the count into the return
        object (reference: ReportGeneratorItemReturns,
        core_worker.proto:402). Items become visible to the consumer's
        ObjectRefGenerator immediately; an exception mid-iteration falls
        through to the caller's error path, which seals the error into
        the return object and unblocks the consumer."""
        from ray_tpu_torch.generator import item_object_id

        count = 0
        for item in result:
            self.runtime.put(item, _object_id=item_object_id(spec.task_id, count))
            count += 1
        self.runtime.put(count, _object_id=spec.return_ids[0])

    def _store_returns(self, spec: TaskSpec, result) -> None:
        n = len(spec.return_ids)
        if n == 0:
            return
        if n == 1:
            self._put_result(spec, result, spec.return_ids[0])
            return
        values = list(result) if isinstance(result, (tuple, list)) else None
        if values is None or len(values) != n:
            raise ValueError(
                f"task {spec.name} declared num_returns={n} but returned "
                f"{type(result).__name__} of length "
                f"{len(result) if hasattr(result, '__len__') else 'n/a'}"
            )
        for oid, v in zip(spec.return_ids, values):
            self._put_result(spec, v, oid)

    def main_loop(self) -> None:
        self._exit.wait()


def main() -> None:
    import faulthandler
    import gc
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # Crash forensics black box (forensics.py): faulthandler armed into
    # a per-worker crash file (fatal signals dump all-thread stacks),
    # sys/threading excepthooks appended there, and the mmap'd beacon
    # the agent/head read post-mortem — even after SIGKILL.
    if GLOBAL_CONFIG.crash_forensics_enabled:
        forensics.arm()
    # Continuous profiling plane (profplane.py): every worker samples
    # its own threads on a duty cycle from boot; window summaries ride
    # the runtime's amortized rpc_report cast and the last window
    # persists to a sidecar next to the .beacon for crash forensics.
    from ray_tpu_torch._private import profplane

    profplane.arm("worker", os.environ.get("RAY_TPU_WORKER_ID"))
    # Trace-correlated logs: worker stderr lands in {worker_id}.log, so
    # stamping [trace=<id>] into every log record made while a traced
    # task executes lets `ray-tpu logs --trace <id>` grep a request's
    # log lines across the whole cluster.
    if GLOBAL_CONFIG.trace_enabled:
        from ray_tpu_torch.util.tracing import install_log_correlation

        install_log_correlation()
    # Flood workloads allocate millions of small objects; default gen0
    # thresholds make cyclic GC a measurable tax (reference analogue:
    # the reference's workers also tune GC). Collection still happens,
    # just in larger batches. User code can re-tune freely.
    gc.set_threshold(50_000, 25, 25)
    head_host, head_port = os.environ["RAY_TPU_HEAD"].rsplit(":", 1)
    # Worker-side profiling knob (reference analogue: py-spy/memray
    # hooks in dashboard/modules/reporter/profile_manager.py): dump a
    # cumulative cProfile of the executor thread at exit.
    prof_dir = os.environ.get("RAY_TPU_WORKER_PROFILE")
    if prof_dir:
        import atexit
        import cProfile
        import threading as _threading

        profiles: list = []
        _orig_init = _threading.Thread.__init__

        def _patched(self, *a, **k):
            _orig_init(self, *a, **k)
            if not (self.name or "").startswith(("task-exec", "group-")):
                return  # profile executor threads only: wrapping the rpc
                #         reader/writer threads perturbs registration
            run = self.run

            def run_prof():
                pr = cProfile.Profile()
                profiles.append(pr)
                pr.enable()
                try:
                    run()
                finally:
                    pr.disable()

            self.run = run_prof

        _threading.Thread.__init__ = _patched

        def _dump():
            import pstats

            os.makedirs(prof_dir, exist_ok=True)
            stats = None
            for p in profiles:
                try:
                    s = pstats.Stats(p)
                except TypeError:
                    continue  # thread never ran / empty profile
                stats = s if stats is None else stats.add(s)
            if stats is not None:
                stats.dump_stats(os.path.join(
                    prof_dir, f"worker_{os.getpid()}.prof"))

        atexit.register(_dump)
        globals()["_profile_dump"] = _dump
    worker = Worker(
        (head_host, int(head_port)),
        os.environ["RAY_TPU_WORKER_ID"],
        os.environ["RAY_TPU_NODE_ID"],
    )
    worker.main_loop()


if __name__ == "__main__":
    sys.exit(main())
