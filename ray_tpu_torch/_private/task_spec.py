"""Task and actor specs exchanged between driver, head, and workers.

Counterpart of the reference's TaskSpecification protobuf
(reference: src/ray/protobuf/common.proto TaskSpec; built in
python/ray/_raylet.pyx submit_task :3709 / create_actor :3795).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any


@dataclasses.dataclass(slots=True)
class TaskSpec:
    task_id: str
    name: str
    func_id: str  # KV key of the serialized function/class
    args: bytes  # cloudpickled (args, kwargs) with ObjectRefs embedded
    deps: list[str]  # object ids appearing top-level in args
    return_ids: list[str]
    resources: dict[str, float]
    owner_id: str  # client id of the submitter
    # (host, port) of the submitter's owner-plane server: the executor
    # delivers inline results DIRECTLY there, bypassing the head
    # (reference: owner-resident in-process store + direct actor/task
    # replies, core_worker.h:172 ownership model). None = head-routed
    # results (older producers, e.g. the native C++ client).
    owner_addr: Any = None
    max_retries: int = 0
    retries_used: int = 0
    # Streaming generator task: yielded items are stored under
    # deterministic ids ({task_id}:g{i}); return_ids[0] seals the count.
    streaming: bool = False
    scheduling_strategy: Any = None
    runtime_env: dict | None = None
    # actor fields
    actor_id: str | None = None  # set for actor method calls
    actor_creation: bool = False
    method_name: str = ""
    seq_no: int = 0  # per-caller ordering for actor calls
    # Concurrency group this call runs under (reference:
    # core_worker/transport/concurrency_group_manager.h:37). None =
    # method-level annotation or the default group.
    concurrency_group: str | None = None
    # Object ids NESTED inside args (inside containers, not top-level).
    # Not dependencies — they don't gate scheduling — but the head pins
    # them for the task's flight so the submitter may drop its refs
    # immediately after a fire-and-forget submit (reference:
    # reference_count.h serialized-in-task-args borrows).
    borrowed_ids: list = dataclasses.field(default_factory=list)
    # Worker recycling (reference: @ray.remote(max_calls=N),
    # remote_function.py — the worker process exits after executing N
    # calls of this function; the standard lever against native-memory
    # leaks/fragmentation, e.g. XLA device allocator churn). 0 = never.
    max_calls: int = 0
    # Overload-protection deadline (epoch seconds; 0 = none), stamped at
    # submit from .options(timeout_s=...) / task_timeout_s_default.
    # Checked at every queue hop (owner direct queues, head ready/dep/
    # actor queues, worker executor queue): expired work is shed with a
    # TaskTimeoutError error-seal instead of executing. Rides the spec
    # itself, so it crosses every dispatch path with zero extra frames.
    deadline: float = 0.0
    # Request-tracing context (trace_id, parent_span_id, sampled) or
    # None, stamped at submit from the ambient trace context
    # (worker_context) minted at the serve proxy / tracing.span. The
    # task's own span id IS its task_id; nested submissions inherit the
    # trace with this task as parent. Rides the spec like deadline — an
    # optional trailing field of the compiled encoding, zero extra
    # frames, byte-identical payloads when absent.
    trace_ctx: Any = None
    # Scratch attributes the head/worker hang off a spec in flight —
    # declared because the dataclass uses __slots__ (a 1M-task backlog
    # at ~1 KB/dict-backed spec would cost a GB of pure dict overhead;
    # slots roughly halves that and speeds dispatch-path attr access):
    #   _rkey / _demand — head dispatch caches (queue key, ResourceSet)
    #   _deps_pending   — unready-dependency set while dep-blocked
    #   _deferred_results — worker-side buffer of inline results
    #   _remote_markers — worker-side "stored big, ask the head" notes
    #                     delivered to the owner alongside inline seals
    #   _lease_key      — head-side: owner wants a worker lease for this
    #                     task shape (echoed back in the lease_grant)
    #   _direct         — worker-side: task arrived over the direct
    #                     plane (owner→worker push, not a head dispatch)
    #   _evt            — flight-recorder phase stamps accumulated while
    #                     the spec is in THIS process ({phase: ts},
    #                     events.py); each wire hop copies them into the
    #                     carrying message's "evt" field instead of the
    #                     spec pickle, so disabled-events payloads are
    #                     byte-identical to the pre-tracing wire format
    #   _queued         — head-side: this spec is counted in the
    #                     admission plane's pending budgets (set on
    #                     enqueue, cleared on dispatch/failure) so
    #                     re-enqueues and double-fails never skew the
    #                     per-owner/global counters
    _rkey: Any = dataclasses.field(default=None, repr=False)
    _demand: Any = dataclasses.field(default=None, repr=False)
    _queued: Any = dataclasses.field(default=None, repr=False)
    _deps_pending: Any = dataclasses.field(default=None, repr=False)
    _deferred_results: Any = dataclasses.field(default=None, repr=False)
    _remote_markers: Any = dataclasses.field(default=None, repr=False)
    _lease_key: Any = dataclasses.field(default=None, repr=False)
    _direct: Any = dataclasses.field(default=None, repr=False)
    _evt: Any = dataclasses.field(default=None, repr=False)
    #   _cpu_time       — worker-side: executor-thread CPU seconds of
    #                     the exec span, stamped onto the lifecycle
    #                     event (wall-vs-CPU skew in summarize_tasks)
    _cpu_time: Any = dataclasses.field(default=None, repr=False)
    # Submit-time compiled encoding, reused verbatim for every later
    # send of this spec: worker pushes, the task_started bookkeeping
    # cast, retries/re-pushes/spillback after a bounce (recovery paths
    # must not re-encode — see pack_spec_cached). Must be invalidated
    # wherever a PACKED field mutates after unpack — today that is only
    # retries_used on the retry path. Cached only under
    # _PACKED_CACHE_MAX bytes (a million-spec backlog must not hold a
    # duplicate serialized copy of large args; the head also drops it
    # from long-retained specs after its push), and stripped from
    # pickle below.
    _packed_bin: Any = dataclasses.field(default=None, repr=False)

    _SCRATCH = ("_rkey", "_demand", "_deps_pending", "_deferred_results",
                "_remote_markers", "_packed_bin", "_lease_key", "_direct",
                "_evt", "_cpu_time", "_queued")

    def __getstate__(self):
        """Strip scratch slots (dispatch caches, the packed-bytes
        duplicate) from pickle: a pickle-fallback push must not ship a
        second serialized copy of the spec inside itself."""
        slots = {}
        for f in dataclasses.fields(self):
            if f.name in self._SCRATCH:
                continue
            try:
                slots[f.name] = getattr(self, f.name)
            except AttributeError:
                pass
        return (None, slots)

    def __setstate__(self, state):
        """Accept BOTH pickle state forms. The slotted class emits
        (None, {slots}); the native C++ client (src/client/minipickle.h)
        crafts streams with plain dict state, which default BUILD would
        apply via __dict__ — absent here. Unset fields get their
        declared defaults so older/foreign producers stay compatible."""
        if isinstance(state, tuple):
            d, s = state
            merged = {**(d or {}), **(s or {})}
        else:
            merged = dict(state or {})
        for f in dataclasses.fields(self):
            if f.name in merged:
                object.__setattr__(self, f.name, merged[f.name])
            else:
                try:
                    getattr(self, f.name)
                except AttributeError:
                    if f.default is not dataclasses.MISSING:
                        v = f.default
                    elif f.default_factory is not dataclasses.MISSING:
                        v = f.default_factory()
                    else:
                        v = None
                    object.__setattr__(self, f.name, v)


def env_pkg_key(renv: "dict | None") -> "str | None":
    """Hash of the package half of a runtime env (pip/conda), or None
    for envs that don't alter installed packages — only the package
    half poisons a worker's sys.modules for other envs. Shared by the
    head's shape-keyed ready queues and the owner-side lease cache
    (their keys MUST match or lease grants would never be spent)."""
    if not renv:
        return None
    pkg = {k: renv[k] for k in ("pip", "conda", "uv") if renv.get(k)}
    if not pkg:
        return None
    import hashlib as _hashlib

    return _hashlib.sha256(repr(sorted(
        (k, repr(v)) for k, v in pkg.items())).encode()).hexdigest()[:16]


def shape_key(spec: "TaskSpec") -> tuple:
    """Resource-shape key of a default-strategy task: every task with
    the same key shares placement feasibility, so a worker lease
    granted for one serves them all (reference analogue: the owner-side
    lease cache keyed by SchedulingClass, normal_task_submitter.cc:29)."""
    return (tuple(sorted((spec.resources or {}).items())),
            env_pkg_key(spec.runtime_env))


# --- compiled fast path (reference: the C++ TaskSpecification built/
# parsed behind the Cython bridge, _raylet.pyx:3709) -------------------
#
# Pickling a slotted dataclass costs ~25-50 us per spec across
# submit+dispatch; src/specenc/specenc.c packs the spec's typed fields
# straight to bytes. The two arbitrary-object fields
# (scheduling_strategy, runtime_env) are pickled as embedded blobs —
# and are None on the hot path. The codec now lives behind
# wirefmt.codec(): the C extension where it builds, a byte-identical
# pure-Python fallback everywhere else (RAY_TPU_NATIVE=0 forces it) —
# so the compiled encoding is ALWAYS available and every peer
# advertises specenc. pack_spec returns None only when a field doesn't
# fit the codec; callers fall back to pickling the dataclass, so
# foreign producers (the C++ minipickle client) and exotic field
# values keep working.


def _specenc():
    from ray_tpu_torch._private import wirefmt

    return wirefmt.codec()


def pack_spec(spec: "TaskSpec") -> "bytes | None":
    enc = _specenc()
    if enc is None:
        return None
    strat = spec.scheduling_strategy
    renv = spec.runtime_env
    try:
        return enc.pack((
            spec.task_id, spec.name, spec.func_id, spec.args,
            list(spec.deps), list(spec.return_ids),
            spec.resources or {}, spec.owner_id,
            tuple(spec.owner_addr) if spec.owner_addr else None,
            spec.max_retries, spec.retries_used, bool(spec.streaming),
            None if strat is None else pickle.dumps(strat, protocol=5),
            None if renv is None else pickle.dumps(renv, protocol=5),
            spec.actor_id, bool(spec.actor_creation), spec.method_name,
            spec.seq_no, spec.concurrency_group,
            list(spec.borrowed_ids or ()),
            spec.max_calls,
            # Optional trailing fields (the codec is length-prefixed and
            # unpack maps positionally onto the dataclass, so omitting
            # them keeps deadline-free payloads byte-identical to the
            # pre-overload-plane wire format):
            #   22. deadline — overload-protection expiry stamp
            #   23. trace_ctx — (trace_id, parent_span_id, sampled);
            #       packing it forces deadline out too (possibly 0.0)
            #       to keep the positional mapping intact
        ) + _trailing(spec))
    except (TypeError, ValueError, OverflowError):
        return None  # exotic field value: pickle fallback


def _trailing(spec: "TaskSpec") -> tuple:
    """Optional trailing fields of the compiled encoding, oldest first.
    A later field forces every earlier one out (unpack is positional);
    each combination that omits a tail keeps its payload byte-identical
    to the format that predated the omitted fields."""
    if spec.trace_ctx is not None:
        return (spec.deadline, tuple(spec.trace_ctx))
    if spec.deadline:
        return (spec.deadline,)
    return ()


def unpack_spec(data: bytes) -> "TaskSpec":
    vals = list(_specenc().unpack(data))
    if vals[12] is not None:
        vals[12] = pickle.loads(vals[12])
    if vals[13] is not None:
        vals[13] = pickle.loads(vals[13])
    return TaskSpec(*vals)


_PACKED_CACHE_MAX = 4096


def pack_spec_cached(spec: "TaskSpec") -> "bytes | None":
    """pack_spec with the result cached on the spec (small specs only):
    the owner packs ONCE per task and every subsequent send — the
    task_started bookkeeping cast, a retry, a re-push after a bounce,
    spillback to the head — reuses the bytes verbatim. The cache is
    invalidated wherever a packed field mutates (retries_used on the
    head's retry path) and stripped from pickle (__getstate__)."""
    packed = spec._packed_bin
    if packed is None:
        packed = pack_spec(spec)
        if packed is not None and len(packed) <= _PACKED_CACHE_MAX:
            spec._packed_bin = packed
    return packed


def spec_from_body(body: dict) -> "TaskSpec":
    """Spec from a control-plane message: compiled encoding when the
    sender used it, pickled dataclass otherwise."""
    spec = body.get("spec")
    if spec is not None:
        return spec
    spec = unpack_spec(body["spec_bin"])
    if len(body["spec_bin"]) <= _PACKED_CACHE_MAX:
        spec._packed_bin = body["spec_bin"]
    return spec


@dataclasses.dataclass
class ActorSpec:
    actor_id: str
    name: str | None  # named actor registry key
    namespace: str
    cls_func_id: str
    init_args: bytes
    deps: list[str]
    resources: dict[str, float]
    max_restarts: int
    max_concurrency: int
    owner_id: str
    # Per-method replay budget across actor RESTARTS (reference:
    # @ray.remote(max_task_retries=N) — in-flight calls on a dying actor
    # are re-queued onto the restarted incarnation instead of erroring).
    max_task_retries: int = 0
    scheduling_strategy: Any = None
    runtime_env: dict | None = None
    lifetime: str | None = None  # "detached" or None
    # {"group_name": max_concurrency} (reference:
    # concurrency_group_manager.h:37; Python API
    # @ray.remote(concurrency_groups={...})). Applies to threaded AND
    # async actors; the default group runs at max_concurrency.
    concurrency_groups: dict | None = None
    # Refs nested inside init_args (see TaskSpec.borrowed_ids).
    borrowed_ids: list = dataclasses.field(default_factory=list)
    # Opt-in out-of-order execution (reference:
    # out_of_order_actor_submit_queue.h): calls whose args are ready
    # may overtake earlier calls parked on unresolved args.
    allow_out_of_order: bool = False
