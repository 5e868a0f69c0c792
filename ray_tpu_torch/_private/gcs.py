"""Head control service: cluster metadata + scheduling + object directory.

This process-resident service plays the roles that the reference splits
across three C++ daemons:
  - GCS (reference: src/ray/gcs/gcs_server/gcs_server.h:90 — actor/node/job/PG
    tables, KV, pubsub, health) → the tables + KV here,
  - raylet/NodeManager (reference: src/ray/raylet/node_manager.h:123 — worker
    leases, dispatch, dependency management) → WorkerPool + dispatch loop,
  - plasma store ownership (reference: src/ray/object_manager/plasma/store.h:55)
    → ObjectDirectory over the C++ shm arena (src/object_store/arena.cc).

Design departure (SURVEY.md §7): the hot path on TPU is the jitted step, not
per-task dispatch, so the control plane favors simplicity and correctness —
one head service, coarse lock, dedicated dispatch thread — while the data
plane (tensors) bypasses it entirely via ICI collectives.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Any

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.scheduler import (
    GRANULARITY,
    ClusterScheduler,
    NodeEntry,
    PlacementGroupSchedulingStrategy,
    ResourceSet,
    _fp,
)
from ray_tpu_torch._private.shm_store import ShmArena
from ray_tpu_torch._private.task_spec import (ActorSpec, TaskSpec, env_pkg_key,
                                        pack_spec, spec_from_body)

# Object directory entry states.
CREATING, SEALED, SPILLED, LOST = "CREATING", "SEALED", "SPILLED", "LOST"
# Task states (mirrors the reference's task state machine used by the state
# API, reference: src/ray/protobuf/gcs.proto TaskStatus).
# Sentinel: strategy resolves to "cannot place now" (e.g. its placement
# group is still pending) — dispatch must requeue, never fall through to the
# default policy.
UNPLACEABLE = object()
_SCAN_KEY = ("strategy",)  # ready-queue key for explicit-strategy tasks

PENDING, SCHEDULED, RUNNING, FINISHED, FAILED = (
    "PENDING_ARGS_AVAIL",
    "SCHEDULED",
    "RUNNING",
    "FINISHED",
    "FAILED",
)


class ObjectEntry:
    __slots__ = (
        "object_id", "state", "offset", "size", "inline", "spill_path",
        "refcount", "read_pins", "task_pins", "lru", "is_error", "owner_id",
        "created_at", "location", "remote_offset", "borrowers",
        "container_pins", "contained", "pin_holders", "replicas", "rr",
        "owner_resident", "reads", "last_read", "pull_clients",
    )

    def __init__(self, object_id: str, owner_id: str):
        self.object_id = object_id
        self.state = CREATING
        self.offset: int | None = None
        self.size = 0
        self.inline: bytes | None = None
        self.spill_path: str | None = None
        self.refcount = 0
        self.read_pins = 0
        # Object-plane observability: how many times a meta for this
        # entry was served (leak detector: SEALED + never read past the
        # TTL = suspect) and when last.
        self.reads = 0
        self.last_read = 0.0
        # read_pins by holder client (zero-copy gets hold pins for the
        # life of the aliasing arrays, so a crashed client's pins must
        # be reaped on disconnect or the object could never spill/free).
        self.pin_holders: dict[str, int] = {}
        self.task_pins = 0
        self.lru = 0
        self.is_error = False
        self.owner_id = owner_id
        self.created_at = time.time()
        # Borrow protocol (reference: reference_count.h:72): client ids
        # holding a live deserialized copy of this ref. The entry cannot
        # be freed while any borrower lives; a borrower's death or
        # del_borrow removes it.
        self.borrowers: set[str] = set()
        # Containment: count of SEALED objects whose payload embeds this
        # ref (each pins this entry until that container is freed), and
        # the ids this entry's own payload embeds.
        self.container_pins = 0
        self.contained: tuple = ()
        # P2P: node hosting the payload in its agent store (the head
        # keeps only this directory entry; reference:
        # ownership_based_object_directory.h:39).
        self.location: str | None = None
        self.remote_offset: int | None = None
        # Broadcast fan-out (reference: push_manager.h:32 spanning-tree
        # push): nodes holding a cached copy of the payload in their
        # agent store, node_id -> (offset, size). _meta_for round-robins
        # sources across primary + replicas via the rr counter, so N
        # pullers spread over the nodes that already have the bytes
        # instead of convoying on one source.
        self.replicas: dict[str, tuple] = {}
        self.rr = 0
        # Relay-tree gating: in-flight remote bulk pulls by client id
        # (incremented when a gateable p2p meta is served, decremented
        # at that client's read_done). Past relay_fanout, additional
        # remote pullers park until a relay source registers or a slot
        # frees — O(N) convoys on one source become a tree.
        self.pull_clients: dict[str, int] = {}
        # Owner-resident object (reference: core_worker in-process store
        # + ownership, core_worker.h:172): the payload lives in the
        # OWNING runtime's store, delivered there directly by the
        # executor; this directory entry holds metadata only and the
        # value fate-shares with the owner process.
        self.owner_resident = False


class WorkerRecord:
    __slots__ = (
        "worker_id", "node_id", "conn", "proc", "pid", "busy", "actor_id",
        "inflight", "started_at", "gpu_ids", "acquired", "ready", "pg_alloc",
        "gpu_capable", "cur_rkey", "zygote", "env_key", "blocked",
        "released_alloc", "retiring", "leased_to", "lease_deadline",
        "lease_key", "expected_exit", "gpu_bound", "gpu_units",
    )

    def __init__(self, worker_id: str, node_id: str, proc,
                 gpu_capable: bool = False):
        self.worker_id = worker_id
        self.node_id = node_id
        self.conn: rpc.Connection | None = None
        self.proc = proc
        # Remote (agent-spawned) workers report their real pid at
        # registration; None until then.
        self.pid = proc.pid if proc else None
        self.busy = False
        self.actor_id: str | None = None
        # In-flight tasks by task_id: actors with max_concurrency > 1 can
        # have several; completion messages are matched by id (a completion
        # for call N must not clobber the record of call N+1).
        self.inflight: dict[str, TaskSpec] = {}
        self.started_at = time.time()
        self.gpu_ids: list[int] = []
        # The share of each device in gpu_ids this lease holds, in the
        # scheduler's 1e-4 units (GRANULARITY = a whole device).
        self.gpu_units = 0
        self.acquired: ResourceSet | None = None
        self.pg_alloc: tuple[str, int, ResourceSet] | None = None  # (pg_id, bundle, demand)
        self.ready = False  # set by worker_ready (two-phase registration)
        # max_calls handshake: the worker asked to exit; no new work is
        # dispatched to it, and the head releases it (exit_worker cast)
        # once every pending owner-seal confirmation has landed — an
        # immediate exit would strand just-delivered results as "lost"
        # and re-execute their tasks through lineage recovery.
        self.retiring = False
        # Resource-shape key of the normal task(s) currently allocated to
        # this worker — same-shape tasks may pipeline onto it (bounded
        # inflight window) without extra allocation: execution is serial,
        # so peak usage stays one task's worth (reference analogue: the
        # owner-side lease cache pipelining tasks onto leased workers,
        # normal_task_submitter.cc:29).
        self.cur_rkey: tuple | None = None
        # Forked from the local zygote: no Popen handle, but the pid is
        # THIS machine's — hard kills go through os.kill.
        self.zygote = False
        # Package-env affinity (reference: runtime-env-keyed worker pool
        # caching, worker_pool.h:224): once a worker runs a task with a
        # pip/conda env, its sys.modules may cache that env's package
        # versions — it is keyed to that env hash for life and never
        # serves plain tasks or other envs again.
        self.env_key: str | None = None
        # Blocked-task resource release (reference: a worker blocked in
        # ray.get returns its CPU so dependent tasks can run —
        # core_worker task-blocked protocol). blocked counts this
        # worker's threads parked in a nested get/wait; the allocation
        # released at 0->1 is parked in released_alloc for reacquisition
        # at 1->0.
        self.blocked = 0
        self.released_alloc = None
        # Spawned with the parent's CUDA visibility (can take GPU
        # leases). Chipless pool workers spawn with every device hidden
        # (CUDA_VISIBLE_DEVICES="") so they never create a context on a
        # device no lease granted them.
        self.gpu_capable = gpu_capable
        # The device ids of this worker's first GPU lease. CUDA reads
        # CUDA_VISIBLE_DEVICES once, when it initialises, so a pooled
        # GPU worker can only ever take the same devices again
        # (_assign_gpus, _idle_worker).
        self.gpu_bound: list | None = None
        # Direct-call plane worker lease (reference: the raylet-granted
        # worker lease the owner-side cache pipelines onto,
        # normal_task_submitter.cc:29): while leased_to an owner, this
        # worker dispatches ONLY that owner's direct pushes — it leaves
        # the idle/pipeline pools and keeps its allocation until the
        # lease is returned, expires, or the worker dies.
        self.leased_to: str | None = None
        self.lease_deadline = 0.0
        self.lease_key = None
        # Crash forensics: the supervisor's recorded kill intent
        # ("memory_monitor" | "intended_kill" | "retired" | "shutdown" |
        # "node_death" | "spawn_failure", detail), set BEFORE the head
        # kills/releases this worker so its own kills never classify as
        # anonymous SIGKILLs (reference: WorkerExitType INTENDED_*).
        self.expected_exit: tuple | None = None


class ActorRecord:
    __slots__ = (
        "spec", "state", "worker_id", "node_id", "restarts", "pending",
        "death_cause", "created_at", "arg_pins_held", "direct_watchers",
    )

    def __init__(self, spec: ActorSpec):
        self.spec = spec
        self.state = "PENDING_CREATION"
        self.worker_id: str | None = None
        self.node_id: str | None = None
        self.restarts = 0
        self.pending: deque[TaskSpec] = deque()
        self.death_cause = ""
        self.created_at = time.time()
        # Init-arg objects stay pinned for the actor's restartable
        # lifetime (restarts replay the creation args); released once at
        # the permanent-DEAD transition.
        self.arg_pins_held = False
        # Owners granted a direct route to this actor's worker: each
        # gets an actor_direct_revoke cast when the worker dies so
        # in-flight direct calls re-route instead of hanging.
        self.direct_watchers: set[str] = set()


class PlacementGroupRecord:
    __slots__ = (
        "pg_id", "name", "bundles", "strategy", "state", "node_per_bundle",
        "waiters", "bundle_used",
    )

    def __init__(self, pg_id: str, name: str, bundles, strategy: str):
        self.pg_id = pg_id
        self.name = name
        self.bundles = bundles
        self.strategy = strategy
        self.state = "PENDING"
        self.node_per_bundle: list[str] | None = None
        self.waiters: list[tuple[rpc.Connection, str]] = []
        # Per-bundle resource accounting: work scheduled into a bundle
        # consumes its reservation, bounded by the bundle size (reference:
        # bundle resource bookkeeping in NewPlacementGroupResourceManager,
        # raylet/placement_group_resource_manager.h:90).
        self.bundle_used: list[ResourceSet] = [ResourceSet({}) for _ in bundles]

    def bundle_fits(self, index: int, demand: ResourceSet) -> bool:
        remaining = ResourceSet(self.bundles[index])
        remaining.subtract(self.bundle_used[index])
        return remaining.fits(demand)


def _hist_quantile_dict(h: dict, q: float) -> "float | None":
    """Linear-interpolated quantile from an exported phase histogram
    dict ({boundaries, buckets, sum, count} — PhaseHistogram.to_dict
    shape). The open last bucket reports its lower edge (cannot
    interpolate into +inf). Used by the profiling plane's
    phase-regression sentinel."""
    total = h.get("count") or 0
    if not total:
        return None
    target = q * total
    bounds = list(h["boundaries"])
    cum = 0.0
    for i, c in enumerate(h["buckets"]):
        if cum + c >= target and c:
            lo = bounds[i - 1] if i else 0.0
            if i >= len(bounds):
                return lo
            hi = bounds[i]
            return lo + (hi - lo) * (target - cum) / c
        cum += c
    return bounds[-1] if bounds else None


class Head:
    """The head service. Runs inside the driver process (threads)."""

    def __init__(
        self,
        config: Config,
        num_cpus: float | None = None,
        num_gpus: float | None = None,
        resources: dict[str, float] | None = None,
        session_dir: str | None = None,
        shard_ctx=None,
        gpu_base: int = 0,
    ):
        self.config = config
        # Sharded-head mode (head_shards.ShardCtx): None means the
        # single-process head — every shard branch below is behind
        # `self.shard is not None`, so shards=1 never runs sharding
        # code (the bit-identical kill switch).
        self.shard = shard_ctx
        self.session_id = uuid.uuid4().hex[:12]
        self.session_dir = session_dir or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", f"session_{self.session_id}")
        os.makedirs(self.session_dir, exist_ok=True)
        self.spill_dir = config.object_spilling_dir or os.path.join(self.session_dir, "spill")
        from ray_tpu_torch._private.external_storage import setup_external_storage

        self.external_storage = setup_external_storage(
            config.object_spilling_config, self.spill_dir)

        self.shm_name = f"/ray_tpu_torch_{self.session_id}"
        self.arena = ShmArena(self.shm_name, config.object_store_memory)
        # Bulk transfer plane (reference: object_manager chunked
        # push/pull, push_manager.h:32): off-host clients pull head-
        # stored payloads from here in parallel raw-socket stripes
        # instead of receiving them pickled inline over the control
        # connection (which serialized a whole broadcast through one
        # framed stream AND the head lock).
        from ray_tpu_torch._private.bulk_transfer import BulkServer

        self.bulk_server = BulkServer(self._bulk_read)
        # "" host: the client substitutes the head host it dialed.
        self.node_bulk_addrs: dict[str, tuple] = {}

        self.lock = threading.RLock()
        self.dispatch_event = threading.Event()
        self._push_touched: set = set()  # conns with buffered pushes
        # Set by _on_sealed when a seal readied a dep-blocked task, so
        # completion handlers know a dispatch pass is actually needed.
        self._sealed_woke_task = False

        # --- tables ---
        self.objects: dict[str, ObjectEntry] = {}
        self.get_waiters: dict[str, tuple[rpc.Connection, set[str]]] = {}
        self._waiter_ids: dict[str, list[str]] = {}
        self.wait_waiters: dict[str, tuple[rpc.Connection, list[str], int]] = {}
        # Sampling-profiler rendezvous: req_id -> (event, result holder).
        self.profile_waiters: dict[str, tuple[threading.Event, dict]] = {}
        self.kv: dict[tuple[str, str], bytes] = {}
        self.actors: dict[str, ActorRecord] = {}
        self.named_actors: dict[tuple[str, str], str] = {}
        self.pgs: dict[str, PlacementGroupRecord] = {}
        # Dispatch queues, shape-keyed (reference analogues: the
        # raylet's per-SchedulingClass task queues in
        # cluster_task_manager.h:45 and the DependencyManager's
        # object->waiting-task index, dependency_manager.h:55).
        #   ready_queues[("shape", rkey)] — default-strategy tasks with
        #     all deps ready, grouped by resource shape: every entry
        #     shares placement feasibility, so dispatch tries heads and
        #     stops at the first resource failure — a saturated pass is
        #     O(#shapes), not O(#queued).
        #   ready_queues[_SCAN_KEY] — tasks with explicit scheduling
        #     strategies (PG/affinity/spread); feasibility varies per
        #     task, so these keep the budgeted skip-over scan.
        #   dep_blocked[object_id] — tasks waiting on that object;
        #     _on_sealed moves them to a ready queue (event-driven, no
        #     rescans).
        self.ready_queues: dict[tuple, deque[TaskSpec]] = {}
        self.dep_blocked: dict[str, list[TaskSpec]] = {}
        self.tasks: dict[str, dict] = {}  # task_id -> state record (state API)
        self.finished_tasks: deque[str] = deque(maxlen=config.task_events_max_buffer)
        self.workers: dict[str, WorkerRecord] = {}
        self.clients: dict[str, rpc.Connection] = {}  # client_id -> conn
        # client_id -> (host, port) of the client's owner-plane server
        # (direct result delivery + peer value fetch; the head hands
        # these out in "owner" metas).
        self.client_owner_addrs: dict[str, tuple] = {}
        # Liveness backstop for in-flight direct seals: object_id ->
        # executing worker_id, registered when a task finishes with
        # owner-destined results and cleared when the owner confirms.
        # A worker that dies in the gap gets its pending ids error-
        # sealed so waiters never hang on a seal that was lost with the
        # process.
        self._pending_owner_seals: dict[str, str] = {}
        self._worker_pending_seals: dict[str, set] = {}
        # Producing spec for each pending ACTOR-task seal. Actor methods
        # have no lineage entry (single-method reconstruction cannot
        # honor incarnation ordering), so a seal that dies with the
        # worker must replay through the actor restart path instead —
        # this map is what makes that replay possible. Normal tasks
        # recover via _maybe_reconstruct and are never stashed here.
        self._pending_seal_specs: dict[str, TaskSpec] = {}
        # Direct-plane completion tombstones: a worker's task_finished
        # can beat the owner's batched task_started (different
        # connections, no ordering) — remember recently-finished ids so
        # the late task_started doesn't register a phantom inflight
        # entry that would pin the worker busy forever.
        self._early_finished: set[str] = set()
        self._early_finished_fifo: deque[str] = deque()
        # owner_id -> freed object ids awaiting one coalesced
        # owned_freed cast (flushed per dispatch pass).
        self._owned_freed_buf: dict[str, list] = {}
        # Flight-recorder event table (reference: gcs_task_manager.h:159
        # bounded task-event ring): lifecycle events merged per task as
        # stamps arrive on submit/task_started/task_finished/owner_sealed,
        # plus user spans, profile events, and chaos instants.
        from ray_tpu_torch._private.events import EventTable

        self.task_events = EventTable(config.task_events_max_buffer)
        # Request-tracing table (traceplane.py): causal trace trees
        # assembled from lifecycle events / span records that arrive on
        # the SAME task_finished / task_events / rpc_report messages the
        # flight recorder already rides — tail-based retention keeps
        # slow/error/shed exemplars and a uniform sample in full detail.
        from ray_tpu_torch._private.traceplane import TraceTable

        self.traces = TraceTable(config)
        # Crash forensics plane (reference: the GCS worker-death table
        # with WorkerExitType + exit_detail): bounded table of
        # classified crash reports keyed by worker_id (node deaths under
        # "node:<id>"), deaths-by-reason counters for the
        # ray_tpu_worker_deaths_total{reason=...} exposition, and the
        # lazily-built cgroup oom_kill watcher for kernel-OOM
        # attribution of local worker SIGKILLs.
        self.crash_reports: dict[str, dict] = {}
        self._crash_fifo: deque[str] = deque()
        self.death_counts: dict[str, int] = {}
        self._oom_watch = None
        # Per-node clock offsets (node_clock - head_clock), estimated
        # NTP-style over the agent heartbeat loop; timeline() aligns
        # cross-node spans with them.
        self.clock_offsets: dict[str, float] = {}
        # Cluster-wide rpc counter snapshots: client_id -> last report
        # (workers/drivers via the amortized rpc_report cast, agents
        # piggybacked on their heartbeats).
        self.rpc_reports: dict[str, dict] = {}
        # --- object-plane observability ---
        # Owner censuses (objcensus.py summaries piggybacked on
        # rpc_report): client_id -> {"ts", "groups", "live_objects",
        # "live_bytes", ...}. Merged with self.objects into the
        # `ray-tpu memory` view (memory_summary handler).
        self.object_census: dict[str, dict] = {}
        # Leak-detector trend windows: (client_id, callsite) ->
        # deque[(ts, bytes, count)], one sample per census REPORT (not
        # per sweep — "grew across N report windows" means N reports).
        self._census_history: dict[tuple, deque] = {}
        # Leak suspects (observe-only: flagged with trend data, never
        # killed): suspect key -> record. Swept by the health loop.
        self.leak_suspects: dict[str, dict] = {}
        self._last_leak_sweep = 0.0
        # --- continuous profiling plane (profplane.py) ---
        # Cluster profile table: (node, role, window_index) -> merged
        # window record {"node","role","ident","pid","start","end",
        # "samples","folded",...}. Window index = floor(end_ts /
        # profiling_window_s) so summaries from different processes on
        # the same node+role land in one mergeable bucket. Bounded FIFO
        # (cluster_profile_max_windows); eviction skips PINNED windows
        # (phase-regression exemplars) until they age past the pin cap.
        self.cluster_profile: dict[tuple, dict] = {}
        self._profile_fifo: deque[tuple] = deque()
        self.profile_stats = {"windows_total": 0, "dropped_windows": 0,
                              "gil_exemplars": 0, "pinned": 0}
        # GIL-starvation exemplars (wall >> cpu tasks auto-captured by
        # the owning worker's sampler): bounded recents, newest last.
        self._gil_exemplars: deque[dict] = deque(maxlen=16)
        # Phase-regression sentinel state: trailing p95 per phase
        # (queue_wait/dispatch), sampled once per health tick from the
        # cumulative phase histograms; a tick whose p95 exceeds the
        # trailing median by profiling_regression_factor pins the
        # head/shard flamegraph windows covering that tick.
        self._phase_p95_hist: dict[str, deque] = {}
        self._phase_prev_counts: dict[str, int] = {}
        self._pinned_windows: set[tuple] = set()
        self.metrics: dict[str, Any] = {}
        # Core runtime counters (reference: DEFINE_stats core metric set,
        # src/ray/stats/metric_defs.h:46 — `tasks`, `actors`, …); gauges
        # are derived from the live tables at scrape time.
        self.stats = {"tasks_finished": 0, "tasks_failed": 0,
                      "admission_rejected": 0}
        # --- overload-protection plane ---
        # Admission budgets: queued-but-not-executing tasks per owner
        # and cluster-wide, maintained via spec._queued transitions
        # (enqueue +1, dispatch/failure -1) so the gate in the submit
        # handlers is O(1) under flood.
        self.pending_by_owner: dict[str, int] = {}
        self.pending_total = 0
        # Deadline sheds by hop ({where: count} →
        # ray_tpu_tasks_shed_total{where=...}).
        self.shed_counts: dict[str, int] = {}
        # In-flight tasks already sent a deadline cancel cast (dedup so
        # the health sweep doesn't re-signal every tick).
        self._expiry_signalled: set[str] = set()
        # Memory-aware backpressure: node_id -> {"used", "total", "ts",
        # "remote"}; pressured nodes receive no placements or lease
        # grants until recovery. Remote entries expire if the agent's
        # refresh casts stop (self-healing against a lost recovery
        # cast); the head node's own entry is managed by its
        # MemoryMonitor in-process.
        self.pressured_nodes: dict[str, dict] = {}
        # Cheap skip for the health loop's expiry sweeps: False until
        # the first deadline-stamped submission arrives.
        self._any_deadlines = False
        self.node_agents: dict[str, rpc.Connection] = {}  # node_id -> agent conn
        self.node_transfer_addrs: dict[str, tuple] = {}  # node_id -> (ip, port)
        # Data plane: per-node arena identity (store name, capacity,
        # host id) stamped into p2p metas so host-colocated readers map
        # the holder arena directly.
        self.node_store_info: dict[str, dict] = {}
        # Relay-tree broadcast gating: per-object count of in-flight
        # remote pulls (incremented when a gateable p2p meta is served,
        # decremented at read_done) and the pullers parked waiting for
        # a relay source to register. waiter_id -> (conn, parked_at).
        self._relay_parked: dict[str, deque] = {}
        self._parked_waiters: dict[str, tuple] = {}
        # Liveness beyond the TCP session (reference: GCS health checks,
        # gcs_health_check_manager.h:45): agents heartbeat every
        # health_check_period_s; a node silent past
        # health_check_timeout_s is declared dead even though its
        # connection never closed — the partitioned-node case the
        # conn-close lease alone cannot see.
        self._agent_last_seen: dict[str, float] = {}
        from concurrent.futures import ThreadPoolExecutor

        # Meta replies (which may embed payload bytes for remote clients)
        # are sent from here, never while holding self.lock.
        self._send_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="meta-send")
        # Lineage: return object id -> producing TaskSpec (normal tasks).
        # Reference: owner-side lineage pinning (task_manager.h:223) +
        # ObjectRecoveryManager re-execution (object_recovery_manager.h:43).
        self.lineage: dict[str, TaskSpec] = {}
        self.lineage_order: deque[str] = deque()
        self.reconstructions: dict[str, int] = {}
        self._lru_tick = 0
        self._shutdown = False
        self._subscribers: dict[str, list[rpc.Connection]] = {}  # pubsub topic
        # --- cross-shard tables (empty/idle at shards=1) ---
        # Metas for objects owned by OTHER shards, learned through the
        # bus (dir_obj_lookup replies + pushed xshard_sealed casts).
        # Every cross-shard meta is PIN-FREE (inline copy / owner
        # pointer / unpinned p2p) so no pin lifecycle spans shards;
        # bounded FIFO — a consumer that comes back later just re-asks.
        self._xshard_metas: dict[str, tuple] = {}
        self._xshard_meta_fifo: deque[str] = deque()
        # Owner side: oid -> set of shard indexes to push the meta to
        # when it seals (registered by their pending lookups).
        self._xshard_watch: dict[str, set] = {}
        # actor_id -> owning shard index, learned via dir_find_actor /
        # dir_name_get (a stale entry self-heals: the forward errors
        # and the next locate re-asks).
        self._xshard_actors: dict[str, int] = {}

        # --- local node (head node) ---
        node_resources = self._detect_resources(num_cpus, num_gpus, resources)
        self.scheduler = ClusterScheduler(config.scheduler_spread_threshold)
        self.node_id = "node-" + uuid.uuid4().hex[:8]
        self.scheduler.add_node(
            NodeEntry(
                node_id=self.node_id,
                address="127.0.0.1",
                total=ResourceSet(node_resources),
                available=ResourceSet(node_resources),
            )
        )
        self.node_resources = node_resources
        # Continuous profiling plane: the head (or this dispatch shard)
        # samples its own dispatch/health/send threads from boot. Its
        # windows are merged into cluster_profile by the health tick —
        # no rpc needed for the in-process role. Shards run the same
        # Head class; the role tag keeps their flamegraphs separable so
        # the per-shard CPU rows become attributable.
        from ray_tpu_torch._private import profplane

        profplane.arm("shard" if self.shard is not None else "head",
                      self.node_id)
        # --- telemetry history + SLO alerting plane (tsdb.py /
        # alertplane.py) --- bounded embedded time-series store fed
        # from the EXISTING amortized casts (rpc_report, heartbeats,
        # report_metrics) plus this process's own tables sampled on the
        # health tick, and the declarative alert engine evaluated on
        # the same tick. Sharded head: each shard keeps its own store
        # and engine; queries/alert listings fan out like every other
        # state read.
        from ray_tpu_torch._private import alertplane
        from ray_tpu_torch._private import tsdb as tsdb_mod

        self.tsdb = tsdb_mod.SeriesStore(config) \
            if tsdb_mod.enabled() else None
        self.alerts = alertplane.AlertEngine(config) \
            if (self.tsdb is not None and alertplane.enabled()) else None
        self._last_tsdb_sample = 0.0
        # GPU device pool for visibility pinning (reference:
        # python/ray/_private/accelerators/nvidia_gpu.py,
        # CUDA_VISIBLE_DEVICES): each device's free share in the
        # scheduler's 1e-4 units, so fractional leases share a device.
        # A shard of a sharded head owns the contiguous device range its
        # resource slice counts, from gpu_base on, so no device is
        # leased from two shards.
        from ray_tpu_torch.accelerators.cuda import CUDAAcceleratorManager

        n_gpus = int(node_resources.get("GPU", 0))
        self.gpu_pool: dict[str, dict[int, int]] = {
            self.node_id: dict.fromkeys(
                CUDAAcceleratorManager.node_device_ids(gpu_base + n_gpus)[gpu_base:],
                GRANULARITY)
        }
        self.max_pool_workers = max(2, int(node_resources.get("CPU", 2)))

        # --- head fault tolerance (reference: gcs_init_data.h bulk load
        # + redis_store_client.h persistent tables; here a snapshot file,
        # see _private/gcs_persistence.py) --- must happen BEFORE the
        # server accepts connections so restored state is visible to the
        # first reconnecting client.
        # gcs_external_store ("file:///shared/dir") supersedes the
        # node-local snapshot path: pointed at shared storage, ANY
        # machine can adopt the head role after a failure (reference:
        # redis_store_client.h:111 — external-store head HA).
        self._snapshot_path = (config.gcs_external_store
                               or config.gcs_snapshot_path or None)
        self._snapshot_dirty = False
        self._wal = None
        self._gcs_store = None
        if self._snapshot_path:
            from ray_tpu_torch._private import gcs_persistence

            if config.gcs_external_store:
                from ray_tpu_torch._private.gcs_store import store_from_uri

                self._gcs_store = store_from_uri(config.gcs_external_store)
            else:
                self._gcs_store = gcs_persistence._as_store(
                    self._snapshot_path)
            payload = gcs_persistence.load_snapshot(self._gcs_store)
            from_seg = payload.get("wal_seg", 0) if payload else 0
            ops, last_seg = gcs_persistence.WriteAheadLog.read_ops(
                self._gcs_store, from_seg)
            if payload is None and ops:
                payload = gcs_persistence.empty_payload()
            if payload is not None:
                if ops:
                    gcs_persistence.apply_ops(payload, ops)
                stats = gcs_persistence.restore_into(self, payload)
                print(f"ray_tpu_torch head: restored snapshot+wal "
                      f"({stats['actors_restored']} actors to restart, "
                      f"{stats['kv_keys']} KV keys, {stats['pgs']} PGs, "
                      f"{len(ops)} WAL ops)",
                      file=sys.stderr)
            self._wal = gcs_persistence.WriteAheadLog(
                self._gcs_store, last_seg)
            threading.Thread(target=self._snapshot_loop, daemon=True,
                             name="gcs-snapshot").start()

        self.server = rpc.Server(
            self._handle,
            on_close=self._on_conn_close,
            host=config.head_host,
            port=config.head_port,
        )
        self.address = self.server.address
        # Warm the worker fork-server off-thread NOW: the first actor
        # burst should find it READY instead of falling back to direct
        # interpreter spawns (and spawn() must never block the dispatch
        # lock on the zygote's worker-module import).
        try:
            self._zygote().start_async()
        except Exception:
            pass
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="head-dispatch"
        )
        self._dispatcher.start()

        # Health plane: declare silent/partitioned nodes dead after the
        # grace, and reap worker records whose process never registered
        # (a spawn cast lost to a fault/crash would otherwise hold a
        # pool slot and its leased tasks forever).
        threading.Thread(target=self._health_loop, daemon=True,
                         name="head-health").start()

        # Resource-view syncer (reference: ray_syncer.h:83): replicate
        # version-stamped node resource views to every agent so state
        # reads and spillback pre-filtering never funnel through the
        # head's call path.
        from ray_tpu_torch._private.resource_syncer import ViewPublisher

        self._view_publisher = ViewPublisher(self)
        self._view_publisher.start()

        # Warm pool (reference: WorkerPool pre-starting idle language
        # workers, raylet/worker_pool.h:224): first tasks skip the
        # process-spawn + import latency. Opt-in via
        # _system_config={"worker_pool_prestart": N}.
        # TPU-capable and chipless pools are disjoint, so on a TPU node
        # part of the prestart budget goes to TPU-capable workers or the
        # first TPU task would always pay cold-start.
        n_prestart = min(config.worker_pool_prestart, self.max_pool_workers)
        n_gpu = min(n_prestart // 2, int(node_resources.get("GPU", 0))) \
            if node_resources.get("GPU", 0) else 0
        deferred_prestart = 0
        for i in range(n_prestart):
            try:
                if self.spawn_worker(self.node_id,
                                     gpu_capable=i < n_gpu) is None:
                    deferred_prestart += 1
            except Exception:
                traceback.print_exc()
                print("ray_tpu_torch: worker prestart failed; first tasks will "
                      "pay cold-start latency", file=sys.stderr)
                break
        if deferred_prestart:
            # Zygote was mid-warmup at init: finish the warm pool the
            # moment it is READY (prestart isn't dispatch-driven, so the
            # on_ready dispatch kick alone wouldn't respawn these).
            def _finish_prestart(n=deferred_prestart):
                zy = self._zygote()
                # Wake on SUCCESS or FAILURE: a failed warmup must fall
                # through to direct Popens in ~1 s, not sit out the
                # whole window (only success sets _ready).
                deadline = time.time() + 30
                while time.time() < deadline:
                    if zy._ready.is_set() or zy._failed:
                        break
                    time.sleep(0.1)
                for _ in range(n):
                    if self._shutdown:
                        return
                    # Dispatch may have spawned workers during warmup:
                    # re-check the pool cap per respawn so the deferred
                    # batch tops the pool up without overshooting it.
                    with self.lock:
                        if not self._can_spawn(self.node_id):
                            return
                    try:
                        self.spawn_worker(self.node_id)
                    except Exception:
                        return

            threading.Thread(target=_finish_prestart, daemon=True,
                             name="prestart-finish").start()

        # OOM protection: kill-and-retry busy workers under host memory
        # pressure (memory_monitor.py; reference memory_monitor.h:52).
        self.memory_monitor = None
        if config.memory_monitor_enabled and config.memory_usage_threshold < 1.0:
            from ray_tpu_torch._private.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(
                self,
                threshold=config.memory_usage_threshold,
                interval_s=config.memory_monitor_interval_s,
                soft_threshold=config.memory_pressure_threshold,
                hysteresis=config.memory_pressure_hysteresis,
            )
            self.memory_monitor.start()

        # Local-only usage summary (reference: usage_lib.py; no egress).
        try:
            from ray_tpu_torch._private.usage_stats import record_cluster_usage

            record_cluster_usage(self)
        except Exception:
            pass

    # ------------------------------------------------------------------
    # bootstrap helpers

    def _detect_resources(self, num_cpus, num_gpus, custom) -> dict[str, float]:
        res = dict(custom or {})
        res["CPU"] = float(num_cpus if num_cpus is not None else os.cpu_count() or 1)
        if num_gpus is not None:
            res["GPU"] = float(num_gpus)
        else:
            # All registered vendor managers contribute (TPU, GPU,
            # neuron_cores, plugins) — reference: resource_spec.py
            # resolving _private/accelerators at node start.
            from ray_tpu_torch.accelerators.accelerator import merge_detected_resources

            merge_detected_resources(res)
        try:
            import psutil

            res["memory"] = float(psutil.virtual_memory().total)
        except Exception:
            res["memory"] = 8e9
        shard = getattr(self, "shard", None)
        if shard is not None and shard.total > 1:
            # Each shard of a sharded head detects the SAME host memory;
            # divide so the cross-shard cluster_resources sum stays the
            # real host total instead of total × shards.
            res["memory"] /= shard.total
        res[f"node:{self.node_id if hasattr(self, 'node_id') else '127.0.0.1'}"] = 1.0
        return res

    # ------------------------------------------------------------------
    # cross-shard plumbing (every entry point no-ops at shards=1)

    def _new_worker_id(self) -> str:
        """Mint a worker id; in shard mode it is rejection-sampled so
        shard_for(worker_id) == this shard — the router can then land a
        re-dialing worker back on the shard that owns its record."""
        if self.shard is None:
            return "worker-" + uuid.uuid4().hex[:8]
        from ray_tpu_torch._private.head_shards import mint_for_shard

        return mint_for_shard("worker-", self.shard.index,
                              self.shard.total)

    def _client_cast(self, client_id: str, kind: str, body: dict) -> None:
        """Push to a client by id, wherever its connection lives: the
        local conn when we host it, else relayed through the shard bus
        (the owner of a forwarded actor task is on another shard).
        Safe under self.lock (cast_buffered only serializes+queues)."""
        c = self.clients.get(client_id)
        if c is not None:
            try:
                c.cast_buffered(kind, body)
            except rpc.ConnectionLost:
                pass
        elif self.shard is not None:
            self.shard.relay_client_cast(client_id, kind, body)

    def _dir_name_del(self, key: tuple, actor_id: str) -> None:
        """Release a name's directory claim (cast; guarded shard-side
        and directory-side against a successor that re-took it)."""
        if self.shard is not None:
            self.shard.bus_cast("dir_name_del", {
                "key": list(key), "actor_id": actor_id})

    def _locate_actor_shard(self, actor_id: str) -> "int | None":
        """Which shard hosts this actor? NEVER call under self.lock —
        it blocks on a bus round-trip."""
        cached = self._xshard_actors.get(actor_id)
        if cached is not None:
            return cached
        try:
            r = self.shard.bus_call("dir_find_actor",
                                    {"actor_id": actor_id})
        except rpc.RpcError:
            return None
        shard = r.get("shard") if r else None
        if shard is not None:
            self._xshard_actors[actor_id] = shard
        return shard

    def _xshard_track(self, ids) -> None:
        """Resolve ids this shard doesn't own before the waiter parks:
        ask the directory to fan a pin-free lookup out to the other
        shards, record the metas, and register a sealed-watch for the
        still-pending ones. Runs OUTSIDE self.lock (bus round-trip)."""
        with self.lock:
            unknown = [i for i in ids
                       if i not in self.objects
                       and i not in self._xshard_metas]
        if not unknown:
            return
        try:
            r = self.shard.bus_call("dir_obj_lookup", {
                "ids": unknown, "shard": self.shard.index})
        except rpc.RpcError:
            return
        metas = (r or {}).get("metas") or {}
        if metas:
            with self.lock:
                for oid, meta in metas.items():
                    self._xshard_meta_put(oid, meta)

    def _xshard_meta_put(self, oid: str, meta) -> None:
        """lock held. Record a bus-served meta (bounded FIFO)."""
        if oid not in self._xshard_metas:
            self._xshard_meta_fifo.append(oid)
            while len(self._xshard_meta_fifo) > 8192:
                self._xshard_metas.pop(self._xshard_meta_fifo.popleft(),
                                       None)
        self._xshard_metas[oid] = tuple(meta)

    def _xshard_ref_relay(self, op: str, ids, conn) -> None:
        """Forward ref/borrow ops on ids another shard owns (cast:
        refcounts tolerate async application; the owner's own live ref
        covers the gap)."""
        if not ids or self.shard is None:
            return
        self.shard.bus_cast("dir_obj_ref", {
            "op": op, "ids": list(ids),
            "client_id": conn.peer_info.get("client_id"),
            "shard": self.shard.index})

    def _xshard_fanout(self, kind: str, body: dict) -> list:
        """State-query merge: collect the other shards' replies for
        this read-only handler through the directory. NEVER under
        self.lock. `_shard_local` marks a fanned-out copy so the
        receiving shard answers locally instead of re-fanning."""
        if self.shard is None or body.get("_shard_local"):
            return []
        try:
            r = self.shard.bus_call(
                "dir_fanout",
                {"kind": kind, "body": dict(body, _shard_local=True)})
        except rpc.RpcError:
            return []
        return [x for x in (r or {}).get("replies", []) if x]

    # -- bus-served handlers (arrive from other shards / the directory)

    def _h_has_actor(self, body: dict, conn):
        with self.lock:
            return {"have": body["actor_id"] in self.actors}

    def _h_xshard_obj_lookup(self, body: dict, conn):
        """Pin-free meta service for another shard's consumers; pending
        ids register a sealed-watch pushed from _on_sealed."""
        watcher = body.get("watcher")
        metas = {}
        with self.lock:
            for oid in body["ids"]:
                e = self.objects.get(oid)
                if e is None:
                    continue
                if e.state in (SEALED, SPILLED) or e.inline is not None \
                        or e.owner_resident:
                    meta = self._meta_for(e, remote=True, pin=False)
                    if meta[0] != "lost":
                        metas[oid] = meta
                        continue
                if watcher is not None:
                    self._xshard_watch.setdefault(oid, set()).add(watcher)
        return {"metas": metas}

    def _h_xshard_sealed(self, body: dict, conn):
        with self.lock:
            self._xshard_meta_put(body["object_id"], body["meta"])
            self._on_sealed(body["object_id"])
        self.dispatch_event.set()
        return None

    def _h_xshard_obj_ref(self, body: dict, conn):
        client_id = body.get("client_id")
        op = body["op"]
        with self.lock:
            for oid in body["ids"]:
                e = self.objects.get(oid)
                if e is None:
                    continue
                if op == "add_ref":
                    e.refcount += 1
                elif op == "del_ref":
                    e.refcount -= 1
                    self._maybe_free(e)
                elif op == "add_borrow" and client_id:
                    e.borrowers.add(client_id)
                elif op == "del_borrow" and client_id:
                    e.borrowers.discard(client_id)
                    self._maybe_free(e)
        return None

    def _h_xshard_client_gone(self, body: dict, conn):
        """A client hosted on another shard disconnected: clear its
        borrower marks and direct-watcher registrations here."""
        client_id = body["client_id"]
        with self.lock:
            for e in self.objects.values():
                if client_id in e.borrowers:
                    e.borrowers.discard(client_id)
                    self._maybe_free(e)
            for a in self.actors.values():
                a.direct_watchers.discard(client_id)
        return None

    # --- head FT: write-behind snapshots --------------------------------

    def _mark_dirty(self) -> None:
        """Durable-table mutation: schedule a snapshot (no-op when
        persistence is disabled)."""
        self._snapshot_dirty = True

    def _wal_append(self, op: tuple) -> None:
        """lock held. Append one durable op (reference: the Redis store
        client persisting each table mutation, redis_store_client.h:111).
        Ops since the last snapshot replay on restart, so a kill -9
        between snapshots loses nothing."""
        if self._wal is not None:
            try:
                self._wal.append(op)
            except Exception:
                traceback.print_exc()

    def _snapshot_loop(self) -> None:
        while not self._shutdown:
            time.sleep(self.config.gcs_snapshot_interval_s)
            if self._snapshot_dirty:
                self._snapshot_now()

    def _snapshot_now(self) -> None:
        from ray_tpu_torch._private import gcs_persistence

        try:
            with self.lock:
                self._snapshot_dirty = False
                # Rotate FIRST: ops after this instant land in the new
                # segment, which the snapshot names — replay over it
                # reconstructs exactly the post-snapshot mutations.
                new_seg = self._wal.rotate() if self._wal else 0
                payload = gcs_persistence.build_payload(self)
                payload["wal_seg"] = new_seg
            # Pickle + fsync outside the lock: RPC handlers keep running.
            gcs_persistence.write_blob(payload, self._gcs_store)
            if self._wal is not None:
                # Snapshot durably subsumes the older segments.
                self._wal.prune_below(new_seg)
        except Exception:
            traceback.print_exc()

    def spawn_worker(self, node_id: str,
                     gpu_capable: bool = False) -> "WorkerRecord | None":
        """Start a pool worker on `node_id`: fork locally, or route the
        spawn through the node's agent connection for remote nodes
        (reference analogue: WorkerPool::StartWorkerProcess,
        raylet/worker_pool.h:224; remote = raylet-side pool).

        Returns None when the spawn is DEFERRED: the zygote fork-server
        is mid-warmup, so instead of a direct interpreter Popen (a burst
        of which thrashes a small box — 40 actor creations measured 12 s
        as a Popen storm vs ~1 s deferred-then-forked) the caller should
        retry on the next dispatch pass; zygote.on_ready sets
        dispatch_event so that pass happens immediately.

        ``gpu_capable`` workers keep the parent's CUDA visibility so
        they can take GPU leases (the worker narrows it to the lease);
        chipless pool workers spawn with every device hidden
        (hermetic.hide_gpus, ``CUDA_VISIBLE_DEVICES=""``) — CUDA fixes
        its visible set when it initialises, so the pin must be in the
        environment before the worker's first CUDA call."""
        if node_id != self.node_id:
            return self._spawn_remote_worker(node_id, gpu_capable)
        worker_id = self._new_worker_id()
        env = dict(os.environ)
        env["RAY_TPU_WORKER_ID"] = worker_id
        env["RAY_TPU_HEAD"] = f"{self.address[0]}:{self.address[1]}"
        env["RAY_TPU_SHM"] = f"{self.shm_name}:{self.config.object_store_memory}"
        env["RAY_TPU_NODE_ID"] = node_id
        env["RAY_TPU_SESSION_DIR"] = self.session_dir
        # Workers resolve functions pickled by reference (module+name), so
        # they need the driver's import roots (reference analogue: workers
        # inherit the driver's sys.path / working_dir runtime env).
        extra = [p for p in sys.path if p and os.path.isdir(p)]
        existing = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = os.pathsep.join(extra + ([existing] if existing else []))
        if not gpu_capable:
            from ray_tpu_torch._private.hermetic import hide_gpus

            hide_gpus(env)
        logs = os.path.join(self.session_dir, "logs")
        os.makedirs(logs, exist_ok=True)
        proc = None
        pid = None
        if not gpu_capable:
            # Fork from the pre-imported zygote (~5 ms) instead of a
            # fresh interpreter (~300 ms+): reference analogue is the
            # raylet's warm worker pool (worker_pool.h:224).
            zy = self._zygote()
            pid = zy.spawn(
                {k: env[k] for k in ("RAY_TPU_WORKER_ID", "RAY_TPU_HEAD",
                                     "RAY_TPU_SHM", "RAY_TPU_NODE_ID",
                                     "RAY_TPU_SESSION_DIR")},
                os.path.join(logs, f"{worker_id}.log"))
            if pid is None and zy.deferral_active():
                return None  # warmup imminent; retry next dispatch pass
        if pid is None:
            with open(os.path.join(logs, f"{worker_id}.log"), "ab") as out:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch._private.worker"],
                    env=env,
                    stdout=out,
                    stderr=subprocess.STDOUT,
                    cwd=os.getcwd(),
                )  # child keeps its inherited fd; don't leak one per spawn
        rec = WorkerRecord(worker_id, node_id, proc, gpu_capable)
        if pid is not None:
            rec.pid = pid
            rec.zygote = True
        # Best-effort cgroup v2 isolation: workers land in the node's
        # application slice (reference: cgroup_setup.h; no-op without a
        # writable cgroupfs).
        from ray_tpu_torch._private.cgroup import CgroupSetup

        CgroupSetup.get_or_create(self, self.node_id).add_worker_process(
            proc.pid if proc is not None else pid)
        with self.lock:
            self.workers[worker_id] = rec
        return rec

    def _zygote(self):
        """Lazily-started fork-server for chipless local workers."""
        zy = getattr(self, "_zygote_client", None)
        if zy is None:
            from ray_tpu_torch._private.hermetic import hide_gpus
            from ray_tpu_torch._private.zygote import ZygoteClient

            env = dict(os.environ)
            env["RAY_TPU_HEAD"] = f"{self.address[0]}:{self.address[1]}"
            extra = [p for p in sys.path if p and os.path.isdir(p)]
            existing = env.get("PYTHONPATH", "")
            env["PYTHONPATH"] = os.pathsep.join(
                extra + ([existing] if existing else []))
            hide_gpus(env)
            zy = self._zygote_client = ZygoteClient(
                env, os.path.join(self.session_dir, "logs"))
            # Deferred spawns retry the moment warmup lands (or fails —
            # then they fall back to direct Popens on the next pass).
            zy.on_ready = self.dispatch_event.set
        return zy

    def _spawn_remote_worker(self, node_id: str,
                             gpu_capable: bool = False) -> WorkerRecord:
        """Ask the node's agent to fork a worker (reference: raylet spawns
        its own workers after the GCS-side lease decision)."""
        worker_id = self._new_worker_id()
        rec = WorkerRecord(worker_id, node_id, None, gpu_capable)
        with self.lock:
            self.workers[worker_id] = rec
        body = {
            "worker_id": worker_id,
            "head": f"{self.address[0]}:{self.address[1]}",
            "node_id": node_id,
            "gpu_capable": gpu_capable,
        }
        # A transient send failure (injected reset, agent mid-re-join)
        # re-resolves the agent connection and retries once — without
        # sleeping: callers may hold the dispatch lock. A spawn that is
        # lost anyway is recovered by the health loop's ghost reaper
        # (the record never registers and is reaped after the register
        # timeout, requeueing its leased tasks).
        last_agent = None
        for _ in range(2):
            with self.lock:
                agent = self.node_agents.get(node_id)
            if agent is None or agent is last_agent:
                break  # node gone (death handling owns rec) or no new conn
            try:
                agent.cast("spawn_worker", body)
                break
            except rpc.ConnectionLost:
                last_agent = agent
        return rec

    # ------------------------------------------------------------------
    # RPC handling

    def _handle(self, kind: str, body: dict, conn: rpc.Connection):
        method = getattr(self, f"_h_{kind}", None)
        if method is None:
            raise rpc.RpcError(f"unknown message kind {kind!r}")
        return method(body, conn)

    def _on_conn_close(self, conn: rpc.Connection) -> None:
        info = conn.peer_info
        node_id = info.get("node_agent_for")
        if node_id is not None:
            with self.lock:
                if self.node_agents.get(node_id) is not conn:
                    return  # stale connection of a re-joined node
            self._handle_node_death(node_id)
            return
        client_id = info.get("client_id")
        if client_id is None:
            return
        if self.shard is not None:
            # Other shards may hold this client's borrows / direct
            # watches (cross-shard actor calls): broadcast the death.
            self.shard.bus_cast("dir_client_gone", {
                "client_id": client_id, "shard": self.shard.index})
        with self.lock:
            self.clients.pop(client_id, None)
            self.client_owner_addrs.pop(client_id, None)
            self.rpc_reports.pop(client_id, None)
            # A dead owner's census dies with it (its refs are gone);
            # its leak-trend windows and callsite suspects clear too.
            if self.object_census.pop(client_id, None) is not None:
                for key in [k for k in self._census_history
                            if k[0] == client_id]:
                    del self._census_history[key]
                for key in [k for k in self.leak_suspects
                            if self.leak_suspects[k].get("owner")
                            == client_id]:
                    del self.leak_suspects[key]
            # A dead owner's worker leases end now (its direct pushes
            # died with it; the workers must rejoin the pool).
            for w in self.workers.values():
                if w.leased_to == client_id:
                    self._end_lease(w)
            for a in self.actors.values():
                a.direct_watchers.discard(client_id)
            rec = self.workers.get(client_id)
            # Borrower death releases its borrows (reference:
            # reference_count.h WaitForRefRemoved resolves when the
            # borrower dies), and the owner's registration count dies
            # with the owner (its del_ref may never arrive). Payloads
            # live in head/agent arenas, so objects survive their
            # owner's death for remaining borrowers/pins and free when
            # the last of those drops.
            affected = []
            for e in self.objects.values():
                changed = False
                held = e.pin_holders.pop(client_id, 0)
                if held:
                    # Reap the dead client's read pins (zero-copy gets
                    # hold them until arrays die — which never comes).
                    e.read_pins = max(0, e.read_pins - held)
                    changed = True
                if client_id in e.borrowers:
                    e.borrowers.discard(client_id)
                    changed = True
                if e.owner_id == client_id and e.refcount > 0:
                    e.refcount -= 1
                    changed = True
                if (e.owner_resident and e.owner_id == client_id
                        and e.inline is None and e.state == SEALED):
                    # The value lived in the owner's process: it is gone
                    # (reference: OwnerDiedError fate-sharing). Remaining
                    # borrowers' fetches raise ObjectLostError.
                    e.state = LOST
                    changed = True
                if changed:
                    affected.append(e)
            # In-flight results destined for the dead owner: the direct
            # seal (if any) died with it and no owner_sealed will ever
            # confirm. Error-seal still-CREATING entries someone else
            # still references so their gets resolve instead of hanging;
            # unreferenced ones fall to _maybe_free below. refcount is
            # restored to 0 after sealing (the seal helper re-registers
            # 1, but this owner is gone and will never del_ref) so the
            # entry frees when the last borrower/pin drops.
            orphaned = [e.object_id for e in self.objects.values()
                        if e.owner_id == client_id and e.state == CREATING
                        and (e.borrowers or e.task_pins > 0
                             or e.container_pins > 0 or e.refcount > 0)]
            for oid in orphaned:
                self._seal_error(
                    oid,
                    f"OwnerDiedError: owner {client_id} died before "
                    "the value was delivered", "object_lost")
                e = self.objects.get(oid)
                if e is not None:
                    e.refcount = 0
            for e in affected:
                self._maybe_free(e)
        if rec is not None:
            self._handle_worker_death(rec)

    def _handle_node_death(self, node_id: str) -> None:
        """Agent connection dropped OR the node went silent past the
        health grace: the whole node is gone (reference: GcsNodeManager
        node-death path + health checks, gcs_health_check_manager.h:45
        — the TCP session is the lease, heartbeats cover partitions).
        Workers of the node are declared dead so their leased tasks
        requeue elsewhere; the node leaves the schedulable set; objects
        that lived only there reconstruct through lineage or error-seal
        with provenance so waiters raise instead of hanging."""
        with self.lock:
            last_seen = self._agent_last_seen.get(node_id)
            self.node_agents.pop(node_id, None)
            self._agent_last_seen.pop(node_id, None)
            self.node_transfer_addrs.pop(node_id, None)
            self.node_bulk_addrs.pop(node_id, None)
            self.node_store_info.pop(node_id, None)
            self.clock_offsets.pop(node_id, None)
            self.rpc_reports.pop(f"agent:{node_id}", None)
            self.scheduler.mark_dead(node_id)
            doomed = [r for r in self.workers.values()
                      if r.node_id == node_id]
            # Node-death forensics: the node gets the same post-mortem
            # treatment as a worker — a classified report ("presumed
            # dead: heartbeat age, tasks in flight") in the crash table,
            # carried into every error this death seals.
            age = (time.time() - last_seen) if last_seen else None
            node_detail = (
                "node presumed dead: last heartbeat "
                + (f"{age:.1f}s ago" if age is not None
                   else "never received")
                + f", {sum(len(r.inflight) for r in doomed)} task(s) "
                  f"in flight on it")
            self._record_crash({
                "worker_id": f"node:{node_id}", "node_id": node_id,
                "pid": None, "exit_type": "node_death",
                "exit_detail": node_detail,
                "workers_lost": [r.worker_id for r in doomed],
                "source": "head", "ts": time.time()}, count=False)
            for rec in doomed:
                if rec.expected_exit is None:
                    rec.expected_exit = ("node_death", node_detail)
            # P2P payloads hosted by the dead node are gone; mark the
            # entries lost so fetches trigger lineage reconstruction
            # instead of hanging (reference: object_recovery_manager.h).
            # Snapshot first: _maybe_reconstruct INSERTS entries for
            # freed dependency ids, which would blow up an iteration
            # over the live dict.
            lost = []
            for e in self.objects.values():
                e.replicas.pop(node_id, None)
                if e.location == node_id and e.state == SEALED:
                    lost.append(e)
            for e in lost:
                if e.replicas:
                    # Promote a replica to primary instead of losing
                    # the object (spanning-tree copies ARE recovery).
                    nid, (off, _sz) = next(iter(e.replicas.items()))
                    del e.replicas[nid]
                    e.location, e.remote_offset = nid, off
                    continue
                if e.spill_path:
                    # The primary died but a spill copy survives in
                    # external storage: serve via restore instead of
                    # declaring the object lost.
                    e.state = SPILLED
                    e.location = None
                    e.remote_offset = None
                    continue
                e.state = LOST
                e.location = None
                if not self._maybe_reconstruct(e.object_id):
                    # Unreconstructable (put() data has no lineage, or
                    # the budget is exhausted): waiters must raise, not
                    # hang — seal an ObjectLostError that names the
                    # dead node and the owner.
                    self._seal_error(
                        e.object_id,
                        f"ObjectLostError: object {e.object_id} was "
                        f"lost with node {node_id} and has no lineage "
                        f"to reconstruct from ({node_detail})",
                        "object_lost",
                        provenance={"object_id": e.object_id,
                                    "node_id": node_id,
                                    "owner_id": e.owner_id})
        for rec in doomed:
            # The agent died but its worker processes may be orphaned
            # alive and still connected: tell them to exit so ghosts
            # don't keep computing against a node the scheduler already
            # buried (their in-flight tasks requeue below either way).
            if rec.conn is not None:
                try:
                    rec.conn.cast("kill", {})
                except rpc.ConnectionLost:
                    pass
            self._handle_worker_death(rec)
        self.dispatch_event.set()

    # --- health plane (reference: gcs_health_check_manager.h:45) ------

    def _h_agent_heartbeat(self, body: dict, conn):
        """Agent liveness beacon (cast every health_check_period_s).
        Piggybacks the node's estimated clock offset (timeline
        alignment) and the agent's rpc counter snapshot (cluster-wide
        rpc_counters aggregation) — observability rides the beacon that
        already flows instead of new frames."""
        with self.lock:
            nid = body.get("node_id")
            if nid in self.node_agents:
                self._agent_last_seen[nid] = time.time()
                if body.get("clock_offset") is not None:
                    self.clock_offsets[nid] = float(body["clock_offset"])
                if body.get("rpc") is not None:
                    self.rpc_reports[f"agent:{nid}"] = {
                        "counters": body["rpc"], "ts": time.time()}
                if body.get("profile") is not None:
                    self._profile_intake(nid, body["profile"])
        # Telemetry history: the agent's tiny node-health sample (load
        # average, available memory) becomes per-node gauge series —
        # `ray-tpu top`'s node rows and the dashboard sparklines read
        # these. Outside self.lock; the store has its own.
        sys_sample = body.get("sys")
        if sys_sample and self.tsdb is not None and nid:
            now = time.time()
            labels = {"node_id": nid}
            for field, metric in (
                    ("load1", "ray_tpu_node_load1"),
                    ("mem_available_bytes",
                     "ray_tpu_node_mem_available_bytes"),
                    ("mem_total_bytes", "ray_tpu_node_mem_total_bytes")):
                if sys_sample.get(field) is not None:
                    self.tsdb.ingest(metric, labels, sys_sample[field],
                                     now, "gauge")
        return None

    def _h_clock_sync(self, body: dict, conn):
        """NTP-style probe target: the agent records t0/t1 around this
        call and estimates its node's offset as (t0+t1)/2 - t_head
        (reference analogue: the profiling timeline's cross-node clock
        alignment in the GCS usage/metrics plumbing)."""
        return {"t_head": time.time()}

    def _h_rpc_report(self, body: dict, conn):
        """A runtime's amortized counter snapshot (and buffered chaos
        events) — the cluster-wide half of util.metrics.rpc_counters."""
        cid = body.get("client_id") or conn.peer_info.get("client_id")
        with self.lock:
            if cid:
                self.rpc_reports[cid] = {
                    "counters": body.get("counters") or {},
                    "type": body.get("client_type"),
                    "ts": time.time()}
                if body.get("census") is not None:
                    self._census_intake(cid, body["census"])
                if body.get("profile") is not None:
                    prof = body["profile"]
                    # Node attribution: workers resolve through their
                    # registration record; drivers (and anything else
                    # without one) count against the head's node — in
                    # this runtime the driver process runs there.
                    rec = self.workers.get(prof.get("ident") or "")
                    node = rec.node_id if rec is not None else self.node_id
                    self._profile_intake(node, prof)
        if body.get("chaos_events"):
            self.task_events.extend(body["chaos_events"])
        if body.get("spans"):
            self.task_events.extend(body["spans"])
            self.traces.intake(body["spans"])
        if body.get("spans_dropped"):
            self.traces.note_dropped(body["spans_dropped"])
        return None

    def _census_intake(self, cid: str, census: dict) -> None:
        """lock held. Store an owner's piggybacked census summary and
        advance the leak detector's per-callsite trend windows — one
        sample per REPORT, so "grew across N windows" means N
        consecutive reports, independent of sweep cadence."""
        now = time.time()
        census = dict(census)
        census["ts"] = now
        self.object_census[cid] = census
        groups = census.get("groups") or {}
        keep = max(3, int(self.config.object_leak_windows) + 1)
        for site, g in groups.items():
            if site == "(other callsites)":
                continue
            hist = self._census_history.get((cid, site))
            if hist is None:
                hist = self._census_history[(cid, site)] = deque(
                    maxlen=keep)
            hist.append((now, int(g.get("bytes", 0)),
                         int(g.get("count", 0))))
        # Callsites that vanished from this owner's report released
        # everything: their trend (and any standing suspect) clears.
        for key in [k for k in self._census_history
                    if k[0] == cid and k[1] not in groups]:
            del self._census_history[key]
            self.leak_suspects.pop(f"growth:{key[0]}:{key[1]}", None)

    def _census_attribution(self) -> dict:
        """lock held. Per-object callsite attribution merged from every
        owner's census sample ids: oid -> (owner_client, callsite,
        kind-ish record). Bounded by clients x report_groups x
        sample_ids."""
        out: dict = {}
        for cid, rep in self.object_census.items():
            for site, g in (rep.get("groups") or {}).items():
                for oid in g.get("sample_ids") or ():
                    out.setdefault(oid, (cid, site))
        return out

    # --- continuous profiling plane (profplane.py head side) ----------

    def _profile_intake(self, node: str, prof: dict) -> None:
        """lock held. Merge one process's sampler window summary into
        the bounded cluster profile table. Key = (node, role, window
        index): two workers on one node in the same window MERGE — the
        table answers "where does this node+role burn CPU", the sidecar
        next to the .beacon answers the per-process question."""
        from ray_tpu_torch._private import profplane

        role = prof.get("role") or "worker"
        end = float(prof.get("end") or time.time())
        win = int(end // max(0.5, self.config.profiling_window_s))
        key = (node, role, win)
        rec = self.cluster_profile.get(key)
        if rec is None:
            rec = self.cluster_profile[key] = {
                "node": node, "role": role, "window": win,
                "start": float(prof.get("start") or end), "end": end,
                "samples": 0, "sample_cost_s": 0.0, "dropped": 0,
                "pids": [], "folded": {}}
            self._profile_fifo.append(key)
            self.profile_stats["windows_total"] += 1
        rec["start"] = min(rec["start"], float(prof.get("start") or end))
        rec["end"] = max(rec["end"], end)
        rec["samples"] += int(prof.get("samples") or 0)
        rec["sample_cost_s"] += float(prof.get("sample_cost_s") or 0.0)
        rec["dropped"] += int(prof.get("dropped") or 0)
        pid = prof.get("pid")
        if pid is not None and pid not in rec["pids"]:
            rec["pids"].append(pid)
        profplane.merge_folded(rec["folded"], prof.get("folded") or {},
                               cap=self.config.profiling_table_max)
        gil = prof.get("gil_exemplar")
        if gil:
            self.profile_stats["gil_exemplars"] += 1
            self._gil_exemplars.append(
                {**gil, "node": node, "role": role, "window": win,
                 "ident": prof.get("ident"), "ts": end})
        # FIFO eviction, skipping pinned windows (phase-regression
        # exemplars survive until the pin set itself is rotated).
        cap = max(8, self.config.cluster_profile_max_windows)
        while len(self.cluster_profile) > cap and self._profile_fifo:
            victim = self._profile_fifo.popleft()
            if victim in self._pinned_windows:
                self._profile_fifo.append(victim)
                if all(k in self._pinned_windows
                       for k in self._profile_fifo):
                    break  # everything pinned: stop, table stays at cap
                continue
            if self.cluster_profile.pop(victim, None) is not None:
                self.profile_stats["dropped_windows"] += 1

    def _profile_phase_sweep(self, now: float) -> None:
        """lock held. Phase-regression sentinel: once per health tick,
        read the cumulative queue_wait/dispatch histograms; if a
        phase's p95 drifted past profiling_regression_factor x the
        trailing median, PIN the head/shard flamegraph windows covering
        this tick so the evidence outlives FIFO eviction."""
        hists = self.task_events.hist_snapshot()
        win = int(now // max(0.5, self.config.profiling_window_s))
        for phase in ("queue_wait", "dispatch"):
            h = hists.get(phase)
            if not h or h.get("count", 0) < \
                    self.config.profiling_regression_min_count:
                continue
            # Only sample when new observations landed since last tick
            # (a quiet cluster must not re-pin on a stale p95 forever).
            if h["count"] == self._phase_prev_counts.get(phase):
                continue
            self._phase_prev_counts[phase] = h["count"]
            p95 = _hist_quantile_dict(h, 0.95)
            if p95 is None:
                continue
            hist = self._phase_p95_hist.setdefault(phase, deque(maxlen=32))
            if len(hist) >= 4:
                med = sorted(hist)[len(hist) // 2]
                if med > 0 and p95 > med * \
                        self.config.profiling_regression_factor:
                    for key in list(self.cluster_profile):
                        if key[1] in ("head", "shard") and \
                                key[2] in (win, win - 1):
                            if key not in self._pinned_windows:
                                self._pinned_windows.add(key)
                                self.profile_stats["pinned"] += 1
                                self.cluster_profile[key]["pinned"] = {
                                    "phase": phase, "p95": p95,
                                    "trailing_median": med, "ts": now}
            hist.append(p95)
        # Rotate the pin set: pins on evicted-from-fifo... windows whose
        # record aged out of the table entirely have nothing to protect.
        self._pinned_windows &= set(self.cluster_profile)

    # --- telemetry history + SLO alerting (tsdb.py / alertplane.py) ---

    def _telemetry_sweep(self, now: float) -> None:
        """Health-tick half of the telemetry plane: (1) every
        tsdb_sample_interval_s, snapshot this head's core tables into
        the time-series store (derived phase p95/p99 gauges included —
        the alert rules' latency SLOs read these, not raw histograms);
        (2) run the alert-rule sweep (its own cadence gate). NEVER
        called under self.lock — the snapshot takes it briefly."""
        if self.tsdb is None:
            return
        if now - self._last_tsdb_sample >= \
                self.config.tsdb_sample_interval_s:
            self._last_tsdb_sample = now
            with self.lock:
                counters = dict(self.stats)
                shed = dict(self.shed_counts)
                deaths = dict(self.death_counts)
                hists = self.task_events.hist_snapshot()
                gauges = {
                    "workers_alive": sum(
                        1 for r in self.workers.values()
                        if r.conn is not None),
                    "actors_alive": sum(
                        1 for a in self.actors.values()
                        if a.state == "ALIVE"),
                    "nodes_alive": 1 + len(self.node_agents),
                    "tasks_pending": sum(
                        len(q) for q in self.ready_queues.values()),
                    "object_store_num_objects": len(self.objects),
                    "object_store_used_bytes": self.arena.in_use,
                    "mem_pressured_nodes": len(self.pressured_nodes),
                    "admission_pending_total": self.pending_total,
                }
                head_frames = sum(
                    ((r.get("counters") or {}).get("head") or {})
                    .get("frames_sent", 0)
                    for r in self.rpc_reports.values())
            ing = self.tsdb.ingest
            # Sharded head: every shard samples its OWN tables, and two
            # shards' cumulative counters must stay distinct series —
            # merging them into one would interleave unrelated counter
            # values. The shard label is bounded by head_shards; a
            # single-process head keeps the unlabelled pre-shard shape.
            base = {} if self.shard is None \
                else {"shard": str(self.shard.index)}
            for name, v in counters.items():
                ing(f"ray_tpu_{name}_total", base or None, v, now,
                    "counter")
            for name, v in gauges.items():
                ing(f"ray_tpu_{name}", base or None, v, now, "gauge")
            ing("ray_tpu_rpc_head_frames_total", base or None,
                head_frames, now, "counter")
            for where, v in shed.items():
                ing("ray_tpu_tasks_shed_total",
                    {**base, "where": where}, v, now, "counter")
            for reason, v in deaths.items():
                ing("ray_tpu_worker_deaths_total",
                    {**base, "reason": reason}, v, now, "counter")
            for phase, h in hists.items():
                for q, metric in ((0.95, "ray_tpu_phase_p95_seconds"),
                                  (0.99, "ray_tpu_phase_p99_seconds")):
                    val = _hist_quantile_dict(h, q)
                    if val is not None:
                        ing(metric, {**base, "phase": phase}, val,
                            now, "gauge")
            # The head's own host is a node too: self-sample load/mem
            # so `ray-tpu top` has node rows even in-process, where no
            # node agent exists to piggyback them on a heartbeat.
            from ray_tpu_torch._private.node_agent import _sys_sample

            sys_sample = _sys_sample()
            labels = {"node_id": self.node_id}
            for field, metric in (
                    ("load1", "ray_tpu_node_load1"),
                    ("mem_available_bytes",
                     "ray_tpu_node_mem_available_bytes"),
                    ("mem_total_bytes",
                     "ray_tpu_node_mem_total_bytes")):
                if sys_sample.get(field) is not None:
                    ing(metric, labels, sys_sample[field], now, "gauge")
        if self.alerts is not None:
            self.alerts.evaluate(self.tsdb, now,
                                 context_fn=self._alert_context)
            self.alerts.note_resolved()

    def _alert_context(self, rec: dict) -> dict:
        """Cross-plane join, run once when an alert FIRES: pin the
        evidence an operator needs — retained trace exemplar ids,
        profile windows overlapping the alert window, and crash
        reports in it — onto the alert record before
        it ships to sinks."""
        fired = rec.get("fired_at") or time.time()
        rule = rec.get("rule") or {}
        win = float(rule.get("fast_window_s")
                    or rule.get("window_s") or 300.0)
        start = fired - win
        with self.lock:
            exemplar_ids = (self.traces.stats()
                            .get("exemplar_ids") or {})
            profile_windows = [
                {"node": n, "role": r, "window": w,
                 "start": round(pw["start"], 3),
                 "end": round(pw["end"], 3)}
                for (n, r, w), pw in self.cluster_profile.items()
                if pw["end"] >= start and pw["start"] <= fired][-8:]
            crash_keys = ("worker_id", "node_id", "exit_type",
                          "reason", "ts")
            crashes = [
                {k: r.get(k) for k in crash_keys if r.get(k) is not None}
                for r in (self.crash_reports.get(w)
                          for w in self._crash_fifo)
                if r is not None and start <= (r.get("ts") or 0) <= fired
            ][-8:]
        return {
            "trace_exemplars": sorted(set(exemplar_ids.values()))[:8],
            "exemplar_kinds": dict(exemplar_ids),
            "profile_windows": profile_windows,
            "crash_reports": crashes,
        }

    def _health_loop(self) -> None:
        period = max(0.1, self.config.health_check_period_s)
        while not self._shutdown:
            time.sleep(period)
            try:
                self._health_check_once()
            except Exception:
                traceback.print_exc()

    def _health_check_once(self) -> None:
        now = time.time()
        grace = self.config.health_check_timeout_s
        self._overload_sweep(now)
        if self._parked_waiters:
            self._relay_sweep()
        if (now - self._last_leak_sweep
                >= self.config.object_leak_sweep_interval_s):
            self._last_leak_sweep = now
            self._leak_sweep(now)
        # Profiling plane: the head/shard role is in-process — its
        # sampler window merges straight into cluster_profile on the
        # health tick (no rpc), and the same tick runs the
        # phase-regression sentinel that pins suspect windows.
        from ray_tpu_torch._private import profplane

        self_prof = profplane.report_summary()
        with self.lock:
            if self_prof is not None:
                self._profile_intake(self.node_id, self_prof)
            try:
                self._profile_phase_sweep(now)
            except Exception:
                pass  # sentinel is observe-only; never wedge health
        # Telemetry plane: sample the head's own runtime stats into the
        # tsdb and run the alert-rule sweep — both amortized on this
        # tick, both observe-only (never wedge health). Runs OUTSIDE
        # self.lock: the sweep takes it briefly for the snapshot and
        # the alert context join, and the engine has its own lock.
        try:
            self._telemetry_sweep(now)
        except Exception:
            pass
        with self.lock:
            silent = [
                (nid, self.node_agents.get(nid))
                for nid, seen in self._agent_last_seen.items()
                if now - seen > grace and nid in self.node_agents
            ]
            # Worker records whose process never registered within the
            # register timeout (spawn cast lost, interpreter crashed at
            # boot): reap them so their pool slot frees and any leased
            # tasks requeue — otherwise a single lost spawn_worker
            # wedges its shape's dispatch queue forever.
            ghosts = [
                r for r in self.workers.values()
                if r.conn is None and not r.ready
                and now - r.started_at > self.config.worker_register_timeout_s
            ]
            # Direct-plane lease safety net: the owner returns leases on
            # expiry itself; a crashed/partitioned owner can't, so the
            # head reaps past deadline + grace or its worker (and
            # allocation) would be pinned forever.
            for r in self.workers.values():
                if (r.leased_to is not None
                        and now > r.lease_deadline + 2.0):
                    self._end_lease(r, revoke=True)
        for nid, conn in silent:
            print(f"ray_tpu_torch head: node {nid} silent for >{grace:.0f}s — "
                  f"declaring it dead", file=sys.stderr)
            self._handle_node_death(nid)
            if conn is not None:
                # Close AFTER the death handling: _on_conn_close sees
                # the agent table already cleared and no-ops, and a
                # healed partition re-joins through register_node.
                try:
                    conn.close()
                except Exception:
                    pass
        for rec in ghosts:
            print(f"ray_tpu_torch head: worker {rec.worker_id} never registered "
                  f"within {self.config.worker_register_timeout_s:.0f}s — "
                  f"reaping", file=sys.stderr)
            if rec.expected_exit is None:
                rec.expected_exit = (
                    "spawn_failure",
                    f"worker never registered within "
                    f"{self.config.worker_register_timeout_s:.0f}s "
                    f"(lost spawn cast or interpreter crash at boot)")
            self._handle_worker_death(rec)

    def _overload_sweep(self, now: float) -> None:
        """Overload-protection housekeeping, once per health tick:
        (1) expire stale REMOTE pressure entries whose agent stopped
        refreshing (a lost recovery cast must not wedge a node out of
        the scheduler forever); (2) shed deadline-expired tasks still
        parked in queues the pop-time checks haven't visited (dep-
        blocked, unplaceable ready queues, dep-parked actor calls);
        (3) signal in-flight expiry to workers via the existing cancel
        cast (queued-not-started work drops at pickup)."""
        cancel_casts: list = []
        stale_after = max(5.0, 3.0 * self.config.memory_monitor_interval_s)
        with self.lock:
            for nid, info in list(self.pressured_nodes.items()):
                if info.get("remote") and now - info.get("ts", 0) > stale_after:
                    self.pressured_nodes.pop(nid, None)
                    self.task_events.append({
                        "event": "overload", "kind": "mem_recovered",
                        "node_id": nid, "stale": True, "ts": now})
                    self.dispatch_event.set()
            if not self._any_deadlines:
                return
            saw_deadline = False
            # Ready queues (incl. the scan queue): tasks a full cluster
            # keeps parked still expire on time.
            for key in list(self.ready_queues):
                q = self.ready_queues.get(key)
                if q is None:
                    continue
                expired = [s for s in q if self._expired(s, now)]
                saw_deadline = saw_deadline or any(s.deadline for s in q)
                for s in expired:
                    q.remove(s)
                    self._shed_expired(s, "head_queue")
                if not q:
                    self.ready_queues.pop(key, None)
            # Dep-blocked tasks register under EVERY unready dep: drop
            # expired specs from all lists before sealing (dedup by id).
            doomed: dict[str, TaskSpec] = {}
            for specs in self.dep_blocked.values():
                for s in specs:
                    if self._expired(s, now):
                        doomed[s.task_id] = s
                    elif s.deadline:
                        saw_deadline = True
            for s in doomed.values():
                for oid, lst in list(self.dep_blocked.items()):
                    if s in lst:
                        lst.remove(s)
                        if not lst:
                            del self.dep_blocked[oid]
                self._shed_expired(s, "dep_blocked")
            # Dep-parked / not-yet-alive actor calls.
            for actor in self.actors.values():
                expired = [s for s in actor.pending
                           if self._expired(s, now)]
                saw_deadline = saw_deadline or any(
                    s.deadline for s in actor.pending)
                for s in expired:
                    actor.pending.remove(s)
                    self._shed_expired(s, "actor_queue")
            # In-flight expiry: reuse the existing cancel cast — the
            # worker drops a queued-not-started task at pickup with the
            # worker_queue shed path; running tasks are not interrupted
            # (same contract as ray_tpu_torch.cancel).
            for rec in self.workers.values():
                for spec in list(rec.inflight.values()):
                    if spec.deadline:
                        saw_deadline = True
                    if (self._expired(spec, now)
                            and spec.task_id not in self._expiry_signalled
                            and rec.conn is not None):
                        self._expiry_signalled.add(spec.task_id)
                        cancel_casts.append((rec.conn, spec.task_id))
            if len(self._expiry_signalled) > 65536:
                self._expiry_signalled.clear()  # bound (re-signal is ok)
            if not saw_deadline and not cancel_casts:
                self._any_deadlines = False
        for conn, task_id in cancel_casts:
            try:
                conn.cast("cancel", {"task_id": task_id})
            except rpc.ConnectionLost:
                pass

    # --- object-plane leak detector (observe-only) --------------------

    def _leak_sweep(self, now: float) -> None:
        """Flag suspect object groups with trend data — never frees or
        kills anything (reference analogue: `ray memory`'s leak-hunting
        workflow, here automated). Three detectors:

        (1) growth — a (owner, callsite) whose live bytes grew strictly
            monotonically across object_leak_windows consecutive census
            reports (the classic append-refs-in-a-loop leak);
        (2) unawaited — objects SEALED longer than object_leak_ttl_s
            ago that nothing ever fetched (head-store entries by their
            read counter; owner-resident groups by the census's
            unawaited count + age);
        (3) orphan borrows — entries whose owner-side ref died
            (refcount <= 0) but borrowers still pin them.

        Suspects keep first_seen across sweeps; entries that stop
        matching clear. Surfaced via memory_summary / `ray-tpu memory
        --leaks` / the ray_tpu_object_leak_suspects gauge."""
        windows = max(2, int(self.config.object_leak_windows))
        ttl = float(self.config.object_leak_ttl_s)
        seen: set = set()
        with self.lock:
            # (1) monotonic per-callsite growth across report windows.
            for (cid, site), hist in self._census_history.items():
                if len(hist) < windows:
                    continue
                tail = list(hist)[-windows:]
                growing = all(tail[i][1] < tail[i + 1][1]
                              for i in range(len(tail) - 1))
                key = f"growth:{cid}:{site}"
                if growing and tail[-1][1] > 0:
                    seen.add(key)
                    rec = self.leak_suspects.get(key)
                    if rec is None:
                        rec = self.leak_suspects[key] = {
                            "kind": "growing_callsite", "callsite": site,
                            "owner": cid, "first_seen": now}
                    rec.update({
                        "last_seen": now,
                        "bytes": tail[-1][1], "count": tail[-1][2],
                        "trend_bytes": [b for _t, b, _c in tail],
                        "trend_counts": [c for _t, _b, c in tail],
                        "windows": len(tail),
                        "detail": (f"live bytes grew {tail[0][1]} -> "
                                   f"{tail[-1][1]} across {len(tail)} "
                                   f"report windows"),
                    })
            # (2a) owner-resident / census view: callsite groups whose
            # oldest member outlived the TTL with unawaited refs.
            for cid, rep in self.object_census.items():
                for site, g in (rep.get("groups") or {}).items():
                    if (g.get("unawaited", 0) > 0
                            and g.get("oldest_age_s", 0) > ttl):
                        key = f"unawaited_cs:{cid}:{site}"
                        seen.add(key)
                        rec = self.leak_suspects.get(key)
                        if rec is None:
                            rec = self.leak_suspects[key] = {
                                "kind": "unawaited_callsite",
                                "callsite": site, "owner": cid,
                                "first_seen": now}
                        rec.update({
                            "last_seen": now,
                            "count": g.get("unawaited", 0),
                            "bytes": g.get("bytes", 0),
                            "oldest_age_s": g.get("oldest_age_s", 0),
                            "detail": (f"{g.get('unawaited', 0)} ref(s) "
                                       f"never awaited, oldest "
                                       f"{g.get('oldest_age_s', 0):.0f}s "
                                       f"old (ttl {ttl:.0f}s)"),
                        })
            # (2b)+(3) per-entry scans, capped so a million-object
            # flood never stalls the health loop under the head lock.
            scanned_entries = (
                len(self.objects) <= self.config.object_leak_scan_cap)
            if scanned_entries:
                attribution = self._census_attribution()
                budget = 100  # suspects per kind per sweep (bounded)
                for e in self.objects.values():
                    if e.state == SEALED and e.reads == 0 \
                            and not e.is_error and not e.owner_resident \
                            and now - e.created_at > ttl and budget > 0:
                        key = f"unawaited:{e.object_id}"
                        seen.add(key)
                        rec = self.leak_suspects.get(key)
                        if rec is None:
                            budget -= 1
                            cs = attribution.get(e.object_id)
                            rec = self.leak_suspects[key] = {
                                "kind": "sealed_never_read",
                                "object_id": e.object_id,
                                "owner": e.owner_id,
                                "callsite": cs[1] if cs else None,
                                "first_seen": now}
                        rec.update({
                            "last_seen": now, "bytes": e.size,
                            "age_s": round(now - e.created_at, 1),
                            "detail": (f"sealed {now - e.created_at:.0f}s "
                                       f"ago, never fetched"),
                        })
                    if e.borrowers and e.refcount <= 0:
                        key = f"borrow:{e.object_id}"
                        seen.add(key)
                        rec = self.leak_suspects.get(key)
                        if rec is None:
                            rec = self.leak_suspects[key] = {
                                "kind": "borrow_outlives_owner",
                                "object_id": e.object_id,
                                "owner": e.owner_id,
                                "first_seen": now}
                        rec.update({
                            "last_seen": now, "bytes": e.size,
                            "borrowers": sorted(e.borrowers),
                            "detail": (f"owner ref released but "
                                       f"{len(e.borrowers)} borrower(s) "
                                       f"still pin it"),
                        })
            # Clear suspects that stopped matching (swept kinds only —
            # growth suspects also clear in _census_intake when their
            # callsite vanishes from the owner's report; per-entry kinds
            # keep their state when the capped scan was skipped).
            for key in [k for k in self.leak_suspects if k not in seen]:
                if (not scanned_entries
                        and key.startswith(("unawaited:", "borrow:"))):
                    continue
                del self.leak_suspects[key]

    # --- registration ---

    def _h_register(self, body: dict, conn: rpc.Connection):
        ctype = body["client_type"]  # "driver" | "worker"
        from ray_tpu_torch._private import wirefmt

        # Binary wire negotiation (wirefmt.py): hot frames head→client
        # go binary only when the client advertised the same wire
        # version AND this head has it enabled; the reply tells the
        # client whether to do the same. The register exchange itself
        # is always pickled, so negotiation can't race a binary frame.
        head_wire = (wirefmt.WIRE_VERSION if self.config.wire_binary
                     else 0)
        conn.wire_binary = body.get("wire") == head_wire != 0
        # Off-host clients can't mmap the head's shared memory; their
        # object path degrades to inline payloads over the connection
        # (reference analogue: remote plasma access goes through the
        # object manager's chunked transfer, not local mmap).
        remote = not body.get("can_shm", True)
        if ctype == "worker":
            client_id = body["worker_id"]
            with self.lock:
                rec = self.workers.get(client_id)
                if rec is None:
                    # worker from a previous epoch / unknown: reject
                    raise rpc.RpcError(f"unknown worker {client_id}")
                rec.conn = conn
                rec.pid = body.get("pid", rec.pid)
                self.clients[client_id] = conn
                if body.get("owner_addr"):
                    self.client_owner_addrs[client_id] = tuple(
                        body["owner_addr"])
                conn.peer_info = {"client_id": client_id, "type": "worker",
                                  "remote": remote, "node_id": rec.node_id,
                                  "host": body.get("host"),
                                  "specenc": bool(body.get("specenc"))}
            self.dispatch_event.set()
        else:
            # Sharded head: the router minted an id hashed to this
            # shard (adopt_meta rides the fd handoff) so that
            # shard_for(client_id) == its hosting shard everywhere.
            meta = getattr(conn, "adopt_meta", None)
            client_id = (meta or {}).get("client_id") \
                or "driver-" + uuid.uuid4().hex[:8]
            with self.lock:
                # Shm-fallback re-register on the same connection: drop the
                # first registration's entry.
                stale = conn.peer_info.get("client_id")
                if stale:
                    self.clients.pop(stale, None)
                    self.client_owner_addrs.pop(stale, None)
                self.clients[client_id] = conn
                if body.get("owner_addr"):
                    self.client_owner_addrs[client_id] = tuple(
                        body["owner_addr"])
            conn.peer_info = {"client_id": client_id, "type": "driver",
                              "remote": remote, "node_id": self.node_id,
                              "host": body.get("host")}
        from ray_tpu_torch._private.task_spec import _specenc

        reply = {
            "client_id": client_id,
            "shm_name": None if remote else self.shm_name,
            "specenc": _specenc() is not None,
            "wire": head_wire,
            "shm_capacity": self.config.object_store_memory,
            # A worker's node is where it was spawned (P2P object
            # locations are recorded against it); drivers sit on the
            # head node.
            "node_id": rec.node_id if ctype == "worker" else self.node_id,
            "session_dir": self.session_dir,
        }
        if self.shard is not None:
            # Only in shard mode: the shards=1 reply stays bit-identical.
            reply["shard"] = self.shard.index
            reply["head_shards"] = self.shard.total
        return reply

    def _h_oom_pressure(self, body: dict, conn: rpc.Connection):
        """A node agent reports host memory pressure: run the kill policy
        scoped to that node (the agent has no task/worker tables)."""
        if self.memory_monitor is not None:
            self.memory_monitor.kill_on_node(
                body["node_id"], body.get("used_bytes", 0),
                body.get("total_bytes", 0),
            )
        return None

    def _h_mem_pressure(self, body: dict, conn: rpc.Connection):
        """A node agent crossed (or recovered from) the soft memory
        watermark: flip its pressure state. Agents re-cast every monitor
        tick while pressured, so the entry's ts stays fresh and the
        health loop can expire entries whose agent went silent."""
        self.set_node_pressure(
            body["node_id"], bool(body.get("pressured")),
            body.get("used_bytes", 0), body.get("total_bytes", 0),
            remote=True)
        return None

    def set_node_pressure(self, node_id: str, pressured: bool,
                          used: int = 0, total: int = 0,
                          remote: bool = False) -> None:
        """Memory-aware backpressure switch for one node (overload
        plane): while pressured, the node receives no new placements or
        lease grants, and its existing idle leases are revoked so owners
        stop pushing to it. Recovery re-wakes the dispatcher."""
        with self.lock:
            was = node_id in self.pressured_nodes
            if pressured:
                self.pressured_nodes[node_id] = {
                    "used": used, "total": total, "ts": time.time(),
                    "remote": remote}
            else:
                self.pressured_nodes.pop(node_id, None)
            if was == pressured:
                return
            if pressured:
                # Owners holding leases here must stop pushing NOW —
                # revoke them; in-flight work drains, new work re-routes
                # through the head, which won't place here either.
                for rec in self.workers.values():
                    if rec.node_id == node_id and rec.leased_to is not None:
                        self._end_lease(rec, revoke=True)
            self.task_events.append({
                "event": "overload",
                "kind": "mem_pressure" if pressured else "mem_recovered",
                "node_id": node_id,
                "used_bytes": used, "total_bytes": total,
                "ts": time.time(),
            })
        print(f"ray_tpu_torch head: node {node_id} "
              f"{'PRESSURED' if pressured else 'recovered'} "
              f"(mem {used}/{total})", file=sys.stderr)
        if pressured:
            # Data-plane spill gating (watermarks → external
            # storage): a pressured node's cold object primaries move
            # to disk and its redundant relay replicas free outright.
            try:
                self._spill_node_objects(node_id)
            except Exception:
                pass
        if not pressured:
            self.dispatch_event.set()

    def _spill_node_objects(self, node_id: str,
                            max_objects: int = 8) -> None:
        """Pick a memory-pressured node's spill victims: its coldest
        unpinned primaries (bytes move to external storage through the
        agent's spill-with-consent protocol) and every redundant relay
        replica it hosts (freed outright — other copies exist)."""
        agent = self.node_agents.get(node_id)
        if agent is None:
            return
        with self.lock:
            cands = sorted(
                (e for e in self.objects.values()
                 if e.location == node_id and e.state == SEALED
                 and not e.spill_path and e.read_pins == 0
                 and not e.pull_clients
                 and e.size >= self.config.bulk_transfer_min),
                key=lambda e: e.lru)
            ids = [e.object_id for e in cands[:max_objects]]
            for e in self.objects.values():
                if node_id in e.replicas and e.location != node_id:
                    del e.replicas[node_id]
                    try:
                        agent.cast("free_object",
                                   {"object_id": e.object_id})
                    except rpc.ConnectionLost:
                        pass
        if ids:
            try:
                agent.cast("spill_objects", {"ids": ids})
            except rpc.ConnectionLost:
                pass

    def _h_object_spilled(self, body: dict, conn):
        """An agent wrote an object's bytes to external storage and
        asks to drop its arena copy. Granted only when no reader holds
        a meta into that arena (the spill file is recorded either way —
        it doubles as the node-death recovery copy)."""
        with self.lock:
            e = self.objects.get(body["object_id"])
            if e is None:
                # Freed while the agent was writing: nothing references
                # the spill copy either.
                return {"drop": True, "delete": True}
            e.spill_path = body["path"]
            if (e.location != body.get("node_id") or e.read_pins > 0
                    or e.pull_clients):
                return {"drop": False}
            if e.replicas:
                # A relay replica survives in RAM: promote it to
                # primary; the spill file stays as the backstop.
                nid, (off, _sz) = next(iter(e.replicas.items()))
                del e.replicas[nid]
                e.location, e.remote_offset = nid, off
            else:
                e.location = None
                e.remote_offset = None
                e.state = SPILLED
            self._relay_release(body["object_id"])
            return {"drop": True}

    def _h_register_node(self, body: dict, conn: rpc.Connection):
        """A node agent joins the cluster (reference: raylet registration
        with the GCS node table, gcs_node_manager.h:49)."""
        from ray_tpu_torch._private.scheduler import NodeEntry, ResourceSet

        node_id = (body.get("node_id")
                   or (getattr(conn, "adopt_meta", None)
                       or {}).get("node_id")
                   or ("node-" + uuid.uuid4().hex[:8]))
        if body.get("transfer_port"):
            try:
                peer_ip = conn._sock.getpeername()[0]
            except OSError:
                peer_ip = "127.0.0.1"
            self.node_transfer_addrs[node_id] = (peer_ip,
                                                 int(body["transfer_port"]))
            if body.get("bulk_port"):
                self.node_bulk_addrs[node_id] = (peer_ip,
                                                 int(body["bulk_port"]))
            if body.get("store_name"):
                # Data plane: the node's arena identity + host id let
                # host-colocated readers map the arena directly instead
                # of pulling bytes through a socket (p2p meta "extra").
                self.node_store_info[node_id] = {
                    "store": body["store_name"],
                    "cap": int(body.get("store_capacity") or 0),
                    "host": body.get("host_id")}
        resources = dict(body.get("resources") or {})
        resources.setdefault(f"node:{node_id}", 1.0)
        entry = NodeEntry(
            node_id=node_id,
            address=body.get("address", "?"),
            total=ResourceSet(resources),
            available=ResourceSet(resources),
            labels=dict(body.get("labels") or {}),
        )
        with self.lock:
            # Re-join with a fixed node id: neuter the stale connection so
            # its eventual close can't evict the fresh agent.
            old = self.node_agents.get(node_id)
            if old is not None and old is not conn:
                old.peer_info.pop("node_agent_for", None)
            self.scheduler.add_node(entry)
            self.node_agents[node_id] = conn
            self._agent_last_seen[node_id] = time.time()
            # New capacity: retry pending placement groups (also the
            # re-placement path for PGs restored from a head snapshot).
            for pg in self.pgs.values():
                if pg.state == "PENDING":
                    self._try_place_pg(pg)
        conn.peer_info = {"node_agent_for": node_id}
        self.dispatch_event.set()
        reply = {"node_id": node_id, "session_dir": self.session_dir}
        if self.shard is not None:
            reply["shard"] = self.shard.index
            reply["head_shards"] = self.shard.total
        return reply

    def _h_worker_blocked(self, body: dict, conn):
        """A worker thread is entering a blocking nested get/wait:
        release its CPU/memory allocation so the tasks it waits on can
        be placed (reference: CoreWorker NotifyDirectCallTaskBlocked —
        blocked workers return resources to the raylet). TPU-leased
        workers keep their allocation: chip assignment is process
        state that cannot be handed to another worker mid-task."""
        with self.lock:
            rec = self.workers.get(body["worker_id"])
            if rec is None or rec.actor_id is not None or rec.gpu_ids:
                return None
            rec.blocked += 1
            if (rec.blocked == 1 and rec.acquired is not None
                    and rec.pg_alloc is None):
                self.scheduler.release(rec.node_id, rec.acquired)
                rec.released_alloc, rec.acquired = rec.acquired, None
        self.dispatch_event.set()
        return None

    def _h_worker_unblocked(self, body: dict, conn):
        with self.lock:
            rec = self.workers.get(body["worker_id"])
            if rec is None:
                return None
            rec.blocked = max(0, rec.blocked - 1)
            if rec.blocked == 0 and rec.released_alloc is not None:
                demand, rec.released_alloc = rec.released_alloc, None
                if rec.inflight and self.scheduler.acquire(rec.node_id,
                                                           demand):
                    rec.acquired = demand
                # else: transient oversubscription (reference semantics:
                # the resumed task runs on; the slot re-enters the
                # accounting at the window's next allocation).
        return None

    def _h_worker_ready(self, body: dict, conn):
        with self.lock:
            rec = self.workers.get(body["worker_id"])
            if rec is None:
                return None
            rec.ready = True
            if rec.actor_id is not None:
                self._maybe_push_creation(rec)
        self.dispatch_event.set()
        return None

    # --- object store ---

    def _h_create_object(self, body: dict, conn):
        object_id, size, owner = body["object_id"], body["size"], body["owner_id"]
        with self.lock:
            offset = self._alloc_with_spill(size)
            if offset is None:
                pinned = sum(
                    e.size for e in self.objects.values()
                    if e.read_pins > 0 and e.offset is not None)
                hint = ""
                if pinned:
                    # Zero-copy gets hold read pins for the life of
                    # their aliasing arrays, and pinned objects cannot
                    # spill (reference: plasma pinned-buffer semantics).
                    hint = (
                        f"; {pinned} bytes are read-pinned by live "
                        f"zero-copy arrays — drop them, copy out, or "
                        f"disable zero_copy_get"
                    )
                raise rpc.RpcError(
                    f"ObjectStoreFullError: cannot allocate {size} bytes "
                    f"(in use {self.arena.in_use}/{self.arena.capacity}"
                    f"{hint})"
                )
            entry = self.objects.get(object_id) or ObjectEntry(object_id, owner)
            if entry.offset is not None:
                # Re-creation (e.g. task retry rewriting its return id):
                # release the stale block instead of leaking it.
                self.arena.free(entry.offset)
            if entry.spill_path:
                self.external_storage.delete(entry.spill_path)
                entry.spill_path = None
            entry.inline = None
            entry.offset, entry.size, entry.owner_id = offset, size, owner
            entry.state = CREATING
            if entry.refcount == 0:
                entry.refcount = 1
            self.objects[object_id] = entry
        return {"offset": offset}

    def _alloc_with_spill(self, size: int) -> int | None:
        offset = self.arena.alloc(size)
        if offset is not None:
            return offset
        # Spill LRU sealed, unpinned objects until the allocation fits
        # (reference analogue: LocalObjectManager spilling,
        # raylet/local_object_manager.h:45).
        candidates = sorted(
            (e for e in self.objects.values() if e.state == SEALED and e.read_pins == 0 and e.offset is not None),
            key=lambda e: e.lru,
        )
        for e in candidates:
            self._spill(e)
            offset = self.arena.alloc(size)
            if offset is not None:
                return offset
        return None

    def _spill(self, entry: ObjectEntry) -> None:
        entry.spill_path = self.external_storage.spill(
            entry.object_id, self.arena.view(entry.offset, entry.size))
        self.arena.free(entry.offset)
        entry.offset = None
        entry.state = SPILLED

    def _restore(self, entry: ObjectEntry) -> bool:
        offset = self._alloc_with_spill(entry.size)
        if offset is None:
            return False
        data = self.external_storage.restore(entry.spill_path)
        self.arena.view(offset, entry.size)[:] = data
        self.external_storage.delete(entry.spill_path)
        entry.spill_path = None
        entry.offset = offset
        entry.state = SEALED
        return True

    def _bulk_read(self, object_id: str, start: int, length: int):
        """BulkServer reader over the head arena: pin the entry for the
        duration of the raw send (same discipline as shm metas)."""
        with self.lock:
            e = self.objects.get(object_id)
            if (e is None or e.state != SEALED or e.offset is None
                    or start >= e.size):
                raise KeyError(f"object {object_id} not in head arena")
            n = min(length, e.size - start)
            e.read_pins += 1
            view = self.arena.view(e.offset + start, n)

        def release(e=e, view=view):
            view.release()
            with self.lock:
                e.read_pins -= 1
                if e.refcount <= 0:
                    self._maybe_free(e)

        return view, release

    def _h_seal_object(self, body: dict, conn):
        with self.lock:
            entry = self.objects.get(body["object_id"])
            if entry is None:
                raise rpc.RpcError(f"seal of unknown object {body['object_id']}")
            entry.state = SEALED
            entry.is_error = body.get("is_error", False)
            self._register_contained(entry, body.get("contained_ids"))
            self._lru_tick += 1
            entry.lru = self._lru_tick
            self._on_sealed(entry.object_id)
        self.dispatch_event.set()
        return {}

    def _h_put_p2p(self, body: dict, conn):
        """Directory-only registration of an object whose payload lives
        in a node agent's local store (reference: object location
        updates into the ownership-based directory,
        ownership_based_object_directory.h:39). The bytes never touch
        the head."""
        object_id = body["object_id"]
        with self.lock:
            entry = self.objects.get(object_id) or ObjectEntry(
                object_id, body["owner_id"])
            entry.location = body["node_id"]
            entry.remote_offset = body["offset"]
            entry.size = body["size"]
            entry.inline = None
            entry.state = SEALED
            entry.is_error = body.get("is_error", False)
            if entry.refcount == 0:
                entry.refcount = 1
            self._register_contained(entry, body.get("contained_ids"))
            self._lru_tick += 1
            entry.lru = self._lru_tick
            self.objects[object_id] = entry
            self._on_sealed(object_id)
        self.dispatch_event.set()
        return {}

    def _h_put_inline(self, body: dict, conn):
        with self.lock:
            self._seal_inline_locked(body)
        self.dispatch_event.set()
        return {}

    def _h_owner_sealed(self, body: dict, conn):
        """An owning runtime confirms holding directly-delivered result
        payloads: seal the directory entries (dependency wakeup, wait
        readiness) — metadata only, the bytes never transited the
        head."""
        with self.lock:
            for sbody in body["objects"]:
                self._seal_remote_locked(sbody)
            need = self._sealed_woke_task
            self._sealed_woke_task = False
            if body.get("t_resolve") and self.config.task_events_enabled:
                # Flight recorder: the owner holds the results — stamp
                # the resolve phase on the producing tasks' timelines.
                self.task_events.resolve(
                    [o["object_id"] for o in body["objects"]],
                    body["t_resolve"])
        if need:
            self.dispatch_event.set()
        return None

    def _seal_inline_locked(self, body: dict) -> None:
        """lock held. Seal one inline object (put_inline call or a
        result piggybacked on task_finished)."""
        object_id = body["object_id"]
        entry = self.objects.get(object_id) or ObjectEntry(object_id, body["owner_id"])
        entry.inline = body["payload"]
        entry.size = len(entry.inline)
        entry.state = SEALED
        entry.is_error = body.get("is_error", False)
        if entry.refcount == 0:
            entry.refcount = 1
        self._register_contained(entry, body.get("contained_ids"))
        self._lru_tick += 1
        entry.lru = self._lru_tick
        self.objects[object_id] = entry
        self._on_sealed(object_id)

    def _seal_remote_locked(self, body: dict) -> None:
        """lock held. Record an owner-resident seal: the payload went
        straight from the executor to the owning runtime; this entry is
        directory-only (dependency wakeup, wait readiness, borrow/pin
        bookkeeping, owner liveness). Only EXISTING entries update — a
        missing entry means the object was already freed (fire-and-
        forget submit whose ref died), and recreating it would leak."""
        object_id = body["object_id"]
        entry = self.objects.get(object_id)
        if entry is None:
            if not body.get("direct"):
                return
            # Direct-dispatched task result whose task_started cast lost
            # the race (or was lost): create the directory entry so
            # cross-client waits/deps on this ref resolve. The owner's
            # del_ref follows on this same ordered connection, so the
            # refcount cannot have been decremented already.
            entry = ObjectEntry(object_id, body.get("owner_id", ""))
            self.objects[object_id] = entry
        w = self._pending_owner_seals.pop(object_id, None)
        self._pending_seal_specs.pop(object_id, None)
        if w is not None:
            s = self._worker_pending_seals.get(w)
            if s:
                s.discard(object_id)
                if not s:
                    self._maybe_release_retiree(w)
        if entry.inline is not None:
            # A death-backstop error seal raced the owner confirmation:
            # keep the inline error (at-least-once semantics; the owner-
            # local fast path may still serve the late good value).
            return
        entry.size = body.get("size", 0)
        entry.state = SEALED
        entry.owner_resident = True
        entry.is_error = body.get("is_error", False)
        if entry.refcount == 0:
            entry.refcount = 1
        self._register_contained(entry, body.get("contained_ids"))
        self._lru_tick += 1
        entry.lru = self._lru_tick
        self._on_sealed(object_id)

    def _on_sealed(self, object_id: str) -> None:
        """Resolve get/wait waiters; wake dependency-blocked tasks. lock held."""
        watchers = self._xshard_watch.pop(object_id, None)
        if watchers and self.shard is not None:
            # Another shard's consumer asked for this object before it
            # sealed: push the (pin-free) meta now. Cast — safe under
            # the lock (cast_buffered serializes and queues).
            e = self.objects.get(object_id)
            if e is not None and e.state in (SEALED, SPILLED):
                meta = self._meta_for(e, remote=True, pin=False)
                for shard in watchers:
                    self.shard.bus_cast("dir_fwd_cast", {
                        "shard": shard, "kind": "xshard_sealed",
                        "body": {"object_id": object_id, "meta": meta}})
        blocked = self.dep_blocked.pop(object_id, None)
        if blocked:
            self._sealed_woke_task = True
            for spec in blocked:
                pending = getattr(spec, "_deps_pending", None)
                if pending is None:
                    continue  # already woken (stale index entry)
                pending.discard(object_id)
                if pending:
                    continue  # still waiting on other deps
                spec._deps_pending = None
                q = self.ready_queues.setdefault(self._queue_key(spec),
                                                 deque())
                q.append(spec)
        for waiter_id, (conn, ids) in list(self.get_waiters.items()):
            if object_id in ids:
                ids.discard(object_id)
                if not ids:
                    del self.get_waiters[waiter_id]
                    self._send_metas(conn, waiter_id)
        for waiter_id, (conn, ids, num_returns) in list(self.wait_waiters.items()):
            ready = [i for i in ids if self._is_ready(i)]
            if len(ready) >= num_returns:
                del self.wait_waiters[waiter_id]
                try:
                    conn.cast("wait_ready", {"waiter_id": waiter_id, "ready": ready})
                except rpc.ConnectionLost:
                    pass

    def _is_ready(self, object_id: str) -> bool:
        e = self.objects.get(object_id)
        if e is None:
            # Another shard's object whose meta the bus delivered.
            return object_id in self._xshard_metas
        return e.state in (SEALED, SPILLED)

    def _meta_for(self, entry: ObjectEntry, remote: bool = False,
                  client_id: "str | None" = None,
                  client_node: "str | None" = None,
                  client_host: "str | None" = None,
                  pin: bool = True) -> tuple:
        # pin=False (cross-shard bus lookups only): serve the meta
        # without read pins or pull-slot accounting — no pin lifecycle
        # may span shards (there is no cross-shard read_done), so bus
        # metas ride the unpinned paths (inline copy / owner pointer /
        # validated p2p read).
        # Leak-detector input: this entry was fetched (sealed-but-never-
        # read objects past the TTL are suspects; a read clears them).
        entry.reads += 1
        entry.last_read = time.time()
        if entry.inline is not None:
            return ("inline", entry.inline, entry.is_error)
        if (entry.owner_resident and entry.state == SEALED
                and entry.offset is None and entry.location is None):
            # Directory-only entry: the value lives in the owning
            # runtime's store — the client resolves it there (owner-
            # local hit or a peer fetch). No head-side pin: the owner's
            # store is not subject to arena eviction.
            addr = self.client_owner_addrs.get(entry.owner_id)
            if addr is not None:
                return ("owner", addr[0], addr[1], entry.is_error,
                        entry.owner_id)
            return ("lost",
                    f"object {entry.object_id}: owner {entry.owner_id} "
                    "is gone (owner-resident value fate-shares with its "
                    "owner)", False)
        if entry.state == SPILLED:
            if not self._restore(entry):
                # Slow path: serve straight from external storage.
                return ("inline",
                        self.external_storage.restore(entry.spill_path),
                        entry.is_error)
        if entry.state == SEALED:
            if entry.location is not None or (
                    remote and entry.offset is not None
                    and entry.size > self.config.bulk_transfer_min):
                # P2P object: the head is directory only — the client
                # pulls the bytes from a hosting node's bulk server
                # (reference: pull_manager.h:57), round-robined across
                # primary + replicas. Read-pinned like shm metas: the
                # free_object cast must not fire mid-pull (client sends
                # read_done when finished).
                src = self._pick_source(entry, client_node)
                if src is not None:
                    node_id, off, addr = src
                    if pin:
                        entry.read_pins += 1
                        if client_id:
                            entry.pin_holders[client_id] = (
                                entry.pin_holders.get(client_id, 0) + 1)
                    # Data-plane "extra": the source arena's identity
                    # (host-colocated readers map it directly) and
                    # whether this source is a relay (a replica, not
                    # the primary) for the transfer-path counters.
                    info = self._node_store_meta(node_id)
                    extra = dict(info) if info else {}
                    extra["relay"] = node_id != (entry.location
                                                 or self.node_id)
                    if pin and client_id and self._pull_counted(
                            entry, node_id, client_node, client_host,
                            extra):
                        # Remote bulk pull expected: account the slot
                        # for relay fan-out gating (read_done frees it).
                        entry.pull_clients[client_id] = (
                            entry.pull_clients.get(client_id, 0) + 1)
                    return ("p2p", entry.object_id, node_id, addr,
                            off, entry.size, entry.is_error, extra)
            if remote:
                # Off-host client, small object: copy out under the lock
                # and ship bytes over the connection (no mmap, no read
                # pin to release).
                return (
                    "inline",
                    bytes(self.arena.view(entry.offset, entry.size)),
                    entry.is_error,
                )
            entry.read_pins += 1
            if client_id:
                entry.pin_holders[client_id] = (
                    entry.pin_holders.get(client_id, 0) + 1)
            return ("shm", entry.offset, entry.size, entry.is_error)
        return ("lost", f"object {entry.object_id} is {entry.state}", False)

    def _node_store_meta(self, node_id: str) -> "dict | None":
        """Arena identity of a source node for the p2p meta's extra
        (store name + capacity + host id; host-colocated readers use it
        to map the arena instead of pulling)."""
        if node_id == self.node_id:
            from ray_tpu_torch._private import dataplane

            return {"store": self.shm_name,
                    "cap": self.config.object_store_memory,
                    "host": dataplane.host_id()}
        return self.node_store_info.get(node_id)

    def _pull_counted(self, entry: ObjectEntry, src_node: str,
                      client_node, client_host, extra: dict) -> bool:
        """Whether serving this meta consumes a relay fan-out slot: only
        readers that will actually PULL bytes over the network count —
        same-node readers copy out of their mapped arena, and clients
        that advertised a matching host id map the source arena
        directly."""
        if self.config.relay_fanout <= 0:
            return False
        if client_node is not None and client_node == src_node:
            return False
        if client_host and extra.get("host") == client_host:
            return False
        return True

    def _pick_source(self, entry: ObjectEntry,
                     client_node: "str | None" = None):
        """lock held. Choose a payload source among the primary copy and
        replicas (spanning-tree fan-out: a node that pulled the object
        becomes a source for later pullers), preferring a copy on the
        REQUESTER's own node (it reads its mapped arena — no transfer
        at all). Returns (node_id, offset, bulk_addr) or None."""
        sources = []
        if entry.location is not None:
            sources.append((entry.location, entry.remote_offset))
        elif entry.offset is not None:
            sources.append((self.node_id, entry.offset))
        for nid, (off, _sz) in entry.replicas.items():
            if nid in self.node_agents or nid == self.node_id:
                sources.append((nid, off))
        if client_node is not None:
            for nid, off in sources:
                if nid == client_node and nid != self.node_id:
                    addr = self.node_bulk_addrs.get(nid)
                    if addr is not None:
                        return nid, off, addr
        while sources:
            entry.rr += 1
            nid, off = sources[entry.rr % len(sources)]
            if nid == self.node_id:
                return nid, off, ("", self.bulk_server.address[1])
            addr = self.node_bulk_addrs.get(nid)
            if addr is not None:
                return nid, off, addr
            # Source node lacks a bulk server (older agent): the legacy
            # rpc transfer addr, explicitly TAGGED — the two protocols
            # are not interchangeable on the wire, so the client must
            # never guess (a bulk frame misread as an rpc length field
            # blocks the reader on a ~4 GiB recv).
            if (nid, off) == (entry.location, entry.remote_offset):
                legacy = self.node_transfer_addrs.get(nid)
                if legacy is not None:
                    return nid, off, (legacy[0], legacy[1], "rpc")
                return nid, off, None
            sources.remove((nid, off))
        return None

    def _h_add_replica(self, body: dict, conn):
        """A node cached a pulled payload in its agent store and offers
        itself as a source (reference: object location updates into the
        directory, ownership_based_object_directory.h:39)."""
        with self.lock:
            e = self.objects.get(body["object_id"])
            if e is not None and e.state == SEALED:
                e.replicas[body["node_id"]] = (body["offset"], body["size"])
                # Relay tree: a new source exists — parked pullers fan
                # out onto it immediately.
                self._relay_release(body["object_id"])
                return None
            # Object freed while the replica was being cached: without a
            # directory entry nothing would ever free the sealed bytes —
            # tell the offering node to drop them now.
            agent = self.node_agents.get(body["node_id"])
            if agent is not None:
                try:
                    agent.cast("free_object",
                               {"object_id": body["object_id"]})
                except rpc.ConnectionLost:
                    pass
        return None

    def _relay_gated(self, ids, conn) -> "str | None":
        """lock held. The object id whose relay fan-out budget is
        exhausted for this (pulling) client, or None. Parked waiters
        re-check when a pull slot frees or a relay source registers —
        the health loop's relay_max_defer_s sweep is the safety valve."""
        if self.config.relay_fanout <= 0:
            return None
        client_node = conn.peer_info.get("node_id")
        client_host = conn.peer_info.get("host")
        remote = bool(conn.peer_info.get("remote"))
        for oid in ids:
            e = self.objects.get(oid)
            if (e is None or e.state != SEALED or e.inline is not None
                    or e.owner_resident):
                continue
            p2p_like = e.location is not None or (
                remote and e.offset is not None
                and e.size > self.config.bulk_transfer_min)
            if not p2p_like:
                continue
            if sum(e.pull_clients.values()) < self.config.relay_fanout:
                continue
            # A slot-exempt reader (same node/host as some source) never
            # parks: probe with the same predicate the server applies.
            src_nodes = set(e.replicas)
            src_nodes.add(e.location or self.node_id)
            exempt = False
            for nid in src_nodes:
                info = self._node_store_meta(nid) or {}
                if not self._pull_counted(e, nid, client_node,
                                          client_host, info):
                    exempt = True
                    break
            if not exempt:
                return oid
        return None

    def _relay_release(self, object_id: str) -> None:
        """lock held. A pull slot freed (read_done) or a new source
        registered (add_replica): re-run parked pullers of this object
        through the meta path (they may park again if the budget is
        still exhausted)."""
        q = self._relay_parked.pop(object_id, None)
        if not q:
            return
        for waiter_id in q:
            parked = self._parked_waiters.pop(waiter_id, None)
            if parked is not None:
                self._send_metas(parked[0], waiter_id)

    def _relay_sweep(self) -> None:
        """Health-loop safety valve: a puller parked past
        relay_max_defer_s is released to whatever sources exist (gating
        is an optimization; it must never become a hang)."""
        cutoff = time.time() - self.config.relay_max_defer_s
        with self.lock:
            stale = [w for w, (_c, t0) in self._parked_waiters.items()
                     if t0 < cutoff]
            for waiter_id in stale:
                conn, _t0 = self._parked_waiters.pop(waiter_id)
                for q in self._relay_parked.values():
                    try:
                        q.remove(waiter_id)
                    except ValueError:
                        pass
                self._send_metas(conn, waiter_id, gate=False)

    def _send_metas(self, conn: rpc.Connection, waiter_id: str,
                    gate: bool = True) -> None:
        metas = {}
        ids = self._waiter_ids.get(waiter_id) or []
        if gate:
            gated_oid = self._relay_gated(ids, conn)
            if gated_oid is not None:
                self._relay_parked.setdefault(
                    gated_oid, deque()).append(waiter_id)
                self._parked_waiters[waiter_id] = (conn, time.time())
                return
        self._waiter_ids.pop(waiter_id, None)
        self._parked_waiters.pop(waiter_id, None)
        remote = bool(conn.peer_info.get("remote"))
        for oid in ids:
            entry = self.objects.get(oid)
            if entry is None:
                xmeta = self._xshard_metas.get(oid)
                if xmeta is not None:
                    metas[oid] = xmeta
                    continue
                metas[oid] = ("lost", f"object {oid} unknown (freed?)", False)
            else:
                metas[oid] = self._meta_for(
                    entry, remote=remote,
                    client_id=conn.peer_info.get("client_id"),
                    client_node=conn.peer_info.get("node_id"),
                    client_host=conn.peer_info.get("host"))
        # The cast happens OFF the head lock path: for remote clients the
        # metas embed full payloads, and a blocking sendall to a slow peer
        # under self.lock would freeze all scheduling.
        def _cast(conn=conn, waiter_id=waiter_id, metas=metas):
            try:
                conn.cast("objects_ready", {"waiter_id": waiter_id, "metas": metas})
            except rpc.ConnectionLost:
                pass

        self._send_pool.submit(_cast)

    def _h_get_meta(self, body: dict, conn):
        waiter_id, ids = body["waiter_id"], body["ids"]
        if self.shard is not None:
            self._xshard_track(ids)
        with self.lock:
            self._waiter_ids[waiter_id] = list(ids)
            missing = set()
            for i in ids:
                if self._is_ready(i):
                    continue
                # Freed-but-reconstructable objects re-execute their
                # producing task (lineage); the seal unblocks this waiter.
                self._maybe_reconstruct(i)
                if not self._is_ready(i):
                    missing.add(i)
            # Missing ids may be return values of tasks still in flight —
            # wait for their seal. The client applies its own timeout.
            if missing:
                self.get_waiters[waiter_id] = (conn, missing)
            else:
                self._send_metas(conn, waiter_id)
        return None

    def _h_read_done(self, body: dict, conn):
        client_id = conn.peer_info.get("client_id")
        with self.lock:
            for oid in body["ids"]:
                e = self.objects.get(oid)
                if e is not None and e.read_pins > 0:
                    e.read_pins -= 1
                    if client_id and e.pin_holders.get(client_id):
                        e.pin_holders[client_id] -= 1
                        if not e.pin_holders[client_id]:
                            del e.pin_holders[client_id]
                    if client_id and e.pull_clients.get(client_id):
                        # A relay fan-out slot freed: parked pullers of
                        # this object re-run the meta path (the freed
                        # slot or a fresh replica serves them).
                        e.pull_clients[client_id] -= 1
                        if not e.pull_clients[client_id]:
                            del e.pull_clients[client_id]
                        self._relay_release(oid)
                    if e.refcount <= 0:
                        self._maybe_free(e)
        return None

    def _h_wait(self, body: dict, conn):
        waiter_id, ids, num_returns = body["waiter_id"], body["ids"], body["num_returns"]
        if self.shard is not None:
            self._xshard_track(ids)
        with self.lock:
            for i in ids:
                if not self._is_ready(i):
                    self._maybe_reconstruct(i)
            ready = [i for i in ids if self._is_ready(i)]
            if len(ready) >= num_returns:
                conn.cast("wait_ready", {"waiter_id": waiter_id, "ready": ready})
            else:
                self.wait_waiters[waiter_id] = (conn, list(ids), num_returns)
        return None

    def _h_wait_check(self, body: dict, conn):
        if self.shard is not None:
            self._xshard_track(body["ids"])
        with self.lock:
            for i in body["ids"]:
                if not self._is_ready(i):
                    self._maybe_reconstruct(i)
            return {"ready": [i for i in body["ids"] if self._is_ready(i)]}

    def _h_cancel_wait(self, body: dict, conn):
        with self.lock:
            self.wait_waiters.pop(body["waiter_id"], None)
            self.get_waiters.pop(body["waiter_id"], None)
            if hasattr(self, "_waiter_ids"):
                self._waiter_ids.pop(body["waiter_id"], None)
            self._parked_waiters.pop(body["waiter_id"], None)
        return None

    def _h_del_ref(self, body: dict, conn):
        unknown = []
        with self.lock:
            for oid in body["ids"]:
                e = self.objects.get(oid)
                if e is not None:
                    e.refcount -= 1
                    self._maybe_free(e)
                elif self.shard is not None:
                    unknown.append(oid)
        self._xshard_ref_relay("del_ref", unknown, conn)
        return None

    def _h_add_ref(self, body: dict, conn):
        unknown = []
        with self.lock:
            for oid in body["ids"]:
                e = self.objects.get(oid)
                if e is not None:
                    e.refcount += 1
                elif self.shard is not None:
                    unknown.append(oid)
        self._xshard_ref_relay("add_ref", unknown, conn)
        return None

    def _h_add_borrow(self, body: dict, conn):
        """A client deserialized a copy of these refs (reference:
        reference_count.h:72 borrower registration). Arrives on the
        client's ordered connection before whatever releases the
        in-flight pin that covered the deserialization."""
        client_id = conn.peer_info.get("client_id")
        if not client_id:
            return None
        unknown = []
        with self.lock:
            for oid in body["ids"]:
                e = self.objects.get(oid)
                if e is not None:
                    e.borrowers.add(client_id)
                elif self.shard is not None:
                    unknown.append(oid)
        self._xshard_ref_relay("add_borrow", unknown, conn)
        return None

    def _h_del_borrow(self, body: dict, conn):
        client_id = conn.peer_info.get("client_id")
        if not client_id:
            return None
        unknown = []
        with self.lock:
            for oid in body["ids"]:
                e = self.objects.get(oid)
                if e is not None:
                    e.borrowers.discard(client_id)
                    self._maybe_free(e)
                elif self.shard is not None:
                    unknown.append(oid)
        self._xshard_ref_relay("del_borrow", unknown, conn)
        return None

    def _release_container_pins(self, ids) -> None:
        """lock held. Drop one containment pin per id and re-check
        freeability — the single release path symmetric with
        _register_contained (may cascade through nested containers)."""
        for cid in ids:
            ce = self.objects.get(cid)
            if ce is not None and ce.container_pins > 0:
                ce.container_pins -= 1
                self._maybe_free(ce)

    def _register_contained(self, entry: ObjectEntry, contained_ids) -> None:
        """lock held. Pin every object embedded in this sealed payload
        until the container itself is freed. A re-seal (task retry /
        lineage re-execution) may embed a DIFFERENT set of fresh nested
        puts: release the old pins and register the new so pins stay
        symmetric with the release in _maybe_free."""
        new = tuple(contained_ids or ())
        if new == entry.contained:
            return
        old, entry.contained = entry.contained, new
        self._release_container_pins(old)
        for cid in new:
            ce = self.objects.get(cid)
            if ce is not None:
                ce.container_pins += 1

    def _h_free_objects(self, body: dict, conn):
        with self.lock:
            for oid in body["ids"]:
                e = self.objects.get(oid)
                if e is not None:
                    e.refcount = 0
                    self._maybe_free(e, force=body.get("force", False))
        return {}

    def _maybe_free(self, entry: ObjectEntry, force: bool = False) -> None:
        if self._shutdown:
            return  # the arena is (being) destroyed with the session
        if self.objects.get(entry.object_id) is not entry:
            # Already freed (or superseded): callers may hold stale
            # entries gathered before a cascading containment free —
            # a second pass must not double-free the arena region.
            return
        if entry.refcount > 0 and not force:
            return
        if entry.task_pins > 0 and not force:
            return
        if (entry.borrowers or entry.container_pins > 0) and not force:
            # A process still holds a deserialized copy, or a sealed
            # object embeds this ref: the borrow protocol keeps it alive
            # (reference: reference_count.h:72).
            return
        if entry.read_pins > 0:
            # A client still holds a shm meta for this object; freeing now
            # would let the arena reuse the region under the reader. The
            # read_done handler re-invokes _maybe_free.
            return
        if entry.offset is not None:
            self.arena.free(entry.offset)
        if entry.spill_path:
            self.external_storage.delete(entry.spill_path)
        self._relay_parked.pop(entry.object_id, None)
        holders = set(entry.replicas)
        if entry.location is not None:
            holders.add(entry.location)
        for nid in holders:
            agent = self.node_agents.get(nid)
            if agent is not None:
                try:
                    agent.cast("free_object",
                               {"object_id": entry.object_id})
                except rpc.ConnectionLost:
                    pass
        if ((entry.owner_resident or entry.state == CREATING
                or entry.is_error)
                and entry.owner_id in self.client_owner_addrs):
            # The payload lives (owner_resident), may yet arrive
            # (CREATING: a pending result whose direct seal is in
            # flight), or was PUSHED to the owner (error seals —
            # _seal_error mirrors them into the owner store, which
            # would otherwise never purge them): tell the owner the
            # cluster is done with this object so it can drop/tombstone
            # the id. Buffered per owner and flushed by the dispatcher
            # in ONE cast per pass — a million-object drain must not
            # become a million owned_freed messages.
            self._owned_freed_buf.setdefault(
                entry.owner_id, []).append(entry.object_id)
        self.objects.pop(entry.object_id, None)
        w = self._pending_owner_seals.pop(entry.object_id, None)
        self._pending_seal_specs.pop(entry.object_id, None)
        if w is not None:
            s = self._worker_pending_seals.get(w)
            if s:
                s.discard(entry.object_id)
                if not s:
                    self._maybe_release_retiree(w)
        # The container is gone: release its containment pins so the
        # embedded objects can free (possibly cascading through nested
        # containers).
        contained, entry.contained = entry.contained, ()
        self._release_container_pins(contained)

    # --- KV store (reference: GCS InternalKV, gcs_service.proto) ---

    def _h_kv_put(self, body, conn):
        key = (body.get("ns", ""), body["key"])
        with self.lock:
            if not body.get("overwrite", True) and key in self.kv:
                return {"added": False}
            self.kv[key] = body["value"]
            self._wal_append(("kv_put", key[0], key[1], body["value"]))
            self._mark_dirty()
        return {"added": True}

    def _h_kv_get(self, body, conn):
        with self.lock:
            return {"value": self.kv.get((body.get("ns", ""), body["key"]))}

    def _h_kv_del(self, body, conn):
        with self.lock:
            existed = self.kv.pop((body.get("ns", ""), body["key"]), None) is not None
            if existed:
                self._wal_append(("kv_del", body.get("ns", ""), body["key"]))
                self._mark_dirty()
        return {"deleted": existed}

    def _h_kv_keys(self, body, conn):
        ns, prefix = body.get("ns", ""), body.get("prefix", "")
        with self.lock:
            return {"keys": [k for (n, k) in self.kv if n == ns and k.startswith(prefix)]}

    def _h_kv_exists(self, body, conn):
        with self.lock:
            return {"exists": (body.get("ns", ""), body["key"]) in self.kv}

    # --- pubsub (reference: src/ray/pubsub/publisher.h:300) ---

    def _h_subscribe(self, body, conn):
        with self.lock:
            self._subscribers.setdefault(body["topic"], []).append(conn)
        # Fresh resource-view subscribers get a full snapshot at once
        # (reference: per-connection snapshot on sync startup) instead
        # of waiting out the anti-entropy period.
        from ray_tpu_torch._private import resource_syncer

        if (body["topic"] == resource_syncer.TOPIC
                and getattr(self, "_view_publisher", None) is not None):
            self._view_publisher.broadcast_snapshot()
        return {}

    def _h_publish(self, body, conn):
        with self.lock:
            subs = list(self._subscribers.get(body["topic"], []))
        for s in subs:
            try:
                s.cast("pubsub_message", {"topic": body["topic"], "data": body["data"]})
            except rpc.ConnectionLost:
                pass
        return {}

    # --- task submission ---

    @staticmethod
    def _pinned_ids(spec) -> list:
        """Ids a task's flight pins: scheduling deps (top-level args)
        plus refs nested inside arg containers (disjoint by construction
        — pack_args dedups). Pin and release MUST both use this list."""
        return list(spec.deps) + list(getattr(spec, "borrowed_ids", None)
                                      or ())

    def _h_submit_task(self, body, conn):
        spec: TaskSpec = spec_from_body(body)
        self._adopt_evt(spec, body)
        if body.get("lease_key") is not None:
            # The owner wants a direct-dispatch lease for this shape:
            # granted in _push_to_worker once the task lands on a
            # leasable worker (same placement machinery, zero extra
            # round trips — the grant rides back as a buffered cast).
            spec._lease_key = tuple(
                tuple(k) if isinstance(k, list) else k
                for k in body["lease_key"])
        with self.lock:
            if not self._admission_check(spec, conn):
                return None  # typed rejection sealed + backpressure cast
            if spec.deadline:
                self._any_deadlines = True
            for oid in spec.return_ids:
                entry = self.objects.get(oid) or ObjectEntry(oid, spec.owner_id)
                entry.refcount = max(entry.refcount, 1)
                self.objects[oid] = entry
            for dep in self._pinned_ids(spec):
                e = self.objects.get(dep)
                if e is not None:
                    e.task_pins += 1
            self.tasks[spec.task_id] = {
                "task_id": spec.task_id,
                "name": spec.name,
                "state": PENDING,
                "type": "ACTOR_TASK" if spec.actor_id else ("ACTOR_CREATION_TASK" if spec.actor_creation else "NORMAL_TASK"),
                "submitted_at": time.time(),
                "node_id": None,
                "worker_id": None,
                "resources": dict(spec.resources or {}),
            }
            if self._expired(spec):
                # Dead on arrival (owner queued it past its deadline, or
                # the submit itself sat in a flooded socket): shed now.
                self._shed_expired(spec, "submit")
            elif spec.actor_id is not None:
                self._enqueue_actor_task(spec)
            else:
                self._enqueue_task_spec(spec)
                self._record_lineage(spec)
        self.dispatch_event.set()
        return None

    # --- flight recorder (events.py) ----------------------------------

    def _adopt_evt(self, spec: TaskSpec, body: dict) -> None:
        """A head-routed submission landed: adopt the owner's phase
        stamps onto the in-process spec and add the enqueue stamp. The
        stamps ride the eventual push_task body to the worker, which
        returns the full timeline inside task_finished."""
        if not self.config.task_events_enabled:
            return
        evt = dict(body.get("evt") or {})
        evt["enqueue"] = time.time()
        spec._evt = evt
        self.task_events.register_oids(spec.task_id, spec.return_ids)

    def _client_node(self, client_id: "str | None") -> "str | None":
        """lock held (or best-effort). The node a client's clock lives
        on: workers map through their record; drivers co-locate with the
        head (offset 0 either way when unknown)."""
        rec = self.workers.get(client_id or "")
        return rec.node_id if rec is not None else self.node_id

    # Package-env hash shared with the owner-side lease cache (the two
    # sides must key shapes identically) — see task_spec.env_pkg_key.
    _env_key = staticmethod(env_pkg_key)

    def _queue_key(self, spec: TaskSpec) -> tuple:
        if spec.scheduling_strategy is not None:
            return _SCAN_KEY
        rkey = spec._rkey
        if rkey is None:
            rkey = spec._rkey = (
                tuple(sorted(spec.resources.items())),
                self._env_key(spec.runtime_env))
        return ("shape", rkey)

    # --- overload-protection plane: pending budgets + deadline sheds --

    def _pending_inc(self, spec: TaskSpec) -> None:
        """lock held. Count a spec entering a head queue (ready/dep/
        actor). Guarded by spec._queued so re-enqueues are idempotent."""
        if spec._queued:
            return
        spec._queued = True
        self.pending_total += 1
        self.pending_by_owner[spec.owner_id] = (
            self.pending_by_owner.get(spec.owner_id, 0) + 1)

    def _pending_dec(self, spec: TaskSpec) -> None:
        """lock held. A spec left the queued state (dispatched or
        failed)."""
        if not spec._queued:
            return
        spec._queued = None
        self.pending_total = max(0, self.pending_total - 1)
        n = self.pending_by_owner.get(spec.owner_id, 0) - 1
        if n <= 0:
            self.pending_by_owner.pop(spec.owner_id, None)
        else:
            self.pending_by_owner[spec.owner_id] = n

    def _admission_check(self, spec: TaskSpec, conn) -> bool:
        """lock held. Head-side admission gate (the authoritative
        backstop behind the owner runtime's own blocking gate): False =
        REJECT — the return ids get a typed PendingCallsLimitError seal
        and the owner a backpressure cast. Fairness is per-owner: the
        per-owner budget trips first for a hot client, and when the
        GLOBAL budget trips, owners still under their fair share keep
        submitting (the hot owner is the one rejected)."""
        if spec.actor_creation:
            return True  # creations are cluster setup, never load
        cfg = self.config
        per_owner = int(cfg.admission_max_pending_per_owner)
        total = int(cfg.admission_max_pending_total)
        mine = self.pending_by_owner.get(spec.owner_id, 0)
        over = None
        if per_owner > 0 and mine >= per_owner:
            over = ("owner", mine, per_owner)
        elif total > 0 and self.pending_total >= total:
            fair = max(1, total // max(1, len(self.pending_by_owner) or 1))
            if mine >= fair:
                over = ("global", self.pending_total, total)
        if over is None:
            return True
        scope, n, limit = over
        self.stats["admission_rejected"] += 1
        msg = (f"PendingCallsLimitError: submission of {spec.name} "
               f"rejected by admission control: {scope} pending budget "
               f"exhausted ({n}/{limit})")
        t = self.tasks.get(spec.task_id)
        if t is None:
            self.tasks[spec.task_id] = t = {
                "task_id": spec.task_id, "name": spec.name,
                "state": FAILED, "type": ("ACTOR_TASK" if spec.actor_id
                                          else "NORMAL_TASK"),
                "submitted_at": time.time(), "node_id": None,
                "worker_id": None}
        t["state"] = FAILED
        t["error"] = msg
        t["finished_at"] = time.time()
        self._record_finished(spec.task_id)
        for oid in spec.return_ids:
            entry = self.objects.get(oid) or ObjectEntry(oid, spec.owner_id)
            entry.refcount = max(entry.refcount, 1)
            self.objects[oid] = entry
            self._seal_error(oid, msg, kind="pending_calls_limit")
        self.task_events.append({
            "event": "overload", "kind": "admission_reject",
            "task_id": spec.task_id, "owner_id": spec.owner_id,
            "scope": scope, "pending": n, "limit": limit,
            "ts": time.time()})
        # Typed backpressure signal: the owner runtime turns this into
        # blocking-submit (default) or fast-fail for subsequent calls.
        oconn = self.clients.get(spec.owner_id) or conn
        if oconn is not None:
            try:
                oconn.cast_buffered("backpressure", {
                    "scope": scope, "pending": n, "limit": limit,
                    "retry_after_s": 1.0})
            except rpc.ConnectionLost:
                pass
        return False

    def _shed_expired(self, spec: TaskSpec, where: str) -> None:
        """lock held. A deadline-expired task leaves the system with a
        typed TaskTimeoutError seal instead of burning capacity."""
        self.shed_counts[where] = self.shed_counts.get(where, 0) + 1
        self.task_events.append({
            "event": "overload", "kind": "shed", "where": where,
            "task_id": spec.task_id, "name": spec.name,
            "owner_id": spec.owner_id, "ts": time.time()})
        self._fail_task(
            spec,
            f"TaskTimeoutError: task {spec.name} exceeded its deadline "
            f"while queued ({where}); shed before execution",
            kind="task_timeout")

    @staticmethod
    def _expired(spec: TaskSpec, now: "float | None" = None) -> bool:
        return bool(spec.deadline) and (now or time.time()) > spec.deadline

    def _enqueue_task_spec(self, spec: TaskSpec, front: bool = False) -> None:
        """lock held. Route a normal task to the dependency index (any
        unready arg) or its ready queue."""
        self._pending_inc(spec)
        # Deduped: f.remote(x, x) lists the dep twice, but the spec must
        # register under each distinct object exactly once or the seal
        # wake-up would enqueue (and execute) the task twice.
        unready = {d for d in spec.deps if not self._is_ready(d)}
        if unready:
            spec._deps_pending = unready
            for d in unready:
                self.dep_blocked.setdefault(d, []).append(spec)
            return
        q = self.ready_queues.setdefault(self._queue_key(spec), deque())
        q.appendleft(spec) if front else q.append(spec)

    def _record_lineage(self, spec: TaskSpec) -> None:
        """lock held. Remember who produces each return id (bounded)."""
        for oid in spec.return_ids:
            self.lineage[oid] = spec
            self.lineage_order.append(oid)
        while len(self.lineage_order) > self.config.max_lineage_entries:
            old = self.lineage_order.popleft()
            self.lineage.pop(old, None)

    def _maybe_reconstruct(self, oid: str) -> bool:
        """lock held. If `oid` is gone but its producing task is known,
        re-execute the task (recursively re-creating missing deps).
        Returns True when the object is ready, in flight, or now queued
        for reconstruction. Reference: object_recovery_manager.h:43."""
        entry = self.objects.get(oid)
        if entry is not None and entry.state in (CREATING, SEALED, SPILLED):
            return True  # fine or already being (re)produced
        spec = self.lineage.get(oid)
        if spec is None:
            return False
        # Budget is per re-EXECUTION of the producing task, not per return
        # id (a 2-return task recovered once charges once).
        used = self.reconstructions.get(spec.task_id, 0)
        if used >= self.config.max_object_reconstructions:
            return False
        self.reconstructions[spec.task_id] = used + 1
        # Resurrect entries for every return id BEFORE recursing so
        # diamond-shaped lineage doesn't resubmit the same task twice.
        for rid in spec.return_ids:
            e = self.objects.get(rid) or ObjectEntry(rid, spec.owner_id)
            e.state = CREATING
            e.inline = None
            if e.refcount == 0:
                e.refcount = 1
            # The re-executed task will re-seal with ITS OWN nested puts
            # (fresh random ids): release the stale containment pins and
            # clear the set so the new seal registers the new children.
            contained, e.contained = e.contained, ()
            self._release_container_pins(contained)
            self.objects[rid] = e
        # Validate/recover ALL deps before pinning ANY: a failure must not
        # touch pins that belong to other in-flight consumers of the deps.
        for dep in spec.deps:
            if not self._maybe_reconstruct(dep) and not self._is_ready(dep):
                # Unrecoverable dep: seal errors on the return ids only
                # (no dep-pin release — nothing was pinned this round).
                msg = (
                    f"ObjectLostError: cannot reconstruct {oid}: dependency "
                    f"{dep} is lost with no lineage"
                )
                t_rec = self.tasks.get(spec.task_id)
                if t_rec is not None:
                    t_rec["state"] = FAILED
                    t_rec["error"] = msg
                for rid in spec.return_ids:
                    self._seal_error(rid, msg, kind="object_lost",
                                     provenance={"object_id": rid,
                                                 "owner_id": spec.owner_id})
                return True  # error is sealed; getters unblock with it
        for dep in self._pinned_ids(spec):
            e = self.objects.get(dep)
            if e is not None:
                e.task_pins += 1
        t = self.tasks.get(spec.task_id)
        if t is not None:
            t["state"] = PENDING
            t["reconstructions"] = used + 1
        self._enqueue_task_spec(spec)
        self.dispatch_event.set()
        return True

    def _h_cancel_task(self, body, conn):
        # Accepts a task id or one of the task's return object ids (the
        # public `cancel(ref)` passes the ref).
        task_id = body["task_id"]
        with self.lock:
            for q in self.ready_queues.values():
                for spec in list(q):
                    if spec.task_id == task_id or task_id in spec.return_ids:
                        q.remove(spec)
                        self._fail_task(spec, "TaskCancelledError: cancelled before execution")
                        return {"cancelled": True}
            for oid, specs in list(self.dep_blocked.items()):
                for spec in specs:
                    if spec.task_id == task_id or task_id in spec.return_ids:
                        # Drop it from EVERY dep's wait list, not just
                        # this one, or a later seal would resurrect it.
                        for o2, s2 in list(self.dep_blocked.items()):
                            if spec in s2:
                                s2.remove(spec)
                                if not s2:
                                    del self.dep_blocked[o2]
                        self._fail_task(spec, "TaskCancelledError: cancelled before execution")
                        return {"cancelled": True}
            # Dep-parked actor calls (args still resolving).
            for actor in self.actors.values():
                for spec in list(actor.pending):
                    if spec.task_id == task_id or task_id in spec.return_ids:
                        actor.pending.remove(spec)
                        self._fail_task(spec, "TaskCancelledError: cancelled before execution")
                        return {"cancelled": True}
            # Pushed to a worker (running, or queued in its executor —
            # actor calls wait there, not head-side): signal it. The
            # public cancel(ref) passes a RETURN id, so match those too.
            for rec in self.workers.values():
                spec = rec.inflight.get(task_id) or next(
                    (s for s in rec.inflight.values()
                     if task_id in s.return_ids), None)
                if spec is not None and rec.conn:
                    try:
                        rec.conn.cast("cancel", {"task_id": spec.task_id})
                    except rpc.ConnectionLost:
                        pass
                    return {"cancelled": False, "signalled": True}
        return {"cancelled": False}

    def _h_task_finished(self, body, conn):
        with self.lock:
            need = self._task_finished_locked(body)
        if need:
            self.dispatch_event.set()
        return None

    def _task_finished_locked(self, body) -> bool:
        """lock held. One task completion; returns whether the
        dispatcher should wake."""
        worker_id = body["worker_id"]
        # Piggybacked inline RESULTS (sealed before the completion
        # bookkeeping below, same order the split put_inline +
        # task_finished messages guaranteed) and profile events —
        # one cast per task carries everything, replacing a blocking
        # put_inline round trip on the control plane's hottest path.
        for rbody in body.get("results") or ():
            self._seal_inline_locked(rbody)
            # Head-routed fallback (owner was unreachable from the
            # executor): the owner may still be waiting locally for this
            # id — push an ask-the-head marker so its get resolves now
            # instead of riding the 5 s stall probe.
            e = self.objects.get(rbody["object_id"])
            if e is not None and (
                    e.owner_id in self.client_owner_addrs
                    or (self.shard is not None
                        and e.owner_id not in self.clients)):
                self._client_cast(e.owner_id, "seal_objects", {
                    "objects": [{"object_id": rbody["object_id"],
                                 "remote": True}]})
        if body.get("events"):
            for ev in body["events"]:
                # Clock-domain annotation for cross-node alignment: the
                # owner's submit/push/resolve stamps are on the owner
                # node's clock, the worker's on its node's clock.
                if (isinstance(ev, dict) and "phases" in ev
                        and "owner_node_id" not in ev):
                    ev["owner_node_id"] = self._client_node(
                        ev.get("owner_id"))
            self.task_events.extend(body["events"])
            self.traces.intake(body["events"])
        rec = self.workers.get(worker_id)
        if rec is None:
            # Worker record already reaped (death raced the final
            # cast) — but the seals above may have readied
            # dep-blocked tasks, so the dispatcher must still wake.
            # (No sealed_pending registration: the death handler
            # already error-sealed or retried this task's returns.)
            return True
        for sp in body.get("sealed_pending") or ():
            oid = sp["object_id"]
            e = self.objects.get(oid)
            if e is not None and e.state == CREATING:
                # Containment pins register EAGERLY, before the owner's
                # seal confirmation: the executing worker's del_ref for
                # a ref returned inside a container must not free the
                # inner object while the confirmation is in flight.
                # (_register_contained is idempotent for the identical
                # tuple arriving later via owner_sealed.)
                if sp.get("contained_ids"):
                    self._register_contained(e, sp["contained_ids"])
                self._pending_owner_seals[oid] = worker_id
                self._worker_pending_seals.setdefault(
                    worker_id, set()).add(oid)
        if body.get("shed"):
            # Worker-side deadline shed (executor-queue hop): attribute
            # it in the same counter family as the head's own sheds.
            where = str(body["shed"])
            self.shed_counts[where] = self.shed_counts.get(where, 0) + 1
            self.task_events.append({
                "event": "overload", "kind": "shed", "where": where,
                "task_id": body.get("task_id"), "worker_id": worker_id,
                "ts": time.time()})
        if body.get("task_id"):
            self._expiry_signalled.discard(body["task_id"])
        spec = rec.inflight.pop(body.get("task_id", ""), None)
        if spec is None and body.get("task_id"):
            # Direct-plane race: the completion beat the owner's batched
            # task_started. Tombstone the id so the late registration
            # doesn't create a phantom inflight entry.
            self._early_finished.add(body["task_id"])
            self._early_finished_fifo.append(body["task_id"])
            if len(self._early_finished_fifo) > 65536:
                self._early_finished.discard(
                    self._early_finished_fifo.popleft())
        if spec is not None and spec.actor_id is not None:
            # Remember who produced each still-unconfirmed actor seal:
            # if this worker dies before the owner confirms, the death
            # handler replays the spec on the restarted incarnation
            # (actor methods have no lineage for _maybe_reconstruct).
            for sp in body.get("sealed_pending") or ():
                if sp["object_id"] in self._pending_owner_seals:
                    self._pending_seal_specs[sp["object_id"]] = spec
        if spec is not None:
            t = self.tasks.get(spec.task_id)
            if t:
                t["state"] = FAILED if body.get("failed") else FINISHED
                t["finished_at"] = time.time()
                self._record_finished(spec.task_id)
            self.stats["tasks_failed" if body.get("failed")
                       else "tasks_finished"] += 1
            if not spec.actor_creation:
                # Creation-arg pins are held for the actor's
                # restartable lifetime, released once at permanent
                # DEAD (_release_actor_arg_pins) — not per attempt.
                for dep in self._pinned_ids(spec):
                    e = self.objects.get(dep)
                    if e is not None and e.task_pins > 0:
                        e.task_pins -= 1
                        self._maybe_free(e)
        # A dispatch pass is only useful when this completion freed
        # capacity (allocation released) or a piggybacked seal woke a
        # dep-blocked task — pipelined mid-window completions do
        # neither, and skipping their wake cuts pass count ~4x.
        need_dispatch = self._sealed_woke_task
        self._sealed_woke_task = False
        if rec.actor_id is None:
            # Pipelined same-shape tasks share ONE allocation —
            # release it only when the window fully drains. Wake the
            # dispatcher BEFORE that (window nearly empty) so the
            # refill overlaps the last task's execution instead of
            # stalling the worker. LEASED workers keep their allocation
            # through idle gaps — the owner is still pushing to them
            # directly; the lease end releases it.
            if not rec.inflight:
                # busy answers "is it EXECUTING" (autoscaler idle
                # checks, kill policies) — a leased-but-idle worker is
                # not busy; only its allocation stays held for the
                # lease's remaining life. Leased completions still wake
                # the dispatcher: head-queued spillover may be waiting
                # for exactly this worker's pipeline window (the
                # all-capacity-leased fallback), and a 0.2 s poll tick
                # per refill wave would throttle whole bursts.
                rec.busy = False
                if rec.leased_to is None:
                    self._release_worker_allocation(rec)
                need_dispatch = True
                if rec.retiring:
                    self._maybe_release_retiree(rec.worker_id)
            elif len(rec.inflight) <= 2:
                need_dispatch = True
        else:
            actor = self.actors.get(rec.actor_id)
            if actor is not None and spec is not None and spec.actor_creation:
                actor.state = "ALIVE" if not body.get("failed") else "DEAD"
                self._mark_dirty()
                if actor.state == "ALIVE":
                    # Direct-call plane: owners that asked for this
                    # actor's route before creation finished (or that
                    # lost it to a restart) get the grant pushed now.
                    self._push_direct_grants(actor)
                if actor.state == "DEAD":
                    self._wal_append(("actor_dead", rec.actor_id))
                    actor.death_cause = "creation task failed"
                    self._release_actor_arg_pins(actor)
                    self._drain_actor_queue(actor)
                    if actor.spec.name:
                        # Guarded like the death path: never unregister
                        # a successor that re-took the name.
                        key = (actor.spec.namespace, actor.spec.name)
                        if self.named_actors.get(key) == rec.actor_id:
                            self.named_actors.pop(key, None)
                            self._dir_name_del(key, rec.actor_id)
                    # Retire the dedicated worker and return its
                    # reservation — otherwise failed creations leak
                    # CPUs/chips and a zombie process each.
                    self._release_worker_allocation(rec)
                    if rec.conn is not None:
                        try:
                            rec.conn.cast("kill", {})
                        except rpc.ConnectionLost:
                            pass
            # flush queued calls for this actor
            if actor is not None:
                self._flush_actor(actor)
            rec.busy = bool(rec.inflight)
            need_dispatch = True
        return need_dispatch

    # --- actors ---

    def _release_actor_arg_pins(self, actor: ActorRecord) -> None:
        """lock held. Drop the creation-arg pins exactly once, at the
        actor's permanent-DEAD transition (restarts replay the creation
        args, so per-attempt release would free them too early)."""
        if not actor.arg_pins_held:
            return
        actor.arg_pins_held = False
        for dep in self._pinned_ids(actor.spec):
            e = self.objects.get(dep)
            if e is not None and e.task_pins > 0:
                e.task_pins -= 1
                self._maybe_free(e)

    def _h_create_actor(self, body, conn):
        spec: ActorSpec = body["spec"]
        if spec.name and self.shard is not None:
            # Cluster-wide atomic claim in the directory (outside
            # self.lock: bus round-trip). The local table below stays
            # the authority for THIS shard's names; the directory
            # arbitrates across shards.
            r = self.shard.bus_call("dir_name_put", {
                "key": [spec.namespace, spec.name],
                "actor_id": spec.actor_id, "shard": self.shard.index})
            if not (r or {}).get("ok"):
                raise rpc.RpcError(
                    f"actor name {spec.name!r} already taken")
        with self.lock:
            if spec.name:
                key = (spec.namespace, spec.name)
                if key in self.named_actors:
                    raise rpc.RpcError(f"actor name {spec.name!r} already taken")
                self.named_actors[key] = spec.actor_id
            rec = ActorRecord(spec)
            # Pin init-arg objects (top-level AND nested) for the
            # actor's restartable lifetime; the submitter may drop its
            # refs right after this call returns.
            for dep in self._pinned_ids(spec):
                e = self.objects.get(dep)
                if e is not None:
                    e.task_pins += 1
            rec.arg_pins_held = True
            self.actors[spec.actor_id] = rec
            self._wal_append(("actor_create", spec))
            self._mark_dirty()
        self.dispatch_event.set()
        return {"actor_id": spec.actor_id}

    def _h_submit_actor_task(self, body, conn):
        spec: TaskSpec = spec_from_body(body)
        if self.shard is not None and not conn.peer_info.get("relay"):
            with self.lock:
                known = spec.actor_id in self.actors
            if not known:
                # Another shard's actor: forward the whole submit to
                # its hosting shard (cast — this handler replies None
                # either way; results flow back over the owner plane /
                # relayed seal pushes). The owner rides along so the
                # receiving shard can push to it through the bus.
                shard = self._locate_actor_shard(spec.actor_id)
                if shard is not None and shard != self.shard.index:
                    self.shard.bus_cast("dir_fwd_cast", {
                        "shard": shard, "kind": "submit_actor_task",
                        "body": dict(body, _relay_owner=spec.owner_id)})
                    return None
        self._adopt_evt(spec, body)
        with self.lock:
            if not self._admission_check(spec, conn):
                return None  # typed rejection sealed + backpressure cast
            if spec.deadline:
                self._any_deadlines = True
            for oid in spec.return_ids:
                entry = self.objects.get(oid) or ObjectEntry(oid, spec.owner_id)
                entry.refcount = max(entry.refcount, 1)
                self.objects[oid] = entry
            for dep in self._pinned_ids(spec):
                e = self.objects.get(dep)
                if e is not None:
                    e.task_pins += 1
            self.tasks[spec.task_id] = {
                "task_id": spec.task_id,
                "name": spec.name,
                "state": PENDING,
                "type": "ACTOR_TASK",
                "submitted_at": time.time(),
                "node_id": None,
                "worker_id": None,
            }
            if self._expired(spec):
                self._shed_expired(spec, "submit")
            else:
                self._enqueue_actor_task(spec)
        self.dispatch_event.set()
        return None

    # --- direct-call plane (reference: direct_actor_transport.h +
    # normal_task_submitter.cc:29 — the owner dispatches to workers
    # directly; the head is a directory + async bookkeeper) ---

    def _h_actor_direct_info(self, body, conn):
        """An owner asks for an actor's direct route (cast; the grant
        comes back as a cast so the submit path never blocks). Granted
        only for ALIVE actors whose worker runs a peer server; the
        owner is registered as a watcher for death revokes."""
        owner_id = conn.peer_info.get("client_id")
        if (self.shard is not None and owner_id
                and not conn.peer_info.get("relay")):
            with self.lock:
                have = body["actor_id"] in self.actors
            if not have:
                # The actor lives on another shard: forward the watch
                # registration there; the grant/revoke casts come back
                # relayed through the bus to this owner.
                shard = self._locate_actor_shard(body["actor_id"])
                if shard is not None and shard != self.shard.index:
                    self.shard.bus_cast("dir_fwd_cast", {
                        "shard": shard, "kind": "actor_direct_info",
                        "body": dict(body, _relay_owner=owner_id)})
                    return None
        with self.lock:
            actor = self.actors.get(body["actor_id"])
            if actor is None or not owner_id:
                return None
            # Watchers get the grant pushed the moment the actor is (or
            # becomes, incl. after a restart) ALIVE — and the revoke
            # when its worker dies.
            actor.direct_watchers.add(owner_id)
            grant = self._direct_grant_body(actor)
        if grant is not None:
            try:
                conn.cast_buffered("actor_direct_grant", grant)
            except rpc.ConnectionLost:
                pass
        return None

    def _direct_grant_body(self, actor: ActorRecord) -> "dict | None":
        """lock held. Grant payload for an ALIVE actor's direct route,
        or None when the actor isn't routable (pending, retiring worker,
        worker without a peer server)."""
        if actor.state != "ALIVE":
            return None
        rec = self.workers.get(actor.worker_id or "")
        if rec is None or rec.conn is None or rec.retiring:
            return None
        addr = self.client_owner_addrs.get(rec.worker_id)
        if addr is None:
            return None  # worker has no peer server: head path only
        return {
            "actor_id": actor.spec.actor_id,
            "addr": tuple(addr),
            "worker_id": rec.worker_id,
            "gpu_ids": list(rec.gpu_ids),
            "specenc": bool(rec.conn.peer_info.get("specenc")),
            "out_of_order": bool(getattr(
                actor.spec, "allow_out_of_order", False)),
        }

    def _push_direct_grants(self, actor: ActorRecord) -> None:
        """lock held. The actor just became ALIVE: push the direct
        route to every owner that asked for it (first-call requesters
        and owners re-routing after a restart)."""
        grant = self._direct_grant_body(actor)
        if grant is None:
            return
        for owner_id in actor.direct_watchers:
            self._client_cast(owner_id, "actor_direct_grant", grant)

    def _h_task_started(self, body, conn):
        """Async bookkeeping for a DIRECT-dispatched task (batched cast,
        off the submission latency path): directory entries for the
        return ids, dep pins, task-state row, lineage, and inflight
        registration so the head's own death machinery re-routes the
        task if the worker dies."""
        spec: TaskSpec = spec_from_body(body)
        worker_id = body.get("worker_id")
        with self.lock:
            known = spec.task_id in self.tasks
            finished = spec.task_id in self._early_finished
            if finished:
                self._early_finished.discard(spec.task_id)
            if not known:
                for oid in spec.return_ids:
                    entry = self.objects.get(oid) or ObjectEntry(
                        oid, spec.owner_id)
                    entry.refcount = max(entry.refcount, 1)
                    self.objects[oid] = entry
                for dep in self._pinned_ids(spec):
                    e = self.objects.get(dep)
                    if e is not None:
                        e.task_pins += 1
                self.tasks[spec.task_id] = {
                    "task_id": spec.task_id,
                    "name": spec.name,
                    "state": RUNNING,
                    "type": ("ACTOR_TASK" if spec.actor_id
                             else "NORMAL_TASK"),
                    "submitted_at": time.time(),
                    "started_at": time.time(),
                    "node_id": None,
                    "worker_id": worker_id,
                    "direct": True,
                }
                if spec.actor_id is None:
                    self._record_lineage(spec)
            if (self.config.task_events_enabled and not known
                    and body.get("evt")):
                # Flight recorder: a partial lifecycle record makes the
                # in-flight direct task visible in the timeline NOW; the
                # worker's task_finished completes it (merge by task id)
                # and owner_sealed adds the resolve stamp.
                wrec = self.workers.get(worker_id or "")
                self.task_events.merge({
                    "task_id": spec.task_id,
                    "name": spec.name,
                    "worker_id": worker_id,
                    "node_id": wrec.node_id if wrec is not None else None,
                    "pid": wrec.pid if wrec is not None else None,
                    "owner_id": spec.owner_id,
                    "owner_node_id": self._client_node(spec.owner_id),
                    "direct": True,
                    "phases": dict(body["evt"]),
                })
                self.task_events.register_oids(spec.task_id,
                                               spec.return_ids)
            rec = self.workers.get(worker_id or "")
            if rec is not None and not finished and not known:
                rec.inflight[spec.task_id] = spec
                rec.busy = True
                self.tasks[spec.task_id]["node_id"] = rec.node_id
            elif finished and not known:
                # The completion beat this registration: the task-state
                # row (created above or by recover) closes out here; the
                # seals already flowed through owner_sealed.
                t = self.tasks.get(spec.task_id)
                if t is not None and t["state"] == RUNNING:
                    t["state"] = FINISHED
                    t["finished_at"] = time.time()
                    self._record_finished(spec.task_id)
                # Pins taken above are released now (no inflight entry
                # will ever pop to release them).
                if not known and not spec.actor_creation:
                    for dep in self._pinned_ids(spec):
                        e = self.objects.get(dep)
                        if e is not None and e.task_pins > 0:
                            e.task_pins -= 1
                            self._maybe_free(e)
        return None

    def _h_direct_recover(self, body, conn):
        """The owner re-routes direct calls it can no longer trust to a
        dead/unreachable worker (call, retried client-side). Deduped by
        task state: anything the head already requeued through its own
        death handling — or that already finished — is skipped, so
        recovery never double-submits (at-least-once only when the
        direct link itself silently ate the push or the ack)."""
        specs = list(body.get("specs") or ())
        if self.shard is not None and not conn.peer_info.get("relay"):
            # Items for actors hosted on other shards recover THERE
            # (forwarded whole, owner riding along); the rest proceed
            # locally. Locate runs outside self.lock (bus round-trip).
            keep = []
            for sbody in specs:
                spec = spec_from_body(sbody)
                if spec.actor_id is not None:
                    with self.lock:
                        known = spec.actor_id in self.actors
                    if not known:
                        shard = self._locate_actor_shard(spec.actor_id)
                        if shard is not None \
                                and shard != self.shard.index:
                            self.shard.bus_cast("dir_fwd_cast", {
                                "shard": shard,
                                "kind": "direct_recover",
                                "body": {"specs": [sbody],
                                         "_relay_owner": spec.owner_id}})
                            continue
                keep.append(sbody)
            specs = keep
        accepted = []
        with self.lock:
            for sbody in specs:
                spec: TaskSpec = spec_from_body(sbody)
                t = self.tasks.get(spec.task_id)
                if t is not None and t["state"] in (FINISHED, FAILED):
                    continue
                if t is not None and t["state"] == PENDING:
                    continue  # head already requeued it (death path)
                stale_wid = sbody.get("worker_id") or t and t.get(
                    "worker_id")
                if stale_wid:
                    stale = self.workers.get(stale_wid)
                    if stale is not None:
                        stale.inflight.pop(spec.task_id, None)
                if t is None:
                    # task_started never landed: full registration.
                    for oid in spec.return_ids:
                        entry = self.objects.get(oid) or ObjectEntry(
                            oid, spec.owner_id)
                        entry.refcount = max(entry.refcount, 1)
                        self.objects[oid] = entry
                    for dep in self._pinned_ids(spec):
                        e = self.objects.get(dep)
                        if e is not None:
                            e.task_pins += 1
                    self.tasks[spec.task_id] = {
                        "task_id": spec.task_id,
                        "name": spec.name,
                        "state": PENDING,
                        "type": ("ACTOR_TASK" if spec.actor_id
                                 else "NORMAL_TASK"),
                        "submitted_at": time.time(),
                        "node_id": None,
                        "worker_id": None,
                        "direct": True,
                    }
                    if spec.actor_id is None:
                        self._record_lineage(spec)
                else:
                    t["state"] = PENDING
                    t["worker_id"] = None
                accepted.append(spec.task_id)
                if spec.actor_id is not None:
                    actor = self.actors.get(spec.actor_id)
                    if actor is not None and actor.state != "DEAD":
                        # Recovered calls predate anything the owner
                        # head-routed after the spillback: front of the
                        # queue, in seq order (mirrors the death
                        # handler's replay ordering).
                        idx = next(
                            (i for i, p in enumerate(actor.pending)
                             if p.owner_id == spec.owner_id
                             and p.seq_no > spec.seq_no),
                            len(actor.pending))
                        self._pending_inc(spec)
                        actor.pending.insert(idx, spec)
                        if actor.state == "ALIVE":
                            self._flush_actor(actor)
                    else:
                        self._enqueue_actor_task(spec)  # fails: dead
                else:
                    self._enqueue_task_spec(spec)
        self.dispatch_event.set()
        return {"accepted": accepted}

    def _grant_lease(self, rec: WorkerRecord, spec: TaskSpec) -> None:
        """lock held. A normal task carrying a lease request just landed
        on a leasable worker: hand the owner a time/count-bounded direct
        route (reference: worker leases, normal_task_submitter.cc:29)."""
        if (rec.actor_id is not None or rec.gpu_capable or rec.retiring
                or rec.leased_to is not None or rec.conn is None
                # Memory-aware backpressure: pressured nodes grant no
                # leases — a lease is a standing invitation to push
                # work at a node that must shed load instead.
                or rec.node_id in self.pressured_nodes):
            return
        # Only a worker whose sole inflight task is the one that carried
        # the request is leasable: granting on a worker mid-way through
        # OTHER work hands the owner a "fast direct route" to the
        # busiest worker in the pool (a quick direct push then queues
        # behind a possibly minutes-long head task), and the lease pins
        # that worker's allocation on top of it.
        if len(rec.inflight) > 1:
            return
        # Lease POOL per (owner, shape): one lease per distinct worker,
        # granted as same-shape spillover lands on fresh leasable
        # workers — the pool converges on the shape's real parallelism.
        # Deduped per worker (a submission burst carries the request on
        # every task until the first grant lands) and capped so one
        # owner cannot lease an entire large pool away.
        owner_leases = getattr(self, "_owner_leases", None)
        if owner_leases is None:
            owner_leases = self._owner_leases = {}
        lk = (spec.owner_id, spec._lease_key)
        held = owner_leases.setdefault(lk, set())
        held &= set(self.workers)  # drop dead workers from the count
        owner_leases[lk] = held
        if rec.worker_id in held or len(held) >= 16:
            return
        addr = self.client_owner_addrs.get(rec.worker_id)
        oconn = self.clients.get(spec.owner_id)
        if addr is None or oconn is None:
            return
        held.add(rec.worker_id)
        rec.leased_to = spec.owner_id
        rec.lease_deadline = time.time() + self.config.lease_ttl_s
        rec.lease_key = spec._lease_key
        try:
            oconn.cast_buffered("lease_grant", {
                "key": spec._lease_key,
                "addr": tuple(addr),
                "worker_id": rec.worker_id,
                "ttl_s": self.config.lease_ttl_s,
                "max_calls": self.config.lease_max_calls,
                "window": self.config.lease_window,
                "specenc": bool(rec.conn.peer_info.get("specenc")),
            })
        except rpc.ConnectionLost:
            held.discard(rec.worker_id)
            rec.leased_to = None
            rec.lease_key = None

    def _end_lease(self, rec: WorkerRecord, revoke: bool = False) -> None:
        """lock held. Clear a worker's lease; optionally tell the owner
        (worker death/retirement — the owner must stop pushing). The
        allocation releases once nothing is inflight."""
        owner = rec.leased_to
        if owner is not None and rec.lease_key is not None:
            ol = getattr(self, "_owner_leases", None)
            if ol is not None:
                held = ol.get((owner, rec.lease_key))
                if held is not None:
                    held.discard(rec.worker_id)
                    if not held:
                        ol.pop((owner, rec.lease_key), None)
        rec.leased_to = None
        rec.lease_deadline = 0.0
        rec.lease_key = None
        if revoke and owner:
            oconn = self.clients.get(owner)
            if oconn is not None:
                try:
                    oconn.cast_buffered("lease_revoke",
                                        {"worker_id": rec.worker_id})
                except rpc.ConnectionLost:
                    pass
        if not rec.inflight and rec.worker_id in self.workers:
            rec.busy = False
            self._release_worker_allocation(rec)
            self.dispatch_event.set()

    def _h_lease_return(self, body, conn):
        """Owner voluntarily returns a lease (expiry, shutdown)."""
        with self.lock:
            rec = self.workers.get(body["worker_id"])
            if rec is not None and rec.leased_to == conn.peer_info.get(
                    "client_id"):
                self._end_lease(rec)
        return None

    def _enqueue_actor_task(self, spec: TaskSpec) -> None:
        actor = self.actors.get(spec.actor_id)
        if actor is None or actor.state == "DEAD":
            self._fail_task(
                spec,
                f"ActorDiedError: actor {spec.actor_id} is dead"
                + (f" ({actor.death_cause})" if actor else ""),
                kind="actor_died",
            )
            return
        self._pending_inc(spec)
        actor.pending.append(spec)
        if actor.state == "ALIVE":
            self._flush_actor(actor)

    def _flush_actor(self, actor: ActorRecord) -> None:
        """Push queued calls to the actor's worker respecting dependencies.
        lock held."""
        if actor.state != "ALIVE" or actor.worker_id is None:
            return
        rec = self.workers.get(actor.worker_id)
        if rec is None or rec.conn is None:
            return
        if getattr(actor.spec, "allow_out_of_order", False):
            # Out-of-order execution (opt-in; reference:
            # out_of_order_actor_submit_queue.h): every dep-ready call
            # dispatches NOW; calls parked on unresolved args do not
            # block later ones. Ready calls still arrive at the worker
            # in submission order relative to each other.
            parked: deque[TaskSpec] = deque()
            while actor.pending:
                spec = actor.pending.popleft()
                if self._expired(spec):
                    self._shed_expired(spec, "actor_queue")
                elif all(self._is_ready(d) for d in spec.deps):
                    self._push_to_worker(rec, spec)
                else:
                    parked.append(spec)
            actor.pending = parked
            return
        # Strict submission-order dispatch: stop at the first call whose
        # args are not yet available (later calls must not overtake it —
        # per-handle ordering, reference: sequential_actor_submit_queue.h).
        while actor.pending:
            spec = actor.pending[0]
            if self._expired(spec):
                # Expired calls shed in order (a typed error IS the
                # call's outcome, so ordering is preserved).
                actor.pending.popleft()
                self._shed_expired(spec, "actor_queue")
                continue
            if not all(self._is_ready(d) for d in spec.deps):
                break
            actor.pending.popleft()
            self._push_to_worker(rec, spec)

    def _h_kill_actor(self, body, conn):
        with self.lock:
            actor = self.actors.get(body["actor_id"])
        if actor is None and self.shard is not None \
                and not body.get("_shard_local"):
            shard = self._locate_actor_shard(body["actor_id"])
            if shard is not None and shard != self.shard.index:
                return self.shard.bus_call("dir_fwd", {
                    "shard": shard, "kind": "kill_actor",
                    "body": dict(body, _shard_local=True)})
        with self.lock:
            actor = self.actors.get(body["actor_id"])
            if actor is None:
                return {}
            if body.get("no_restart", True):
                actor.spec.max_restarts = 0
                # Durable: a head crash between this kill and the
                # worker-death processing must not resurrect the actor
                # from the WAL's actor_create (whose pickled spec still
                # has the original budget).
                self._wal_append(("actor_max_restarts",
                                  body["actor_id"], 0))
                self._mark_dirty()
                # The actor is doomed NOW: unregister its name so a
                # concurrent get_actor cannot hand out a handle that
                # dies mid-first-call (the kill → worker-death window
                # is real — the death path reaps the exit status and
                # builds the crash report before the DEAD transition).
                if actor.spec.name:
                    key = (actor.spec.namespace, actor.spec.name)
                    if self.named_actors.get(key) == body["actor_id"]:
                        self.named_actors.pop(key, None)
                        self._dir_name_del(key, body["actor_id"])
            rec = self.workers.get(actor.worker_id) if actor.worker_id else None
            if rec is not None and rec.expected_exit is None:
                rec.expected_exit = ("intended_kill",
                                     "ray_tpu_torch.kill(actor) requested")
        if rec is not None and rec.proc is not None:
            rec.proc.kill()
        elif rec is not None and rec.zygote and rec.pid:
            try:
                os.kill(rec.pid, 9)
            except OSError:
                pass
        elif rec is not None and rec.conn is not None:
            # Remote worker: tell it to exit; its connection drop runs the
            # normal death handling.
            try:
                rec.conn.cast("kill", {})
            except rpc.ConnectionLost:
                pass
        else:
            with self.lock:
                actor.state = "DEAD"
                actor.death_cause = "killed before start"
                self._release_actor_arg_pins(actor)
                self._drain_actor_queue(actor)
                self._wal_append(("actor_dead", body["actor_id"]))
                self._mark_dirty()
        return {}

    def _h_list_named_actors(self, body, conn):
        """Names of live named actors (reference:
        util/__init__.py:29 list_named_actors)."""
        if self.shard is not None:
            # The directory's claim table is the cluster-wide view.
            r = self.shard.bus_call("dir_name_list", {})
            names = [tuple(k) for k in (r or {}).get("names", [])]
        else:
            with self.lock:
                names = list(self.named_actors)
        if body.get("all_namespaces"):
            return {"actors": [
                {"namespace": ns, "name": name}
                for (ns, name) in names
            ]}
        ns = body.get("namespace", "")
        return {"actors": [name for (n, name) in names if n == ns]}

    def _h_get_named_actor(self, body, conn):
        key = (body.get("namespace", ""), body["name"])
        with self.lock:
            actor_id = self.named_actors.get(key)
            if actor_id is not None:
                actor = self.actors[actor_id]
                return {
                    "actor_id": actor_id,
                    "cls_func_id": actor.spec.cls_func_id,
                    "max_concurrency": actor.spec.max_concurrency,
                }
        if self.shard is not None and not body.get("_shard_local"):
            # Another shard may hold the name: the directory knows.
            r = self.shard.bus_call("dir_name_get", {"key": list(key)})
            shard = (r or {}).get("shard")
            if shard is not None and shard != self.shard.index:
                self._xshard_actors[r["actor_id"]] = shard
                return self.shard.bus_call("dir_fwd", {
                    "shard": shard, "kind": "get_named_actor",
                    "body": dict(body, _shard_local=True)})
        raise rpc.RpcError(f"no actor named {body['name']!r}")

    def _drain_actor_queue(self, actor: ActorRecord) -> None:
        while actor.pending:
            spec = actor.pending.popleft()
            self._fail_task(
                spec,
                f"ActorDiedError: actor died ({actor.death_cause})",
                kind="actor_died",
            )

    # --- placement groups ---

    def _h_create_pg(self, body, conn):
        pg_id = "pg-" + uuid.uuid4().hex[:8]
        rec = PlacementGroupRecord(pg_id, body.get("name", ""), body["bundles"], body["strategy"])
        with self.lock:
            self.pgs[pg_id] = rec
            self._wal_append(("pg_create", pg_id, rec.name, rec.bundles,
                              rec.strategy))
            self._mark_dirty()
            # `ready()` object: sealed once the gang reservation commits.
            entry = ObjectEntry(pg_id + ":ready", "head")
            entry.refcount = 1
            self.objects[pg_id + ":ready"] = entry
            self._try_place_pg(rec)
        return {"pg_id": pg_id}

    def _try_place_pg(self, rec: PlacementGroupRecord) -> None:
        """lock held. Gang-reserve bundle resources (2PC analogue:
        gcs_placement_group_scheduler.h prepare/commit collapsed to one step
        since the head owns all node availability)."""
        if rec.state == "CREATED":
            return
        placement = self.scheduler.place_bundles(rec.bundles, rec.strategy)
        if placement is None:
            return
        for node_id, bundle in zip(placement, rec.bundles):
            self.scheduler.acquire(node_id, ResourceSet(bundle))
        rec.node_per_bundle = placement
        rec.state = "CREATED"
        self._seal_inline(rec.pg_id + ":ready", True)
        for conn, waiter_id in rec.waiters:
            try:
                conn.cast("pg_ready", {"waiter_id": waiter_id, "pg_id": rec.pg_id})
            except rpc.ConnectionLost:
                pass
        rec.waiters.clear()

    def _h_pg_wait(self, body, conn):
        with self.lock:
            rec = self.pgs.get(body["pg_id"])
            if rec is None:
                raise rpc.RpcError(f"unknown placement group {body['pg_id']}")
            if rec.state == "CREATED":
                conn.cast("pg_ready", {"waiter_id": body["waiter_id"], "pg_id": rec.pg_id})
            else:
                rec.waiters.append((conn, body["waiter_id"]))
        return None

    def _h_remove_pg(self, body, conn):
        with self.lock:
            rec = self.pgs.pop(body["pg_id"], None)
            if rec is not None:
                self._wal_append(("pg_remove", body["pg_id"]))
                self._mark_dirty()
            if rec is not None and rec.state == "CREATED":
                for node_id, bundle in zip(rec.node_per_bundle, rec.bundles):
                    self.scheduler.release(node_id, ResourceSet(bundle))
            # Retry other pending PGs with the freed resources.
            for other in self.pgs.values():
                self._try_place_pg(other)
        self.dispatch_event.set()
        return {}

    # --- cluster info / state API ---

    def _h_cluster_resources(self, body, conn):
        with self.lock:
            total: dict[str, float] = {}
            avail: dict[str, float] = {}
            for n in self.scheduler.alive_nodes():
                for k, v in n.total.to_dict().items():
                    total[k] = total.get(k, 0) + v
                for k, v in n.available.to_dict().items():
                    avail[k] = avail.get(k, 0) + v
        for r in self._xshard_fanout("cluster_resources", body):
            for k, v in (r.get("total") or {}).items():
                total[k] = total.get(k, 0) + v
            for k, v in (r.get("available") or {}).items():
                avail[k] = avail.get(k, 0) + v
        return {"total": total, "available": avail}

    def _h_profile_result(self, body, conn):
        """A worker's sampling run finished: wake the parked request."""
        with self.lock:
            waiter = self.profile_waiters.get(body.get("req_id") or "")
        if waiter is not None:
            ev, holder = waiter
            holder.update(body)
            ev.set()
        return None

    def _h_profile_worker(self, body, conn):
        """Live stack capture of a worker (reference:
        dashboard/modules/reporter/profile_manager.py:191 — py-spy).
        Two modes:
          - default: one faulthandler snapshot ("where is it stuck"),
            harvested from the worker log;
          - sample_s > 0: the worker samples all threads at `hz` for
            that long and reports folded collapsed stacks ("where does
            time GO") over its own connection — no log scanning, no
            cross-request interleaving."""
        import signal

        worker_id = body["worker_id"]
        sample_s = float(body.get("sample_s") or 0.0)
        if sample_s > 0:
            sample_s = min(15.0, max(0.1, sample_s))
            with self.lock:
                rec = self.workers.get(worker_id)
                wconn = rec.conn if rec is not None else None
            if wconn is None:
                return {"worker_id": worker_id,
                        "error": "unknown worker or no connection"}

            def rendezvous() -> dict:
                # Runs on a DeferredReply thread: waiting out the sample
                # must not park the requesting connection's reader (the
                # dashboard multiplexes every /api call over one conn).
                req_id = uuid.uuid4().hex[:16]
                ev = threading.Event()
                holder: dict = {}
                with self.lock:
                    self.profile_waiters[req_id] = (ev, holder)
                try:
                    wconn.cast("profile_start", {
                        "req_id": req_id, "duration_s": sample_s,
                        "hz": int(body.get("hz") or 50),
                        "mode": body.get("mode") or "cpu",
                        "include_idle": bool(body.get("include_idle"))})
                    if not ev.wait(sample_s + 10.0):
                        return {"worker_id": worker_id,
                                "error": "sampling timed out"}
                finally:
                    with self.lock:
                        self.profile_waiters.pop(req_id, None)
                holder.pop("req_id", None)
                return {"worker_id": worker_id, **holder}

            return rpc.DeferredReply(rendezvous)
        # Clamped: this handler polls on the requesting connection's
        # reader thread, so only ITS client stalls, and boundedly.
        timeout_s = min(5.0, max(0.2, float(body.get("timeout_s", 3.0))))
        with self.lock:
            rec = self.workers.get(worker_id)
            if rec is None:
                return {"worker_id": worker_id, "error": "unknown worker"}
            # Zygote-forked workers have no Popen handle but ARE local
            # (their pid is this machine's — signal via os.kill).
            pid, node_id, local = (rec.pid, rec.node_id,
                                   rec.proc is not None or rec.zygote)
            agent = self.node_agents.get(node_id)
        path = os.path.join(self.session_dir, "logs", f"{worker_id}.log")
        before = 0
        if local:
            try:
                before = os.path.getsize(path)
            except OSError:
                before = 0
        try:
            if local:
                os.kill(pid, signal.SIGUSR1)
            elif agent is not None:
                agent.cast("signal_worker",
                           {"worker_id": worker_id,
                            "signum": int(signal.SIGUSR1)})
            else:
                return {"worker_id": worker_id,
                        "error": f"node {node_id} has no agent connection"}
        except Exception as e:  # noqa: BLE001
            return {"worker_id": worker_id, "error": str(e)}
        if not local:
            return {"worker_id": worker_id, "signalled": True,
                    "note": "remote worker: dump lands in its node-local "
                            "log"}
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = before
            if size > before:
                with open(path, "rb") as f:
                    f.seek(before)
                    dump = f.read().decode("utf-8", errors="replace")
                # Ordinary log output can land in the window too: only a
                # faulthandler header marks the actual dump, and the
                # thread list may still be flushing — keep polling until
                # the marker shows (returning from the marker on).
                marker = dump.find("Thread 0x")
                if marker < 0:
                    marker = dump.find("Current thread")
                if marker >= 0:
                    time.sleep(0.2)  # let the remaining threads flush
                    with open(path, "rb") as f:
                        f.seek(before)
                        dump = f.read().decode("utf-8", errors="replace")
                    marker2 = dump.find("Thread 0x")
                    if marker2 < 0:
                        marker2 = dump.find("Current thread")
                    return {"worker_id": worker_id, "pid": pid,
                            "stacks": dump[marker2:].splitlines()}
            time.sleep(0.05)
        return {"worker_id": worker_id, "pid": pid, "stacks": [],
                "error": "no dump appeared (worker busy in native code?)"}

    def _h_cluster_profile(self, body, conn):
        """Continuous-profiling state query (util.state.cluster_profile
        / `ray-tpu profile`): the bounded cluster profile table,
        filtered by role/node/window, plus GIL-starvation exemplars and
        plane counters. Sharded head: each shard contributes its own
        table through the directory fanout — window records keep their
        (node, role) identity so the merged view stays attributable."""
        role = body.get("role")
        node = body.get("node")
        window = body.get("window")
        with self.lock:
            wins = []
            for (n, r, w), rec in self.cluster_profile.items():
                if role is not None and r != role:
                    continue
                if node is not None and n != node:
                    continue
                if window is not None and w != int(window):
                    continue
                rec = dict(rec)
                rec["folded"] = dict(rec["folded"])
                rec["pinned_flag"] = (n, r, w) in self._pinned_windows
                wins.append(rec)
            out = {
                "windows": sorted(wins, key=lambda x: (x["end"],
                                                       x["node"],
                                                       x["role"])),
                "gil_exemplars": list(self._gil_exemplars),
                "stats": dict(self.profile_stats),
                "window_s": self.config.profiling_window_s,
            }
        for rep in self._xshard_fanout("cluster_profile", body):
            out["windows"].extend(rep.get("windows") or ())
            out["gil_exemplars"].extend(rep.get("gil_exemplars") or ())
            for k, v in (rep.get("stats") or {}).items():
                out["stats"][k] = out["stats"].get(k, 0) + v
        return out

    def _h_get_nodes(self, body, conn):
        with self.lock:
            nodes = [
                    {
                        "node_id": n.node_id,
                        "address": n.address,
                        "alive": n.alive,
                        "is_head": n.node_id == self.node_id,
                        "resources": n.total.to_dict(),
                        "available": n.available.to_dict(),
                        "labels": n.labels,
                        # Reference parity: ray.nodes() rows carry
                        # NodeManagerAddress/ObjectManagerPort; these
                        # are the agent's public control (transfer) and
                        # raw-socket bulk endpoints.
                        "transfer_address": self.node_transfer_addrs.get(
                            n.node_id),
                        "bulk_address": self.node_bulk_addrs.get(
                            n.node_id),
                    }
                    for n in self.scheduler.nodes.values()
                ]
        for r in self._xshard_fanout("get_nodes", body):
            nodes.extend(r.get("nodes") or [])
        return {"nodes": nodes}

    def _h_list_tasks(self, body, conn):
        state = body.get("state")
        task_id = body.get("task_id")
        worker_id = body.get("worker_id")
        with self.lock:
            if task_id is not None:
                # Point lookup (dashboard drill-down): never ship the
                # table to select one row. Remaining pushed-down
                # filters still apply — the client stripped them.
                t = self.tasks.get(task_id)
                recs = [t] if t is not None and (
                    (state is None or t["state"] == state)
                    and (worker_id is None
                         or t.get("worker_id") == worker_id)) else []
            elif state is not None or worker_id is not None:
                # Server-side filters: hot pollers (autoscaler) and the
                # per-actor task view must not ship the whole task
                # table per request.
                recs = [t for t in self.tasks.values()
                        if (state is None or t["state"] == state)
                        and (worker_id is None
                             or t.get("worker_id") == worker_id)]
            else:
                recs = list(self.tasks.values())
        for r in self._xshard_fanout("list_tasks", body):
            recs.extend(r.get("tasks") or [])
        limit = body.get("limit", 1000)
        return {"tasks": recs[-limit:]}

    def _actor_row(self, a: ActorRecord) -> dict:
        return {
            "actor_id": a.spec.actor_id,
            "name": a.spec.name,
            "state": a.state,
            "node_id": a.node_id,
            "worker_id": a.worker_id,
            "pid": self.workers[a.worker_id].pid if a.worker_id in self.workers else None,
            "restarts": a.restarts,
            "class_name": a.spec.name or a.spec.cls_func_id,
            "resources": dict(a.spec.resources or {}),
        }

    def _h_list_actors(self, body, conn):
        actor_id = body.get("actor_id")
        with self.lock:
            if actor_id is not None:
                # Point lookup pushed down (mirrors _h_list_tasks'
                # task_id path): get_actor() and the dashboard actor
                # drill-down must not ship the whole actor table.
                a = self.actors.get(actor_id)
                rows = [self._actor_row(a)] if a is not None else []
            else:
                rows = [self._actor_row(a)
                        for a in self.actors.values()]
        if actor_id is None or not rows:
            for r in self._xshard_fanout("list_actors", body):
                rows.extend(r.get("actors") or [])
        return {"actors": rows}

    def _h_list_placement_groups(self, body, conn):
        with self.lock:
            pgs = [
                    {
                        "placement_group_id": pg.pg_id,
                        "name": pg.name,
                        "state": pg.state,
                        "strategy": pg.strategy,
                        "bundles": [dict(b) for b in pg.bundles],
                        "node_per_bundle": list(pg.node_per_bundle or ()),
                    }
                    for pg in self.pgs.values()
                ]
        for r in self._xshard_fanout("list_placement_groups", body):
            pgs.extend(r.get("placement_groups") or [])
        return {"placement_groups": pgs}

    def _object_node(self, e: ObjectEntry) -> str:
        """lock held. Which node holds this object's bytes: the P2P
        hosting node, the head arena's node, or (owner-resident) the
        owning runtime's node."""
        if e.location is not None:
            return e.location
        if e.offset is not None or e.inline is not None:
            return self.node_id
        if e.owner_resident:
            w = self.workers.get(e.owner_id)
            if w is not None:
                return w.node_id
        return self.node_id

    def _object_row(self, e: ObjectEntry,
                    attribution: "dict | None" = None) -> dict:
        """lock held. One full state-API row for an object directory
        entry (reference: util/state list_objects columns + the `ray
        memory` per-ref table)."""
        row = {
            "object_id": e.object_id,
            "state": e.state,
            "size": e.size,
            "refcount": e.refcount,
            "owner": e.owner_id,
            "borrowers": sorted(e.borrowers),
            "container_pins": e.container_pins,
            "task_pins": e.task_pins,
            "read_pins": e.read_pins,
            "node_id": self._object_node(e),
            "owner_resident": e.owner_resident,
            "is_error": e.is_error,
            "created_at": e.created_at,
            "age_s": round(time.time() - e.created_at, 1),
            "reads": e.reads,
            "spilled": e.state == SPILLED,
            "location": e.location,
            "replicas": sorted(e.replicas),
        }
        task_id = self.lineage[e.object_id].task_id \
            if e.object_id in self.lineage \
            else self.task_events.producer_task(e.object_id)
        if task_id is not None:
            row["task_id"] = task_id
        cs = (attribution or {}).get(e.object_id)
        if cs is not None:
            row["callsite"] = cs[1]
        return row

    def _h_list_objects(self, body, conn):
        body = body or {}
        object_id = body.get("object_id")
        with self.lock:
            attribution = self._census_attribution()
            if object_id is not None:
                # Point lookup pushed down (mirrors _h_list_tasks'
                # task_id path): a drill-down must never ship the whole
                # object table.
                e = self.objects.get(object_id)
                rows = [self._object_row(e, attribution)] \
                    if e is not None else []
            else:
                rows = [self._object_row(e, attribution)
                        for e in self.objects.values()]
        if object_id is None or not rows:
            for r in self._xshard_fanout("list_objects", body):
                rows.extend(r.get("objects") or [])
        if object_id is not None:
            return {"objects": rows}
        limit = int(body.get("limit", 1_000_000))
        return {"objects": rows[-limit:]}

    def _lineage_chain(self, oid: str, depth: int = 5,
                       fanout: int = 4) -> dict:
        """lock held. The lineage chain for one object id: obj ← task ←
        args ← … (reference: the ownership/lineage walk behind
        `ray memory` debugging + ObjectRecoveryManager's recursive
        reconstruction). Bounded depth and per-task arg fanout."""
        node: dict = {"object_id": oid}
        spec = self.lineage.get(oid)
        task_id = spec.task_id if spec is not None \
            else self.task_events.producer_task(oid)
        if task_id is None:
            return node
        t = self.tasks.get(task_id) or {}
        task: dict = {
            "task_id": task_id,
            "name": spec.name if spec is not None else t.get("name"),
            "state": t.get("state"),
            "worker_id": t.get("worker_id"),
            "node_id": t.get("node_id"),
        }
        ev = self.task_events.task_record(task_id)
        if ev is not None:
            # Flight-recorder cross-link: the producing task's phase
            # stamps ride the drill-down (obj ← task ← its timeline).
            task["phases"] = ev.get("phases") or {}
            if ev.get("actor_id"):
                task["actor_id"] = ev["actor_id"]
        node["task"] = task
        deps = list(spec.deps or ()) if spec is not None else []
        if deps and depth > 0:
            node["args"] = [self._lineage_chain(d, depth - 1, fanout)
                            for d in deps[:fanout]]
            if len(deps) > fanout:
                node["args_truncated"] = len(deps) - fanout
        return node

    def _h_get_object(self, body, conn):
        """Object drill-down: the full row, the owner census record
        (callsite/kind) when known, and the lineage chain."""
        oid = body["object_id"]
        with self.lock:
            e = self.objects.get(oid)
            attribution = self._census_attribution()
            row = self._object_row(e, attribution) if e is not None \
                else None
            chain = self._lineage_chain(oid)
        if row is None and "task" not in chain:
            # Not ours: the owning shard has the row + lineage.
            for r in self._xshard_fanout("get_object", body):
                if r.get("object"):
                    return r
            return {"object": None}
        out = row or {"object_id": oid, "state": "FREED"}
        out["lineage"] = chain
        return {"object": out}

    def _h_list_workers(self, body, conn):
        with self.lock:
            workers = [
                    {
                        "worker_id": w.worker_id,
                        "node_id": w.node_id,
                        "pid": w.pid,
                        "busy": w.busy,
                        "actor_id": w.actor_id,
                    }
                    for w in self.workers.values()
                ]
        for r in self._xshard_fanout("list_workers", body):
            workers.extend(r.get("workers") or [])
        return {"workers": workers}

    def _h_log_index(self, body, conn):
        """Per-worker log file index (reference: `ray logs` listing via
        the dashboard log module — dashboard/modules/log). With a
        node_id the request forwards over the agent's own connection
        (rpc conns are bidirectional), so every node's logs are
        listable from the driver."""
        fwd = self._forward_to_agent("log_index", body)
        if fwd is not None:
            return fwd
        from ray_tpu_torch._private import log_utils

        return {"logs": log_utils.log_index(
            os.path.join(self.session_dir, "logs"))}

    def _h_log_tail(self, body, conn):
        """Tail one worker log (reference: `ray logs <file>`), locally
        or on a remote node via its agent (body["node_id"])."""
        fwd = self._forward_to_agent("log_tail", body)
        if fwd is not None:
            return fwd
        from ray_tpu_torch._private import log_utils

        return log_utils.log_tail(
            os.path.join(self.session_dir, "logs"), body["name"],
            int(body.get("max_bytes", 64 * 1024)))

    def _forward_to_agent(self, kind: str, body: dict) -> "dict | None":
        """Route a log request to the named node's agent; None means
        'serve locally' (no node_id given). Blocking call on the
        requesting client's reader thread — acceptable for CLI log
        requests, which are rare and small."""
        node_id = body.get("node_id")
        if not node_id:
            return None
        with self.lock:
            agent = self.node_agents.get(node_id)
        empty = ({"logs": []} if kind == "log_index"
                 else {"name": body.get("name", ""), "lines": []})
        if agent is None:
            return {"error": f"no agent for node {node_id!r}", **empty}
        try:
            return agent.call(kind, {k: v for k, v in body.items()
                                     if k != "node_id"}, timeout=10.0) or empty
        except Exception as e:  # ConnectionLost / futures TimeoutError
            return {"error": f"agent unreachable: {e!r}", **empty}

    def _h_stop_cluster(self, body, conn):
        """`ray-tpu stop` (reference: `ray stop`): ask every agent to
        shut down, then schedule the head's own exit off-thread so this
        reply still reaches the caller."""
        with self.lock:
            agents = list(self.node_agents.values())
        for a in agents:
            try:
                a.cast("shutdown_node", {})
            except rpc.ConnectionLost:
                pass

        def _exit():
            time.sleep(0.5)
            if self.shard is not None:
                # Whole-cluster stop: the directory tears every shard
                # down (including this one) with recorded intent.
                self.shard.bus_cast("dir_stop", {})
                time.sleep(10)  # the shard_stop cast exits us first
            self.shutdown()
            os._exit(0)

        if not body.get("head_keepalive"):
            threading.Thread(target=_exit, daemon=True,
                             name="stop-cluster").start()
        return {"stopping": True, "agents": len(agents)}

    def _h_worker_retiring(self, body, conn):
        """max_calls worker recycling, phase 1 (reference: the worker's
        graceful Disconnect handshake with its raylet): mark the worker
        retiring — nothing new dispatches to it — and release it the
        moment its delivered results are all owner-confirmed."""
        with self.lock:
            rec = self.workers.get(body["worker_id"])
            if rec is None:
                return None
            if rec.actor_id is not None:
                # The dispatcher converted this worker to an actor in
                # the window before the retiring cast arrived: the
                # retirement is void (the worker cancels its side on
                # become_actor) — killing a live actor would burn its
                # restart budget.
                return None
            rec.retiring = True
            if rec.leased_to is not None:
                # A retiring worker's lease is void: the owner falls
                # back to the head path (its queued direct pushes are
                # direct_rej'd by the worker and spill back too).
                self._end_lease(rec, revoke=True)
            self._maybe_release_retiree(rec.worker_id)
        return None

    def _maybe_release_retiree(self, worker_id: str) -> None:
        """lock held. Phase 2: every pending owner-seal confirmed and
        nothing inflight -> tell the worker it may exit."""
        rec = self.workers.get(worker_id)
        if rec is None or not rec.retiring or rec.actor_id is not None:
            return
        if rec.inflight or self._worker_pending_seals.get(worker_id):
            return
        if rec.conn is not None:
            if rec.expected_exit is None:
                rec.expected_exit = (
                    "retired", "max_calls budget reached; clean "
                    "retirement after owner-confirmed results")
            try:
                rec.conn.cast("exit_worker", {})
            except rpc.ConnectionLost:
                pass

    def _store_stats_locked(self) -> dict:
        """lock held. Arena stats plus the pin/fragmentation breakdown
        that makes memory-pressure decisions explainable: how much of
        the in-use arena is pinned (cannot spill/evict) vs reclaimable,
        and how many eviction candidates the spill scan would find."""
        pinned_bytes = reclaimable_bytes = 0
        eviction_candidates = num_spilled = 0
        for e in self.objects.values():
            if e.state == SPILLED:
                num_spilled += 1
            if e.offset is None:
                continue  # not arena-resident (inline/p2p/owner/spilled)
            if e.state != SEALED:
                continue
            if e.read_pins > 0:
                # The same predicate as _alloc_with_spill's candidate
                # scan: read-pinned sealed bytes can neither spill nor
                # free until the pins drop.
                pinned_bytes += e.size
            else:
                reclaimable_bytes += e.size
                eviction_candidates += 1
        capacity, in_use = self.arena.capacity, self.arena.in_use
        largest_free = self.arena.largest_free
        return {
            "capacity": capacity,
            "in_use": in_use,
            "num_objects": self.arena.num_objects,
            "largest_free": largest_free,
            "num_entries": len(self.objects),
            "num_spilled": num_spilled,
            # Free space the allocator cannot serve as one block — the
            # fragmentation the arena's best-fit policy is fighting.
            "fragmented_free": max(0, capacity - in_use - largest_free),
            "pinned_bytes": pinned_bytes,
            "reclaimable_bytes": reclaimable_bytes,
            "eviction_candidates": eviction_candidates,
        }

    def _h_store_stats(self, body, conn):
        with self.lock:
            stats = self._store_stats_locked()
        for r in self._xshard_fanout("store_stats", body):
            for k, v in r.items():
                if isinstance(v, (int, float)):
                    stats[k] = stats.get(k, 0) + v
        return stats

    def _h_memory_summary(self, body, conn):
        """The cluster-wide `ray-tpu memory` feed (reference:
        _private/internal_api.py memory_summary): owner censuses merged
        by callsite, directory bytes grouped by node and state, store
        stats, and the leak detector's current suspects — one call, no
        full object table transfer."""
        with self.lock:
            groups: dict[str, dict] = {}
            census_clients: dict[str, dict] = {}
            for cid, rep in self.object_census.items():
                census_clients[cid] = {
                    "live_objects": rep.get("live_objects", 0),
                    "live_bytes": rep.get("live_bytes", 0),
                    "dropped": rep.get("dropped", 0),
                    "ts": rep.get("ts"),
                }
                for site, g in (rep.get("groups") or {}).items():
                    m = groups.get(site)
                    if m is None:
                        m = groups[site] = {
                            "count": 0, "bytes": 0, "kinds": {},
                            "unawaited": 0, "oldest_age_s": 0.0,
                            "owners": []}
                    m["count"] += g.get("count", 0)
                    m["bytes"] += g.get("bytes", 0)
                    m["unawaited"] += g.get("unawaited", 0)
                    m["oldest_age_s"] = max(m["oldest_age_s"],
                                            g.get("oldest_age_s", 0.0))
                    for k, v in (g.get("kinds") or {}).items():
                        m["kinds"][k] = m["kinds"].get(k, 0) + v
                    if cid not in m["owners"]:
                        m["owners"].append(cid)
            by_node: dict[str, dict] = {}
            by_state: dict[str, dict] = {}
            for e in self.objects.values():
                node = self._object_node(e)
                b = by_node.setdefault(node, {})
                s = b.setdefault(e.state, {"count": 0, "bytes": 0})
                s["count"] += 1
                s["bytes"] += e.size
                s2 = by_state.setdefault(e.state, {"count": 0, "bytes": 0})
                s2["count"] += 1
                s2["bytes"] += e.size
            out = {
                "store": self._store_stats_locked(),
                "groups": groups,
                "by_node": by_node,
                "by_state": by_state,
                "census_clients": census_clients,
                "leak_suspects": [dict(r) for r in
                                  self.leak_suspects.values()],
                "num_entries": len(self.objects),
                "total_bytes": sum(v["bytes"] for v in by_state.values()),
            }
        for r in self._xshard_fanout("memory_summary", body):
            # Censuses/suspects concat; directory counters sum; nested
            # node/state groups merge per bucket.
            out["groups"].update(r.get("groups") or {})
            out["census_clients"].update(r.get("census_clients") or {})
            out["leak_suspects"].extend(r.get("leak_suspects") or [])
            for node, states in (r.get("by_node") or {}).items():
                b = out["by_node"].setdefault(node, {})
                for st, s in states.items():
                    m = b.setdefault(st, {"count": 0, "bytes": 0})
                    m["count"] += s.get("count", 0)
                    m["bytes"] += s.get("bytes", 0)
            for st, s in (r.get("by_state") or {}).items():
                m = out["by_state"].setdefault(st,
                                               {"count": 0, "bytes": 0})
                m["count"] += s.get("count", 0)
                m["bytes"] += s.get("bytes", 0)
            out["num_entries"] += r.get("num_entries", 0)
            out["total_bytes"] += r.get("total_bytes", 0)
        return out

    def _h_task_events(self, body, conn):
        with self.lock:
            self.task_events.extend(body["events"])
        self.traces.intake(body["events"])
        return None

    def _h_get_trace(self, body, conn):
        """One causal trace tree, full span detail (util.state.get_trace,
        `ray-tpu trace <id>`, dashboard /api/traces/<id>)."""
        trace = self.traces.get(body["trace_id"])
        if trace is None:
            # A trace assembles on the shard its owner registered with.
            for r in self._xshard_fanout("get_trace", body):
                if r.get("trace") is not None:
                    return r
        return {"trace": trace}

    def _h_list_traces(self, body, conn):
        """Retained trace summaries, newest first; exemplars_only skips
        the uniform sample (dashboard Traces view default)."""
        limit = int(body.get("limit", 100))
        traces = self.traces.list(
            limit=limit,
            exemplars_only=bool(body.get("exemplars_only")))
        for r in self._xshard_fanout("list_traces", body):
            traces.extend(r.get("traces") or [])
        return {"traces": traces[:limit]}

    def _h_report_metrics(self, body, conn):
        with self.lock:
            self.metrics.update(body["metrics"])
            # Bounded like task_events: evict oldest series beyond the cap
            # (each short-lived metric instance contributes a series key).
            overflow = len(self.metrics) - self.config.task_events_max_buffer
            if overflow > 0:
                for key in list(self.metrics)[:overflow]:
                    del self.metrics[key]
        # Telemetry history: user metric points land in the tsdb keyed
        # by (name, tags) — reporters of one tagset interleave into one
        # series (counters therefore answer min/max/sum honestly but
        # rate only approximately across reporters). Rides this
        # already-amortized flush cast; histograms keep their scalar
        # sum (the per-bucket history lives in the rollup of the raw
        # exposition, not here).
        if self.tsdb is not None:
            now = time.time()
            for point in body["metrics"].values():
                name = point.get("name")
                if not name:
                    continue
                value = point.get("value")
                if isinstance(value, dict):
                    value = value.get("sum")
                self.tsdb.ingest(name, point.get("tags"), value,
                                 point.get("ts") or now,
                                 point.get("type") or "gauge")
        return None

    def _h_get_metrics(self, body, conn):
        with self.lock:
            metrics = dict(self.metrics)
        for r in self._xshard_fanout("get_metrics", body):
            metrics.update(r.get("metrics") or {})
        return {"metrics": metrics}

    def _h_query_metrics(self, body, conn):
        """Telemetry-history range query (util.state.query_metrics /
        `ray-tpu metrics query` / dashboard /api/metrics/query).
        Sharded head: every shard holds its own store, so replies merge
        by (name, labels) — same-keyed series from different shards
        concatenate their buckets in time order."""
        from ray_tpu_torch._private import tsdb as tsdb_mod

        series = [] if self.tsdb is None else self.tsdb.query(
            body.get("name") or "", body.get("labels"),
            body.get("start"), body.get("end"), body.get("step"))
        for r in self._xshard_fanout("query_metrics", body):
            series.extend(r.get("series") or [])
        merged: dict[tuple, dict] = {}
        for s in series:
            key = (s["name"], tsdb_mod.label_key(s.get("labels")))
            cur = merged.get(key)
            if cur is None:
                merged[key] = s
            else:
                cur["points"] = sorted(
                    cur["points"] + s["points"], key=lambda b: b[0])
        return {"series": list(merged.values()),
                "enabled": self.tsdb is not None}

    def _h_list_alerts(self, body, conn):
        """Alert-table read (util.state.list_alerts / `ray-tpu alerts`
        / dashboard /api/alerts): active (pending+firing) records,
        optionally the resolved history, plus engine counters. Each
        shard evaluates its own rules over its own store; rows carry
        the rule name so merged views stay attributable."""
        include_history = bool(body.get("history"))
        alerts = [] if self.alerts is None \
            else self.alerts.list(include_history)
        stats = {} if self.alerts is None else self.alerts.stats()
        for r in self._xshard_fanout("list_alerts", body):
            alerts.extend(r.get("alerts") or [])
            for k, v in (r.get("stats") or {}).items():
                if isinstance(v, (int, float)):
                    stats[k] = stats.get(k, 0) + v
                elif isinstance(v, dict):
                    mine = stats.setdefault(k, {})
                    for sk, sv in v.items():
                        mine[sk] = mine.get(sk, 0) + sv
        return {"alerts": alerts, "stats": stats,
                "enabled": self.alerts is not None}

    def _h_worker_death(self, body, conn):
        """A node agent's reaper classified one of its workers' exits
        (real wait status + crash file + beacon + log tail). Merge it
        into the crash table: the head's conn-close path usually ran
        first with only intent/connection knowledge, and this report
        carries the evidence (see _record_crash's rank merge)."""
        report = body.get("report") or {}
        wid = report.get("worker_id") or body.get("worker_id")
        if not wid:
            return None
        report.setdefault("worker_id", wid)
        with self.lock:
            self._record_crash(report)
        return None

    def _h_list_crash_reports(self, body, conn):
        """Crash-report table reads (util.state.list_crash_reports /
        get_crash_report, `ray-tpu crashes`, dashboard). A worker_id
        point lookup returns the FULL report; the listing ships bounded
        summary rows (no stacks/log tails)."""
        wid = body.get("worker_id")
        with self.lock:
            if wid is not None:
                r = self.crash_reports.get(wid)
                reports = [dict(r)] if r else []
            else:
                rows = [self.crash_reports[w] for w in self._crash_fifo
                        if w in self.crash_reports]
                limit = int(body.get("limit", 100))
                summary_keys = ("worker_id", "node_id", "pid",
                                "actor_id", "exit_type", "exit_detail",
                                "exit_code", "term_signal",
                                "signal_name", "last_task",
                                "source", "ts", "reason", "detail",
                                "kind")
                reports = [
                    {k: r.get(k) for k in summary_keys if r.get(k)
                     is not None}
                    for r in rows[-limit:]]
        if wid is None or not reports:
            # Other shards' tables + the directory's own shard-death
            # reports (appended by its fanout handler).
            for r in self._xshard_fanout("list_crash_reports", body):
                reports.extend(r.get("reports") or [])
        return {"reports": reports}

    def _h_get_task_events(self, body, conn):
        from ray_tpu_torch._private import faultinject

        # Chaos instants injected in THIS process (local clusters: the
        # head shares the driver process, covering owner-side injection
        # deterministically); remote processes piggyback theirs on the
        # periodic rpc_report cast.
        chaos = faultinject.drain_events()
        if chaos:
            self.task_events.extend(chaos)
        events = self.task_events.snapshot(
            limit=body.get("limit", 10000),
            task_ids=body.get("task_ids"))
        with self.lock:
            offsets = dict(self.clock_offsets)
        for r in self._xshard_fanout("get_task_events", body):
            events.extend(r.get("events") or [])
            offsets.update(r.get("clock_offsets") or {})
        return {"events": events, "clock_offsets": offsets,
                "head_node_id": self.node_id}

    # ------------------------------------------------------------------
    # dispatch loop (the raylet role)

    def _dispatch_loop(self) -> None:
        while not self._shutdown:
            self.dispatch_event.wait(timeout=0.2)
            self.dispatch_event.clear()
            try:
                self._dispatch_once()
            except Exception:
                traceback.print_exc()

    def _dispatch_once(self) -> None:
        self._push_touched: set = set()
        try:
            self._dispatch_once_locked()
        finally:
            # Flush coalesced pushes AFTER dropping the head lock: a
            # slow worker socket must never stall scheduling.
            touched, self._push_touched = self._push_touched, set()
            for conn in touched:
                try:
                    conn.flush_casts()
                except Exception:
                    pass
            self._flush_owned_freed()

    def _flush_owned_freed(self) -> None:
        """One owned_freed cast per owner per pass (frees accumulate in
        _owned_freed_buf under the lock)."""
        if not self._owned_freed_buf:
            return
        with self.lock:
            buf, self._owned_freed_buf = self._owned_freed_buf, {}
        for owner_id, ids in buf.items():
            if owner_id not in self.clients and self.shard is None:
                continue
            self._client_cast(owner_id, "owned_freed", {"ids": ids})

    def _dispatch_once_locked(self) -> None:
        with self.lock:
            # 1. actor creations first (they unblock queued calls)
            for actor in list(self.actors.values()):
                if actor.state == "PENDING_CREATION":
                    self._try_start_actor(actor)
                elif actor.state == "ALIVE" and actor.pending:
                    # Calls parked behind unresolved args: deps may have
                    # sealed since (the seal sets dispatch_event).
                    self._flush_actor(actor)
            # 2. normal tasks. Shape-keyed ready queues make a saturated
            # pass O(#shapes): every task in a shape queue shares
            # placement feasibility and default strategy, so dispatch
            # drains heads until the first resource/worker failure and
            # moves to the next shape. Dep-blocked tasks never appear
            # here (they sit in dep_blocked until _on_sealed wakes
            # them). This loop runs UNDER the head lock — anything
            # per-queued-task here directly stalls worker put/finish
            # RPCs, which is why the old single-queue skip-over scan
            # (O(#queued) per pass, ResourceSet parse per scan) capped
            # the flood envelope at a few hundred tasks/s.
            spawned = False
            no_worker: set = set()
            # Memory-aware backpressure: pressured nodes receive no new
            # placements this pass (recovery re-wakes the dispatcher).
            pressured = (frozenset(self.pressured_nodes)
                         if self.pressured_nodes else None)
            for key in [k for k in self.ready_queues if k != _SCAN_KEY]:
                q = self.ready_queues.get(key)
                last_node = None  # same-shape node reuse within a pass
                while q:
                    spec = q[0]
                    # Tracks whether THIS spec left the queue: the except
                    # handler must never pop a task it didn't process (a
                    # failure after the success-path pop would otherwise
                    # silently drop the NEXT queued task).
                    popped = False
                    try:
                        if self._expired(spec):
                            # Overload plane: expired work is shed at
                            # the pop instead of burning a dispatch.
                            q.popleft()
                            popped = True
                            self._shed_expired(spec, "head_queue")
                            continue
                        # Deps were ready at enqueue; free/loss since is
                        # possible (and rare) — re-route to dep_blocked.
                        if spec.deps and not all(
                                self._is_ready(d) for d in spec.deps):
                            q.popleft()
                            popped = True
                            self._enqueue_task_spec(spec)
                            continue
                        demand = spec._demand
                        if demand is None:
                            demand = spec._demand = self._effective_demand(
                                spec.resources, None)
                        # Reuse the node the previous same-shape task
                        # landed on (skips a ctypes pick_node marshal per
                        # task; hybrid policy packs first anyway) — a
                        # failed allocation below re-picks freshly.
                        fresh_pick = last_node is None
                        node = last_node
                        if node is None:
                            node = self.scheduler.pick_node(
                                demand, None, exclude=pressured)
                        if node is None:
                            # No free capacity anywhere — but the
                            # owner's own leases may HOLD it all: an
                            # IDLE leased worker of this very shape
                            # serves the owner's spillover directly
                            # (riding the lease-held allocation).
                            lw = self._lease_matched_worker(
                                None, key, spec.owner_id)
                            if lw is not None:
                                q.popleft()
                                popped = True
                                self._push_to_worker(lw, spec,
                                                     buffered=True)
                                continue
                            # Or an idle lease (other shape / other
                            # owner) pins the capacity: reclaim one and
                            # re-pick — otherwise every queued task
                            # starves for the lease's remaining TTL.
                            if self._reclaim_idle_lease():
                                node = self.scheduler.pick_node(
                                    demand, None, exclude=pressured)
                            if node is None:
                                break  # unplaceable until capacity frees
                        need_gpu = float(spec.resources.get("GPU", 0)) > 0
                        if (node.node_id, need_gpu) in no_worker:
                            break
                        ek = key[1][1] if key[0] == "shape" else None
                        n_gpu = float(spec.resources.get("GPU", 0))
                        rec = self._idle_worker(node.node_id, need_gpu, ek,
                                                n_gpu)
                        if rec is None:
                            if not spawned and self._can_spawn(node.node_id,
                                                               need_gpu):
                                self.spawn_worker(node.node_id,
                                                  gpu_capable=need_gpu)
                                spawned = True
                            elif not spawned:
                                # Pool at cap and every idle worker is
                                # keyed to another package env: retire
                                # one so the NEXT pass can spawn for
                                # this env (reference: worker_pool.h
                                # evicts idle cached-env workers).
                                self._retire_idle_mismatch(
                                    node.node_id, need_gpu, ek, n_gpu)
                            # Capacity is ARRIVING (a pool worker of
                            # this kind is mid-boot on the node) or can
                            # still be spawned (pool below cap — the
                            # spawn above may have been deferred by a
                            # warming zygote): leave the task queued
                            # for the fresh worker instead of parking
                            # it behind a busy one — a quick task must
                            # not serialize behind a slow one while
                            # real parallelism is ~100 ms away.
                            # worker_ready / zygote.on_ready set
                            # dispatch_event (plus the dispatch loop's
                            # 200 ms backstop tick), so waiting here
                            # cannot strand the queue; pipelining
                            # remains the fallback once the pool is at
                            # cap with every worker ready.
                            if (self._booting_worker(node.node_id,
                                                     need_gpu)
                                    or self._can_spawn(node.node_id,
                                                       need_gpu)):
                                no_worker.add((node.node_id, need_gpu))
                                break
                            # Pipeline: same-shape tasks ride an already-
                            # allocated worker's bounded inflight window
                            # (serial execution — no extra allocation).
                            # LAST resort: this owner's own leased
                            # workers — without that fallback, an owner
                            # whose leases cover the whole pool
                            # deadlocks its spillover until lease
                            # expiry (every worker's allocation is
                            # lease-held, so nothing else can place).
                            rec = (None if need_gpu else
                                   self._pipeline_worker(node.node_id, key)
                                   or self._lease_matched_worker(
                                       node.node_id, key, spec.owner_id))
                            if rec is None:
                                no_worker.add((node.node_id, need_gpu))
                                break
                            q.popleft()
                            popped = True
                            self._push_to_worker(rec, spec, buffered=True)
                            continue
                        if not self._try_allocate(rec, node.node_id,
                                                  spec.resources, None,
                                                  demand=demand):
                            last_node = None
                            if fresh_pick:
                                break
                            continue  # stale reused node: re-pick
                        last_node = node
                        rec.cur_rkey = key
                        if ek is not None:
                            rec.env_key = ek  # keyed for life (pip/conda)
                        q.popleft()
                        popped = True
                        self._push_to_worker(rec, spec, buffered=True)
                    except Exception:
                        # One malformed spec must not wedge the loop.
                        traceback.print_exc()
                        if not popped:
                            q.popleft()
                        self._fail_task(
                            spec,
                            f"SchedulingError: {traceback.format_exc()}")
                if not q:
                    self.ready_queues.pop(key, None)
            # 2b. explicit-strategy tasks (PG bundles, node affinity,
            # SPREAD): feasibility is per task, so these keep the
            # budgeted skip-over scan with rotation.
            scan_q = self.ready_queues.get(_SCAN_KEY)
            if scan_q:
                self._dispatch_scan_queue(scan_q, no_worker, spawned)
                if not scan_q:
                    self.ready_queues.pop(_SCAN_KEY, None)

    def _dispatch_scan_queue(self, queue, no_worker: set,
                             spawned: bool) -> None:
        """lock held. Budgeted skip-over scan for explicit-strategy
        tasks; on budget exhaustion the queue rotates so a long
        infeasible prefix cannot starve feasible tasks behind it
        (FIFO is already best-effort due to skip-over)."""
        requeue: deque[TaskSpec] = deque()
        misses = 0
        scanned = 0
        while queue:
            if misses >= 64 or scanned >= 4096:
                # ROTATE: unscanned tasks go to the FRONT of the next
                # pass, the scanned-but-unplaced prefix to the back.
                requeue.extendleft(reversed(queue))
                queue.clear()
                break
            spec = queue.popleft()
            scanned += 1
            try:
                if self._expired(spec):
                    self._shed_expired(spec, "head_queue")
                    continue
                if not self._validate_strategy(spec):
                    continue  # failed with an error object
                if not all(self._is_ready(d) for d in spec.deps):
                    requeue.append(spec)
                    continue
                strategy = self._resolve_strategy(spec)
                if strategy is UNPLACEABLE:
                    requeue.append(spec)
                    continue
                demand = getattr(spec, "_demand", None)
                if demand is None:
                    demand = self._effective_demand(
                        spec.resources, spec.scheduling_strategy)
                    spec._demand = demand
                pressured = (frozenset(self.pressured_nodes)
                             if self.pressured_nodes else None)
                node = self.scheduler.pick_node(demand, strategy,
                                                exclude=pressured)
                if node is None and self._reclaim_idle_lease():
                    # Capacity may sit idle-pinned under a lease (PG
                    # demand is bundle-reserved and unaffected, but
                    # affinity/SPREAD tasks compete with leases).
                    node = self.scheduler.pick_node(demand, strategy,
                                                    exclude=pressured)
                if node is None:
                    # Not a budgeted miss: feasibility varies per task
                    # here, and counting currently-infeasible entries
                    # would end the pass after 64 of them — a feasible
                    # task behind a few hundred pending-PG tasks would
                    # then wait many rotations instead of one
                    # 4096-entry scan.
                    requeue.append(spec)
                    continue
                need_gpu = float(spec.resources.get("GPU", 0)) > 0
                if (node.node_id, need_gpu) in no_worker:
                    requeue.append(spec)
                    misses += 1
                    continue
                scan_ek = self._env_key(spec.runtime_env)
                rec = self._idle_worker(node.node_id, need_gpu, scan_ek,
                                        float(spec.resources.get("GPU", 0)))
                if rec is None:
                    if not spawned and self._can_spawn(node.node_id,
                                                       need_gpu):
                        self.spawn_worker(node.node_id,
                                          gpu_capable=need_gpu)
                        spawned = True
                    no_worker.add((node.node_id, need_gpu))
                    requeue.append(spec)
                    misses += 1
                    continue
                if not self._try_allocate(
                    rec, node.node_id, spec.resources,
                    spec.scheduling_strategy
                ):
                    requeue.append(spec)
                    continue
                misses = 0
                if scan_ek is not None:
                    rec.env_key = scan_ek  # keyed for life (pip/conda)
                self._push_to_worker(rec, spec, buffered=True)
            except Exception:
                # One malformed spec must not wedge the dispatch loop or
                # drop the requeue of healthy tasks.
                traceback.print_exc()
                self._fail_task(spec, f"SchedulingError: {traceback.format_exc()}")
        queue.extend(requeue)

    def _validate_strategy(self, spec: TaskSpec) -> bool:
        """Fail specs with malformed strategies up front. lock held."""
        s = spec.scheduling_strategy
        if isinstance(s, PlacementGroupSchedulingStrategy):
            pg_id = getattr(s.placement_group, "id", None) or s.placement_group
            pg = self.pgs.get(pg_id)
            if pg is None:
                self._fail_task(spec, f"SchedulingError: unknown placement group {pg_id}")
                return False
            if s.placement_group_bundle_index >= len(pg.bundles):
                self._fail_task(
                    spec,
                    f"SchedulingError: bundle index {s.placement_group_bundle_index} "
                    f"out of range for {len(pg.bundles)}-bundle placement group",
                )
                return False
        return True

    @staticmethod
    def _effective_demand(resources, strategy) -> ResourceSet:
        """PG-scheduled work consumes the bundle's reservation, not fresh
        node resources (reference semantics: tasks in a placement group use
        reserved bundle resources)."""
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            return ResourceSet({})
        return ResourceSet(resources)

    def _resolve_strategy(self, spec: TaskSpec):
        s = spec.scheduling_strategy
        if isinstance(s, PlacementGroupSchedulingStrategy):
            pg = self.pgs.get(getattr(s.placement_group, "id", None) or s.placement_group)
            if pg is None or pg.state != "CREATED":
                return UNPLACEABLE
            idx = s.placement_group_bundle_index
            node_id = pg.node_per_bundle[idx if idx >= 0 else 0]
            from ray_tpu_torch._private.scheduler import NodeAffinitySchedulingStrategy

            return NodeAffinitySchedulingStrategy(node_id=node_id, soft=False)
        return s

    PIPELINE_DEPTH = 8  # max same-shape tasks queued on one busy worker

    def _retire_idle_mismatch(self, node_id: str, need_gpu: bool,
                              env_key: "str | None",
                              n_gpu: float = 0) -> None:
        """lock held. Kill ONE idle worker whose env key (or, for a GPU
        task, whose bound devices) blocks this task class; its death
        handler frees a pool slot."""
        for rec in self.workers.values():
            if (
                rec.node_id == node_id
                and rec.conn is not None
                and rec.ready
                and not rec.busy
                and rec.actor_id is None
                and rec.gpu_capable == need_gpu
                and ((rec.env_key != env_key and rec.env_key is not None)
                     or not self._gpus_fit_bound(rec, n_gpu))
            ):
                try:
                    rec.conn.cast("kill", {})
                except rpc.ConnectionLost:
                    pass
                return

    def _lease_matched_worker(self, node_id: "str | None", key: tuple,
                              owner_id: str) -> "WorkerRecord | None":
        """lock held. A worker LEASED to this very owner for this very
        shape still serves the owner's head-routed spillover (bounded
        by the pipeline depth, riding the allocation the lease already
        holds). Without this, an owner whose leases cover the whole
        pool deadlocks its own overflow until the leases expire: the
        owner spills because every lease has a task inflight, and the
        head can't place the spillover because every worker's
        allocation is lease-held."""
        if key[0] != "shape":
            return None
        best = None
        for rec in self.workers.values():
            if (
                (node_id is None or rec.node_id == node_id)
                and rec.conn is not None
                and rec.ready
                and rec.actor_id is None
                and not rec.retiring
                and rec.node_id not in self.pressured_nodes
                and rec.leased_to == owner_id
                and rec.lease_key == key[1]
                # IDLE leases only: parking a task on a leased worker
                # mid-task serializes it behind work of UNKNOWN length
                # (a quick task behind a minutes-long one) while every
                # completion would have re-woken dispatch within
                # milliseconds anyway — leased completions set
                # need_dispatch, and the 200 ms backstop tick covers
                # lease expiry, so waiting cannot deadlock: spillover
                # places the moment any of the owner's leased workers
                # drains.
                and not rec.inflight
            ):
                best = rec
                break
        return best

    def _reclaim_idle_lease(self) -> bool:
        """lock held. Under capacity pressure an IDLE leased worker's
        pinned allocation is dead weight: queued tasks of every other
        shape and owner starve behind it for the lease's remaining TTL
        (observed: a stale 2-CPU lease plus a nested-owner lease
        idle-pinning 3 of a node's 4 CPUs for the full 10 s TTL).
        Revoke one — the owner falls back to the head path and re-earns
        a lease wherever its next spillover lands (reference analogue:
        idle leased workers are returned to the raylet on demand,
        normal_task_submitter.cc ReturnWorker). Oldest grant (nearest
        deadline) goes first."""
        victim = None
        for rec in self.workers.values():
            if (rec.leased_to is not None and not rec.inflight
                    and not rec.retiring and rec.acquired is not None
                    and (victim is None
                         or rec.lease_deadline < victim.lease_deadline)):
                victim = rec
        if victim is None:
            return False
        self._end_lease(victim, revoke=True)
        return True

    def _booting_worker(self, node_id: str, gpu_capable: bool) -> bool:
        """lock held. A pool worker of this kind was spawned on the
        node but has not finished two-phase registration — fresh
        capacity is arriving, so dispatch should WAIT for it rather
        than queue behind a busy worker's pipeline window. (A boot that
        never completes is reaped by the ghost-worker reaper, whose
        death handling re-sets dispatch_event.)"""
        return any(
            r.node_id == node_id and r.actor_id is None
            and r.gpu_capable == gpu_capable and not r.retiring
            and (r.conn is None or not r.ready)
            for r in self.workers.values()
        )

    def _pipeline_worker(self, node_id: str,
                         key: tuple) -> WorkerRecord | None:
        """lock held. A busy non-actor worker already holding an
        allocation for this resource shape whose inflight window has
        room. TPU tasks never pipeline (chip visibility is per-lease)."""
        if node_id in self.pressured_nodes:
            return None  # pressured: no new work, not even pipelined
        for rec in self.workers.values():
            if (
                rec.node_id == node_id
                and rec.conn is not None
                and rec.ready
                and rec.actor_id is None
                and not rec.gpu_capable
                and not rec.retiring
                and rec.leased_to is None
                and rec.cur_rkey == key
                and rec.acquired is not None
                and 0 < len(rec.inflight) < self.PIPELINE_DEPTH
            ):
                return rec
        return None

    def _idle_worker(self, node_id: str, need_gpu: bool = False,
                     env_key: "str | None" = None,
                     n_gpu: float = 0) -> WorkerRecord | None:
        """GPU tasks need a gpu_capable worker; chipless tasks need a
        GPU-hidden one — a gpu_capable worker running a chipless task
        would create a CUDA context on a device the lease never
        granted. A gpu_capable worker bound to devices by an earlier
        lease (``gpu_bound``) serves only a request for exactly those
        devices while they are free.

        ``env_key`` (pip/conda hash): exact-keyed workers first, then an
        unkeyed pool worker is claimed (keyed for life — its sys.modules
        will cache this env's packages). Plain tasks only match unkeyed
        workers."""
        claimable = None
        for rec in self.workers.values():
            if (
                rec.node_id == node_id
                and rec.conn is not None
                and rec.ready
                and not rec.busy
                and rec.actor_id is None
                and not rec.retiring
                and rec.leased_to is None
                and rec.gpu_capable == need_gpu
                and self._gpus_fit_bound(rec, n_gpu)
            ):
                if rec.env_key == env_key:
                    return rec
                if env_key is not None and rec.env_key is None:
                    claimable = claimable or rec
        # NOTE: the caller keys the claimed worker (rec.env_key = ek)
        # only AFTER allocation succeeds and the task is pushed — keying
        # here would poison a worker that never runs the env.
        return claimable

    def _gpus_fit_bound(self, rec: WorkerRecord, n_gpu: float) -> bool:
        """lock held. Whether ``rec`` can take a lease of ``n_gpu``
        devices (a fraction: a share of one): always for a worker no
        lease bound yet."""
        bound = rec.gpu_bound
        if bound is None or n_gpu <= 0:
            return True
        free = self.gpu_pool.get(rec.node_id, {})
        if n_gpu < 1:
            return len(bound) == 1 and free.get(bound[0], 0) >= _fp(n_gpu)
        return len(bound) == n_gpu and all(free.get(i, 0) == GRANULARITY for i in bound)

    def _can_spawn(self, node_id: str, gpu_capable: bool = False) -> bool:
        """Pool caps are per worker kind: TPU-capable and hook-stripped
        pool workers are disjoint (cannot serve each other's tasks), so
        a pool full of idle TPU workers must not starve chipless tasks
        of their own spawn budget — and vice versa."""
        # Blocked workers (parked in a nested get, allocation released)
        # don't count against the cap: a chain of N nested gets needs N+1
        # workers alive even though only one runs at a time (reference:
        # the raylet starts extra workers to cover blocked ones,
        # worker_pool.h maximum_startup_concurrency semantics).
        count = sum(
            1 for r in self.workers.values()
            if r.node_id == node_id and r.actor_id is None
            and r.gpu_capable == gpu_capable and not r.blocked
        )
        return count < self.max_pool_workers

    def _push_to_worker(self, rec: WorkerRecord, spec: TaskSpec,
                        buffered: bool = False) -> None:
        """``buffered=True`` (dispatch-pass pushes) coalesces pushes to
        the same worker into one CAST_BATCH frame; the pass flushes all
        touched connections after dropping the lock. Direct pushes
        (actor-call flush paths) stay immediate for latency."""
        self._pending_dec(spec)
        rec.busy = True
        rec.inflight[spec.task_id] = spec
        t = self.tasks.get(spec.task_id)
        if t:
            t["state"] = RUNNING
            t["node_id"] = rec.node_id
            t["worker_id"] = rec.worker_id
            t["started_at"] = time.time()
        try:
            packed = ((spec._packed_bin or pack_spec(spec))
                      if rec.conn.peer_info.get("specenc") else None)
            # The cached bytes served their one reuse; a retained spec
            # (inflight map, lineage) must not keep a duplicate copy.
            spec._packed_bin = None
            push_body = ({"spec_bin": packed} if packed is not None
                         else {"spec": spec})
            push_body["gpu_ids"] = rec.gpu_ids
            if spec._evt is not None:
                # Flight recorder: the head's dispatch stamp joins the
                # owner's submit/enqueue stamps on the push it already
                # rides (retries re-stamp — the timeline shows the
                # attempt that actually executed).
                evt = dict(spec._evt)
                evt["dispatch"] = time.time()
                push_body["evt"] = evt
            if buffered:
                rec.conn.cast_buffered("push_task", push_body)
                self._push_touched.add(rec.conn)
            else:
                rec.conn.cast("push_task", push_body)
        except rpc.ConnectionLost:
            pass  # worker death handler requeues
        if spec._lease_key is not None and spec.actor_id is None:
            self._grant_lease(rec, spec)
            spec._lease_key = None

    def _try_start_actor(self, actor: ActorRecord) -> None:
        """lock held. Reserve resources, spawn a dedicated worker, send the
        creation task once it registers."""
        spec = actor.spec
        strategy = self._resolve_actor_strategy(spec)
        if strategy is UNPLACEABLE:
            return
        demand = self._effective_demand(spec.resources, spec.scheduling_strategy)
        node = self.scheduler.pick_node(
            demand, strategy,
            exclude=(frozenset(self.pressured_nodes)
                     if self.pressured_nodes else None))
        if node is None:
            return
        need_gpu = float(spec.resources.get("GPU", 0)) > 0
        # Reuse an idle pool worker instead of forking a fresh
        # interpreter (reference: WorkerPool::PopWorker serves actor
        # creation from the pool, raylet/worker_pool.h:224) — actor
        # spawn drops from ~interpreter-start (250ms+) to one RPC.
        # Runtime envs are applied in-worker by the creation task, so
        # any pool worker qualifies — except: (a) GPU actors (a pooled
        # worker runs with every device hidden, and CUDA cannot be
        # re-pointed at a device once it has initialised);
        # (b) package envs (pip/conda) — a pooled worker's sys.modules
        # may cache other versions; the reference keys pools by env hash
        # (worker_pool.h runtime-env-keyed caching), here those actors
        # get a fresh interpreter.
        renv = spec.runtime_env or {}
        fresh_env = bool(renv.get("pip") or renv.get("conda")
                         or renv.get("uv"))
        rec = (None if (need_gpu or fresh_env)
               else self._idle_worker(node.node_id, False))
        reused = rec is not None
        if not reused:
            rec = self.spawn_worker(node.node_id, gpu_capable=need_gpu)
            if rec is None:
                return  # spawn deferred (zygote warming); actor stays
                # PENDING_CREATION and the on_ready dispatch retries
        rec.actor_id = spec.actor_id
        if not self._try_allocate(rec, node.node_id, spec.resources, spec.scheduling_strategy):
            if reused:
                rec.actor_id = None  # back to the pool, untouched
                return
            if rec.proc is not None:
                rec.proc.kill()
            elif rec.zygote and rec.pid:
                try:
                    os.kill(rec.pid, 9)
                except OSError:
                    pass
            # Remote spawn: the worker registers, finds its record gone,
            # and exits (registration is rejected for unknown workers).
            self.workers.pop(rec.worker_id, None)
            return
        actor.state = "STARTING"
        actor.worker_id = rec.worker_id
        actor.node_id = node.node_id
        # Defer the creation push until the worker registers (it has no conn
        # yet). A creation TaskSpec is queued on the record.
        creation = TaskSpec(
            task_id="task-" + uuid.uuid4().hex[:12],
            name=f"{spec.name or 'Actor'}.__init__",
            func_id=spec.cls_func_id,
            args=spec.init_args,
            deps=spec.deps,
            borrowed_ids=list(getattr(spec, "borrowed_ids", None) or ()),
            return_ids=[spec.actor_id + ":creation"],
            resources=spec.resources,
            owner_id=spec.owner_id,
            actor_creation=True,
            max_retries=0,
            runtime_env=spec.runtime_env,
        )
        ce = self.objects.get(creation.return_ids[0]) or ObjectEntry(creation.return_ids[0], spec.owner_id)
        ce.refcount = max(ce.refcount, 1)
        self.objects[creation.return_ids[0]] = ce
        rec.inflight[creation.task_id] = creation
        rec.busy = True
        self.tasks[creation.task_id] = {
            "task_id": creation.task_id,
            "name": creation.name,
            "state": SCHEDULED,
            "type": "ACTOR_CREATION_TASK",
            "submitted_at": time.time(),
            "node_id": node.node_id,
            "worker_id": rec.worker_id,
        }
        self._pending_creation_push = getattr(self, "_pending_creation_push", {})
        self._pending_creation_push[rec.worker_id] = creation
        # If already registered (restart case), push now.
        if rec.conn is not None:
            self._maybe_push_creation(rec)

    def _resolve_actor_strategy(self, spec: ActorSpec):
        class _Shim:
            pass

        shim = _Shim()
        shim.scheduling_strategy = spec.scheduling_strategy
        return self._resolve_strategy(shim)  # type: ignore[arg-type]

    def _maybe_push_creation(self, rec: WorkerRecord) -> None:
        pending = getattr(self, "_pending_creation_push", {})
        if not rec.ready:
            return
        creation = pending.pop(rec.worker_id, None)
        if creation is not None and rec.conn is not None:
            actor = self.actors.get(rec.actor_id)
            try:
                rec.conn.cast(
                    "become_actor",
                    {
                        "spec": creation,
                        "actor_id": rec.actor_id,
                        "max_concurrency": actor.spec.max_concurrency if actor else 1,
                        "concurrency_groups": getattr(
                            actor.spec, "concurrency_groups", None
                        ) if actor else None,
                        "gpu_ids": rec.gpu_ids,
                    },
                )
                self.tasks[creation.task_id]["state"] = RUNNING
            except rpc.ConnectionLost:
                pass

    def _try_allocate(self, rec: WorkerRecord, node_id: str, resources: dict,
                      strategy, demand: "ResourceSet | None" = None) -> bool:
        """lock held. Reserve resources for `rec` from the node pool, or from
        the placement-group bundle when PG-scheduled. Assigns TPU chips;
        rolls back on partial failure. ``demand`` lets hot dispatch paths
        pass the spec's cached ResourceSet (fixed-point construction per
        task was ~10 us of every dispatch)."""
        if demand is None:
            demand = ResourceSet(resources)
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg_id = getattr(strategy.placement_group, "id", None) or strategy.placement_group
            pg = self.pgs.get(pg_id)
            if pg is None or pg.state != "CREATED":
                return False
            idx = strategy.placement_group_bundle_index
            if idx < 0:
                idx = next(
                    (i for i in range(len(pg.bundles)) if pg.bundle_fits(i, demand)), -1
                )
                if idx < 0:
                    return False
            if not pg.bundle_fits(idx, demand):
                return False
            if not self._assign_gpus(rec, resources):
                return False
            pg.bundle_used[idx].add(demand)
            rec.pg_alloc = (pg_id, idx, demand)
            return True
        if not self.scheduler.acquire(node_id, demand):
            return False
        if not self._assign_gpus(rec, resources):
            self.scheduler.release(node_id, demand)
            return False
        rec.acquired = demand
        return True

    def _release_worker_allocation(self, rec: WorkerRecord) -> None:
        """lock held. Return node or PG-bundle resources + chips."""
        if rec.acquired is not None:
            self.scheduler.release(rec.node_id, rec.acquired)
            rec.acquired = None
        if rec.pg_alloc is not None:
            pg_id, idx, demand = rec.pg_alloc
            pg = self.pgs.get(pg_id)
            if pg is not None and idx < len(pg.bundle_used):
                pg.bundle_used[idx].subtract(demand)
            rec.pg_alloc = None
        rec.cur_rkey = None
        self._return_gpus(rec)

    # GPU visibility assignment (reference semantics:
    # _private/accelerators/nvidia_gpu.py
    # set_current_process_visible_accelerator_ids — CUDA_VISIBLE_DEVICES)
    # handled at dispatch.
    def _assign_gpus(self, rec: WorkerRecord, resources: dict[str, float]) -> bool:
        """Returns False if the device pool cannot cover the request — callers
        must treat that as unschedulable, never run with fewer devices than
        the resource contract promised. A request of n >= 1 takes n whole
        free devices; a fraction takes one device whose free share covers
        it (the tightest such device), so two 0.5 leases share a card and
        both workers see it. A worker keeps the devices of its first lease
        for life (``gpu_bound``): its CUDA has fixed them."""
        want = float(resources.get("GPU", 0))
        if want <= 0:
            return True
        free = self.gpu_pool.setdefault(rec.node_id, {})
        units = _fp(want) if want < 1 else GRANULARITY
        if rec.gpu_bound is not None:
            if not self._gpus_fit_bound(rec, want):
                return False
            ids = list(rec.gpu_bound)
        elif want < 1:
            fits = [d for d, f in free.items() if f >= units]
            if not fits:
                return False
            ids = rec.gpu_bound = [min(fits, key=lambda d: (free[d], d))]
        else:
            whole = sorted(d for d, f in free.items() if f == GRANULARITY)
            if len(whole) < want:
                return False
            ids = rec.gpu_bound = whole[:int(want)]
        rec.gpu_ids = list(ids)
        rec.gpu_units = units
        for d in ids:
            free[d] -= units
        return True

    def _return_gpus(self, rec: WorkerRecord) -> None:
        if rec.gpu_ids:
            free = self.gpu_pool.setdefault(rec.node_id, {})
            for d in rec.gpu_ids:
                free[d] = free.get(d, 0) + rec.gpu_units
            rec.gpu_ids = []
            rec.gpu_units = 0

    # ------------------------------------------------------------------
    # failure handling + crash forensics

    def _mark_expected_exit(self, worker_id: str, intent: str,
                            detail: str) -> None:
        """Record the head's kill intent BEFORE the kill lands, so the
        death classifies as what it is (memory-monitor victim, ray
        kill, retirement) instead of an anonymous SIGKILL/exit."""
        with self.lock:
            rec = self.workers.get(worker_id)
            if rec is not None and rec.expected_exit is None:
                rec.expected_exit = (intent, detail)

    def _oom_delta(self) -> int:
        """cgroup oom_kill events since the last check on THIS node."""
        from ray_tpu_torch._private import forensics

        if self._oom_watch is None:
            cg = getattr(self, "_cgroup", None)
            extra = ()
            if cg is not None and cg.enabled and cg.workers_path:
                extra = (os.path.join(cg.workers_path, "memory.events"),)
            self._oom_watch = forensics.OomWatch(extra)
            return 0  # first call establishes the baseline
        return self._oom_watch.delta()

    def _reap_exit_status(self, rec: WorkerRecord, wait_s: float = 0.5
                          ) -> "tuple[int | None, int | None]":
        """(exit_code, term_signal) of a LOCAL worker. Bounded wait: the
        conn close usually races the process teardown by mere
        milliseconds, and this runs on the dead conn's reader thread."""
        if rec.proc is not None:
            deadline = time.time() + wait_s
            while True:
                rc = rec.proc.poll()
                if rc is not None:
                    return (rc, None) if rc >= 0 else (None, -rc)
                if time.time() >= deadline:
                    return None, None
                time.sleep(0.02)
        if rec.zygote and rec.pid:
            zy = getattr(self, "_zygote_client", None)
            if zy is not None:
                from ray_tpu_torch._private.forensics import split_status

                return split_status(zy.exit_status(rec.pid, wait_s=wait_s))
        return None, None

    def _build_crash_report(self, rec: WorkerRecord) -> dict:
        """Classify one worker death with everything the HEAD can see
        synchronously: its kill intent, the local wait status + crash
        file + beacon + log tail (head-spawned workers), and the dead
        worker's last flight-recorder events. Remote workers get a thin
        report here; the node agent's reaper ships the evidence-rich
        one asynchronously (worker_death) and _record_crash upgrades."""
        from ray_tpu_torch._private import forensics

        local = rec.proc is not None or rec.zygote
        exit_code = term_signal = None
        if local and (rec.expected_exit is None
                      or rec.expected_exit[0] != "node_death"):
            exit_code, term_signal = self._reap_exit_status(rec)
        logs = os.path.join(self.session_dir, "logs")
        report = forensics.collect_report(
            rec.worker_id, rec.node_id, rec.pid,
            exit_code=exit_code, term_signal=term_signal,
            crash_dir=logs if local else None,
            log_path=os.path.join(logs, f"{rec.worker_id}.log")
            if local else None,
            expected=rec.expected_exit,
            oom_killed=(term_signal == 9 and local
                        and self._oom_delta() > 0),
            source="head")
        if rec.actor_id:
            report["actor_id"] = rec.actor_id
        with self.lock:
            infl = [(s.task_id, s.name) for s in rec.inflight.values()]
        if infl:
            report["last_task"] = {"task_id": infl[-1][0],
                                   "name": infl[-1][1]}
        # Cross-link the flight recorder: what the worker's timeline
        # looked like right up to the death.
        report["events"] = self.task_events.by_worker(rec.worker_id)
        return report

    def _record_crash(self, report: dict, count: bool = True) -> dict:
        """lock held. Insert or merge one crash report into the bounded
        table; returns the stored record. Merging upgrades the stored
        reason only with a MORE specific one (forensics.REASON_RANK):
        supervisor intents stick, evidence beats guesswork, and whoever
        arrives second (head conn-close path vs agent reaper) fills in
        the fields the other could not see."""
        from ray_tpu_torch._private.forensics import REASON_RANK

        wid = report["worker_id"]
        cur = self.crash_reports.get(wid)
        if cur is None:
            self.crash_reports[wid] = report
            self._crash_fifo.append(wid)
            while len(self._crash_fifo) > self.config.crash_reports_max:
                self.crash_reports.pop(self._crash_fifo.popleft(), None)
            if count:
                r = report["exit_type"]
                self.death_counts[r] = self.death_counts.get(r, 0) + 1
            # Death instant on the Perfetto timeline.
            self.task_events.append({
                "event": "worker_death", "worker_id": wid,
                "node_id": report.get("node_id"),
                "reason": report["exit_type"],
                "detail": report.get("exit_detail"),
                "pid": report.get("pid"),
                "ts": report.get("ts") or time.time()})
            return report
        for k in ("exit_code", "term_signal", "signal_name", "stack",
                  "log_tail", "beacon", "last_task", "actor_id", "pid",
                  "events"):
            v = report.get(k)
            if v not in (None, [], {}, "") and not cur.get(k):
                cur[k] = v
        new_r, old_r = report["exit_type"], cur["exit_type"]
        if REASON_RANK.get(new_r, 0) > REASON_RANK.get(old_r, 0):
            cur["exit_type"] = new_r
            cur["exit_detail"] = report.get("exit_detail") or \
                cur.get("exit_detail")
            if count:
                self.death_counts[old_r] = max(
                    0, self.death_counts.get(old_r, 1) - 1)
                self.death_counts[new_r] = \
                    self.death_counts.get(new_r, 0) + 1
        return cur

    @staticmethod
    def _death_blurb(report: "dict | None", stack_lines: int = 8) -> str:
        """The classified-death suffix user-facing errors carry: reason,
        last task provenance, node, and a bounded stack excerpt."""
        if not report:
            return "reason: unknown"
        blurb = f"reason: {report.get('exit_type', 'unknown')}"
        detail = report.get("exit_detail")
        if detail:
            blurb += f" ({detail})"
        lt = report.get("last_task")
        if lt:
            blurb += f"; last task {lt.get('name')} [{lt.get('task_id')}]"
        if report.get("node_id"):
            blurb += f"; node {report['node_id']}"
        stack = report.get("stack") or []
        if stack:
            excerpt = "\n    ".join(stack[:stack_lines])
            blurb += f"\n  post-mortem stack excerpt:\n    {excerpt}"
        return blurb

    def _handle_worker_death(self, rec: WorkerRecord) -> None:
        """Worker connection dropped or process died.

        Reference analogues: task retry on worker crash
        (core_worker/task_manager.h:216 max_retries), actor restart
        (gcs/gcs_server/gcs_actor_manager.h:96 max_restarts); death
        classification + exit_detail propagation mirrors the reference's
        WorkerExitType plumbing through the GCS death path."""
        # Forensics first (no lock: bounded file IO + status reap) so
        # every error sealed below carries the classified reason. A
        # shutting-down head skips the evidence collection: every
        # worker dies at once there and nobody will read the reports —
        # N× (status wait + file reads) on the dying conns' reader
        # threads is pure teardown drag.
        try:
            if self._shutdown:
                crash = {"worker_id": rec.worker_id,
                         "node_id": rec.node_id, "pid": rec.pid,
                         "exit_type": "shutdown",
                         "exit_detail": "cluster shutdown",
                         "source": "head", "ts": time.time()}
            else:
                crash = self._build_crash_report(rec)
        except Exception:
            traceback.print_exc()
            crash = {"worker_id": rec.worker_id, "node_id": rec.node_id,
                     "pid": rec.pid, "exit_type": "unknown",
                     "exit_detail": "forensics collection failed",
                     "ts": time.time()}
        with self.lock:
            crash = self._record_crash(crash)
            blurb = self._death_blurb(crash)
            self.workers.pop(rec.worker_id, None)
            getattr(self, "_pending_creation_push", {}).pop(
                rec.worker_id, None)
            if rec.leased_to is not None:
                # Direct-plane lease dies with the worker: tell the
                # owner to stop pushing and fall back to the head path.
                self._end_lease(rec, revoke=True)
            self._release_worker_allocation(rec)
            # Direct seals this worker reported but whose owner never
            # confirmed: the seal died in the worker's send buffer and
            # the result is lost. The task already left rec.inflight
            # (the head saw its seal report), so the inflight-retry
            # path below can't save it — recover through lineage
            # re-execution like any other lost object (reference:
            # object_recovery_manager.h:43; regression test:
            # test_stress.py pipelined-flood chaos), and error-seal
            # only when the object is unrecoverable.
            # Two phases, like node-death recovery: mark EVERY lost
            # entry first, then reconstruct. A multi-return task has
            # all its return ids in the pending set; the first
            # _maybe_reconstruct resurrects the siblings to CREATING
            # and enqueues the spec once — interleaving the marking
            # would flip a resurrected sibling back to LOST and enqueue
            # the same spec again (double execution, budget double-
            # charged).
            # Actor-task seals take a different road: no lineage entry
            # (see _pending_seal_specs), so the producing spec rejoins
            # the in-flight set and replays on the restarted
            # incarnation under the same max_task_retries budget — the
            # at-least-once contract already covering calls that died
            # mid-execution covers calls whose RESULT died in the
            # send buffer too. Dedup by task id: a multi-return method
            # has every return id in the pending set but must requeue
            # once.
            doomed_seals = []
            doomed_replay = []
            replay_tids = set()
            actor_alive = (rec.actor_id is not None
                           and (a := self.actors.get(rec.actor_id))
                           is not None and a.state != "DEAD")
            for oid in self._worker_pending_seals.pop(rec.worker_id, ()):
                self._pending_owner_seals.pop(oid, None)
                spec = self._pending_seal_specs.pop(oid, None)
                e = self.objects.get(oid)
                if e is None or e.state != CREATING:
                    continue
                if spec is not None and actor_alive:
                    # Leave the entry CREATING: the replayed attempt
                    # (or _fail_task, budget exhausted) re-seals it.
                    if spec.task_id not in replay_tids:
                        replay_tids.add(spec.task_id)
                        doomed_replay.append(spec)
                    continue
                e.state = LOST
                e.location = None
                doomed_seals.append(oid)
            for oid in doomed_seals:
                if not self._maybe_reconstruct(oid):
                    self._seal_error(
                        oid,
                        f"WorkerCrashedError: worker {rec.worker_id} "
                        f"died before its result reached the owner "
                        f"[{blurb}]",
                        "worker_crashed")
            inflight = list(rec.inflight.values())
            rec.inflight = {}
            if rec.actor_id is not None:
                self._handle_actor_worker_death(
                    rec, inflight + doomed_replay)
            else:
                for spec in inflight:
                    if spec.retries_used < spec.max_retries:
                        spec.retries_used += 1
                        spec._packed_bin = None  # packed field changed
                        t = self.tasks.get(spec.task_id)
                        if t:
                            t["state"] = PENDING
                            t["retries"] = spec.retries_used
                        self._enqueue_task_spec(spec, front=True)
                    else:
                        self._fail_task(
                            spec,
                            f"WorkerCrashedError: worker {rec.worker_id} died while "
                            f"running {spec.name} (after {spec.retries_used} retries) "
                            f"[{blurb}]",
                            kind="worker_crashed",
                        )
        self.dispatch_event.set()

    def _handle_actor_worker_death(self, rec: WorkerRecord, inflight: list[TaskSpec]) -> None:
        """lock held."""
        actor = self.actors.get(rec.actor_id)
        if actor is None or actor.state == "DEAD":
            return
        blurb = self._death_blurb(self.crash_reports.get(rec.worker_id))
        # Direct-plane revoke: every owner holding a direct route to
        # this worker must stop pushing NOW — their in-flight direct
        # calls re-route through direct_recover / the requeue below
        # instead of hanging on a dead socket.
        for owner_id in actor.direct_watchers:
            self._client_cast(owner_id, "actor_direct_revoke",
                              {"actor_id": rec.actor_id})
        actor.direct_watchers.clear()
        if rec.conn is None and not rec.ready:
            # The worker process never came up (lost spawn cast, boot
            # crash — reaped by the health loop): that is a scheduling-
            # plane failure, not an actor crash. Reschedule the
            # creation WITHOUT charging the max_restarts budget; the
            # stale creation task record is closed out (a fresh spec is
            # minted by the next _try_start_actor).
            for spec in inflight:
                if spec.actor_creation:
                    t = self.tasks.get(spec.task_id)
                    if t:
                        t["state"] = FAILED
                        t["error"] = ("worker never registered; "
                                      "rescheduling actor creation")
            actor.state = "PENDING_CREATION"
            actor.worker_id = None
            return
        will_restart = actor.spec.max_restarts != 0 and (
            actor.spec.max_restarts < 0
            or actor.restarts < actor.spec.max_restarts
        )
        retry_budget = int(getattr(actor.spec, "max_task_retries", 0))
        creation_spec = None
        retried: list[TaskSpec] = []
        for spec in inflight:
            if spec.actor_creation:
                creation_spec = spec
                continue
            if (will_restart and retry_budget != 0
                    and (retry_budget < 0
                         or spec.retries_used < retry_budget)):
                # max_task_retries: the call replays on the restarted
                # incarnation (reference: @ray.remote(max_task_retries)
                # — at-least-once actor-method semantics, opt-in).
                spec.retries_used += 1
                spec._packed_bin = None  # packed field changed
                t = self.tasks.get(spec.task_id)
                if t:
                    t["state"] = PENDING
                    t["retries"] = spec.retries_used
                retried.append(spec)
                continue
            # In-flight calls die with the actor.
            self._fail_task(
                spec,
                f"ActorDiedError: actor {rec.actor_id} died while running "
                f"{spec.name} [{blurb}]",
                kind="actor_died",
            )
        if retried:
            # Ahead of already-queued calls, in submission order, so the
            # restarted incarnation replays the stream where it broke.
            for spec in sorted(retried, key=lambda s: s.seq_no,
                               reverse=True):
                self._pending_inc(spec)
                actor.pending.appendleft(spec)
        if will_restart:
            actor.restarts += 1
            actor.state = "PENDING_CREATION"
            actor.worker_id = None
            self._wal_append(("actor_restarts", rec.actor_id, actor.restarts))
            self._mark_dirty()
            # queued (not yet pushed) calls survive the restart
        else:
            actor.state = "DEAD"
            # Structured death context (not a bare string): subsequent
            # method calls raise ActorDiedError carrying the classified
            # reason + last-task provenance + stack excerpt.
            actor.death_cause = f"worker process died [{blurb}]"
            self._release_actor_arg_pins(actor)
            if creation_spec is not None:
                self._seal_error(
                    rec.actor_id + ":creation",
                    f"ActorDiedError: actor creation worker died [{blurb}]",
                    kind="actor_died",
                )
            self._drain_actor_queue(actor)
            if actor.spec.name:
                # Guarded: kill_actor already freed the name, and a NEW
                # same-named actor may have registered in the window
                # before this death processed — an unconditional pop
                # would silently unregister the successor.
                key = (actor.spec.namespace, actor.spec.name)
                if self.named_actors.get(key) == rec.actor_id:
                    self.named_actors.pop(key, None)
                    self._dir_name_del(key, rec.actor_id)
            self._wal_append(("actor_dead", rec.actor_id))
            self._mark_dirty()

    def _h_runtime_stats(self, body, conn):
        """Core runtime metric snapshot for the Prometheus exposition
        (reference: the C++ DEFINE_stats registry exported through the
        metrics agent)."""
        with self.lock:
            workers_alive = sum(1 for r in self.workers.values()
                                if r.conn is not None)
            actors_alive = sum(1 for a in self.actors.values()
                               if a.state == "ALIVE")
            rpc = {cid: dict(r.get("counters") or {})
                   for cid, r in self.rpc_reports.items()}
            from ray_tpu_torch._private import dataplane
            from ray_tpu_torch._private.retry import breaker_snapshot

            # Data-plane transfer accounting: every runtime's byte/copy
            # counters (ridden in on rpc_report) plus this process's
            # own, summed by path for
            # ray_tpu_object_bytes_transferred_total{path=...}.
            xfer_bytes: dict[str, int] = {}
            xfer_copies: dict[str, int] = {}
            for snap in [dataplane.counters()] + [
                    c.get("transfers") or {} for c in rpc.values()]:
                for path, n in (snap.get("bytes") or {}).items():
                    xfer_bytes[path] = xfer_bytes.get(path, 0) + n
                for path, n in (snap.get("host_copies") or {}).items():
                    xfer_copies[path] = xfer_copies.get(path, 0) + n

            out = {
                "counters": dict(self.stats),
                "gauges": {
                    "workers_alive": workers_alive,
                    "actors_alive": actors_alive,
                    "object_store_num_objects": len(self.objects),
                    "object_store_used_bytes": self.arena.in_use,
                    "nodes_alive": 1 + len(self.node_agents),
                    "tasks_pending": sum(len(q) for q in
                                         self.ready_queues.values()),
                    # Overload-protection plane gauges.
                    "admission_pending_total": self.pending_total,
                    "admission_pending_owners": len(self.pending_by_owner),
                    "mem_pressured_nodes": len(self.pressured_nodes),
                },
                # Deadline sheds by hop
                # (ray_tpu_tasks_shed_total{where=...}).
                "tasks_shed": dict(self.shed_counts),
                # Memory-pressure state per node (operator view).
                "pressured_nodes": {
                    nid: {k: info.get(k) for k in ("used", "total", "ts")}
                    for nid, info in self.pressured_nodes.items()},
                # Unified retry plane: the head process's own breakers;
                # each client's ride inside rpc.clients[*].breakers.
                "breakers": breaker_snapshot(),
                # Phase-latency histograms (queue wait / dispatch / exec
                # / result transfer) from the flight-recorder plane.
                "histograms": self.task_events.hist_snapshot(),
                # Crash-forensics plane: classified worker deaths for
                # the ray_tpu_worker_deaths_total{reason=...} counters.
                "worker_deaths": dict(self.death_counts),
                # Cluster-wide per-process rpc counters: every runtime's
                # snapshot (amortized rpc_report casts + agent
                # heartbeats), so the zero-head-frames property is
                # checkable for the whole cluster, not just locally.
                "rpc": {
                    "clients": rpc,
                    "total_head_frames": sum(
                        (c.get("head") or {}).get("frames_sent", 0)
                        for c in rpc.values()),
                    "clock_offsets": dict(self.clock_offsets),
                },
                # Object-plane observability: store bytes by node/state
                # (ray_tpu_object_store_bytes{node,state}), live refs by
                # kind from the owner censuses (ray_tpu_objects_live
                # {kind}), top callsites by bytes, and the leak
                # detector's suspect count.
                "objects": self._objects_stats_locked(),
                # Data-plane transfer census
                # (ray_tpu_object_bytes_transferred_total{path=...}).
                "transfers": {"bytes": xfer_bytes,
                              "host_copies": xfer_copies},
                # Request-tracing plane: retained/exemplar trace counts,
                # tail-fold aggregates, and owner-side span-buffer drops.
                "tracing": self.traces.stats(),
                # Continuous profiling plane: table occupancy, window
                # churn, GIL exemplars, and per-role self-time top-N
                # (ray_tpu_profile_* series in util/metrics).
                "profiling": self._profiling_stats_locked(),
            }
        # Telemetry history + alerting plane self-metrics (outside
        # self.lock — both keep their own): ray_tpu_tsdb_* gauges and
        # the ray_tpu_alerts_firing{severity} exposition read these.
        out["telemetry"] = self.tsdb.stats() if self.tsdb is not None \
            else {"series": 0, "points": 0, "ingested_total": 0,
                  "dropped_total": 0}
        out["alerts"] = self.alerts.stats() if self.alerts is not None \
            else {}
        out["head_shards"] = 1 if self.shard is None else self.shard.total
        for r in self._xshard_fanout("runtime_stats", body):
            # Numeric merge: counters/gauges/deaths/sheds sum; per-
            # client rpc maps concat (client ids are disjoint between
            # shards by construction of the owner hash).
            for sect in ("counters", "gauges", "tasks_shed",
                         "worker_deaths"):
                for k, v in (r.get(sect) or {}).items():
                    if isinstance(v, (int, float)):
                        out[sect][k] = out[sect].get(k, 0) + v
            rrpc = r.get("rpc") or {}
            out["rpc"]["clients"].update(rrpc.get("clients") or {})
            out["rpc"]["total_head_frames"] += rrpc.get(
                "total_head_frames", 0)
            out["rpc"]["clock_offsets"].update(
                rrpc.get("clock_offsets") or {})
            out["pressured_nodes"].update(r.get("pressured_nodes") or {})
            for path, n in ((r.get("transfers") or {}).get("bytes")
                            or {}).items():
                out["transfers"]["bytes"][path] = \
                    out["transfers"]["bytes"].get(path, 0) + n
            for path, n in ((r.get("transfers") or {}).get("host_copies")
                            or {}).items():
                out["transfers"]["host_copies"][path] = \
                    out["transfers"]["host_copies"].get(path, 0) + n
            # Profiling plane: counters sum; per-(role,frame) self-time
            # sums (shards report role="shard", so the merged top-N
            # attributes shard CPU separately from the parent head's).
            rprof = r.get("profiling") or {}
            for k in ("windows", "windows_total", "dropped_windows",
                      "gil_exemplars", "pinned", "samples_total"):
                out["profiling"][k] = (out["profiling"].get(k, 0)
                                       + rprof.get(k, 0))
            for role, frames in (rprof.get("self_time") or {}).items():
                mine = out["profiling"]["self_time"].setdefault(role, {})
                for frame, n in frames.items():
                    mine[frame] = mine.get(frame, 0) + n
            # Telemetry + alert planes: per-shard stores/engines, so
            # occupancy counters sum and the firing-by-severity map
            # merges per key.
            for k, v in (r.get("telemetry") or {}).items():
                if isinstance(v, (int, float)):
                    out["telemetry"][k] = out["telemetry"].get(k, 0) + v
            for k, v in (r.get("alerts") or {}).items():
                if isinstance(v, (int, float)):
                    out["alerts"][k] = out["alerts"].get(k, 0) + v
                elif isinstance(v, dict):
                    mine = out["alerts"].setdefault(k, {})
                    for sk, sv in v.items():
                        mine[sk] = mine.get(sk, 0) + sv
        return out

    def _profiling_stats_locked(self) -> dict:
        """lock held. Profiling-plane metric snapshot: plane counters
        plus per-role leaf-frame self-time hits (top-N per role, the
        Grafana "where do cycles go" panel's series)."""
        from ray_tpu_torch._private import profplane

        self_time: dict[str, dict[str, int]] = {}
        samples = 0
        for (_n, role, _w), rec in self.cluster_profile.items():
            samples += rec.get("samples", 0)
            agg = self_time.setdefault(role, {})
            for frame, hits in profplane.self_time(
                    rec.get("folded") or {}).items():
                agg[frame] = agg.get(frame, 0) + hits
        top_n = 8
        return {
            "windows": len(self.cluster_profile),
            "samples_total": samples,
            "self_time": {
                role: dict(sorted(frames.items(), key=lambda kv: kv[1],
                                  reverse=True)[:top_n])
                for role, frames in self_time.items()},
            **dict(self.profile_stats),
        }

    def _objects_stats_locked(self) -> dict:
        by_node_state: dict[str, dict] = {}
        for e in self.objects.values():
            node = self._object_node(e)
            b = by_node_state.setdefault(node, {})
            b[e.state] = b.get(e.state, 0) + e.size
        live_by_kind: dict[str, int] = {}
        by_callsite: dict[str, int] = {}
        for rep in self.object_census.values():
            for site, g in (rep.get("groups") or {}).items():
                by_callsite[site] = (by_callsite.get(site, 0)
                                     + g.get("bytes", 0))
                for k, v in (g.get("kinds") or {}).items():
                    live_by_kind[k] = live_by_kind.get(k, 0) + v
        top = sorted(by_callsite.items(), key=lambda kv: kv[1],
                     reverse=True)[:10]
        return {
            "by_node_state": by_node_state,
            "live_by_kind": live_by_kind,
            "top_callsite_bytes": dict(top),
            "leak_suspects": len(self.leak_suspects),
        }

    def _record_finished(self, task_id: str) -> None:
        """lock held. Terminal task-state retention (reference: the GCS
        task-event store keeps a bounded ring, gcs_task_manager.h:159):
        the finished ring's eviction also drops the state-API record —
        without this a million-task flood left a million dict entries in
        self.tasks for the session's lifetime."""
        ring = self.finished_tasks
        if ring.maxlen is not None and len(ring) == ring.maxlen:
            self.tasks.pop(ring[0], None)
        ring.append(task_id)

    def _fail_task(self, spec: TaskSpec, message: str, kind: str = "task_error") -> None:
        """lock held. Seal each return id with an error payload."""
        self._pending_dec(spec)
        self._expiry_signalled.discard(spec.task_id)
        t = self.tasks.get(spec.task_id)
        if t:
            t["state"] = FAILED
            t["error"] = message
            t["finished_at"] = time.time()
            self._record_finished(spec.task_id)
        self.stats["tasks_failed"] += 1
        for oid in spec.return_ids:
            self._seal_error(oid, message, kind)
        if not spec.actor_creation:
            for dep in self._pinned_ids(spec):
                e = self.objects.get(dep)
                if e is not None and e.task_pins > 0:
                    e.task_pins -= 1
                    self._maybe_free(e)

    def _seal_inline(self, object_id: str, value) -> None:
        """lock held. Seal a head-produced value (e.g. PG readiness)."""
        from ray_tpu_torch._private import serialization

        payload = serialization.dumps(value)
        entry = self.objects.get(object_id) or ObjectEntry(object_id, "head")
        entry.inline = payload
        entry.size = len(payload)
        entry.state = SEALED
        if entry.refcount == 0:
            entry.refcount = 1
        self.objects[object_id] = entry
        self._on_sealed(object_id)

    def _seal_error(self, object_id: str, message: str, kind: str,
                    provenance: "dict | None" = None) -> None:
        from ray_tpu_torch._private import serialization

        body = {"__rtpu_error__": kind, "message": message}
        if provenance:
            # Structured loss context (node/owner/object); the client's
            # _deserialize rebuilds a provenance-carrying exception.
            body["provenance"] = provenance
        payload = serialization.dumps(body)
        entry = self.objects.get(object_id) or ObjectEntry(object_id, "head")
        entry.inline = payload
        entry.size = len(payload)
        entry.state = SEALED
        entry.is_error = True
        if entry.refcount == 0:
            entry.refcount = 1
        self.objects[object_id] = entry
        self._on_sealed(object_id)
        # The owner's get() waits LOCALLY for results it expects: push
        # the error seal to its owner plane so that wait resolves
        # without the stall-probe fallback.
        if (entry.owner_id in self.client_owner_addrs
                or (self.shard is not None
                    and entry.owner_id not in self.clients)):
            self._client_cast(entry.owner_id, "seal_objects", {
                "objects": [{"object_id": object_id, "payload": payload,
                             "is_error": True}]})

    # ------------------------------------------------------------------

    def shutdown(self) -> None:
        self._shutdown = True
        vp = getattr(self, "_view_publisher", None)
        if vp is not None:
            vp.stop()
        try:
            self.bulk_server.stop()
        except Exception:
            pass
        zy = getattr(self, "_zygote_client", None)
        if zy is not None:
            zy.stop()
        if self._snapshot_path and self._snapshot_dirty:
            self._snapshot_now()
        if self._wal is not None:
            self._wal.close()
        if self.memory_monitor is not None:
            self.memory_monitor.stop()
        with self.lock:
            workers = list(self.workers.values())
            for rec in workers:
                if rec.expected_exit is None:
                    rec.expected_exit = ("shutdown", "cluster shutdown")
        for rec in workers:
            try:
                if rec.conn:
                    rec.conn.cast("kill", {})
            except rpc.ConnectionLost:
                pass
        deadline = time.time() + 2.0
        for rec in workers:
            if rec.proc is None:
                if rec.zygote and rec.pid:
                    # Zygote children are reaped by the zygote (SIGCHLD
                    # ignored there); a hung one still needs the kill.
                    try:
                        os.kill(rec.pid, 9)
                    except OSError:
                        pass
                continue
            try:
                rec.proc.wait(timeout=max(0.05, deadline - time.time()))
            except subprocess.TimeoutExpired:
                rec.proc.kill()
                try:
                    rec.proc.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    pass
        # Cgroup teardown only after the workers are gone: rmdir on a
        # populated cgroup is EBUSY.
        cg = getattr(self, "_cgroup", None)
        if cg is not None:
            cg.teardown()
        # Spilled objects die with the session (reference: spilled files
        # live under the session dir; external backends get their cleanup
        # hook invoked here).
        try:
            self.external_storage.destroy()
        except Exception:
            pass
        self.server.stop()
        self.arena.close(unlink=True)
