"""Runtime config flags, env-overridable.

Counterpart of the reference's RAY_CONFIG table
(reference: src/ray/common/ray_config_def.h — 224 ``RAY_CONFIG(type, name,
default)`` entries overridable via ``RAY_{name}`` env vars). Here the table is
a typed dataclass; every field can be overridden with ``RAY_TPU_<NAME>`` env
vars or programmatically via ``ray_tpu_torch.init(_system_config={...})``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


def _env(name: str, default: Any, typ: type) -> Any:
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes")
    if default is None or typ in (dict, list, type(None)):
        # Structured / optional fields come in as JSON
        # (reference: RAY_object_spilling_config is a JSON string).
        import json

        return json.loads(raw)
    return typ(raw)


@dataclasses.dataclass
class Config:
    # --- object store ---
    object_store_memory: int = 512 * 1024 * 1024
    # Objects <= this many bytes go through the in-process memory store /
    # control plane inline rather than shm (reference analogue:
    # max_direct_call_object_size in ray_config_def.h).
    max_inline_object_size: int = 100 * 1024
    # Zero-copy ray_tpu_torch.get for shm objects (reference: plasma's
    # read-only mmap'd numpy views): arrays alias the store buffer and
    # the read pin holds until they die. Disabled, get() copies out and
    # releases the pin immediately (arrays are read-only either way —
    # the copy path is bytes-backed).
    zero_copy_get: bool = True
    object_spilling_dir: str = ""
    # Backend selection JSON (reference: RAY_object_spilling_config):
    # {"type": "filesystem"|"smart_open", "params": {...}}
    object_spilling_config: dict | None = None
    # Start spilling when the store passes this fraction of capacity.
    object_spilling_threshold: float = 0.8

    # --- scheduling ---
    num_cpus_default: int = 0  # 0 => autodetect
    worker_pool_prestart: int = 0  # extra idle workers to keep warm
    scheduler_spread_threshold: float = 0.5  # hybrid policy pack->spread cutoff

    # --- fault tolerance ---
    task_max_retries_default: int = 3
    actor_max_restarts_default: int = 0
    # Agent heartbeat cadence / the head's death grace for a silent
    # (partitioned, not just disconnected) node — reference:
    # gcs_health_check_manager.h:45 period/timeout pair.
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 30.0

    # --- chaos plane / unified retry policy ---
    # Deterministic fault injection (faultinject.py): JSON spec with a
    # seed and drop/delay/dup/error/partition rules, filterable by peer
    # and message kind. Usually set via the RAY_TPU_FAULT_SPEC env var
    # so spawned agents/workers inherit it.
    fault_spec: dict | None = None
    # RetryPolicy defaults (retry.py; reference analogue: the retryable
    # gRPC client's backoff + server-unavailable timeout,
    # rpc/retryable_grpc_client.h). Applied at the idempotent control-
    # plane edges: registration, owner-plane fetches, bulk pulls,
    # reconnect loops.
    rpc_retry_max_attempts: int = 4
    rpc_retry_base_delay_s: float = 0.05
    rpc_retry_max_delay_s: float = 2.0
    rpc_retry_jitter: float = 0.2
    rpc_retry_deadline_s: float = 30.0
    rpc_attempt_timeout_s: float = 10.0
    # Circuit breaker: consecutive failures against one target before
    # calls fail fast, and how long the circuit stays open.
    rpc_breaker_threshold: int = 5
    rpc_breaker_reset_s: float = 5.0
    # TCP connect timeout for control-plane dials (was hardcoded 30 s).
    rpc_connect_timeout_s: float = 30.0
    # Lineage reconstruction (reference: task_manager.h:223 max_lineage_bytes,
    # object_recovery_manager.h:43): producing TaskSpecs retained per return
    # object, re-executed when a freed/lost object is fetched again.
    max_lineage_entries: int = 100_000
    max_object_reconstructions: int = 3

    # --- P2P object plane (reference: per-node plasma + chunked
    # push/pull, push_manager.h:32 / pull_manager.h:57) ---
    agent_object_store_memory: int = 256 * 1024 * 1024
    p2p_chunk_size: int = 4 * 1024 * 1024
    # Bulk transfer plane (reference: push_manager.h:32 chunked object
    # push): head-stored objects above this size go to off-host clients
    # via parallel raw-socket stripes instead of pickled inline metas.
    bulk_transfer_min: int = 4 * 1024 * 1024
    bulk_streams: int = 4
    # Off-host pullers cache payloads at least this big in their node's
    # agent store and register as replica sources (spanning-tree
    # broadcast fan-out).
    bulk_replicate_min: int = 16 * 1024 * 1024
    # Relay-tree broadcast registers sources IN-WAVE: a completed reader
    # becomes a pull source immediately (0.0) so later readers of the
    # same object fan out across the tree instead of convoying on one
    # primary. Raise to defer replica cache writes past a latency-
    # sensitive window.
    bulk_replicate_delay_s: float = 0.0

    # --- zero-copy data plane (metadata-only seals + p2p payload
    # pulls + relay-tree broadcast; RAY_TPU_DATA_PLANE=0 master kill
    # switch lives in dataplane.py — read from the env so spawned
    # workers inherit it) ---
    # Serialized results at least this big seal METADATA-ONLY: the
    # payload stays in the producing node's arena and the owner
    # receives a location record (nbytes, dtype/shape/sharding, holder
    # address) instead of bytes; getters pull peer-to-peer.
    data_plane_min_bytes: int = 100 * 1024
    # Relay fan-out: how many concurrent remote-host pulls one object
    # serves before additional pullers are parked to wait for a relay
    # source (a completed reader) to register. <= 0 disables gating.
    relay_fanout: int = 3
    # Safety valve: a parked puller is released to the primary source
    # after this long even if no relay appeared.
    relay_max_defer_s: float = 5.0
    # Same-host readers (boot id match) map the holder node's arena
    # directly instead of pulling over a socket — the host-colocated
    # fast path (multiple logical nodes per TPU host share RAM).
    data_plane_host_shm: bool = True
    # Colocated device-result cache: a get() in the producing process
    # returns a device-side copy of the CUDA tensor result (no D2H2D
    # round trip). Bounds on entries and resident bytes.
    device_result_cache_entries: int = 64
    device_result_cache_bytes: int = 256 * 1024 * 1024

    # --- direct-call plane (reference: Ray's core-worker "direct call"
    # architecture — the submitter owns its tasks and talks to leased
    # workers directly; the GCS is a directory, not a router.
    # normal_task_submitter.cc:29 lease cache + direct actor transport)
    # Master switch: 0 falls every submission back to head routing.
    direct_call_enabled: bool = True
    # Owner-side bounded inflight window per actor route / task lease:
    # calls beyond it queue locally (actors, ordering preserved) or
    # spill back to the head path (leased tasks).
    direct_window: int = 64
    # Worker-side back-pressure: a worker rejects direct pushes past
    # this many queued+running direct tasks (safety valve against a
    # misbehaving owner; rejection spills the call to the head path).
    direct_worker_inflight_max: int = 256
    # Watchdog: a direct-dispatched call unresolved after this long is
    # re-routed through the head (covers a dropped/blackholed direct
    # link; worker/actor death re-routes immediately via revoke casts).
    direct_resubmit_timeout_s: float = 10.0
    # Worker lease grants for same-shape normal tasks: time and call-
    # count bounds (whichever trips first ends the lease).
    lease_ttl_s: float = 10.0
    lease_max_calls: int = 100_000
    # Owner-side inflight per leased worker. Default 1: a normal task
    # never queues behind another on a leased worker (a slow task must
    # not serialize quick ones); parallelism comes from the lease POOL
    # growing across workers, and overflow rides the head path.
    lease_window: int = 1

    # --- native-speed control plane (binary wire format) ---
    # Compact binary framing for HOT control-plane messages (direct
    # pushes, acks, seals, task_started/task_finished — wirefmt.py)
    # instead of per-frame pickle. Negotiated per connection at
    # register/whoami, so mixed-version peers transparently stay on
    # pickle framing. 0 disables advertising/accepting it everywhere.
    wire_binary: bool = True
    # Coalesce consecutive same-kind buffered casts (delivery acks,
    # seal batches) into one frame with N records before framing —
    # flood traffic stops paying per-record framing. Record order is
    # preserved (only adjacent records merge).
    wire_coalesce: bool = True
    # Native event-loop fast lane (src/eventloop → _evloop.so): a
    # Connection moves its reader/writer threads and the cast
    # coalescer into C pthreads that touch Python once per BATCH of
    # frames. Requires wire_binary; chaos-armed sessions route casts
    # back through the Python buffer so faultinject matching is
    # unchanged. 0 (RAY_TPU_NATIVE_LOOP=0) pins today's pure-Python
    # rpc loop even where the extension compiled.
    native_loop: bool = True
    # High-water mark (MiB) for the native lane's send ring — past it,
    # senders block GIL-free until the writer drains (same 64 MiB
    # backpressure contract as the Python _SEND_HIGH_WATER_BYTES).
    evloop_ring_mb: int = 64
    # (RAY_TPU_NATIVE=0 additionally forces the pure-Python codec in
    # place of the _specenc.so C fast lane — read directly from the
    # env in wirefmt.py/native_build.py since it gates extension
    # LOADING, which happens before any Config exists.)

    # --- head fault tolerance (reference: gcs_init_data.h +
    # redis_store_client.h:111 — persistent GCS state; here a periodic
    # snapshot file instead of Redis) ---
    gcs_snapshot_path: str = ""  # empty = persistence disabled
    # External head-state store URI ("file:///shared/dir"). Supersedes
    # gcs_snapshot_path; on shared storage it gives cross-node head HA
    # (reference: redis_store_client.h:111).
    gcs_external_store: str = ""
    gcs_snapshot_interval_s: float = 1.0
    # How long node agents / drivers keep retrying the head address
    # after a connection drop before giving up.
    agent_reconnect_grace_s: float = 60.0
    driver_reconnect_grace_s: float = 60.0

    # --- memory monitor / OOM killing ---
    # Reference: memory_monitor.h:52 (enabled when usage threshold < 1.0),
    # worker_killing_policy_retriable_fifo.h.
    memory_monitor_enabled: bool = True
    memory_usage_threshold: float = 0.95
    memory_monitor_interval_s: float = 1.0
    # Soft watermark BELOW the kill threshold (overload-protection
    # plane): a node past it is "pressured" — it stops receiving new
    # placements and lease grants, and its workers bounce direct pushes
    # (direct_rej → head path) until usage recovers. Backpressure
    # instead of the kill threshold's reactive SIGKILL. >= the kill
    # threshold (or >= 1.0) disables the soft watermark.
    memory_pressure_threshold: float = 0.80
    # Hysteresis: a pressured node recovers only once usage drops this
    # far BELOW the watermark (flap damping).
    memory_pressure_hysteresis: float = 0.03

    # --- overload protection: deadlines + admission control ---
    # Default task deadline stamped at submit (seconds; 0 = none).
    # Per-call override: fn.options(timeout_s=...). Expired tasks are
    # shed at every queue hop with a typed TaskTimeoutError instead of
    # burning capacity.
    task_timeout_s_default: float = 0.0
    # Admission budgets: pending (queued, not yet executing) tasks per
    # owner and cluster-wide. The owner runtime enforces its own budget
    # at submit (blocking by default); the head enforces both as the
    # authoritative backstop and rejects over-budget submissions with a
    # typed PendingCallsLimitError seal + a backpressure cast. Fairness
    # is per-owner: one hot client exhausts ITS budget (or its fair
    # share of the global one) while others keep submitting. <= 0
    # disables a budget.
    admission_max_pending_per_owner: int = 200_000
    admission_max_pending_total: int = 1_000_000
    # What an over-budget submit does at the OWNER: "block" (default)
    # parks the submitting thread until the backlog drains; "fail"
    # raises PendingCallsLimitError immediately.
    admission_mode: str = "block"
    # Blocking-submit gives up (PendingCallsLimitError) after this long.
    admission_block_timeout_s: float = 60.0

    # --- networking ---
    head_host: str = "127.0.0.1"  # 0.0.0.0 for multi-host clusters
    head_port: int = 0  # 0 = ephemeral; CLI `start --head` defaults 6380
    # Head dispatch shards: >1 splits the head's hot path across that
    # many worker processes (each a full Head over a slice of the
    # cluster, fronted by a connection router + metadata directory in
    # the parent — see _private/head_shards.py). 0 = auto
    # (min(4, cpu count)); 1 = the single-process head, bit-identical
    # to the pre-shard runtime (the kill switch).
    head_shards: int = 0

    # --- timeouts ---
    worker_register_timeout_s: float = 30.0
    get_timeout_poll_s: float = 0.01

    # --- task events / observability ---
    task_events_max_buffer: int = 100000
    metrics_report_interval_s: float = 5.0
    # Flight-recorder tracing plane (_private/events.py): stamp per-hop
    # lifecycle phases onto existing control-plane messages and keep a
    # bounded head-side event table rendered by util.state.timeline().
    # Costs a few time.time() calls and floats per task; disable for
    # overhead-sensitive floods (benchmarks/microbenchmark.py measures
    # the delta).
    task_events_enabled: bool = True
    # How often each runtime piggybacks its rpc counter snapshot (and
    # buffered chaos events) to the head — the cluster-wide half of
    # ray_tpu_torch.util.metrics.rpc_counters(). Amortized, never per-call.
    rpc_report_interval_s: float = 5.0
    # Agent clock probe cadence: one NTP-style clock_sync call per this
    # many heartbeats feeds the head's per-node clock-offset table used
    # to align cross-node trace spans.
    clock_sync_every_n_heartbeats: int = 5
    # Request-scoped distributed tracing (_private/traceplane.py):
    # a trace context minted at the serve proxy (or tracing.span)
    # rides TaskSpecs as an optional trailing compiled-encoding field
    # and is inherited by nested .remote() calls; span records ride the
    # existing task_finished/rpc_report casts into a bounded head-side
    # table of causal trace trees. RAY_TPU_TRACE_ENABLED=0 is the kill
    # switch: nothing is minted/stamped and every frame is byte-
    # identical to the pre-tracing wire format.
    trace_enabled: bool = True
    # Fraction of proxy-minted traces that record spans (the sampled
    # bit; unsampled requests still propagate ids for log correlation).
    trace_sample_rate: float = 1.0
    # Head-side trace table bound: past it, non-exemplar traces fold
    # into counts (tail-based retention keeps slow/error/shed
    # exemplars and a uniform 1-in-N sample in full detail).
    trace_table_max: int = 512
    trace_max_spans: int = 256  # spans retained per trace
    # A trace whose root span exceeds this duration is a slow exemplar.
    trace_slow_threshold_s: float = 0.5
    # Uniform tail sample: every Nth non-exemplar trace survives
    # folding (<= 0 keeps exemplars only).
    trace_uniform_keep_nth: int = 16
    # Owner-side user-span buffer (util.tracing spans flush on the
    # amortized rpc_report cast, never per-span): spans past the bound
    # are counted as dropped, not sent.
    trace_span_buffer_max: int = 2048
    # Object-plane observability (_private/objcensus.py): each owner
    # runtime tracks its live ObjectRefs with the creating callsite
    # (interned — the hot path pays one dict lookup), size, and kind;
    # a bounded per-callsite summary piggybacks on the amortized
    # rpc_report cast and feeds `ray-tpu memory` + the leak detector.
    # Zero new per-call head frames (guard: test_dispatch_fastpath).
    object_census_enabled: bool = True
    # Owner-side census table bound (records beyond it are counted as
    # dropped, never tracked — a runaway ref leak must not leak the
    # instrument too).
    object_census_max_entries: int = 100_000
    # Callsite groups per piggybacked census report (rest fold into an
    # "(other callsites)" bucket) and sample object ids per group (the
    # head's per-object callsite attribution for drill-downs).
    object_census_report_groups: int = 64
    object_census_sample_ids: int = 8
    # Leak detector (head-side sweep, observe-only — flags, never
    # kills): a callsite whose live bytes grew monotonically across
    # this many consecutive census reports becomes a suspect; an object
    # SEALED but never fetched past the TTL becomes a suspect; borrows
    # outliving their owner's ref become suspects.
    object_leak_windows: int = 3
    object_leak_ttl_s: float = 300.0
    # Sweep cadence (rides the head health loop) and a per-entry scan
    # cap: past it the sealed-never-read sweep is skipped that tick (a
    # million-object flood must not stall the health loop).
    object_leak_sweep_interval_s: float = 5.0
    object_leak_scan_cap: int = 250_000

    # Post-mortem crash forensics (_private/forensics.py): workers arm
    # faulthandler + excepthooks into a per-worker crash file and stamp
    # a tiny mmap'd beacon per task; supervisors reap the real exit
    # status, classify it, and keep a bounded crash-report table on the
    # head. Arming is one-time at boot and the beacon write is an mmap
    # slice per task — steady-state free (microbenchmark measures the
    # on/off delta).
    crash_forensics_enabled: bool = True
    # Bounded head-side crash report table (oldest evicted past this).
    crash_reports_max: int = 256

    # Continuous profiling plane (_private/profplane.py): every runtime
    # process arms a duty-cycled sampling profiler at boot (kill switch
    # RAY_TPU_PROFILING_ENABLED=0; rate/duty knobs RAY_TPU_PROFILE_HZ /
    # RAY_TPU_PROFILE_DUTY_CYCLE — env-only: read pre-runtime and
    # inherited by every spawned process). Window summaries piggyback
    # on the amortized report casts; the head keeps a bounded cluster
    # table keyed (node, role, window).
    profiling_window_s: float = 5.0          # summary cadence (= report)
    profiling_table_max: int = 4096          # owner-side folded stacks
    profiling_report_stacks: int = 64        # top-K per shipped window
    profiling_sidecar_stacks: int = 200      # stacks in the crash sidecar
    # GIL-starvation exemplar trigger: exec wall >= min_wall_s AND
    # cpu <= wall * cpu_ratio pins the window's profile as an exemplar.
    profiling_gil_min_wall_s: float = 0.5
    profiling_gil_cpu_ratio: float = 0.25
    # Head-side cluster profile table bound (oldest UNPINNED window
    # evicted past it; regression-pinned windows survive).
    cluster_profile_max_windows: int = 512
    # Phase-regression pinning: a queue_wait/dispatch p95 above
    # factor * trailing median (given >= min_count observations) pins
    # the head/shard flamegraphs for that window.
    profiling_regression_factor: float = 2.0
    profiling_regression_min_count: int = 200

    # Telemetry history + SLO alerting plane (_private/tsdb.py +
    # _private/alertplane.py): the head retains bounded metric history
    # in two downsampling tiers and evaluates a declarative alert-rule
    # registry on the health tick. Ingestion rides the existing
    # amortized casts only (kill switches RAY_TPU_TSDB_ENABLED /
    # RAY_TPU_ALERTS_ENABLED — env-only: read pre-Config and in every
    # process).
    tsdb_raw_resolution_s: float = 10.0      # raw tier bucket width
    tsdb_raw_retention_s: float = 1800.0     # raw tier: ~10s x 30min
    tsdb_rollup_resolution_s: float = 60.0   # rollup tier bucket width
    tsdb_rollup_retention_s: float = 86400.0  # rollups: 1min x 24h
    tsdb_max_series: int = 2048              # past it: (other series) fold
    tsdb_sample_interval_s: float = 10.0     # head self-sample cadence
    alerts_eval_interval_s: float = 10.0     # rule sweep cadence
    alerts_history_max: int = 256            # resolved-alert ring bound
    alerts_max_rules: int = 128              # rule registry bound
    # Stock SLO rule thresholds (alertplane.default_rules).
    alert_phase_p95_warn_s: float = 2.0      # queue-wait p95 warn line
    alert_serve_p99_slo_s: float = 2.0       # exec p99 SLO objective
    alert_worker_death_rate: float = 0.2     # deaths/s over 5min = page
    alert_kv_pages_min: float = 1.0          # free KV pages floor

    def apply_overrides(self, overrides: dict | None = None) -> "Config":
        cfg = dataclasses.replace(self)
        for f in dataclasses.fields(cfg):
            setattr(cfg, f.name, _env(f.name, getattr(cfg, f.name), f.type_obj if hasattr(f, "type_obj") else type(getattr(cfg, f.name))))
        for k, v in (overrides or {}).items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown system config key: {k}")
            setattr(cfg, k, v)
        return cfg


GLOBAL_CONFIG = Config().apply_overrides()


# Env-ONLY knobs: RAY_TPU_* names read directly from the environment
# rather than through the Config table above (they are needed before
# the table exists, differ per process, or gate import-time machinery).
# Every such read anywhere in the tree must have an entry here — the
# invariant checker (`ray-tpu lint`, RT-K001) cross-references this
# registry against the AST, so an ad-hoc os.environ.get("RAY_TPU_...")
# fails CI until it is declared. Tags:
#   "operator" — a real tuning/override surface; must also appear in
#                the README knob tables (RT-K002).
#   "internal" — spawn plumbing the runtime sets for its own children
#                (worker identity, session paths); declared so the
#                propagation set is auditable, not operator docs.
ENV_KNOBS = {
    # -- operator surface --------------------------------------------
    "RAY_TPU_ADDRESS": (
        "operator", "head address for ray_tpu_torch.init(); empty starts a "
        "local cluster"),
    "RAY_TPU_NATIVE": (
        "operator", "0 forces pure-Python codec/native fallbacks "
        "everywhere (read pre-Config at import time)"),
    "RAY_TPU_DATA_PLANE": (
        "operator", "0 kills the zero-copy data plane"),
    "RAY_TPU_HOST_SHM": (
        "operator", "0 disables same-host shared-memory object reads"),
    "RAY_TPU_AGENT_STORE": (
        "operator", "0 disables the node-agent shared object store"),
    "RAY_TPU_CRASH_DIR": (
        "operator", "override the per-worker crash-forensics "
        "directory"),
    "RAY_TPU_USAGE_STATS_ENABLED": (
        "operator", "0 disables anonymous usage-stats reporting"),
    "RAY_TPU_WORKER_PROFILE": (
        "operator", "1 arms the worker-side profiler at boot"),
    "RAY_TPU_PROFILING_ENABLED": (
        "operator", "0 kills the continuous profiling plane: no "
        "sampler thread, no profile report fields, bit-identical "
        "report casts"),
    "RAY_TPU_PROFILE_HZ": (
        "operator", "continuous-profiler sample rate during active "
        "bursts (default 19 Hz; prime avoids aliasing with periodic "
        "runtime loops)"),
    "RAY_TPU_PROFILE_DUTY_CYCLE": (
        "operator", "fraction of each sampling cycle the continuous "
        "profiler is active (default 0.2 — steady-state cost is "
        "duty * hz stack walks/s per process)"),
    "RAY_TPU_TSDB_ENABLED": (
        "operator", "0 kills the embedded time-series store: no metric "
        "history retained, query_metrics answers empty"),
    "RAY_TPU_ALERTS_ENABLED": (
        "operator", "0 kills the SLO alert engine: no rule evaluation, "
        "empty alert surfaces"),
    "RAY_TPU_ALERT_WEBHOOK": (
        "operator", "URL POSTed a JSON alert record on every "
        "firing/resolved transition (best-effort, 2s timeout)"),
    "RAY_TPU_METRICS_TIMESTAMPS": (
        "operator", "1 appends millisecond sample timestamps to gauge "
        "lines in the Prometheus exposition (scrape-time vs "
        "sample-time skew becomes visible)"),
    "RAY_TPU_RESOURCE_SYNC_PERIOD_S": (
        "operator", "resource-view publish cadence (seconds)"),
    "RAY_TPU_RESOURCE_SYNC_SNAPSHOT_TICKS": (
        "operator", "full-snapshot interval in publish ticks"),
    "RAY_TPU_WORKFLOW_DIR": (
        "operator", "workflow checkpoint root (default: ~/.ray_tpu_torch)"),
    "RAY_TPU_LOCK_WITNESS": (
        "operator", "1 arms the runtime lock-order witness: every "
        "ray_tpu_torch lock acquisition feeds a live ordering graph and "
        "cycles (potential deadlocks) are reported with both stacks"),
    "RAY_TPU_HEAD_SHARDS": (
        "operator", "head dispatch shards: N>1 runs N parallel head "
        "shard processes behind a connection router + metadata "
        "directory, 1 pins the single-process head (kill switch), "
        "0/unset = auto (min(4, ncpu))"),
    # -- internal spawn plumbing -------------------------------------
    "RAY_TPU_SHARD_BOOT": (
        "internal", "pickled boot payload path handed to a head shard "
        "process (config, resource slice, shard index, bus address)"),
    "RAY_TPU_SHARD_FD": (
        "internal", "inherited socketpair fd a head shard receives "
        "routed client connections on (SCM_RIGHTS fd-passing)"),
    "RAY_TPU_HEAD": (
        "internal", "head host:port handed to spawned workers"),
    "RAY_TPU_WORKER_ID": (
        "internal", "worker identity stamped by the spawner"),
    "RAY_TPU_NODE_ID": (
        "internal", "node identity stamped by the node agent"),
    "RAY_TPU_NODE_IP": (
        "internal", "advertised node IP for cross-node channels"),
    "RAY_TPU_JOB_ID": (
        "internal", "job attribution for spawned workers"),
    "RAY_TPU_SESSION_DIR": (
        "internal", "per-session scratch root (logs, sockets, crash "
        "files)"),
    "RAY_TPU_REMOTE": (
        "internal", "marks a process as a remote (non-head) runtime"),
    "RAY_TPU_ZYGOTE_EXIT_FILE": (
        "internal", "zygote supervisor exit-status handoff path"),
    "RAY_TPU_ZYGOTE_DIRECT_SPAWN_BUDGET": (
        "internal", "direct-spawn fallback budget while the zygote "
        "warms"),
    "RAY_TPU_ZYGOTE_SPAWN_GRACE_S": (
        "internal", "grace window before spawn deferral trips"),
}
