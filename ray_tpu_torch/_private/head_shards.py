"""Sharded multi-core head: parallel dispatch shards behind a router.

The single-process head runs every submit/dispatch/seal/bookkeeping
handler under one GIL — the C event loop proved the per-connection
lane but measured parity on one core because head, owner, and worker
time-share it. This module puts the armed lane on real cores
(reference shape: Ray's GCS/raylet split — a thin metadata service
with scheduling pushed down to per-shard loops):

* ``ShardDirectory`` (parent process) — binds the advertised head
  address but keeps NO per-call state. Its router accepts a
  connection, reads exactly one frame to learn who is dialing, picks a
  shard, and hands the accepted socket over an inherited socketpair
  with SCM_RIGHTS fd-passing (the frame rides along and is replayed
  shard-side, so the peer sees one seamless handler pass). The parent
  also runs the shard bus (names, cross-shard rendezvous), spawns and
  reaps the shard processes through the forensics classifier, and
  respawns a shard that dies.

* ``ShardHost`` (each shard process) — a full ``Head`` over its slice
  of the box (own scheduler, workers, zygote, arena, session subdir),
  plus the bus client that serves cross-shard lookups. Steady-state
  traffic for the owners routed to a shard never leaves it: submit,
  lease grants, direct-plane grants/revokes, seals, and bookkeeping
  all run shard-locally on the shard's own core.

* ``shard_for`` — the stable owner hash. Client ids are minted by the
  router (rejection-sampled) so ``shard_for(client_id) == hosting
  shard`` holds for every client and worker in the cluster; any
  process can compute where an owner lives from its id alone.

``RAY_TPU_HEAD_SHARDS=1`` is the kill switch: ``create_head`` returns
a plain ``Head`` and zero sharding code runs.

Cross-shard protocol notes (the rare path — steady state is
shard-local): object metas served across shards are PIN-FREE (inline
payload copies / owner pointers / unpinned p2p), so no pin lifecycle
ever spans shards; unpinned p2p reads are covered by the data plane's
validated-read handshake. Cross-shard actor calls forward the whole
submit to the owning shard; pushes back to the owner relay through
the directory (``dir_client_cast``).
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

from ray_tpu_torch._private import forensics, rpc
from ray_tpu_torch._private.config import Config

# Directory-global tables: ONLY ShardDirectory may touch these
# attributes directly — shard-local code goes through the shard bus.
# tools/rtlint/passes/shardbus.py enforces this statically (the
# cross-shard race class sharding introduces: a shard mutating the
# name registry behind the directory's atomic-claim lock).
DIRECTORY_TABLES = frozenset({
    "dir_named_actors",   # (namespace, name) -> (actor_id, shard)
    "dir_shards",         # shard index -> _ShardProc
    "dir_crash_reports",  # shard death reports (forensics-classified)
})

_FDHDR = struct.Struct("<I")


def shard_for(client_id: str, total: int) -> int:
    """The owner hash: which shard hosts ``client_id``. Stable across
    processes and runs (crc32, not Python's salted hash)."""
    if total <= 1:
        return 0
    return zlib.crc32(client_id.encode()) % total


def mint_for_shard(prefix: str, shard: int, total: int) -> str:
    """Mint ``prefix-<8hex>`` ids until one hashes to ``shard`` —
    keeps the global invariant shard_for(id) == hosting shard without
    a lookup table (expected ``total`` draws)."""
    import uuid

    while True:
        cid = prefix + uuid.uuid4().hex[:8]
        if shard_for(cid, total) == shard:
            return cid


def resolved_head_shards(config: Config, num_gpus=None) -> int:
    """The effective shard count: the knob, or min(4, ncpu) when 0
    (auto). A 1-core box resolves to 1 — sharding there would only
    add process hops around the same GIL'd core. So does a node with
    GPUs (``num_gpus``, else detected): an owner's tasks stay on its
    shard, and each shard leases only its own slice of the devices, so
    under sharding a driver on a shard without a GPU could never run a
    GPU task (one H100 and four shards leave three shards without
    one). The explicit knob still shards such a node."""
    n = int(getattr(config, "head_shards", 0) or 0)
    if n < 1:
        # Config objects built without apply_overrides (scripts.py
        # cmd_start) still honor the operator knob.
        n = int(os.environ.get("RAY_TPU_HEAD_SHARDS") or 0)
    if n >= 1:
        return n
    if num_gpus is None:
        from ray_tpu_torch.accelerators.cuda import CUDAAcceleratorManager

        num_gpus = CUDAAcceleratorManager.get_current_node_num_accelerators()
    if num_gpus:
        return 1
    return max(1, min(4, os.cpu_count() or 1))


def create_head(config: Config, num_cpus=None, num_gpus=None,
                resources=None):
    """The head factory ``init()``/``start --head`` call: a plain
    ``Head`` at shards==1 (bit-identical kill switch), a
    ``ShardDirectory`` above."""
    n = resolved_head_shards(config, num_gpus)
    if n <= 1:
        from ray_tpu_torch._private.gcs import Head

        return Head(config, num_cpus=num_cpus, num_gpus=num_gpus,
                    resources=resources)
    return ShardDirectory(config, n, num_cpus=num_cpus,
                          num_gpus=num_gpus, resources=resources)


# ---------------------------------------------------------------------------
# SCM_RIGHTS fd-passing over an inherited socketpair


def send_fd(sock: socket.socket, fd: int, meta: bytes) -> None:
    sock.sendmsg([_FDHDR.pack(len(meta)) + meta],
                 [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                   struct.pack("i", fd))])


def recv_fd(sock: socket.socket) -> "tuple[int, bytes] | None":
    """One (fd, meta) handoff, or None on EOF. The ancillary fd
    arrives with the first data byte; the rest of the meta streams."""
    try:
        data, anc, _flags, _addr = sock.recvmsg(
            _FDHDR.size, socket.CMSG_SPACE(struct.calcsize("i")))
    except OSError:
        return None
    if not data:
        return None
    while len(data) < _FDHDR.size:
        chunk = sock.recv(_FDHDR.size - len(data))
        if not chunk:
            return None
        data += chunk
    fd = -1
    for level, ctype, cdata in anc:
        if level == socket.SOL_SOCKET and ctype == socket.SCM_RIGHTS:
            fd = struct.unpack("i", cdata[:struct.calcsize("i")])[0]
    (need,) = _FDHDR.unpack(data)
    meta = b""
    while len(meta) < need:
        chunk = sock.recv(need - len(meta))
        if not chunk:
            if fd >= 0:
                os.close(fd)
            return None
        meta += chunk
    if fd < 0:
        return None
    return fd, meta


# ---------------------------------------------------------------------------
# shard-process side


class ShardCtx:
    """What a shard-mode ``Head`` knows about the sharded world: its
    index, the shard count, and the bus to the directory. ``Head``
    keeps this on ``self.shard`` (None = single-process mode; every
    shard-mode branch in gcs.py is behind that check)."""

    def __init__(self, index: int, total: int):
        self.index = index
        self.total = total
        self.bus: "rpc.Connection | None" = None  # set after dial

    def bus_call(self, kind: str, body: dict, timeout: float = 30.0):
        if self.bus is None:
            raise rpc.ConnectionLost("shard bus not connected")
        return self.bus.call(kind, body, timeout=timeout)

    def bus_cast(self, kind: str, body: dict) -> None:
        if self.bus is None:
            return
        try:
            self.bus.cast_buffered(kind, body)
        except rpc.ConnectionLost:
            pass

    def relay_client_cast(self, client_id: str, kind: str,
                          body: dict) -> None:
        """Push to a client hosted on another shard: the directory
        broadcasts to the other shards and whichever holds the
        connection delivers (no directory-side client registry)."""
        self.bus_cast("dir_client_cast", {
            "client_id": client_id, "kind": kind, "body": body,
            "shard": self.index})


class _RelayConn:
    """Stand-in conn for bus-forwarded handler calls (a cross-shard
    actor submit arrives without the owner's socket): pushes the
    handler makes route back through the owner's hosting shard."""

    def __init__(self, head, client_id: str):
        self._head = head
        self.peer_info = {"client_id": client_id, "type": "driver",
                          "remote": True, "relay": True}

    def cast_buffered(self, kind: str, body: dict) -> None:
        self._head._client_cast(self.peer_info["client_id"], kind, body)

    cast = cast_buffered

    def flush_casts(self) -> None:
        pass


class _BusQueryConn:
    """Conn stand-in for directory-originated state queries (fanout
    merges): remote so meta-shaped replies never embed shm offsets."""

    peer_info = {"client_id": "shard-bus", "type": "driver",
                 "remote": True}

    def cast_buffered(self, kind: str, body: dict) -> None:
        pass

    cast = cast_buffered

    def flush_casts(self) -> None:
        pass


class ShardHost:
    """One shard process: a full Head over a resource slice, adopted
    client connections, and the bus serving cross-shard lookups."""

    def __init__(self, boot: dict, fd_sock: socket.socket):
        from ray_tpu_torch._private import config as config_mod
        from ray_tpu_torch._private.gcs import Head

        self.index = boot["index"]
        self.total = boot["total"]
        self._fd_sock = fd_sock
        self._stop = threading.Event()
        cfg: Config = boot["config"]
        # The shard binds its OWN ephemeral server (workers it spawns
        # dial it directly — no router hop on the worker plane); the
        # advertised address stays the router's.
        cfg.head_host = "127.0.0.1"
        cfg.head_port = 0
        cfg.head_shards = self.total
        if cfg.gcs_snapshot_path:
            cfg.gcs_snapshot_path += f".shard{self.index}"
        if cfg.gcs_external_store:
            cfg.gcs_external_store = ""  # head HA is the parent's story
        # Modules hold `from config import GLOBAL_CONFIG` references:
        # update in place so the parent's effective config (env +
        # _system_config overrides) governs this process too.
        config_mod.GLOBAL_CONFIG.__dict__.update(cfg.__dict__)
        cfg = config_mod.GLOBAL_CONFIG
        forensics.arm(worker_id=f"head-shard-{self.index}",
                      crash_dir=os.path.join(boot["parent_session"],
                                             "crash"))
        ctx = ShardCtx(self.index, self.total)
        self.head = Head(
            cfg,
            num_cpus=boot.get("num_cpus"),
            num_gpus=boot.get("num_gpus"),
            resources=boot.get("resources"),
            session_dir=os.path.join(boot["parent_session"],
                                     f"shard{self.index}"),
            shard_ctx=ctx,
            gpu_base=boot.get("gpu_base", 0),
        )
        self.bus = rpc.connect(
            tuple(boot["bus_addr"]), handler=self._handle_bus,
            name=f"shard{self.index}-bus", on_close=self._on_bus_lost)
        ctx.bus = self.bus
        self.bus.call("shard_hello", {
            "shard": self.index, "pid": os.getpid(),
            "address": tuple(self.head.address)}, timeout=30)
        threading.Thread(target=self._fd_loop, daemon=True,
                         name="shard-fd-recv").start()

    # -- routed-connection adoption --

    def _fd_loop(self) -> None:
        while not self._stop.is_set():
            got = recv_fd(self._fd_sock)
            if got is None:
                # Parent gone: a shard must not outlive its directory
                # (orphaned shards would hold the arena + workers).
                self.stop()
                return
            fd, raw = got
            try:
                meta = pickle.loads(raw)
                sock = socket.socket(fileno=fd)
                self.head.server.adopt_socket(
                    sock, first_frame=meta.get("frame"),
                    adopt_meta=meta)
            except Exception:
                try:
                    os.close(fd)
                except OSError:
                    pass

    # -- bus traffic --

    def _on_bus_lost(self, _conn) -> None:
        if not self._stop.is_set():
            self.stop()

    def _handle_bus(self, kind: str, body: dict, conn):
        # Local delivery fast path: no nesting, run on the reader.
        if kind == "shard_client_cast":
            c = self.head.clients.get(body["client_id"])
            if c is not None:
                try:
                    c.cast_buffered(body["kind"], body["body"])
                except rpc.ConnectionLost:
                    pass
            return None
        if kind == "shard_stop":
            threading.Thread(target=self.stop, daemon=True).start()
            return None
        # Everything else may take the head lock or nest another bus
        # call (a forwarded submit re-locating a dead actor): run it
        # deferred so this bus conn's reader NEVER blocks — two shards
        # mid-fanout would otherwise deadlock on each other's readers.
        def _run(kind=kind, body=body):
            owner = None
            if isinstance(body, dict):
                owner = body.pop("_relay_owner", None)
            c = (_RelayConn(self.head, owner) if owner
                 else _BusQueryConn())
            return self.head._handle(kind, body, c)

        return rpc.DeferredReply(_run)

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self.head.shutdown()
        finally:
            os._exit(0)

    def run_forever(self) -> None:
        import signal as _signal

        _signal.signal(_signal.SIGTERM,
                       lambda *_: threading.Thread(
                           target=self.stop, daemon=True).start())
        while not self._stop.is_set():
            time.sleep(0.5)


def main() -> None:
    boot_path = os.environ["RAY_TPU_SHARD_BOOT"]
    fd = int(os.environ["RAY_TPU_SHARD_FD"])
    with open(boot_path, "rb") as f:
        boot = pickle.load(f)
    fd_sock = socket.socket(fileno=fd)
    host = ShardHost(boot, fd_sock)
    host.run_forever()


# ---------------------------------------------------------------------------
# parent-process side


class _ShardProc:
    def __init__(self, index: int):
        self.index = index
        self.proc: "subprocess.Popen | None" = None
        self.pid: "int | None" = None
        self.conn: "rpc.Connection | None" = None  # bus conn (hello'd)
        self.address: "tuple | None" = None        # shard head server
        self.chan: "socket.socket | None" = None   # fd-passing channel
        self.expected_exit: "tuple | None" = None
        self.started_at = 0.0

    @property
    def alive(self) -> bool:
        return (self.proc is not None and self.proc.poll() is None
                and self.conn is not None)


class ShardDirectory:
    """The parent head at shards>1: router + bus + shard supervisor.

    Public surface mirrors what ``init()``/teardown/tests use of a
    ``Head``: ``address``, ``session_dir``, ``config``,
    ``crash_reports``, ``shutdown()``."""

    def __init__(self, config: Config, total: int, num_cpus=None,
                 num_gpus=None, resources=None):
        import uuid

        self.config = config
        self.total = total
        self.session_id = uuid.uuid4().hex[:12]
        self.session_dir = os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", f"session_{self.session_id}")
        os.makedirs(os.path.join(self.session_dir, "logs"),
                    exist_ok=True)
        self._lock = threading.Lock()
        self._shutdown = False
        # directory-global tables (see DIRECTORY_TABLES)
        self.dir_named_actors: dict[tuple, tuple] = {}
        self.dir_shards: list[_ShardProc] = [
            _ShardProc(i) for i in range(total)]
        self.dir_crash_reports: dict[str, dict] = {}
        self._rr = 0
        self._hello = threading.Condition(self._lock)
        # resource slices (directory keeps none for itself: the parent
        # process only routes and arbitrates)
        from ray_tpu_torch._private.scheduler import (shard_gpu_range,
                                                      split_shard_resources)

        base = self._detect(num_cpus, num_gpus, resources)
        self._slices = [split_shard_resources(base, i, total)
                        for i in range(total)]
        # First device index of each shard's contiguous GPU range (the
        # same split split_shard_resources counts).
        self._gpu_bases = [shard_gpu_range(int(base.get("GPU", 0)), i, total)[0]
                           for i in range(total)]
        # shard bus (loopback; shards dial it at boot)
        self.bus_server = rpc.Server(self._handle_bus,
                                     host="127.0.0.1", port=0)
        # router on the advertised address
        self._rsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._rsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._rsock.bind((config.head_host, config.head_port))
        self._rsock.listen(512)
        self.address = self._rsock.getsockname()
        for sp in self.dir_shards:
            self._spawn(sp)
        threading.Thread(target=self._router_loop, daemon=True,
                         name="shard-router").start()
        threading.Thread(target=self._reaper_loop, daemon=True,
                         name="shard-reaper").start()
        # Block until every shard said hello: init() returns a head
        # whose advertised address actually routes.
        deadline = time.time() + 60.0
        with self._hello:
            while (any(sp.conn is None for sp in self.dir_shards)
                   and time.time() < deadline):
                self._hello.wait(timeout=0.5)
        if any(sp.conn is None for sp in self.dir_shards):
            self.shutdown()
            raise RuntimeError("head shards failed to start")

    def _detect(self, num_cpus, num_gpus, resources) -> dict:
        from ray_tpu_torch._private.gcs import Head

        return Head._detect_resources(self, num_cpus, num_gpus,
                                      resources)

    def shard_pids(self) -> "list[int | None]":
        return [sp.pid for sp in self.dir_shards]

    # -- spawn / reap / respawn --

    def _spawn(self, sp: _ShardProc) -> None:
        parent_chan, child_chan = socket.socketpair()
        boot = {
            "index": sp.index, "total": self.total,
            "config": self.config,
            "parent_session": self.session_dir,
            "bus_addr": tuple(self.bus_server.address),
            "num_cpus": self._slices[sp.index].get("CPU", 1.0),
            # Explicit 0.0 (not None) when the slice holds no chips:
            # None would re-run detection and give EVERY shard the
            # whole chip pool.
            "num_gpus": self._slices[sp.index].get("GPU", 0.0),
            "gpu_base": self._gpu_bases[sp.index],
            "resources": {
                k: v for k, v in self._slices[sp.index].items()
                if k not in ("CPU", "GPU", "memory")} or None,
        }
        boot_path = os.path.join(self.session_dir,
                                 f"shard{sp.index}.boot.pkl")
        with open(boot_path, "wb") as f:
            pickle.dump(boot, f)
        env = dict(os.environ)
        env["RAY_TPU_SHARD_BOOT"] = boot_path
        env["RAY_TPU_SHARD_FD"] = str(child_chan.fileno())
        extra = [p for p in sys.path if p and os.path.isdir(p)]
        existing = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = os.pathsep.join(
            extra + ([existing] if existing else []))
        log = os.path.join(self.session_dir, "logs",
                           f"head-shard-{sp.index}.log")
        with open(log, "ab") as out:
            sp.proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.head_shards"],
                env=env, stdout=out, stderr=subprocess.STDOUT,
                pass_fds=(child_chan.fileno(),), cwd=os.getcwd())
        child_chan.close()
        # Disjoint core sets when the box has at least one core per
        # shard: the C reader/flusher threads and the Python dispatch
        # loop of different shards then never preempt each other. On a
        # core-starved box pinning would only serialize — skip it.
        try:
            cores = sorted(os.sched_getaffinity(0))
            if len(cores) >= self.total:
                os.sched_setaffinity(
                    sp.proc.pid, set(cores[sp.index::self.total]))
        except (AttributeError, OSError):
            pass
        sp.pid = sp.proc.pid
        sp.chan = parent_chan
        sp.conn = None
        sp.expected_exit = None
        sp.started_at = time.time()

    def _reaper_loop(self) -> None:
        while not self._shutdown:
            time.sleep(0.2)
            for sp in self.dir_shards:
                if sp.proc is None or sp.proc.poll() is None:
                    continue
                if self._shutdown:
                    return
                self._reap(sp, respawn=True)

    def _reap(self, sp: _ShardProc, respawn: bool) -> None:
        """Classify a shard death through the forensics plane (real
        wait status, recorded intent, crash-file stack) and respawn it.
        Clients hosted there recover through the normal driver
        reconnect: the router lands their re-registration on a live
        shard."""
        rc = sp.proc.returncode
        exit_code = rc if rc is not None and rc >= 0 else None
        term_signal = -rc if rc is not None and rc < 0 else None
        wid = f"head-shard-{sp.index}"
        crash_dir = os.path.join(self.session_dir, "crash")
        crash_text = forensics.read_crash_text(crash_dir, wid)
        reason, detail = forensics.classify_exit(
            exit_code=exit_code, term_signal=term_signal,
            expected=sp.expected_exit, crash_text=crash_text)
        report = {
            "worker_id": wid, "kind": "head_shard", "pid": sp.pid,
            "reason": reason, "detail": detail,
            "exit_code": exit_code, "term_signal": term_signal,
            "ts": time.time(),
            "stack": forensics.stack_excerpt(crash_text),
        }
        with self._lock:
            self.dir_crash_reports[wid] = report
            if sp.conn is not None:
                try:
                    sp.conn.close()
                except Exception:
                    pass
                sp.conn = None
            if sp.chan is not None:
                try:
                    sp.chan.close()
                except OSError:
                    pass
                sp.chan = None
            # Names the dead shard owned are gone with its actors.
            for key in [k for k, (_aid, s) in
                        self.dir_named_actors.items()
                        if s == sp.index]:
                del self.dir_named_actors[key]
        if respawn and not self._shutdown:
            self._spawn(sp)

    # -- router --

    def _router_loop(self) -> None:
        while not self._shutdown:
            try:
                sock, _addr = self._rsock.accept()
            except OSError:
                return
            threading.Thread(target=self._route_one, args=(sock,),
                             daemon=True, name="shard-route").start()

    def _recvall(self, sock: socket.socket, n: int) -> "bytes | None":
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _route_one(self, sock: socket.socket) -> None:
        """Read ONE frame, pick a shard, hand the fd over. The frame
        is replayed shard-side so this hop is invisible to the peer."""
        from ray_tpu_torch._private import wirefmt

        try:
            sock.settimeout(self.config.worker_register_timeout_s)
            hdr = self._recvall(sock, 4)
            if hdr is None:
                sock.close()
                return
            (n,) = struct.unpack("<I", hdr)
            frame = self._recvall(sock, n)
            if frame is None:
                sock.close()
                return
            sock.settimeout(None)
            try:
                if frame and frame[0] == wirefmt.WIRE_MAGIC:
                    kind, _mid, body = wirefmt.decode_frame(frame)
                else:
                    kind, _mid, body = pickle.loads(frame)
            except Exception:
                sock.close()
                return
            shard, meta = self._route_decision(kind, body)
            meta["frame"] = frame
            self._handoff(sock, shard, meta)
        except Exception:
            try:
                sock.close()
            except OSError:
                pass

    def _alive_shards(self) -> list[int]:
        return [sp.index for sp in self.dir_shards if sp.alive]

    def _route_decision(self, kind: str, body) -> tuple[int, dict]:
        alive = self._alive_shards() or [0]
        if kind == "register" and isinstance(body, dict):
            if body.get("client_type") == "worker" and body.get(
                    "worker_id"):
                # Workers dial their spawning shard directly; a routed
                # worker register is the re-dial fallback — honor the
                # id's hash so it reaches the shard that minted it.
                return shard_for(body["worker_id"], self.total), {}
            # Driver: balance round-robin over live shards, minting the
            # id so shard_for(client_id) == its shard forever after.
            with self._lock:
                shard = alive[self._rr % len(alive)]
                self._rr += 1
            return shard, {"client_id": mint_for_shard(
                "driver-", shard, self.total)}
        if kind == "register_node" and isinstance(body, dict):
            node_id = body.get("node_id") or mint_for_shard(
                "node-", alive[0], self.total)
            shard = shard_for(node_id, self.total)
            if shard not in alive:
                shard = alive[0]
            return shard, {"node_id": node_id}
        # Unregistered one-shot traffic (probes, stray casts): shard 0.
        return alive[0], {}

    def _handoff(self, sock: socket.socket, shard: int,
                 meta: dict) -> None:
        sp = self.dir_shards[shard]
        chan = sp.chan
        try:
            if chan is None:
                raise OSError("shard channel down")
            send_fd(chan, sock.fileno(), pickle.dumps(meta))
            sock.close()  # the shard owns the duplicated fd now
        except OSError:
            # Shard mid-respawn: drivers get re-routed when their
            # retry policy re-dials; nothing to salvage here.
            try:
                sock.close()
            except OSError:
                pass

    # -- shard bus handlers --

    def _handle_bus(self, kind: str, body: dict, conn):
        method = getattr(self, f"_h_{kind}", None)
        if method is None:
            raise rpc.RpcError(f"unknown bus kind {kind!r}")
        return method(body, conn)

    def _h_shard_hello(self, body, conn):
        sp = self.dir_shards[body["shard"]]
        with self._hello:
            sp.conn = conn
            sp.address = tuple(body["address"])
            conn.peer_info = {"shard": body["shard"]}
            self._hello.notify_all()
        return {"ok": True, "shards": self.total}

    def _h_dir_name_put(self, body, conn):
        key = tuple(body["key"])
        with self._lock:
            cur = self.dir_named_actors.get(key)
            if cur is not None and cur[0] != body["actor_id"]:
                return {"ok": False}
            self.dir_named_actors[key] = (body["actor_id"],
                                          body["shard"])
        return {"ok": True}

    def _h_dir_name_del(self, body, conn):
        key = tuple(body["key"])
        with self._lock:
            cur = self.dir_named_actors.get(key)
            if cur is not None and cur[0] == body.get("actor_id"):
                del self.dir_named_actors[key]
        return None

    def _h_dir_name_get(self, body, conn):
        with self._lock:
            cur = self.dir_named_actors.get(tuple(body["key"]))
        if cur is None:
            return {}
        return {"actor_id": cur[0], "shard": cur[1]}

    def _h_dir_name_list(self, body, conn):
        with self._lock:
            return {"names": [list(k) for k in self.dir_named_actors]}

    def _other_conns(self, exclude: "int | None") -> list:
        with self._lock:
            return [(sp.index, sp.conn) for sp in self.dir_shards
                    if sp.conn is not None and sp.index != exclude]

    def _h_dir_find_actor(self, body, conn):
        origin = conn.peer_info.get("shard")

        def _run():
            for idx, c in self._other_conns(origin):
                try:
                    r = c.call("has_actor",
                               {"actor_id": body["actor_id"]},
                               timeout=10)
                    if r and r.get("have"):
                        return {"shard": idx}
                except Exception:
                    continue
            return {}

        return rpc.DeferredReply(_run)

    def _h_dir_fwd(self, body, conn):
        sp = self.dir_shards[body["shard"]]
        target = sp.conn
        if target is None:
            raise rpc.RpcError(f"shard {body['shard']} is down")
        return rpc.DeferredReply(
            lambda: target.call(body["kind"], body["body"], timeout=30))

    def _h_dir_fwd_cast(self, body, conn):
        sp = self.dir_shards[body["shard"]]
        if sp.conn is not None:
            try:
                sp.conn.cast_buffered(body["kind"], body["body"])
            except rpc.ConnectionLost:
                pass
        return None

    def _h_dir_fanout(self, body, conn):
        origin = conn.peer_info.get("shard")

        def _run():
            replies = []
            for _idx, c in self._other_conns(origin):
                try:
                    replies.append(c.call(body["kind"], body["body"],
                                          timeout=30))
                except Exception:
                    continue  # a dead shard drops out of the merge
            if body["kind"] == "list_crash_reports":
                # The directory's own table: shard deaths it reaped.
                with self._lock:
                    replies.append({"reports": list(
                        self.dir_crash_reports.values())})
            return {"replies": replies}

        return rpc.DeferredReply(_run)

    def _h_dir_obj_lookup(self, body, conn):
        origin = body.get("shard")

        def _run():
            metas: dict = {}
            for _idx, c in self._other_conns(origin):
                try:
                    r = c.call("xshard_obj_lookup",
                               {"ids": body["ids"],
                                "watcher": origin}, timeout=30)
                except Exception:
                    continue
                metas.update(r.get("metas") or {})
            return {"metas": metas}

        return rpc.DeferredReply(_run)

    def _h_dir_obj_ref(self, body, conn):
        for _idx, c in self._other_conns(body.get("shard")):
            try:
                c.cast_buffered("xshard_obj_ref", body)
            except rpc.ConnectionLost:
                pass
        return None

    def _h_dir_client_cast(self, body, conn):
        msg = {"client_id": body["client_id"], "kind": body["kind"],
               "body": body["body"]}
        for _idx, c in self._other_conns(body.get("shard")):
            try:
                c.cast_buffered("shard_client_cast", msg)
            except rpc.ConnectionLost:
                pass
        return None

    def _h_dir_client_gone(self, body, conn):
        for _idx, c in self._other_conns(body.get("shard")):
            try:
                c.cast_buffered("xshard_client_gone",
                                {"client_id": body["client_id"]})
            except rpc.ConnectionLost:
                pass
        return None

    def _h_dir_stop(self, body, conn):
        threading.Thread(target=self.shutdown, daemon=True).start()
        return None

    # -- shutdown: reap every shard with a REAL wait status through the
    # forensics classifier (intent recorded first, so a clean teardown
    # never shows up as an unattributed SIGKILL in the crash table) --

    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            for sp in self.dir_shards:
                if sp.expected_exit is None:
                    sp.expected_exit = ("shutdown", "cluster shutdown")
        try:
            self._rsock.close()
        except OSError:
            pass
        for sp in self.dir_shards:
            if sp.conn is not None:
                try:
                    sp.conn.cast("shard_stop", {})
                except rpc.ConnectionLost:
                    pass
        deadline = time.time() + 8.0
        for sp in self.dir_shards:
            if sp.proc is None:
                continue
            try:
                sp.proc.wait(timeout=max(0.05, deadline - time.time()))
            except subprocess.TimeoutExpired:
                sp.proc.terminate()
                try:
                    sp.proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    sp.proc.kill()
                    sp.proc.wait(timeout=5.0)
            self._reap(sp, respawn=False)
        self.bus_server.stop()


if __name__ == "__main__":
    main()
