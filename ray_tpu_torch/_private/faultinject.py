"""Deterministic RPC fault injection: the chaos plane.

Counterpart of the reference's fault-injection strategy (SURVEY.md §4 —
RayletKiller / WorkerKillerActor in _private/test_utils.py:1449 plus the
``RAY_testing_asio_delay_us`` handler-delay knob): faults become a
*tested input* to the transport instead of an accident. Every message
crossing rpc.py's send/recv paths and every bulk-plane pull consults the
active ``FaultPlane``; matching rules can

  - ``drop``       swallow the frame (a lost message on the wire),
  - ``delay``      sleep before the frame proceeds (a slow link),
  - ``dup``        send the frame twice (at-least-once duplication),
  - ``error``      raise ConnectionLost at the send site (a reset),
  - ``partition``  drop everything matching the rule (hard partition).

Rules filter by peer descriptor substring and message-kind glob, so a
test can, say, drop 5% of head<->agent RPCs while leaving worker seals
untouched. Decisions come from ONE seeded stream (``random.Random``)
consumed under a lock: the same seed replays the same decision sequence
for a fixed message order, which makes chaos failures re-runnable.

Enable via the ``RAY_TPU_FAULT_SPEC`` env var (JSON — inherited by
spawned agents/workers) or test-scoped with ``inject()``:

    RAY_TPU_FAULT_SPEC='{"seed": 7, "rules": [
        {"peer": "node_agent", "drop": 0.05, "delay_ms": 50}]}'

    with faultinject.inject({"rules": [{"kind": "fetch_object",
                                        "error": 1.0}]}):
        ...

The plane never touches the data plane's XLA collectives — only the
control-plane TCP framing and the raw-socket bulk plane.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
import time
from collections import Counter
from contextlib import contextmanager

SEND, RECV = "send", "recv"


class Action:
    """One matched decision: what to do to this frame."""

    __slots__ = ("drop", "delay_s", "dup", "error")

    def __init__(self, drop=False, delay_s=0.0, dup=False, error=False):
        self.drop = drop
        self.delay_s = delay_s
        self.dup = dup
        self.error = error

    def __repr__(self):  # tests/log lines
        return (f"Action(drop={self.drop}, delay_s={self.delay_s}, "
                f"dup={self.dup}, error={self.error})")


class FaultRule:
    """One match+probability clause of a fault spec.

    Fields (all optional):
      peer       substring matched against the connection's peer
                 descriptor ("name|client_id|node_agent_for"); default
                 matches every peer.
      kind       fnmatch glob on the message kind (default "*").
      direction  "send" | "recv" | "both" (default "send" — injecting
                 once per edge keeps the effective probability the one
                 written in the spec).
      drop       probability [0, 1] of swallowing the frame.
      delay_ms / delay_s   added latency; ``delay`` is the probability
                 it applies (default 1.0 when a delay is given).
      dup        probability of duplicating the frame.
      error      probability of raising ConnectionLost at the sender.
      partition  true => drop probability 1.0 (hard partition).
    """

    __slots__ = ("peer", "kind", "direction", "drop", "delay_s",
                 "delay_prob", "dup", "error")

    def __init__(self, spec: dict):
        unknown = set(spec) - {"peer", "kind", "direction", "drop",
                               "delay_ms", "delay_s", "delay", "dup",
                               "error", "partition"}
        if unknown:
            raise ValueError(f"unknown fault-rule fields: {sorted(unknown)}")
        self.peer = spec.get("peer", "")
        self.kind = spec.get("kind", "*")
        self.direction = spec.get("direction", SEND)
        if self.direction not in (SEND, RECV, "both"):
            raise ValueError(f"bad direction {self.direction!r}")
        self.drop = 1.0 if spec.get("partition") else float(
            spec.get("drop", 0.0))
        self.delay_s = float(spec.get("delay_s", 0.0)) or (
            float(spec.get("delay_ms", 0.0)) / 1000.0)
        self.delay_prob = float(spec.get("delay", 1.0 if self.delay_s
                                         else 0.0))
        self.dup = float(spec.get("dup", 0.0))
        self.error = float(spec.get("error", 0.0))

    def matches(self, direction: str, peer_desc: str, kind: str) -> bool:
        if self.direction != "both" and direction != self.direction:
            return False
        if self.peer and self.peer not in peer_desc:
            return False
        return fnmatch.fnmatchcase(kind, self.kind)


class FaultPlane:
    """The active rule set + one seeded decision stream + counters."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        import random
        from collections import deque

        self.rules = rules
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.stats: Counter = Counter()
        # Flight-recorder feed: every applied fault is also an instant
        # event, drained into the head's event table (directly when this
        # process hosts the head, else piggybacked on the next
        # rpc_report cast) so chaos-test failures are READABLE in the
        # same Perfetto trace as the task lifecycle spans.
        self.events: deque = deque(maxlen=1000)

    @classmethod
    def from_spec(cls, spec: dict) -> "FaultPlane":
        rules = [r if isinstance(r, FaultRule) else FaultRule(r)
                 for r in spec.get("rules", ())]
        return cls(rules, seed=int(spec.get("seed", 0)))

    def decide(self, direction: str, peer_desc: str,
               kind: str) -> Action | None:
        """None (the common case) = frame proceeds untouched."""
        act: Action | None = None
        for rule in self.rules:
            if not rule.matches(direction, peer_desc, kind):
                continue
            with self._lock:
                r_drop = self._rng.random() if rule.drop else 1.0
                r_delay = self._rng.random() if rule.delay_prob else 1.0
                r_dup = self._rng.random() if rule.dup else 1.0
                r_error = self._rng.random() if rule.error else 1.0
            if r_error < rule.error:
                self.stats[f"error:{kind}"] += 1
                self._record("error", direction, peer_desc, kind)
                return Action(error=True)
            if r_drop < rule.drop:
                self.stats[f"drop:{kind}"] += 1
                self._record("drop", direction, peer_desc, kind)
                return Action(drop=True)
            if act is None:
                act = Action()
            if r_delay < rule.delay_prob and rule.delay_s:
                act.delay_s = max(act.delay_s, rule.delay_s)
                self.stats[f"delay:{kind}"] += 1
                self._record("delay", direction, peer_desc, kind,
                             delay_s=rule.delay_s)
            if r_dup < rule.dup:
                act.dup = True
                self.stats[f"dup:{kind}"] += 1
                self._record("dup", direction, peer_desc, kind)
        if act is not None and not (act.delay_s or act.dup):
            return None
        return act

    def _record(self, action: str, direction: str, peer_desc: str,
                kind: str, delay_s: float = 0.0) -> None:
        ev = {"event": "chaos", "ts": time.time(), "action": action,
              "direction": direction, "peer": peer_desc, "kind": kind,
              "pid": os.getpid()}
        if delay_s:
            ev["delay_s"] = delay_s
        self.events.append(ev)


_plane: FaultPlane | None = None
_loaded = False
_state_lock = threading.Lock()


def active() -> FaultPlane | None:
    """The process's fault plane, lazily loaded from RAY_TPU_FAULT_SPEC
    (None in the overwhelmingly common un-injected case: one global
    read on the hot path)."""
    global _plane, _loaded
    if _loaded:
        return _plane
    with _state_lock:
        if not _loaded:
            raw = os.environ.get("RAY_TPU_FAULT_SPEC")
            if raw:
                try:
                    _plane = FaultPlane.from_spec(json.loads(raw))
                except Exception as e:  # noqa: BLE001 — never break boot
                    import sys

                    print(f"ray_tpu_torch: ignoring malformed RAY_TPU_FAULT_SPEC:"
                          f" {e}", file=sys.stderr)
            _loaded = True
    return _plane


def configure(spec: dict | None) -> FaultPlane | None:
    """Install (or clear, with None) the process's fault plane."""
    global _plane, _loaded
    with _state_lock:
        _plane = FaultPlane.from_spec(spec) if spec is not None else None
        _loaded = True
    return _plane


def drain_events() -> "list[dict]":
    """Pop the active plane's buffered chaos instants (empty when no
    plane is installed). deque.popleft is atomic, so concurrent
    recorders never lose an event to the drain."""
    pl = active()
    if pl is None:
        return []
    out: list[dict] = []
    while True:
        try:
            out.append(pl.events.popleft())
        except IndexError:
            return out


@contextmanager
def inject(spec: dict):
    """Test-scoped injection: installs a plane for the ``with`` body and
    restores the previous one after (yields the plane so tests can
    assert on ``plane.stats``)."""
    global _plane, _loaded
    with _state_lock:
        prev_plane, prev_loaded = _plane, _loaded
        _plane = FaultPlane.from_spec(spec)
        _loaded = True
    try:
        yield _plane
    finally:
        with _state_lock:
            _plane, _loaded = prev_plane, prev_loaded


def apply_send(peer_desc: str, kind: str) -> "tuple[bool, bool]":
    """Send-path hook: sleeps injected delay in place; returns
    (drop, dup). Raises nothing itself — the *caller* raises its own
    ConnectionLost for the error action via ``FaultInjectedError`` so
    transport-layer exception types stay the transport's own."""
    pl = active()
    if pl is None:
        return False, False
    act = pl.decide(SEND, peer_desc, kind)
    if act is None:
        return False, False
    if act.error:
        raise FaultInjectedError(f"injected connection error on {kind!r}")
    if act.delay_s:
        time.sleep(act.delay_s)
    return act.drop, act.dup


def apply_recv(peer_desc: str, kind: str) -> bool:
    """Recv-path hook: sleeps injected delay; returns True when the
    frame should be dropped."""
    pl = active()
    if pl is None:
        return False
    act = pl.decide(RECV, peer_desc, kind)
    if act is None:
        return False
    if act.error or act.drop:
        return True
    if act.delay_s:
        time.sleep(act.delay_s)
    return False


class FaultInjectedError(ConnectionError):
    """Raised at an injected connection-error site; rpc.py converts it
    to its own ConnectionLost so callers see the real failure type."""
