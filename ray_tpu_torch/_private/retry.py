"""Unified retry/backoff policy for the control plane.

Counterpart of the reference's per-RPC-edge retry semantics (reference:
src/ray/rpc/retryable_grpc_client.h — every GCS/raylet client call gets
exponential backoff + a server-unavailable timeout; gcs_rpc_client.h
wraps each method in a retry loop). The seed runtime instead had ad-hoc
timeouts scattered over rpc.call sites, fixed 1 s reconnect sleeps and a
hand-rolled double-try in the bulk puller. This module centralizes the
policy:

  - ``RetryPolicy``: exponential backoff with decorrelated jitter, a
    per-attempt timeout and an overall deadline.
  - ``CircuitBreaker``: after N consecutive failures against one target
    the circuit opens and calls fail fast for ``reset_s`` (one
    half-open probe then decides), so a dead owner/peer costs one
    timeout, not one per caller (reference analogue: the
    server-unavailable fail-fast window in retryable_grpc_client.h).

Defaults come from config.py (``RAY_TPU_RPC_RETRY_*`` env knobs) so the
chaos-plane tests can tighten them per process.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable


class CircuitOpenError(ConnectionError):
    """The target's circuit is open: recent consecutive failures exceed
    the breaker threshold; fail fast instead of burning a timeout."""


class CircuitBreaker:
    """Per-target consecutive-failure breaker (thread-safe)."""

    def __init__(self, threshold: int = 5, reset_s: float = 5.0,
                 name: str = ""):
        self.threshold = max(1, int(threshold))
        self.reset_s = reset_s
        self.name = name
        self._failures = 0
        self._opened_at: float | None = None
        self._probing = False
        self._lock = threading.Lock()
        # Operator-facing history (breaker_snapshot / `ray-tpu health`):
        # how often this target tripped and when it last did (epoch).
        self.trip_count = 0
        self.last_trip_at: float | None = None

    def allow(self) -> bool:
        """True when a call may proceed (closed, or the one half-open
        probe after ``reset_s``)."""
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at < self.reset_s:
                return False
            if self._probing:
                return False  # someone else holds the half-open probe
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._failures >= self.threshold:
                if self._opened_at is None:
                    self.trip_count += 1
                    self.last_trip_at = time.time()
                self._opened_at = time.monotonic()

    @property
    def open(self) -> bool:
        with self._lock:
            return (self._opened_at is not None
                    and time.monotonic() - self._opened_at < self.reset_s)


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(key: str, threshold: int | None = None,
                reset_s: float | None = None) -> CircuitBreaker:
    """Process-wide breaker registry, keyed by target (an address, a
    node id, ...). Threshold/reset apply only on first creation."""
    with _breakers_lock:
        b = _breakers.get(key)
        if b is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

            b = _breakers[key] = CircuitBreaker(
                threshold if threshold is not None
                else _cfg.rpc_breaker_threshold,
                reset_s if reset_s is not None else _cfg.rpc_breaker_reset_s,
                name=key,
            )
        return b


def breaker_snapshot() -> dict:
    """Operator view of this process's per-target circuit breakers:
    {target: {open, failures, trip_count, last_trip_at, open_age_s,
    threshold, reset_s}}. Rides rpc_report snapshots head-ward so
    runtime_stats / `ray-tpu health` can show WHY traffic to a peer is
    being shed (satellite of the overload-protection plane)."""
    with _breakers_lock:
        breakers = list(_breakers.items())
    out = {}
    for key, b in breakers:
        with b._lock:
            open_now = (b._opened_at is not None
                        and time.monotonic() - b._opened_at < b.reset_s)
            out[key] = {
                "open": open_now,
                "failures": b._failures,
                "trip_count": b.trip_count,
                "last_trip_at": b.last_trip_at,
                "open_age_s": (round(time.monotonic() - b._opened_at, 3)
                               if b._opened_at is not None else None),
                "threshold": b.threshold,
                "reset_s": b.reset_s,
            }
    return out


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff + jitter + per-call deadline.

    ``attempt_timeout_s`` bounds one attempt (e.g. one RPC round trip);
    ``deadline_s`` bounds the whole retried operation. ``jitter`` is the
    fraction of each delay drawn uniformly at random (0.2 => delay in
    [0.8d, 1.2d]) so synchronized retry storms decorrelate.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.2
    deadline_s: float | None = 30.0
    attempt_timeout_s: float | None = 10.0

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.max_delay_s,
                self.base_delay_s * (self.multiplier ** max(0, attempt - 1)))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return max(0.0, d)

    def run(self, fn: Callable, *, retry_on: tuple = (Exception,),
            breaker: CircuitBreaker | None = None,
            describe: str = "operation"):
        """Run ``fn(attempt_timeout_s | None)`` under this policy.

        ``fn`` receives the per-attempt timeout budget (already clipped
        to the remaining deadline) and must raise one of ``retry_on`` to
        trigger a retry; any other exception propagates immediately.
        """
        deadline = (None if self.deadline_s is None
                    else time.monotonic() + self.deadline_s)
        last: BaseException | None = None
        for attempt in range(1, self.max_attempts + 1):
            if breaker is not None and not breaker.allow():
                raise CircuitOpenError(
                    f"{describe}: circuit open for {breaker.name or 'target'}"
                    f" ({breaker.threshold} consecutive failures)")
            budget = self.attempt_timeout_s
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                budget = (remaining if budget is None
                          else min(budget, remaining))
            try:
                result = fn(budget)
            except retry_on as e:
                last = e
                if breaker is not None:
                    breaker.record_failure()
                if attempt >= self.max_attempts:
                    break
                d = self.delay(attempt)
                if deadline is not None:
                    d = min(d, max(0.0, deadline - time.monotonic()))
                time.sleep(d)
                continue
            if breaker is not None:
                breaker.record_success()
            return result
        if last is None:
            last = TimeoutError(f"{describe}: retry deadline "
                                f"({self.deadline_s}s) exhausted")
        raise last


def default_policy(**overrides) -> RetryPolicy:
    """Policy from the global config's RAY_TPU_RPC_RETRY_* knobs."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

    kw = dict(
        max_attempts=_cfg.rpc_retry_max_attempts,
        base_delay_s=_cfg.rpc_retry_base_delay_s,
        max_delay_s=_cfg.rpc_retry_max_delay_s,
        jitter=_cfg.rpc_retry_jitter,
        deadline_s=_cfg.rpc_retry_deadline_s,
        attempt_timeout_s=_cfg.rpc_attempt_timeout_s,
    )
    kw.update(overrides)
    return RetryPolicy(**kw)


def backoff_delays(policy: RetryPolicy):
    """Infinite generator of backoff delays (for open-ended reconnect
    loops whose give-up horizon is owned by the caller's grace window)."""
    attempt = 1
    while True:
        yield policy.delay(attempt)
        attempt += 1
