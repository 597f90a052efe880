"""Per-upstream circuit breakers (closed -> open -> half-open).

A hung or down upstream (Zipkin, the external DP, Mongo) must not wedge
the poller: after `threshold` consecutive failures the breaker OPENS and
every call short-circuits with `BreakerOpenError` — no connection, no
timeout wait — until `cooldown_s` elapses. The breaker then admits a
bounded number of HALF-OPEN probes; one success closes it, one failure
re-opens (and restarts the cooldown).

Defaults (overridable per breaker): THRESHOLD consecutive failures to
open, COOLDOWN_S open -> half-open delay, HALF_OPEN_MAX concurrent
half-open probes.

The clock is injectable (tests advance a fake clock); state transitions
serialize on a per-breaker lock. Breakers register in a process-wide
registry, so every call site of one upstream shares one failure budget.

A breaker that opens is an upstream SLO breach: it freezes the
profiler's flight artifact (telemetry/profiling/recorder.py), outside
the breaker's lock.

The control plane (control/warmup.py) adds warm-up: when the forecast's
attribution blames an upstream, `warm_up()` puts a CLOSED breaker into a
warmed HALF_OPEN with a shortened probe cooldown and a one-failure trip
wire; `revert_warm_up()` restores its posture. Warm-up never overrides a
breaker that opened on real failures. A non-default tenant's breakers are
registered as ``<tenant>:<name>`` (tenancy/isolation.py).

A copy of kmamiz_tpu/resilience/breaker.py without the environment knobs
(the JAX package's KMAMIZ_BREAKER_*; here module constants at their
defaults).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from kmamiz_tpu_torch.telemetry.profiling import recorder

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

THRESHOLD = 5
COOLDOWN_S = 30.0
HALF_OPEN_MAX = 1


class BreakerOpenError(RuntimeError):
    """Raised instead of calling the upstream while the breaker is open."""

    def __init__(self, name: str, retry_in_s: float) -> None:
        super().__init__(
            f"circuit breaker '{name}' is open (retry in {retry_in_s:.1f}s)"
        )
        self.breaker_name = name
        self.retry_in_s = retry_in_s


class CircuitBreaker:
    def __init__(
        self,
        name: str,
        threshold: Optional[int] = None,
        cooldown_s: Optional[float] = None,
        half_open_max: Optional[int] = None,
        now: Callable[[], float] = time.monotonic,
    ) -> None:
        self.name = name
        self.threshold = max(1, int(THRESHOLD if threshold is None else threshold))
        self.cooldown_s = COOLDOWN_S if cooldown_s is None else cooldown_s
        self.half_open_max = max(
            1, int(HALF_OPEN_MAX if half_open_max is None else half_open_max)
        )
        self._now = now
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._half_open_inflight = 0
        self._warmed = False
        self._saved_cooldown_s: Optional[float] = None
        self._stats = {"opens": 0, "shortCircuits": 0, "failures": 0, "warmUps": 0}

    # -- state machine -------------------------------------------------------

    def _state_locked(self) -> str:
        """Resolve OPEN -> HALF_OPEN on cooldown expiry (lazy: there is
        no timer thread, the transition happens on the next observation)."""
        if (
            self._state == OPEN
            and self._opened_at is not None
            and self._now() - self._opened_at >= self.cooldown_s
        ):
            self._state = HALF_OPEN
            self._half_open_inflight = 0
        return self._state

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def allow(self) -> None:
        """Admission check. Raises BreakerOpenError while open (or while
        the half-open probe quota is taken); otherwise reserves a
        half-open probe slot when probing."""
        with self._lock:
            state = self._state_locked()
            if state == CLOSED:
                return
            if state == HALF_OPEN:
                if self._half_open_inflight < self.half_open_max:
                    self._half_open_inflight += 1
                    return
                self._stats["shortCircuits"] += 1
                raise BreakerOpenError(self.name, 0.0)
            self._stats["shortCircuits"] += 1
            remaining = self.cooldown_s
            if self._opened_at is not None:
                remaining = max(
                    0.0, self.cooldown_s - (self._now() - self._opened_at)
                )
            raise BreakerOpenError(self.name, remaining)

    def record_success(self) -> None:
        with self._lock:
            state = self._state_locked()
            self._consecutive_failures = 0
            if state == HALF_OPEN:
                self._half_open_inflight = max(
                    0, self._half_open_inflight - 1
                )
            self._state = CLOSED

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            state = self._state_locked()
            self._stats["failures"] += 1
            self._consecutive_failures += 1
            if state == HALF_OPEN:
                # a failed probe re-opens immediately, cooldown restarts
                self._half_open_inflight = max(
                    0, self._half_open_inflight - 1
                )
                self._trip_locked()
                tripped = True
            elif state == CLOSED and (
                self._consecutive_failures >= self.threshold
                # warmed by the forecast's attribution: the cascade's first
                # real failure trips at once
                or self._warmed
            ):
                self._trip_locked()
                tripped = True
        if tripped:
            # outside the lock: the recorder walks the telemetry rings and
            # must not lengthen the admission critical section
            recorder.record("breaker-open", self.name)

    def _trip_locked(self) -> None:
        self._state = OPEN
        self._opened_at = self._now()
        self._stats["opens"] += 1

    # -- control-plane warm-up (control/warmup.py) -----------------------------

    def warm_up(self, probe_cooldown_s: float) -> bool:
        """Pre-trip into a warmed HALF_OPEN with a shortened probe
        cooldown. Only a CLOSED breaker warms (True); one already open or
        half-open from real failures outranks the forecast (False). While
        warmed, one failure trips whatever the threshold."""
        with self._lock:
            if self._state_locked() != CLOSED:
                return False
            if not self._warmed:
                self._saved_cooldown_s = self.cooldown_s
            self._warmed = True
            self.cooldown_s = max(0.0, float(probe_cooldown_s))
            self._state = HALF_OPEN
            self._half_open_inflight = 0
            self._stats["warmUps"] += 1
            return True

    def revert_warm_up(self) -> None:
        """Undo warm_up: the configured cooldown again, and a clean warmed
        HALF_OPEN back to CLOSED (a breaker that tripped on a real failure
        while warmed keeps its state)."""
        with self._lock:
            if not self._warmed:
                return
            self._warmed = False
            if self._saved_cooldown_s is not None:
                self.cooldown_s = self._saved_cooldown_s
                self._saved_cooldown_s = None
            if self._state_locked() == HALF_OPEN and self._consecutive_failures == 0:
                self._state = CLOSED
                self._half_open_inflight = 0

    def call(self, fn: Callable, *args, **kwargs):
        """allow() -> fn() -> record_{success,failure}. The upstream's
        exception propagates after being recorded."""
        self.allow()
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    def snapshot(self) -> dict:
        with self._lock:
            state = self._state_locked()
            return {
                "state": state,
                "consecutiveFailures": self._consecutive_failures,
                "threshold": self.threshold,
                "cooldownS": self.cooldown_s,
                "opens": self._stats["opens"],
                "failures": self._stats["failures"],
                "shortCircuits": self._stats["shortCircuits"],
                "warmed": self._warmed,
                "warmUps": self._stats["warmUps"],
            }


# -- process-wide registry ---------------------------------------------------

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Dict[str, CircuitBreaker] = {}


def _registry_key(name: str, tenant) -> str:
    if tenant in (None, "", "default"):
        return name
    return f"{tenant}:{name}"


def get_breaker(name: str, tenant=None, **kwargs) -> CircuitBreaker:
    """The breaker for an upstream, created on first use. kwargs apply
    only at creation (all call sites of one upstream share one breaker
    and therefore one failure budget). A non-default `tenant` keys it
    ``<tenant>:<name>``: a failure budget of the tenant's own."""
    key = _registry_key(name, tenant)
    with _REGISTRY_LOCK:
        breaker = _REGISTRY.get(key)
        if breaker is None:
            breaker = CircuitBreaker(key, **kwargs)
            _REGISTRY[key] = breaker
        return breaker


def breaker_states(tenant=None) -> Dict[str, dict]:
    """Every breaker's snapshot by name (/health's `resilience` field), or
    with `tenant` only that tenant's ``<tenant>:`` entries."""
    with _REGISTRY_LOCK:
        breakers = dict(_REGISTRY)
    if tenant not in (None, "", "default"):
        prefix = f"{tenant}:"
        breakers = {name: b for name, b in breakers.items() if name.startswith(prefix)}
    return {name: b.snapshot() for name, b in breakers.items()}


def breakers_for(tenant=None) -> Dict[str, CircuitBreaker]:
    """The live breakers a tenant owns: the unprefixed names for the
    default tenant, the ``<tenant>:`` entries for any other (the set the
    control plane's warm-up reconciles)."""
    with _REGISTRY_LOCK:
        breakers = dict(_REGISTRY)
    if tenant in (None, "", "default"):
        return {k: b for k, b in breakers.items() if ":" not in k}
    prefix = f"{tenant}:"
    return {k: b for k, b in breakers.items() if k.startswith(prefix)}


def reset_tenant(tenant: str) -> None:
    """Drop one tenant's ``<tenant>:`` breakers, no other tenant's."""
    if tenant in (None, "", "default"):
        return
    prefix = f"{tenant}:"
    with _REGISTRY_LOCK:
        for key in [k for k in _REGISTRY if k.startswith(prefix)]:
            del _REGISTRY[key]


def reset_for_tests() -> None:
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
