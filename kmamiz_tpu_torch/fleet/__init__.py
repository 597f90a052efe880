"""graftfleet: the multi-process ingest fleet.

Counterpart of kmamiz_tpu/fleet/. N worker processes own disjoint tenant
sets, assigned by a seeded consistent-hash ring (:mod:`.ring`), behind one
logical DP endpoint; a coordinator folds their graphs into one aggregate
store by endpoint names (:mod:`.coordinator`), and a tenant moves between
workers live by WAL handoff (:mod:`.migration`), with the control plane's
predicted costs scoring the placement (:mod:`.placement`).

The JAX package's KMAMIZ_FLEET_SIZE, _VNODES, _SEED, _COORD_PORT and
_DRAIN_TIMEOUT_MS are the module constants below, at the JAX defaults;
the ring and the migration take other values as arguments.

This module owns the fleet's counters, the ``fleet`` section of the DP's
``/timings`` (`snapshot`), each mirrored into a registry counter (the
``kmamiz_fleet_*`` series). Like every registry they are process-wide:
tests clear them with `reset_for_tests`.
"""
from __future__ import annotations

import threading

from kmamiz_tpu_torch.telemetry.registry import REGISTRY

#: workers behind the logical endpoint (>= 2 turns fleet routing on)
SIZE = 1
#: virtual nodes per worker on the ring
VNODES = 64
#: the ring's hash seed: every process that shares it places alike
SEED = 0
#: the coordinator's bind port (0: an ephemeral one)
COORD_PORT = 0
#: the ceiling of a migration's drain phase before it aborts, ms
DRAIN_TIMEOUT_MS = 5000.0


def enabled() -> bool:
    """Fleet routing is on when more than one worker is configured."""
    return SIZE >= 2


# each counter mirrors into a registry counter made at import: incr runs
# on the frame-routing path
_PROM_COUNTERS = {
    "framesRouted": REGISTRY.counter(
        "kmamiz_fleet_frames_routed_total", "Ingest frames the coordinator dispatched to a ring owner"
    ),
    "framesQueuedDuringDrain": REGISTRY.counter(
        "kmamiz_fleet_frames_queued_total", "Frames parked in a drain queue while their tenant migrated"
    ),
    "framesRequeued": REGISTRY.counter(
        "kmamiz_fleet_frames_requeued_total", "Queued frames put back after a failed release (none dropped)"
    ),
    "folds": REGISTRY.counter("kmamiz_fleet_folds_total", "Hierarchical level-two folds into an aggregate graph"),
    "foldedEdges": REGISTRY.counter("kmamiz_fleet_folded_edges_total", "Live edges set-unioned by coordinator folds"),
    "migrationsStarted": REGISTRY.counter(
        "kmamiz_fleet_migrations_started_total", "Live tenant migrations entered (drain began)"
    ),
    "migrationsCompleted": REGISTRY.counter(
        "kmamiz_fleet_migrations_completed_total", "Migrations that replayed bit-exact and flipped the ring entry"
    ),
    "migrationsAborted": REGISTRY.counter(
        "kmamiz_fleet_migrations_aborted_total", "Migrations aborted back to the source (no split-brain path)"
    ),
}

_counters_lock = threading.Lock()


def _fresh_counters() -> dict:
    return {name: 0 for name in _PROM_COUNTERS}


_counters = _fresh_counters()


def incr(name: str, by: int = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + by
    handle = _PROM_COUNTERS.get(name)
    if handle is not None:
        handle.inc(by)


def snapshot() -> dict:
    """The ``fleet`` section of /timings: the settings, then the routing
    and migration counters since the last reset."""
    with _counters_lock:
        counters = dict(_counters)
    return {"size": SIZE, "vnodes": VNODES, "seed": SEED, "enabled": enabled(), **counters}


def reset_for_tests() -> None:
    """Drop the process-wide fleet counters."""
    global _counters
    with _counters_lock:
        _counters = _fresh_counters()


from kmamiz_tpu_torch.fleet.ring import HashRing, RingError  # noqa: E402

__all__ = [
    "COORD_PORT",
    "DRAIN_TIMEOUT_MS",
    "HashRing",
    "RingError",
    "SEED",
    "SIZE",
    "VNODES",
    "enabled",
    "incr",
    "reset_for_tests",
    "snapshot",
]
