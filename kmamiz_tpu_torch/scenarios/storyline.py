"""Failure storylines: seeded, time-ordered fault events over a soak.

A copy of kmamiz_tpu/scenarios/storyline.py over the port's simulator
and chaos module (the same draws, the same events). Its vocabulary
filter is an argument (`storylines`), at the default STORYLINES, where
the JAX package reads KMAMIZ_SCENARIO_STORYLINES.

A storyline is a tuple of :class:`Event` records, each active over a
``[at_tick, at_tick + duration)`` window. The vocabulary:

- ``cascade``        — an upstream failure storm: the root service's
  endpoints take an error-rate fault injected through
  ``simulator/faults.inject_faults`` (MicroViSim fault descriptors over
  hourly slots mapped onto ticks) while the induced traffic burst is
  folded through ``simulator/overload.estimate_error_rate_with_overload``
  to decide which *downstream* services saturate and start erroring too
  — the modeled failure cascading through the mesh;
- ``partial-outage`` — a sampled subset of services goes dark: paths
  crossing them emit nothing for the window;
- ``rolling-deploy`` — one service per tick flips ``v1 -> v2`` starting
  at the event tick (canonical-revision change in live windows);
- ``poison-storm``   — poisoned raw-ingest payloads per tick, kinds
  pre-drawn from ``resilience/chaos.FaultPlan``'s payload stream
  (truncate / corrupt / schema / bomb), every delivery expected to land
  in the quarantine;
- ``upstream-flap``  — the tenant's trace source hard-fails for the
  window; the per-tenant circuit breaker trips, ticks degrade to stale
  serves, and recovery-to-fresh is measured after the flap ends;
- ``tick-stall``     — one tick's source hangs past the watchdog
  deadline (stale serve, straggler merges late, recovery measured);
- ``kill9-replay``   — the run crashes (SIGKILL between WAL append and
  merge) at the event tick and restarts, replaying the ingest WAL
  bit-exact before the soak continues;
- ``capacity-growth`` — one tenant's endpoint count ramps linearly
  across its edge store's segment-consolidation threshold mid-soak
  (unique ``/grow/<k>`` endpoints per tick), exercising graftcost's
  predictive prewarm: the gate demands zero mid-tick compiles at the
  crossing with prewarm on;
- ``tenant-migration`` — the fleet coordinator live-migrates the tenant
  to another worker at the event tick (drain -> WAL handoff -> replay
  -> ring flip, fleet/migration.py) while its traffic keeps flowing;
  the gates demand zero lost spans, a bit-exact post-migration
  ``graph_signature`` vs a serial reference replay, and zero
  steady-state recompiles across the handoff.

Events are fully resolved at compose time (all RNG draws happen here),
so a storyline replays identically however the runner's wall clock
behaves. The ``storylines`` filter (a comma list, default ``all``)
filters the vocabulary; disabled kinds are dropped from composed
storylines and from the scenario signature alike.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kmamiz_tpu_torch.resilience.chaos import FaultPlan, mutate_payload
from kmamiz_tpu_torch.scenarios.topology import (
    BASE_TIMESTAMP_US,
    Topology,
    downstream_of,
    entry_services,
)
from kmamiz_tpu_torch.simulator import faults as sim_faults
from kmamiz_tpu_torch.simulator import naming
from kmamiz_tpu_torch.simulator.overload import estimate_error_rate_with_overload
from kmamiz_tpu_torch.simulator.slot_metrics import SlotMetrics, slot_key

STORYLINE_KINDS = (
    "cascade",
    "partial-outage",
    "rolling-deploy",
    "poison-storm",
    "upstream-flap",
    "tick-stall",
    "kill9-replay",
    "capacity-growth",
    "tenant-migration",
)

#: downstream services whose overload-modeled error rate crosses this
#: during a cascade window are treated as erroring too
CASCADE_ERROR_THRESHOLD = 0.30


@dataclass(frozen=True)
class Event:
    """One storyline event; ``params`` is a hashable kind-specific
    payload (service tuples, poison kinds, multipliers)."""

    kind: str
    at_tick: int
    duration: int
    params: Tuple = ()

    def active(self, tick: int) -> bool:
        return self.at_tick <= tick < self.at_tick + self.duration

    def key(self) -> str:
        return f"{self.kind}@{self.at_tick}+{self.duration}:{self.params!r}"


#: the storyline filter (KMAMIZ_SCENARIO_STORYLINES's default): a comma
#: list of kinds, or "all"
STORYLINES = "all"


def enabled_storylines(storylines: Optional[str] = None) -> Tuple[str, ...]:
    """The storyline vocabulary after the filter (`storylines`, a comma
    list or ``all``; STORYLINES when None)."""
    raw = (STORYLINES if storylines is None else storylines).strip()
    if raw in ("", "all"):
        return STORYLINE_KINDS
    wanted = {p.strip() for p in raw.split(",") if p.strip()}
    return tuple(k for k in STORYLINE_KINDS if k in wanted)


# -- cascade (simulator/faults.py + overload.py) ------------------------------


def compose_cascade(
    topo: Topology, rng: random.Random, n_ticks: int
) -> Event:
    """Model an upstream failure cascading through the mesh with the
    simulator's own machinery: a MicroViSim ``increase-error-rate`` +
    ``inject-traffic`` fault pair on the root's endpoints (hourly slots
    = ticks), injected via ``faults.inject_faults``, then the burst
    folded through the overload error model to pick which downstream
    services saturate."""
    roots = [s for s in entry_services(topo) if downstream_of(topo, s)]
    root = rng.choice(roots or list(topo.services))
    at = rng.randint(1, max(1, n_ticks // 3))
    duration = rng.randint(2, max(2, n_ticks // 3))
    duration = min(duration, max(1, n_ticks - at - 2))
    multiplier = rng.randint(2, 4)

    root_ep = naming.generate_unique_endpoint_name(
        root, topo.namespace, "v1", "GET", "/api/0"
    )
    base_rps = 40.0 * multiplier
    fault_descriptors = [
        {
            "type": "increase-error-rate",
            "increaseErrorRatePercent": 75,
            "targets": {"endpoints": [{"uniqueEndpointName": root_ep}]},
            "timePeriods": [
                {
                    "startTime": {"day": 1, "hour": at},
                    "durationHours": duration,
                    "probabilityPercent": 100,
                }
            ],
        },
        {
            "type": "inject-traffic",
            "requestMultiplier": float(multiplier),
            "targets": {"endpoints": [{"uniqueEndpointName": root_ep}]},
            "timePeriods": [
                {
                    "startTime": {"day": 1, "hour": at},
                    "durationHours": duration,
                    "probabilityPercent": 100,
                }
            ],
        },
    ]
    metrics_per_slot: Dict[str, SlotMetrics] = {
        slot_key(0, h): SlotMetrics() for h in range(24)
    }
    for metrics in metrics_per_slot.values():
        metrics.entry_request_counts[root_ep] = base_rps * 3600.0 / multiplier
        metrics.endpoint_error_rate[root_ep] = 0.01
    sim_faults.inject_faults(
        {"faultInjection": fault_descriptors},
        metrics_per_slot,
        np.random.default_rng(rng.getrandbits(63)),
    )
    storm = metrics_per_slot[slot_key(0, at % 24)]
    root_error = storm.get_error_rate(root_ep)

    # the burst's RPS lands on every downstream service; saturation per
    # the overload model decides who joins the error storm
    affected = [root]
    for svc in sorted(downstream_of(topo, root)):
        svc_i = topo.services.index(svc)
        rate = estimate_error_rate_with_overload(
            request_count_per_second=storm.get_entry_request_count(root_ep)
            / 3600.0,
            replica_count=topo.replicas[svc_i],
            replica_max_rps=25.0,
            base_error_rate=0.01,
            overload_factor_k=1.5,
        )
        if rate >= CASCADE_ERROR_THRESHOLD:
            affected.append(svc)
    return Event(
        kind="cascade",
        at_tick=at,
        duration=duration,
        params=(tuple(affected), multiplier, round(root_error, 3)),
    )


def cascade_forecast(
    event: Event, topo: Topology
) -> Tuple[float, Tuple[Tuple[str, str, float], ...]]:
    """The forecast an oracle STLGT would publish ahead of a composed
    cascade: (p99_ms, attribution edges) as pure functions of the event
    params. The p99 mirrors the span arithmetic the cascade injects
    (``topology.trace_group`` boosts span durations by ``5_000 *
    multiplier`` µs), and the attributions blame the edges along the
    affected-service chain — exactly what the neighbor-bias gates learn
    from the storm. The counterfactual harness feeds this to the
    controller, so ON/OFF runs differ only in whether anyone acts."""
    if event.kind != "cascade":
        raise ValueError(f"not a cascade event: {event.kind!r}")
    affected, multiplier, _root_error = event.params
    p99_ms = (1_000 + 5_000 * multiplier) / 1000.0
    edges = [
        (affected[i], affected[i + 1], 0.95)
        for i in range(len(affected) - 1)
    ]
    if not edges:
        # single-service storm: blame the root's first downstream edge
        root = affected[0]
        down = sorted(downstream_of(topo, root))
        edges = [(root, down[0] if down else root, 0.95)]
    return p99_ms, tuple(edges)


# -- the other storyline families --------------------------------------------


def compose_partial_outage(
    topo: Topology, rng: random.Random, n_ticks: int
) -> Event:
    # dark services are non-entry hops so some traffic always survives
    entries = set(entry_services(topo))
    candidates = [s for s in topo.services if s not in entries]
    if not candidates:
        candidates = list(topo.services[1:]) or list(topo.services)
    k = min(len(candidates), rng.randint(1, 2))
    down = tuple(sorted(rng.sample(candidates, k)))
    at = rng.randint(1, max(1, n_ticks // 2))
    duration = min(rng.randint(2, 3), max(1, n_ticks - at - 1))
    return Event("partial-outage", at, duration, params=(down,))


def compose_rolling_deploy(
    topo: Topology, rng: random.Random, n_ticks: int
) -> Event:
    k = min(len(topo.services), rng.randint(2, 4))
    order = tuple(rng.sample(list(topo.services), k))
    at = rng.randint(1, max(1, n_ticks // 2))
    return Event("rolling-deploy", at, n_ticks - at, params=(order,))


def compose_poison_storm(
    topo: Topology, rng: random.Random, n_ticks: int
) -> Event:
    """Pre-draw the storm's poison kinds from a FaultPlan payload stream
    (weights exclude ``none``/``drop`` so every delivery must land in
    the quarantine with a reason code)."""
    plan = FaultPlan(
        rng.getrandbits(31),
        payload_weights={
            "truncate": 0.25,
            "corrupt": 0.25,
            "schema": 0.25,
            "bomb": 0.25,
        },
    )
    at = rng.randint(1, max(1, n_ticks // 2))
    duration = min(rng.randint(2, 4), max(1, n_ticks - at))
    per_tick = rng.randint(1, 2)
    kinds = tuple(plan.payload_faults(duration * per_tick))
    return Event(
        "poison-storm",
        at,
        duration,
        params=(per_tick, kinds, plan.seed),
    )


def compose_upstream_flap(
    topo: Topology, rng: random.Random, n_ticks: int
) -> Event:
    at = rng.randint(1, max(1, n_ticks // 2))
    duration = min(rng.randint(3, 5), max(2, n_ticks - at - 2))
    return Event("upstream-flap", at, duration)


def compose_tick_stall(
    topo: Topology, rng: random.Random, n_ticks: int
) -> Event:
    at = rng.randint(1, max(1, n_ticks - 2))
    return Event("tick-stall", at, 1)


def compose_kill9(
    topo: Topology, rng: random.Random, n_ticks: int
) -> Event:
    at = rng.randint(2, max(2, n_ticks // 2))
    return Event("kill9-replay", at, 1)


def compose_tenant_migration(
    topo: Topology, rng: random.Random, n_ticks: int
) -> Event:
    """Fire the live migration strictly mid-soak: at least two warm
    ticks land on the source first (so the handoff ships a non-trivial
    WAL) and at least two more run on the target afterward (so the
    post-flip steady state is measured, recompiles included)."""
    at = rng.randint(2, max(2, n_ticks - 3))
    return Event("tenant-migration", at, 1)


# -- capacity growth (graftcost predictive-prewarm gate) ----------------------

#: unique growth endpoints over the ramp — enough to push the default
#: 1024-main + 256-tail edge store past its consolidation threshold
#: (1280) from a small base mesh, with headroom
GROWTH_TOTAL_ENDPOINTS = 1500


def compose_capacity_growth(
    topo: Topology, rng: random.Random, n_ticks: int
) -> Event:
    """Ramp one tenant across a capacity-bucket boundary mid-soak: every
    ramp tick emits ``per_tick`` 2-span traces entry -> ``/grow/<k>``
    with monotonically increasing ``k`` — each unique k is one new
    endpoint and one new edge. The ramp ends two ticks before the soak
    does, so the post-crossing steady state is measured too."""
    entry = entry_services(topo)[0]
    others = [s for s in topo.services if s != entry]
    grow_svc = rng.choice(others or [entry])
    at = 1
    duration = max(2, n_ticks - 3)
    per_tick = -(-GROWTH_TOTAL_ENDPOINTS // duration)
    return Event(
        "capacity-growth", at, duration, params=(entry, grow_svc, per_tick)
    )


def _growth_span(
    topo: Topology,
    trace_id: str,
    span_id: str,
    parent_id,
    svc: str,
    url_path: str,
    ts_us: int,
) -> dict:
    """topology._span with an explicit URL path — growth endpoints live
    outside the ``/api/<u>`` grid the sampler enumerates."""
    host = f"{svc}.{topo.namespace}.svc.cluster.local"
    return {
        "traceId": trace_id,
        "id": span_id,
        "parentId": parent_id,
        "kind": "SERVER",
        "name": f"{host}:80/*",
        "timestamp": ts_us,
        "duration": 1_000,
        "tags": {
            "http.method": "GET",
            "http.status_code": "200",
            "http.url": f"http://{host}{url_path}",
            "istio.canonical_revision": "v1",
            "istio.canonical_service": svc,
            "istio.mesh_id": "cluster.local",
            "istio.namespace": topo.namespace,
        },
    }


def _growth_pair(
    event: Event, topo: Topology, trace_id: str, url_path: str, ts_us: int
) -> List[dict]:
    entry, grow_svc, _per_tick = event.params
    root = _growth_span(
        topo, trace_id, f"{trace_id}-0", None, entry, "/api/0", ts_us
    )
    leaf = _growth_span(
        topo, trace_id, f"{trace_id}-1", f"{trace_id}-0", grow_svc, url_path,
        ts_us + 1,
    )
    return [root, leaf]


def growth_groups(
    event: Event, topo: Topology, prefix: str, tick: int
) -> List[List[dict]]:
    """The ramp's trace groups at ``tick``: ``per_tick`` 2-span chains
    entry ``/api/0`` -> grow-svc ``/grow/<k>``, ``k`` strictly
    increasing across the ramp. Pure (tick, index) arithmetic — no
    runtime RNG, so recovery re-posts are idempotent like every other
    scenario window."""
    if event.kind != "capacity-growth" or not event.active(tick):
        return []
    _entry, _grow_svc, per_tick = event.params
    base = (tick - event.at_tick) * per_tick
    ts0 = BASE_TIMESTAMP_US + tick * 1_000_000
    return [
        _growth_pair(
            event,
            topo,
            f"{prefix}-g{base + j}",
            f"/grow/{base + j}",
            ts0 + j * 10,
        )
        for j in range(per_tick)
    ]


def growth_twin_groups(
    event: Event, topo: Topology, prefix: str, tick: int
) -> List[List[dict]]:
    """Shape twins for the window rehearsal: the same group-length
    multiset AND the same count of brand-new edges as
    :func:`growth_groups` — the merge kernels bucket on the window's
    new-unique-edge count, not just span shape, so the twins must mint
    ``per_tick`` fresh ``/warm/<tick>-<j>`` endpoints of their own.
    That spends a few hundred capacity rows pre-snapshot (far under the
    consolidation threshold), leaving the measured soak to perform the
    actual crossing against fully compiled buckets."""
    if event.kind != "capacity-growth" or not event.active(tick):
        return []
    _entry, _grow_svc, per_tick = event.params
    ts0 = BASE_TIMESTAMP_US + tick * 1_000_000 + 500_000
    return [
        _growth_pair(
            event,
            topo,
            f"{prefix}-gt{tick}-{j}",
            f"/warm/{tick}-{j}",
            ts0 + j * 10,
        )
        for j in range(per_tick)
    ]


_COMPOSERS = {
    "cascade": compose_cascade,
    "partial-outage": compose_partial_outage,
    "rolling-deploy": compose_rolling_deploy,
    "poison-storm": compose_poison_storm,
    "upstream-flap": compose_upstream_flap,
    "tick-stall": compose_tick_stall,
    "kill9-replay": compose_kill9,
    "capacity-growth": compose_capacity_growth,
    "tenant-migration": compose_tenant_migration,
}


def compose_storyline(
    kinds: Tuple[str, ...],
    topo: Topology,
    rng: random.Random,
    n_ticks: int,
    storylines: Optional[str] = None,
) -> Tuple[Event, ...]:
    """Compose one event per requested kind (kinds the `storylines`
    filter drops are skipped), sorted by start tick. Every kind consumes its RNG draws
    from a dedicated child stream, so toggling one storyline off never
    reshuffles another's schedule (the FaultPlan two-stream rule)."""
    enabled = set(enabled_storylines(storylines))
    events: List[Event] = []
    for kind in kinds:
        if kind not in _COMPOSERS:
            raise ValueError(f"unknown storyline kind: {kind!r}")
        child = random.Random(rng.getrandbits(63))
        if kind not in enabled:
            continue
        events.append(_COMPOSERS[kind](topo, child, n_ticks))
    return tuple(sorted(events, key=lambda e: (e.at_tick, e.kind)))


def poison_payloads_for(
    event: Event, topo: Topology, tick: int, clean_window: bytes
) -> List[Tuple[str, bytes]]:
    """The (kind, poisoned bytes) deliveries of a poison-storm event at
    ``tick``: the pre-drawn kinds applied to a clean window via
    ``chaos.mutate_payload`` under a per-delivery seeded RNG (content is
    a pure function of the event params + tick). Every kind is certainly
    fatal to the parse (``mutate_payload`` guarantees it), so the
    scorecard can require quarantined == delivered exactly."""
    if event.kind != "poison-storm" or not event.active(tick):
        return []
    per_tick, kinds, seed = event.params
    offset = (tick - event.at_tick) * per_tick
    out: List[Tuple[str, bytes]] = []
    for j in range(per_tick):
        kind = kinds[(offset + j) % len(kinds)]
        rng = random.Random((seed << 8) ^ (tick * 131 + j))
        mutated = mutate_payload(clean_window, kind, rng)
        if mutated is not None:
            out.append((kind, mutated))
    return out
