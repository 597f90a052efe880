"""The scenario factory: seeded archetype matrix.

A copy of kmamiz_tpu/scenarios/factory.py: the same archetypes and draws,
so `spec_signature` is bit-equal across the packages. The JAX package's
KMAMIZ_SCENARIO_SEED / _MATRIX / _TICKS / _STORYLINES are the module
constants SEED, MATRIX_SIZE, DEFAULT_TICKS and storyline.STORYLINES here,
and arguments of scenario_matrix and build_scenario.

A *scenario* is one closed-loop soak specification: per-tenant sampled
topologies (:mod:`.topology`), traffic curves (:mod:`.traffic`), and a
failure storyline (:mod:`.storyline`), all drawn from one integer seed.
The ten archetypes cover the production failure space the resilience,
tenancy, cost, streaming, and fleet layers were built for; a matrix of size N
instantiates the first N archetypes (cycling with fresh seeds past the
vocabulary), and the ordering guarantees any matrix of ≥ 4 contains the
cascade, multi-tenant, and kill-9/WAL-replay scenarios the acceptance
gate requires.

Everything random happens here, at compose time. ``spec_signature``
hashes the complete composed content (topology canonical YAML digests,
traffic schedules, storyline event keys), so two calls with one seed
must agree byte-for-byte — the determinism oracle the tests pin.
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
from dataclasses import dataclass
from typing import Optional, Tuple

from kmamiz_tpu_torch.scenarios.storyline import Event, compose_storyline
from kmamiz_tpu_torch.scenarios.topology import (
    Topology,
    sample_topology,
    topology_digest,
)
from kmamiz_tpu_torch.scenarios.traffic import sample_traffic

#: (archetype name, ((tenant, topology kind, traffic kind, storyline kinds), ...))
#: Ordered so the always-on bench matrix (first 3) and the acceptance
#: minimum (first 6) both cover cascade + multi-tenant + kill-9.
ARCHETYPES: Tuple[Tuple[str, Tuple[Tuple[str, str, str, Tuple[str, ...]], ...]], ...] = (
    ("steady-chain", (("default", "chain", "steady", ()),)),
    ("cascade-fanout", (("default", "fanout", "burst", ("cascade",)),)),
    (
        "multi-tenant-mix",
        (
            ("alpha", "fanout", "diurnal", ("upstream-flap",)),
            ("beta", "chain", "steady", ("poison-storm",)),
        ),
    ),
    ("kill9-wal-replay", (("default", "chain", "steady", ("kill9-replay",)),)),
    ("poison-storm-mesh", (("default", "mesh", "diurnal", ("poison-storm",)),)),
    ("outage-cycle", (("default", "cycle", "steady", ("partial-outage",)),)),
    (
        "rolling-deploy-mesh",
        (("default", "mesh", "ramp", ("rolling-deploy", "tick-stall")),),
    ),
    # appended (never reordered): the bench matrix (first 3) and the
    # acceptance minimum (first 6) keep their archetype sets
    (
        "capacity-growth-chain",
        (("default", "chain", "steady", ("capacity-growth",)),),
    ),
    # graftstream soak: a bursty fanout under the micro-tick engine with
    # a mid-stream tick stall, so the matrix exercises the freshness SLO
    # AND its degraded mode (watchdog -> last-good stale serve)
    (
        "streaming-freshness",
        (("default", "fanout", "burst", ("tick-stall",)),),
    ),
    # graftfleet soak: three tenants spread across a
    # 4-worker ring by consistent hash; alpha live-migrates mid-soak
    # (drain -> WAL handoff -> replay -> ring flip) while beta/gamma
    # traffic keeps flowing on their own workers
    (
        "fleet-migration",
        (
            ("alpha", "fanout", "steady", ("tenant-migration",)),
            ("beta", "chain", "steady", ()),
            ("gamma", "mesh", "steady", ()),
        ),
    ),
    # graftsoak production replay: a
    # recorded WAL v2 window (KMAMIZ_SOAK_BUNDLE, or a bundle
    # synthesized from this composed topology x traffic) replayed
    # through a live server and gated bit-exact against a reference
    # built from the same records (soak/walreplay.py). No storyline:
    # the recording IS the storyline.
    (
        "wal-replay",
        (("default", "fanout", "burst", ()),),
    ),
)

#: per-scenario child-seed stride (prime, far above any matrix size)
SEED_STRIDE = 1_000_003

DEFAULT_TICKS = 10
#: the matrix's seed and size (KMAMIZ_SCENARIO_SEED / _MATRIX defaults)
SEED = 0
MATRIX_SIZE = len(ARCHETYPES)


@dataclass(frozen=True)
class TenantPlan:
    """One tenant's slice of a scenario: its mesh, its traces-per-tick
    schedule, and the storyline events that hit it."""

    tenant: str
    topology: Topology
    traffic: Tuple[int, ...]
    events: Tuple[Event, ...]


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    archetype: str
    seed: int
    index: int
    n_ticks: int
    tenants: Tuple[TenantPlan, ...]

    def events(self) -> Tuple[Tuple[str, Event], ...]:
        """All (tenant, event) pairs, storyline order."""
        pairs = [
            (plan.tenant, ev) for plan in self.tenants for ev in plan.events
        ]
        return tuple(sorted(pairs, key=lambda p: (p[1].at_tick, p[1].kind, p[0])))

    def has_event(self, kind: str) -> bool:
        return any(ev.kind == kind for _t, ev in self.events())


def build_scenario(
    archetype: str, seed: int, index: int, n_ticks: int, storylines: Optional[str] = None
) -> ScenarioSpec:
    """Compose one scenario. Each tenant consumes topology / traffic /
    storyline draws from dedicated child streams of the scenario's own
    ``random.Random``, so tenants never perturb each other's content."""
    by_name = dict(ARCHETYPES)
    if archetype not in by_name:
        raise ValueError(f"unknown archetype: {archetype!r}")
    scenario_seed = seed * SEED_STRIDE + index
    rng = random.Random(scenario_seed)
    plans = []
    for tenant, topo_kind, traffic_kind, story_kinds in by_name[archetype]:
        topo_rng = random.Random(rng.getrandbits(63))
        traffic_rng = random.Random(rng.getrandbits(63))
        story_rng = random.Random(rng.getrandbits(63))
        topo = sample_topology(topo_kind, topo_rng, f"scn-{tenant}")
        events = compose_storyline(story_kinds, topo, story_rng, n_ticks, storylines)
        if any(ev.kind == "rolling-deploy" for ev in events):
            # the storyline will deploy v2 — warmup must carry it
            topo = dataclasses.replace(topo, versions=("v1", "v2"))
        plans.append(
            TenantPlan(
                tenant=tenant,
                topology=topo,
                traffic=sample_traffic(traffic_kind, n_ticks, traffic_rng),
                events=events,
            )
        )
    return ScenarioSpec(
        name=f"{archetype}-s{seed}i{index}",
        archetype=archetype,
        seed=scenario_seed,
        index=index,
        n_ticks=n_ticks,
        tenants=tuple(plans),
    )


def scenario_matrix(
    seed: Optional[int] = None,
    size: Optional[int] = None,
    n_ticks: Optional[int] = None,
    storylines: Optional[str] = None,
) -> Tuple[ScenarioSpec, ...]:
    """The seeded matrix: archetype ``i % len(ARCHETYPES)`` at index
    ``i``. Defaults: SEED, MATRIX_SIZE, DEFAULT_TICKS, STORYLINES."""
    seed = SEED if seed is None else seed
    size = MATRIX_SIZE if size is None else size
    n_ticks = DEFAULT_TICKS if n_ticks is None else n_ticks
    return tuple(
        build_scenario(ARCHETYPES[i % len(ARCHETYPES)][0], seed, i, n_ticks, storylines)
        for i in range(size)
    )


def spec_signature(spec: ScenarioSpec) -> str:
    """sha256 over the complete composed content — topology canonical
    digests, traffic schedules, storyline event keys. Bit-identical
    across processes for one seed, and sensitive to every sampled
    choice (the determinism oracle)."""
    digest = hashlib.sha256()
    digest.update(f"{spec.name}|{spec.n_ticks}".encode("ascii"))
    for plan in spec.tenants:
        digest.update(f"|{plan.tenant}|".encode("ascii"))
        digest.update(topology_digest(plan.topology).encode("ascii"))
        digest.update(repr(plan.traffic).encode("ascii"))
        for ev in plan.events:
            digest.update(ev.key().encode("utf-8"))
    return digest.hexdigest()
