"""Archetype 10: the fleet-migration soak.

Counterpart of kmamiz_tpu/fleet/soak.py. It drives a fleet of in-process
workers (four by default, behind a ``LocalTransport``) through the seeded
``fleet-migration`` scenario: three tenants spread over the ring by
consistent hash take steady traffic; at the storyline's
``tenant-migration`` tick the coordinator live-migrates tenant ``alpha``
to the placement's least-loaded pick, with one window arriving mid-
handoff (injected between the drain and the WAL export), so the drain
queue's zero-loss promise is exercised, not assumed. Scored like every
runner card:

- **zero lost spans**: every trace id the driver routed (the mid-handoff
  window too) is in the final owner's dedup registry;
- **bit-exact**: each tenant's live graph signature equals a serial
  replay of its whole ordered ingest log on a new processor;
- **fold consistency**: the two-level fold's aggregate edge count equals
  the sum of the tenants' (their namespaces are disjoint, so the fold
  must neither lose nor invent edges);
- the migration committed, and the mid-handoff window was queued and
  released.

The JAX soak's ``zero_steady_recompiles`` gate counts XLA compiles and is
not on this card (nothing is compiled per shape); its rehearsal windows
stay, since they are part of each tenant's ingest log. With the lock
witness armed (the runner's KMAMIZ_LOCK_WITNESS=1), the card also gates
on the witnessed lock-order graph: acyclic, and every edge and site
known to the static model (``lock_witness_acyclic``,
``lock_witness_covered``), with the counts in ``lock_witness``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

from kmamiz_tpu_torch import fleet as fleet_mod
from kmamiz_tpu_torch.fleet import migration as migration_mod
from kmamiz_tpu_torch.fleet import placement
from kmamiz_tpu_torch.fleet.coordinator import FleetCoordinator, LocalTransport
from kmamiz_tpu_torch.fleet.ring import HashRing
from kmamiz_tpu_torch.fleet.worker import FleetWorker
from kmamiz_tpu_torch.telemetry.profiling import events as prof_events

#: in-process workers of the soak's fleet
WORKERS = 4


class _MidHandoffTransport:
    """A transport proxy that fires a callback between the migration's
    drain and its WAL export: a frame racing the handoff, made
    deterministic. The callback routes a real window through the
    coordinator, which must park it in the drain queue and release it to
    whichever side the migration resolves to."""

    def __init__(self, inner, on_export) -> None:
        self._inner = inner
        self._on_export = on_export

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def wal_export(self, worker_id: str, tenant: str) -> bytes:
        self._on_export()
        return self._inner.wal_export(worker_id, tenant)


def run_fleet_scenario(spec, tmpdir: str, verbose: bool = False, device=None) -> dict:
    """Run the fleet-migration scenario on `device` (WORKERS workers, the
    ring at fleet.VNODES and fleet.SEED); returns a runner card."""
    from kmamiz_tpu_torch.graph.store import EndpointGraph, graph_signature
    from kmamiz_tpu_torch.scenarios.factory import spec_signature
    from kmamiz_tpu_torch.scenarios.topology import trace_group
    from kmamiz_tpu_torch.telemetry.slo import percentile

    t_start_ms = prof_events.now_ms()
    ring = HashRing([f"w{i}" for i in range(WORKERS)], vnodes=fleet_mod.VNODES, seed=fleet_mod.SEED)
    fleet_workers = {
        w: FleetWorker(w, wal_root=os.path.join(tmpdir, "fleet-wal"), device=device) for w in ring.workers
    }
    coordinator = FleetCoordinator(ring, LocalTransport(fleet_workers))

    tenant_names = [p.tenant for p in spec.tenants]
    state: dict = {
        "latencies": [],
        "posts": 0,
        "errors": [],
        # per-tenant ordered ingest log (raw bytes, arrival order): the
        # serial reference replays exactly this
        "expected": {t: [] for t in tenant_names},
        "expected_traces": {t: [] for t in tenant_names},
        "migration": None,
        "queued_mid_handoff": 0,
    }

    def window_bytes(plan, tick: int, count: int) -> bytes:
        prefix = f"{spec.name}-{plan.tenant}"
        return json.dumps([trace_group(plan.topology, prefix, tick, i) for i in range(count)]).encode()

    def log_frame(tenant: str, raw: bytes) -> None:
        state["expected"][tenant].append(raw)
        state["expected_traces"][tenant].extend(group[0]["traceId"] for group in json.loads(raw))

    def route(plan, raw: bytes) -> None:
        tenant = plan.tenant
        log_frame(tenant, raw)
        t0 = prof_events.now_ms()
        summary = coordinator.route_ingest(tenant, raw)
        state["latencies"].append(prof_events.now_ms() - t0)
        state["posts"] += 1
        if summary is not None and summary.get("quarantined"):
            state["errors"].append(f"{tenant}: window quarantined ({summary.get('reason')})")

    migration_event = next((ev for _t, ev in spec.events() if ev.kind == "tenant-migration"), None)
    migrating_tenant = next(
        (p.tenant for p in spec.tenants if any(ev.kind == "tenant-migration" for ev in p.events)), None
    )

    def fire_migration(tick: int) -> None:
        tenant = migrating_tenant
        target = placement.pick_target(
            coordinator.ring, tenant, tenant_names, overrides=coordinator.snapshot()["overrides"]
        )
        if target == coordinator.owner(tenant):
            # the least-loaded pick is the current owner: move to the next
            # worker, so the soak always migrates
            target = next(w for w in ring.workers if w != target)
        plan = next(p for p in spec.tenants if p.tenant == tenant)

        def mid_handoff_window() -> None:
            # a distinct trace prefix: extra traffic racing the handoff,
            # not a duplicate of the tick's own window
            raw = json.dumps([trace_group(plan.topology, f"{spec.name}-{tenant}-mid", tick, 0)]).encode()
            log_frame(tenant, raw)
            queued = coordinator.route_ingest(tenant, raw)
            state["posts"] += 1
            if queued is not None:
                state["errors"].append("mid-handoff window bypassed the drain queue")
            else:
                state["queued_mid_handoff"] += 1

        real_transport = coordinator.transport
        coordinator.swap_transport(_MidHandoffTransport(real_transport, mid_handoff_window))
        try:
            state["migration"] = migration_mod.migrate_tenant(coordinator, tenant, target)
        except migration_mod.MigrationError as err:
            state["errors"].append(f"migration failed: {err}")
        finally:
            coordinator.swap_transport(real_transport)

    def rehearse(plan) -> None:
        """The JAX soak's pre-soak shape rehearsal (it compiles there):
        every topology path first, then one window of each distinct tick
        shape and the mid-handoff window's. Its windows route through the
        coordinator like real traffic and join the ingest log."""
        topo = plan.topology
        route(plan, json.dumps([trace_group(topo, f"{spec.name}-warm", 0, p_i) for p_i in range(len(topo.paths))]).encode())
        rehearsed = set()
        shapes = [[trace_group(topo, f"{spec.name}-wm", 0, 0)]]
        for t in range(spec.n_ticks):
            count = plan.traffic[t % len(plan.traffic)]
            shapes.append([trace_group(topo, f"{spec.name}-wr{t}", t, i) for i in range(count)])
        for groups in shapes:
            shape_key = tuple(sorted(len(g) for g in groups))
            if not groups or shape_key in rehearsed:
                continue
            rehearsed.add(shape_key)
            route(plan, json.dumps(groups).encode())

    try:
        for plan in spec.tenants:
            rehearse(plan)
        # the JAX soak's trial fold into a throwaway aggregate (it warms
        # the union programs there); the same folds count here
        coordinator.fold(tenant_names, EndpointGraph(device=device, tenant="fleet-trial"))
        for tick in range(spec.n_ticks):
            if migration_event is not None and tick == migration_event.at_tick and migrating_tenant is not None:
                fire_migration(tick)
            for plan in spec.tenants:
                route(plan, window_bytes(plan, tick, plan.traffic[tick % len(plan.traffic)]))
    except Exception as err:  # noqa: BLE001 - a scorecard, not a crash
        state["errors"].append(f"{type(err).__name__}: {err}")

    aggregate = EndpointGraph(device=device, tenant="fleet-aggregate")
    try:
        folded_edges = coordinator.fold(tenant_names, aggregate)
    except Exception as err:  # noqa: BLE001
        folded_edges = -1
        state["errors"].append(f"fold failed: {err}")

    live_sigs: Dict[str, str] = {}
    live_edges: Dict[str, int] = {}
    lost_spans = 0
    missing: List[str] = []
    for plan in spec.tenants:
        proc = fleet_workers[coordinator.owner(plan.tenant)].processor(plan.tenant)
        live_sigs[plan.tenant] = graph_signature(proc.graph)
        live_edges[plan.tenant] = int(proc.graph.n_edges)
        with proc._dedup_lock:
            processed = set(proc._processed)
        for tid in state["expected_traces"][plan.tenant]:
            if tid not in processed:
                lost_spans += 1
                missing.append(f"{plan.tenant}:{tid}")

    ref_sigs = _reference_signatures(spec, state, device)

    mig = state["migration"]
    gates = {
        "no_errors": not state["errors"],
        "bit_exact": all(live_sigs[t] == ref_sigs[t] for t in tenant_names),
        "zero_lost_spans": lost_spans == 0,
        "migration_committed": bool(mig and mig.get("ok")),
        "mid_handoff_queued": state["queued_mid_handoff"] >= 1 and bool(mig and mig.get("queuedReleased", 0) >= 1),
        "fold_consistent": folded_edges == sum(live_edges.values()),
    }
    from kmamiz_tpu_torch.analysis.concurrency import witness

    lock_witness = None
    if witness.installed():
        report = witness.check()
        gates["lock_witness_acyclic"] = report.acyclic
        # a witnessed edge the static model missed is an extractor blind
        # spot — the soak fails so the model gets fixed, not ignored
        gates["lock_witness_covered"] = not report.uncovered and not report.unknown_sites
        lock_witness = {
            "edges": report.edge_count,
            "acquires": report.acquire_count,
            "cycles": report.cycles,
            "uncovered": [list(p) for p in report.uncovered],
            "unknownSites": report.unknown_sites,
            "peerEdges": report.peer_edges,
        }
    lat = sorted(state["latencies"])
    card = {
        "name": spec.name,
        "archetype": spec.archetype,
        "spec_signature": spec_signature(spec),
        "n_ticks": spec.n_ticks,
        "tenants": tenant_names,
        "posts": state["posts"],
        "stale_serves": 0,
        "stale_rate": 0.0,
        "p50_tick_ms": round(percentile(lat, 0.50), 2),
        "p95_tick_ms": round(percentile(lat, 0.95), 2),
        "p99_tick_ms": round(percentile(lat, 0.99), 2),
        "lost_spans": lost_spans,
        "missing_traces": missing[:8],
        "quarantined": 0,
        "expected_poisons": 0,
        "recovery_ms": 0.0,
        "recoveries": {},
        "signatures": live_sigs,
        "migration": mig,
        "fleet": {
            **fleet_mod.snapshot(),
            "coordinator": coordinator.snapshot(),
            "foldedEdges": folded_edges,
            "workers": {w: fleet_workers[w].summary() for w in ring.workers},
        },
        "wal": None,
        "lock_witness": lock_witness,
        "errors": state["errors"][:4],
        "gates": gates,
        "pass": all(gates.values()),
        "wall_s": round((prof_events.now_ms() - t_start_ms) / 1000.0, 1),
    }
    if not card["pass"]:
        from kmamiz_tpu_torch.scenarios.runner import _failed_gates_artifact

        card["flight_artifact"] = _failed_gates_artifact(spec, gates)
    if verbose:
        import sys

        print(f"{spec.name}: pass={card['pass']} gates={gates}", file=sys.stderr)
    return card


def _reference_signatures(spec, state: dict, device) -> Dict[str, str]:
    """The serial oracle: each tenant's whole ordered ingest log replayed
    on a new processor (no WAL, the default ingest cap); the fleet's
    drain, handoff and replay must land every tenant on exactly this
    graph."""
    from kmamiz_tpu_torch.graph.store import graph_signature
    from kmamiz_tpu_torch.server.processor import DataProcessor

    sigs: Dict[str, str] = {}
    for plan in spec.tenants:
        ref = DataProcessor(trace_source=lambda _lb, _t, _lim: [], device=device, use_device_stats=False, wal=None)
        for raw in state["expected"][plan.tenant]:
            ref.ingest_raw_window(raw)
        sigs[plan.tenant] = graph_signature(ref.graph)
    return sigs
