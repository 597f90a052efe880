"""Load-simulation orchestration.

Equivalent of KMamiz src/MicroViSim-simulator/classes/
LoadSimulation/LoadSimulationHandler.ts: build per-slot base metrics from
the config (daily request counts distributed over 24 hourly slots with
±20% random weights, :240-302), inject faults, propagate once with base
error rates, adjust error rates for overload, propagate again with
latency, and emit per-slot combined realtime data.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from kmamiz_tpu_torch.simulator import datagen, faults, overload, propagator
from kmamiz_tpu_torch.simulator.dependency_builder import ProbabilityGroups
from kmamiz_tpu_torch.simulator.slot_metrics import SlotMetrics, slot_key

TIME_SLOTS_PER_DAY = 24


def distribute_daily_request_count(
    total: int, slots: int, rng: np.random.Generator
) -> np.ndarray:
    """Split a daily total over `slots` with ±20% random weights; floors are
    topped back up to the exact total in descending-weight order
    (LoadSimulationHandler.ts:260-302)."""
    weights = 1.0 + (rng.random(slots) * 0.4 - 0.2)
    normalized = weights / weights.sum()
    counts = np.floor(normalized * total).astype(np.int64)
    diff = int(total - counts.sum())
    if diff >= 1:
        order = np.argsort(-normalized, kind="stable")
        for i in range(diff):
            counts[order[i % slots]] += 1
    return counts


def build_base_metrics_per_slot(
    load: dict,
    base_replica_counts: List[dict],
    rng: np.random.Generator,
) -> Dict[str, SlotMetrics]:
    """slotKey ("day-hour-0") -> SlotMetrics (LoadSimulationHandler.ts:133-238)."""
    days = load["config"]["simulationDurationInDays"]
    metrics_per_slot = {
        slot_key(day, hour): SlotMetrics()
        for day in range(days)
        for hour in range(TIME_SLOTS_PER_DAY)
    }
    if not load["endpointMetrics"]:
        return metrics_per_slot

    replica_map = {
        r["uniqueServiceName"]: r["replicas"] for r in base_replica_counts
    }
    capacity_map: Dict[str, float] = {}
    for ns in load["serviceMetrics"]:
        for svc in ns["services"]:
            for ver in svc["versions"]:
                if ver["uniqueServiceName"]:
                    capacity_map[ver["uniqueServiceName"]] = ver["capacityPerReplica"]

    delay_map = {
        m["uniqueEndpointName"]: (m["delay"]["latencyMs"], m["delay"]["jitterMs"])
        for m in load["endpointMetrics"]
    }
    error_map = {
        m["uniqueEndpointName"]: m["errorRatePercent"] / 100.0
        for m in load["endpointMetrics"]
    }
    counts_map = {
        m["uniqueEndpointName"]: [
            distribute_daily_request_count(
                m["expectedExternalDailyRequestCount"], TIME_SLOTS_PER_DAY, rng
            )
            for _ in range(days)
        ]
        for m in load["endpointMetrics"]
    }

    for day in range(days):
        for hour in range(TIME_SLOTS_PER_DAY):
            metrics = metrics_per_slot[slot_key(day, hour)]
            metrics.endpoint_delay = dict(delay_map)
            metrics.endpoint_error_rate = dict(error_map)
            metrics.entry_request_counts = {
                endpoint: int(day_counts[day][hour])
                for endpoint, day_counts in counts_map.items()
            }
            metrics.service_replicas = dict(replica_map)
            metrics.service_capacity_per_replica = dict(capacity_map)
    return metrics_per_slot


def generate_combined_realtime_data_map(
    load: dict,
    depend_on_groups: Dict[str, ProbabilityGroups],
    base_replica_counts: List[dict],
    base_data_map: Dict[str, dict],
    simulate_date_ms: float,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, List[dict]]:
    """Full load-simulation pipeline (LoadSimulationHandler.ts:37-131)."""
    rng = rng if rng is not None else np.random.default_rng()

    metrics_per_slot = build_base_metrics_per_slot(load, base_replica_counts, rng)

    # faults first so both propagation passes see identical conditions
    faults.inject_faults(load, metrics_per_slot, rng)

    # pass 1: expected traffic under base error rates (no latency)
    base_results = propagator.simulate_propagation(
        load["endpointMetrics"],
        depend_on_groups,
        metrics_per_slot,
        compute_latency=False,
        rng=rng,
    )

    # overload model folds measured traffic back into error rates
    overload.adjust_error_rates_by_overload(
        load["config"]["overloadErrorRateIncreaseFactor"],
        base_results,
        metrics_per_slot,
    )

    # pass 2: actual traffic with overload-adjusted errors + latency stats
    final_results = propagator.simulate_propagation(
        load["endpointMetrics"],
        depend_on_groups,
        metrics_per_slot,
        compute_latency=True,
        rng=rng,
    )

    return datagen.generate_realtime_data(
        base_data_map, final_results, simulate_date_ms
    )
