"""Overload-dependent error-rate model.

Equivalent of KMamiz src/MicroViSim-simulator/classes/
LoadSimulation/OverloadErrorRateEstimator.ts: after the first propagation
pass measures expected per-service traffic, utilization u = RPS /
(replicas x capacityPerReplica); when u > 1 an exponential overload error
E_overload = 1 - exp(-k(u-1)) composes with the base error as
E = E_base + (1 - E_base) * E_overload (:101-142).
"""
from __future__ import annotations

import math
from typing import Dict

from kmamiz_tpu_torch.simulator import naming
from kmamiz_tpu_torch.simulator.slot_metrics import SlotMetrics


def estimate_error_rate_with_overload(
    request_count_per_second: float,
    replica_count: float,
    replica_max_rps: float,
    base_error_rate: float,
    overload_factor_k: float,
) -> float:
    capacity = replica_count * replica_max_rps
    if capacity == 0:
        return 1.0
    utilization = request_count_per_second / capacity
    if utilization <= 1:
        return base_error_rate
    overload = utilization - 1.0
    overload_error = 1.0 - math.exp(-overload_factor_k * overload)
    return min(1.0, base_error_rate + (1.0 - base_error_rate) * overload_error)


def adjust_error_rates_by_overload(
    overload_factor_k: float,
    propagation_results: Dict[str, Dict[str, dict]],
    metrics_per_slot: Dict[str, SlotMetrics],
) -> None:
    """Fold per-service measured traffic back into per-endpoint error rates
    in place (OverloadErrorRateEstimator.ts:8-55)."""
    for key, endpoint_stats in propagation_results.items():
        metrics = metrics_per_slot.get(key)
        if metrics is None:
            continue
        service_counts: Dict[str, float] = {}
        for endpoint, stats in endpoint_stats.items():
            service = naming.extract_unique_service_name(endpoint)
            service_counts[service] = (
                service_counts.get(service, 0.0) + stats["requestCount"]
            )
        for endpoint, base_error_rate in list(metrics.endpoint_error_rate.items()):
            service = naming.extract_unique_service_name(endpoint)
            request_count_per_second = service_counts.get(service, 0.0) / 3600.0
            metrics.set_error_rate(
                endpoint,
                estimate_error_rate_with_overload(
                    request_count_per_second,
                    metrics.get_replicas(service),
                    metrics.get_capacity_per_replica(service),
                    base_error_rate,
                    overload_factor_k,
                ),
            )
