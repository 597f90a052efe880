"""Time-windowed fault injection.

Equivalent of KMamiz src/MicroViSim-simulator/classes/
LoadSimulation/FaultInjector.ts: latency-increase, error-rate-increase,
traffic-burst (add or multiply), and replica-reduction faults, each active
in one or more (day, hour) windows with an occurrence probability; windows
of the same fault that overlap combine as the union of independent events
(1 - prod(1 - p), FaultInjector.ts:108-139).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from kmamiz_tpu_torch.simulator.slot_metrics import SlotMetrics, slot_key


class _EndpointFault:
    __slots__ = ("latency_ms", "error_rate_percent", "request_count", "request_multiplier")

    def __init__(self) -> None:
        self.latency_ms = 0.0
        self.error_rate_percent = 0.0
        self.request_count = 0
        self.request_multiplier = 0.0


class _ServiceFault:
    __slots__ = ("reduced_replicas",)

    def __init__(self) -> None:
        self.reduced_replicas = 0


def _fault_probability_per_slot(fault: dict) -> Dict[str, float]:
    """slotKey -> occurrence probability, overlapping windows unioned."""
    grouped: Dict[str, list] = {}
    for period in fault["timePeriods"]:
        percent = period["probabilityPercent"] / 100.0
        for h in range(period["durationHours"]):
            current_hour = period["startTime"]["hour"] + h
            actual_day = period["startTime"]["day"] + current_hour // 24 - 1
            key = slot_key(actual_day, current_hour % 24)
            grouped.setdefault(key, []).append(percent)
    return {
        key: 1.0 - float(np.prod([1.0 - p for p in probs]))
        for key, probs in grouped.items()
    }


def inject_faults(
    load: dict,
    metrics_per_slot: Dict[str, SlotMetrics],
    rng: np.random.Generator,
) -> None:
    """Draw fault occurrences per slot and apply them to the slot metrics in
    place (FaultInjector.ts:5-68). Faults are injected before propagation so
    both propagation passes see identical conditions."""
    endpoint_faults: Dict[str, Dict[str, _EndpointFault]] = {
        key: {} for key in metrics_per_slot
    }
    service_faults: Dict[str, Dict[str, _ServiceFault]] = {
        key: {} for key in metrics_per_slot
    }

    for fault in load.get("faultInjection") or []:
        for key, prob in _fault_probability_per_slot(fault).items():
            if key not in metrics_per_slot or rng.random() > prob:
                continue
            if fault["type"] == "reduce-instance":
                for svc in fault["targets"]["services"]:
                    record = service_faults[key].setdefault(
                        svc["uniqueServiceName"], _ServiceFault()
                    )
                    record.reduced_replicas = max(0, fault["reduceCount"])
            else:
                for ep in fault["targets"]["endpoints"]:
                    record = endpoint_faults[key].setdefault(
                        ep["uniqueEndpointName"], _EndpointFault()
                    )
                    # later faults of the same slot overwrite, matching the
                    # reference's setter behavior (FaultInjector.ts:163-178)
                    record.latency_ms = (
                        fault["increaseLatencyMs"]
                        if fault["type"] == "increase-latency"
                        else 0.0
                    )
                    record.error_rate_percent = (
                        fault["increaseErrorRatePercent"]
                        if fault["type"] == "increase-error-rate"
                        else 0.0
                    )
                    if fault["type"] == "inject-traffic":
                        if fault.get("increaseRequestCount"):
                            record.request_count = fault["increaseRequestCount"]
                        if fault.get("requestMultiplier"):
                            record.request_multiplier = fault["requestMultiplier"]

    for key, metrics in metrics_per_slot.items():
        for endpoint, record in endpoint_faults[key].items():
            if record.latency_ms > 0:
                metrics.add_delay(endpoint, record.latency_ms, 0.0)
            if record.error_rate_percent > 0:
                metrics.add_error_rate(endpoint, record.error_rate_percent / 100.0)
            if record.request_count > 0:
                metrics.add_entry_request_count(endpoint, record.request_count)
            elif record.request_multiplier > 0:
                metrics.multiply_entry_request_count(
                    endpoint, record.request_multiplier
                )
        for service, record in service_faults[key].items():
            if record.reduced_replicas > 0:
                metrics.subtract_replicas(service, record.reduced_replicas)
