"""Per-time-slot dynamic metrics container.

Equivalent of TCMetricsPerTimeSlot
(KMamiz src/MicroViSim-simulator/entities/TLoadSimulation.ts:59-206):
per-slot entry-point request counts, endpoint delay/error-rate, service
replica counts and per-replica capacity, with clamped mutators used by the
fault injector.
"""
from __future__ import annotations

from typing import Dict, Tuple


class SlotMetrics:
    def __init__(self) -> None:
        self.entry_request_counts: Dict[str, float] = {}
        self.endpoint_delay: Dict[str, Tuple[float, float]] = {}  # (latencyMs, jitterMs)
        self.endpoint_error_rate: Dict[str, float] = {}
        self.service_replicas: Dict[str, int] = {}
        self.service_capacity_per_replica: Dict[str, float] = {}

    # defaults mirror TLoadSimulation.ts:132-147
    def get_entry_request_count(self, endpoint: str) -> float:
        return self.entry_request_counts.get(endpoint, 0)

    def get_delay(self, endpoint: str) -> Tuple[float, float]:
        return self.endpoint_delay.get(endpoint, (0.0, 0.0))

    def get_error_rate(self, endpoint: str) -> float:
        return self.endpoint_error_rate.get(endpoint, 0.0)

    def get_replicas(self, service: str) -> int:
        return self.service_replicas.get(service, 1)

    def get_capacity_per_replica(self, service: str) -> float:
        return self.service_capacity_per_replica.get(service, 1.0)

    # fault-injection mutators (clamped like the reference setters)
    def add_delay(self, endpoint: str, latency_ms: float, jitter_ms: float) -> None:
        base_lat, base_jit = self.get_delay(endpoint)
        self.endpoint_delay[endpoint] = (
            max(0.0, base_lat + latency_ms),
            max(0.0, base_jit + jitter_ms),
        )

    def add_error_rate(self, endpoint: str, delta: float) -> None:
        self.endpoint_error_rate[endpoint] = max(
            0.0, self.get_error_rate(endpoint) + delta
        )

    def set_error_rate(self, endpoint: str, rate: float) -> None:
        self.endpoint_error_rate[endpoint] = max(0.0, rate)

    def add_entry_request_count(self, endpoint: str, delta: float) -> None:
        self.entry_request_counts[endpoint] = max(
            0, self.get_entry_request_count(endpoint) + delta
        )

    def multiply_entry_request_count(self, endpoint: str, factor: float) -> None:
        self.entry_request_counts[endpoint] = max(
            0, self.get_entry_request_count(endpoint) * factor
        )

    def subtract_replicas(self, service: str, count: int) -> None:
        self.service_replicas[service] = max(0, self.get_replicas(service) - count)


def slot_key(day: int, hour: int, minute: int = 0) -> str:
    return f"{day}-{hour}-{minute}"


def parse_slot_key(key: str) -> Tuple[int, int, int]:
    day, hour, minute = (int(x) for x in key.split("-"))
    return day, hour, minute
