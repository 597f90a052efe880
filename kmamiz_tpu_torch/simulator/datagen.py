"""Propagation stats -> per-time-slot combined realtime data.

Equivalent of KMamiz src/MicroViSim-simulator/classes/
LoadSimulation/LoadSimulationDataGenerator.ts: each endpoint's per-slot
stats become up to two TCombinedRealtimeData rows — successes attributed
to the first declared 2xx response (default "200") and errors to the first
5xx (default "500") — stamped with the slot's absolute timestamp in
microseconds (:46-98).
"""
from __future__ import annotations

from typing import Dict, List

from kmamiz_tpu_torch.simulator.slot_metrics import parse_slot_key

DAY_MS = 86_400_000
HOUR_MS = 3_600_000
MINUTE_MS = 60_000


def generate_realtime_data(
    base_data_map: Dict[str, dict],
    propagation_results: Dict[str, Dict[str, dict]],
    simulate_date_ms: float,
) -> Dict[str, List[dict]]:
    """base_data_map: uniqueEndpointName -> {"baseData": ..., "responses": [...]}
    (built by Simulator.collect_sample_data)."""
    out: Dict[str, List[dict]] = {}
    for key, endpoint_stats in propagation_results.items():
        day, hour, minute = parse_slot_key(key)
        timestamp_micro = (
            simulate_date_ms + day * DAY_MS + hour * HOUR_MS + minute * MINUTE_MS
        ) * 1000

        combined: List[dict] = []
        for endpoint, stats in endpoint_stats.items():
            base_with_resp = base_data_map.get(endpoint)
            if not base_with_resp:
                continue
            base = base_with_resp["baseData"]
            responses = base_with_resp.get("responses") or []
            error_count = stats["ownErrorCount"] + stats["downstreamErrorCount"]
            success_count = stats["requestCount"] - error_count
            latency_by_status = stats["latencyStatsByStatus"]
            if success_count > 0:
                resp2xx = next(
                    (r for r in responses if str(r["status"]).startswith("2")), None
                )
                combined.append(
                    {
                        **base,
                        "latestTimestamp": timestamp_micro,
                        "requestSchema": None,
                        "responseSchema": None,
                        "responseBody": resp2xx["responseBody"] if resp2xx else None,
                        "responseContentType": (
                            resp2xx["responseContentType"] if resp2xx else None
                        ),
                        "combined": success_count,
                        "status": resp2xx["status"] if resp2xx else "200",
                        "latency": latency_by_status.get(
                            "200", {"mean": 0.0, "cv": 0.0}
                        ),
                    }
                )
            if error_count > 0:
                resp5xx = next(
                    (r for r in responses if str(r["status"]).startswith("5")), None
                )
                combined.append(
                    {
                        **base,
                        "latestTimestamp": timestamp_micro,
                        "requestSchema": None,
                        "responseSchema": None,
                        "responseBody": resp5xx["responseBody"] if resp5xx else None,
                        "responseContentType": (
                            resp5xx["responseContentType"] if resp5xx else None
                        ),
                        "combined": error_count,
                        "status": resp5xx["status"] if resp5xx else "500",
                        "latency": latency_by_status.get(
                            "500", {"mean": 0.0, "cv": 0.0}
                        ),
                    }
                )
        out[key] = combined
    return out
