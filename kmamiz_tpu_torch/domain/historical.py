"""Historical (per-minute) data and its inverse/aggregate mappings.

Parity with KMamiz src/classes/HistoricalData.ts: inverse mapping
to combined realtime data for the 30-minute look-back risk window, risk
re-injection, and date-range aggregation.

A copy of kmamiz_tpu/domain/historical.py, importing the port's modules.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from kmamiz_tpu_torch.domain.combined import CombinedRealtimeDataList


class HistoricalData:
    def __init__(self, historical_data: dict) -> None:
        self._data = historical_data

    def to_json(self) -> dict:
        return self._data

    def to_combined_realtime_data_list(self) -> CombinedRealtimeDataList:
        """Inverse mapping for look-back risk (HistoricalData.ts:25-84):
        request counts split back into status buckets with a fixed 100 mean."""
        mapped: List[dict] = []
        for s in self._data["services"]:
            service, namespace, version = s["uniqueServiceName"].split("\t")
            for e in s["endpoints"]:
                base = {
                    "service": service,
                    "namespace": namespace,
                    "version": version,
                    "method": e["method"],
                    "latestTimestamp": s["date"] * 1000,
                    "uniqueServiceName": e["uniqueServiceName"],
                    "uniqueEndpointName": e["uniqueEndpointName"],
                }
                normal = e["requests"] - e["requestErrors"] - e["serverErrors"]
                for combined, status in (
                    (normal, "200"),
                    (e["requestErrors"], "400"),
                    (e["serverErrors"], "500"),
                ):
                    if combined:
                        mapped.append(
                            {
                                **base,
                                "combined": combined,
                                "latency": {"mean": 100, "cv": e["latencyCV"]},
                                "status": status,
                            }
                        )
        return CombinedRealtimeDataList(mapped)

    def update_risk_value(self, risk_results: List[dict]) -> "HistoricalData":
        risk_map = {r["uniqueServiceName"]: r for r in risk_results}
        for s in self._data["services"]:
            if s["uniqueServiceName"] in risk_map:
                s["risk"] = risk_map[s["uniqueServiceName"]].get("norm")
        return self

    def to_aggregated_data(
        self, label_map: Optional[Dict[str, str]] = None
    ) -> dict:
        """Date-range + per-service/endpoint sums and averages
        (HistoricalData.ts:100-209)."""
        min_date = float("inf")
        max_date = float("-inf")
        service_map: Dict[str, List[dict]] = {}
        for s in self._data["services"]:
            time = s["date"]
            max_date = max(max_date, time)
            min_date = min(min_date, time)
            service_map.setdefault(s["uniqueServiceName"], []).append(dict(s))
        return {
            "fromDate": min_date,
            "toDate": max_date,
            "services": self._aggregated_service_info(service_map, label_map),
        }

    def _aggregated_service_info(
        self,
        service_map: Dict[str, List[dict]],
        label_map: Optional[Dict[str, str]],
    ) -> List[dict]:
        out = []
        for unique_service_name, group in service_map.items():
            service, namespace, version = unique_service_name.split("\t")
            endpoint_map: Dict[str, List[dict]] = {}
            for s in group:
                for e in s["endpoints"]:
                    endpoint_map.setdefault(e["uniqueEndpointName"], []).append(e)
            endpoints = self._aggregated_endpoint_info(
                unique_service_name, endpoint_map, label_map
            )
            total_requests = sum(s["requests"] for s in group)
            total_server_errors = sum(s["serverErrors"] for s in group)
            total_request_errors = sum(s["requestErrors"] for s in group)
            avg_risk = sum(s.get("risk") or 0 for s in group) / len(group)
            avg_latency_cv = sum(s["latencyCV"] for s in group) / len(group)
            out.append(
                {
                    "uniqueServiceName": unique_service_name,
                    "service": service,
                    "namespace": namespace,
                    "version": version,
                    "totalRequests": total_requests,
                    "totalServerErrors": total_server_errors,
                    "totalRequestErrors": total_request_errors,
                    "avgRisk": avg_risk,
                    "avgLatencyCV": avg_latency_cv,
                    "endpoints": endpoints,
                }
            )
        return out

    @staticmethod
    def _aggregated_endpoint_info(
        unique_service_name: str,
        endpoint_map: Dict[str, List[dict]],
        label_map: Optional[Dict[str, str]],
    ) -> List[dict]:
        out = []
        for unique_endpoint_name, group in endpoint_map.items():
            method = unique_endpoint_name.split("\t")[3]
            out.append(
                {
                    "uniqueServiceName": unique_service_name,
                    "uniqueEndpointName": unique_endpoint_name,
                    "labelName": (label_map or {}).get(unique_endpoint_name),
                    "method": method,
                    "totalRequests": sum(e["requests"] for e in group),
                    "totalServerErrors": sum(e["serverErrors"] for e in group),
                    "totalRequestErrors": sum(e["requestErrors"] for e in group),
                    "avgLatencyCV": sum(e["latencyCV"] for e in group) / len(group),
                }
            )
        return out
