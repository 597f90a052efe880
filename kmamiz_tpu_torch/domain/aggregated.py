"""Running aggregate totals across historical windows.

Parity with KMamiz src/classes/AggregatedData.ts: request-count
weighted avgRisk merge and endpoint-level sum merge.

A copy of kmamiz_tpu/domain/aggregated.py, importing the port's modules.
"""
from __future__ import annotations

from typing import Dict, List


class AggregatedData:
    def __init__(self, aggregated_data: dict) -> None:
        self._data = aggregated_data

    def to_json(self) -> dict:
        return self._data

    def combine(self, other: dict) -> "AggregatedData":
        from_date = min(self._data["fromDate"], other["fromDate"])
        to_date = max(self._data["toDate"], other["toDate"])

        service_map: Dict[str, dict] = {}
        for s in list(self._data["services"]) + list(other["services"]):
            existing = service_map.get(s["uniqueServiceName"])
            if existing is None:
                service_map[s["uniqueServiceName"]] = dict(s)
            else:
                service_map[s["uniqueServiceName"]] = self._merge_service_info(
                    existing, s
                )
        return AggregatedData(
            {
                "fromDate": from_date,
                "toDate": to_date,
                "services": list(service_map.values()),
            }
        )

    def _merge_service_info(self, a: dict, b: dict) -> dict:
        if a["uniqueServiceName"] != b["uniqueServiceName"]:
            return a
        total_requests = a["totalRequests"] + b["totalRequests"]
        # deliberate deviation: the reference's 0/0 here is NaN
        # (serialized null); 0 keeps the merged document arithmetic-safe
        # for every downstream consumer
        avg_risk = (
            (a["totalRequests"] / total_requests) * a["avgRisk"]
            + (b["totalRequests"] / total_requests) * b["avgRisk"]
            if total_requests
            else 0
        )
        return {
            **a,
            "totalRequests": total_requests,
            "totalRequestErrors": a["totalRequestErrors"] + b["totalRequestErrors"],
            "totalServerErrors": a["totalServerErrors"] + b["totalServerErrors"],
            "avgRisk": avg_risk,
            "endpoints": self._merge_endpoint_info(a["endpoints"], b["endpoints"]),
        }

    @staticmethod
    def _merge_endpoint_info(a: List[dict], b: List[dict]) -> List[dict]:
        endpoint_map: Dict[str, dict] = {}
        for e in list(a) + list(b):
            existing = endpoint_map.get(e["uniqueEndpointName"])
            if existing is None:
                endpoint_map[e["uniqueEndpointName"]] = dict(e)
            else:
                existing["totalRequests"] += e["totalRequests"]
                existing["totalRequestErrors"] += e["totalRequestErrors"]
                existing["totalServerErrors"] += e["totalServerErrors"]
        return list(endpoint_map.values())

    def to_plain(self) -> dict:
        """Zeroed copy used when serving an empty/initial aggregate."""
        return {
            **self._data,
            "services": [
                {
                    **s,
                    "avgRisk": 0,
                    "totalRequests": 0,
                    "totalRequestErrors": 0,
                    "totalServerErrors": 0,
                    "avgLatencyCV": 0,
                    "endpoints": [
                        {
                            **e,
                            "totalRequests": 0,
                            "totalRequestErrors": 0,
                            "totalServerErrors": 0,
                            "avgLatencyCV": 0,
                        }
                        for e in s["endpoints"]
                    ],
                }
                for s in self._data["services"]
            ],
        }
