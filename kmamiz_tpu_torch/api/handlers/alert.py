"""Alert REST handler: 3-sigma risk-violation detection.

Equivalent of KMamiz src/handler/AlertService.ts: a service
violates when its latest risk exceeds mean + 3 standard deviations of its
risk history; violations persist for one hour and highlight the endpoint
with the worst server-error rate.

A copy of kmamiz_tpu/api/handlers/alert.py, importing the port's modules.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional

from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.server.initializer import AppContext

ALERT_TIMEOUT_MS = 3_600_000  # AlertService.ts:12


class AlertHandler(IRequestHandler):
    def __init__(
        self,
        ctx: AppContext,
        now_ms: Callable[[], float] = lambda: time.time() * 1000,
    ) -> None:
        super().__init__("alert")
        self._ctx = ctx
        self._now_ms = now_ms
        self._last_update_time = 0.0
        self._violation: Dict[str, dict] = {}
        # the reference mutates its violation map on Node's single event
        # loop; here concurrent GET /alert/violation requests run on
        # their own threads, so detection + expiry + the sorted read
        # serialize
        self._violation_lock = threading.Lock()
        self.add_route("get", "/violation/:namespace?", self._violation_route)

    def _violation_route(self, req: Request) -> Response:
        with self._violation_lock:
            self.gather_risk_violations(
                req.params.get("namespace"),
                req.query_int("notBefore") or 86_400_000,
            )
            result = sorted(
                self._violation.values(),
                key=lambda v: v["timeoutAt"],
                reverse=True,
            )
        return Response(payload=result)

    def _clear_timed_out(self) -> None:
        now = self._now_ms()
        self._violation = {
            k: v for k, v in self._violation.items() if v["timeoutAt"] > now
        }

    def gather_risk_violations(
        self, namespace: Optional[str] = None, not_before_ms: int = 86_400_000
    ) -> None:
        """Caller holds _violation_lock (the route does; direct callers
        in tests are single-threaded)."""
        self._clear_timed_out()
        update_time = self._ctx.cache.get("LookBackRealtimeData").last_update
        if self._last_update_time == update_time:
            return
        self._last_update_time = update_time

        historical = self._ctx.service_utils.get_realtime_historical_data(
            namespace, not_before_ms
        )
        now = self._now_ms()
        for s in self.get_services_with_violation(historical):
            highlight = (
                self._determine_endpoint_to_highlight(s)
                or f"{s['service']}\t{s['namespace']}"
            )
            vid = f"{s['uniqueServiceName']}\t{highlight}"
            self._violation[vid] = {
                "id": vid,
                "uniqueServiceName": s["uniqueServiceName"],
                "displayName": (
                    f"{s['service']}.{s['namespace']} ({s['version']})"
                ),
                "occursAt": self._violation.get(vid, {}).get("occursAt", now),
                "timeoutAt": now + ALERT_TIMEOUT_MS,
                "highlightNodeName": highlight,
            }

    @staticmethod
    def get_services_with_violation(historical: List[dict]) -> List[dict]:
        """AlertService.ts:77-116: latest risk > mean + 3 sigma of history."""
        if not historical:
            return []
        historical.sort(key=lambda h: h["date"])
        stats: Dict[str, dict] = {}
        for h in historical:
            for s in h["services"]:
                risk = s.get("risk")
                if not risk or risk <= 0:
                    continue
                e = stats.setdefault(
                    s["uniqueServiceName"],
                    {"count": 0, "sum": 0.0, "quadraticSum": 0.0},
                )
                e["count"] += 1
                e["sum"] += risk
                e["quadraticSum"] += risk ** 2

        latest_services = historical[-1]["services"]
        latest = {
            s["uniqueServiceName"]: s.get("risk") or 0
            for s in latest_services
            if (s.get("risk") or 0) > 0
        }
        violating = set()
        for name, e in stats.items():
            mean = e["sum"] / e["count"]
            std = math.sqrt(max(e["quadraticSum"] / e["count"] - mean ** 2, 0))
            if latest.get(name, 0) > mean + 3 * std:
                violating.add(name)
        return [
            s for s in latest_services if s["uniqueServiceName"] in violating
        ]

    @staticmethod
    def _determine_endpoint_to_highlight(service_data: dict) -> Optional[str]:
        endpoints = service_data.get("endpoints") or []
        if not endpoints:
            return None

        def error_rate(e: dict) -> float:
            requests = e.get("requests") or 0
            return (e.get("serverErrors") or 0) / requests if requests else 0.0

        worst = max(endpoints, key=error_rate)
        return (
            f"{worst['uniqueServiceName']}\t{worst['method']}\t"
            f"{worst.get('labelName')}"
        )
