"""Health REST handler (KMamiz src/handler/HealthService.ts).

Counterpart of kmamiz_tpu/api/handlers/health.py: GET /health answers
{"status": "UP", "serverTime": ms, "resilience": ...}, the last being
resilience/metrics.py's summary (breakers, quarantine, watchdog and
last-good tick, job streaks, counters). The JAX handler's `prewarm`
field (its compile plan, which the port does not have) is left out, and
GET /health/timings (the step timer) waits for the port's telemetry.
"""
from __future__ import annotations

import time
from typing import Optional

from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.resilience import metrics as res_metrics


class HealthHandler(IRequestHandler):
    def __init__(self, ctx: Optional[object] = None) -> None:
        super().__init__("health")
        self._ctx = ctx
        self.add_route("get", "/", self._health)

    def _health(self, req: Request) -> Response:
        return Response(
            payload={
                "status": "UP",
                "serverTime": int(time.time() * 1000),
                "resilience": res_metrics.resilience_summary(),
            }
        )
