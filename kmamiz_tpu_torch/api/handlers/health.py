"""Health REST handler (KMamiz src/handler/HealthService.ts).

Counterpart of kmamiz_tpu/api/handlers/health.py reduced to its liveness
probe: GET /health answers {"status": "UP", "serverTime": ms}. The JAX
handler's `prewarm` field (its compile plan, which the port does not
have), its `resilience` field and the GET /health/timings route (counters
of resilience/metrics.py and the step timer) wait for the port's
telemetry.
"""
from __future__ import annotations

import time
from typing import Optional

from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response


class HealthHandler(IRequestHandler):
    def __init__(self, ctx: Optional[object] = None) -> None:
        super().__init__("health")
        self._ctx = ctx
        self.add_route("get", "/", self._health)

    def _health(self, req: Request) -> Response:
        return Response(payload={"status": "UP", "serverTime": int(time.time() * 1000)})
