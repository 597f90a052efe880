"""Health REST handler (KMamiz src/handler/HealthService.ts).

Counterpart of kmamiz_tpu/api/handlers/health.py: GET /health answers
{"status": "UP", "serverTime": ms, "resilience": ...}, the last being
resilience/metrics.py's summary (breakers, quarantine, watchdog and
last-good tick, job streaks, counters). GET /health/timings answers the
process-wide step timer (the tick's phases: fetch_traces, dependencies,
combine_window, graph_merge, combine_assemble, transfer, scorers,
model_forward), the device graph's scorer-cache counters, the forecast
forward's serving counters and the resilience summary, so the pipeline
can be inspected in production without a profiler attached. The JAX
handler's `prewarm` field and `programs` section (its compile plan and
program registry, which the port does not have) are left out.
"""
from __future__ import annotations

import time
from typing import Optional

from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.core.profiling import step_timer
from kmamiz_tpu_torch.models import serving
from kmamiz_tpu_torch.resilience import metrics as res_metrics


class HealthHandler(IRequestHandler):
    def __init__(self, ctx: Optional[object] = None) -> None:
        super().__init__("health")
        self._ctx = ctx
        self.add_route("get", "/", self._health)
        self.add_route("get", "/timings", self._timings)

    def _health(self, req: Request) -> Response:
        return Response(
            payload={
                "status": "UP",
                "serverTime": int(time.time() * 1000),
                "resilience": res_metrics.resilience_summary(),
            }
        )

    def _timings(self, req: Request) -> Response:
        payload = {
            "serverTime": int(time.time() * 1000),
            "phases": step_timer.summary(),
        }
        graph = getattr(getattr(self._ctx, "processor", None), "graph", None)
        if graph is not None:
            payload["scorerCache"] = graph.scorer_cache_stats()
        payload["modelServe"] = serving.serve_stats()
        payload["resilience"] = res_metrics.resilience_summary()
        return Response(payload=payload)
