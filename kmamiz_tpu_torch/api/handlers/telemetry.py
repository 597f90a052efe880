"""Telemetry REST handler.

Counterpart of kmamiz_tpu/api/handlers/telemetry.py: the in-process
application's view of the instruments the standalone DP server exposes
at bare paths — Prometheus text exposition, the tick-span ring as
Zipkin v2 JSON, and the on-demand torch.profiler capture.

Routes (under the /api/v1 prefix):
- GET  /telemetry/metrics  — Prometheus text format 0.0.4
- GET  /telemetry/traces   — Zipkin v2 trace groups of recent ticks
- POST /telemetry/profile  — {"durationMs": N, "dir": optional}; 409 when
  a capture is already running
"""
from __future__ import annotations

from typing import Optional

from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.telemetry import REGISTRY, TRACER
from kmamiz_tpu_torch.telemetry import device as tel_device

#: the content type of Prometheus text exposition 0.0.4
PROMETHEUS_TEXT = "text/plain; version=0.0.4; charset=utf-8"


class TelemetryHandler(IRequestHandler):
    def __init__(self, ctx: Optional[object] = None) -> None:
        super().__init__("telemetry")
        self._ctx = ctx
        self.add_route("get", "/metrics", self._metrics)
        self.add_route("get", "/traces", self._traces)
        self.add_route("post", "/profile", self._profile)

    def _metrics(self, req: Request) -> Response:
        return Response(raw_body=REGISTRY.render().encode("utf-8"), content_type=PROMETHEUS_TEXT)

    def _traces(self, req: Request) -> Response:
        return Response(payload=TRACER.export_zipkin())

    def _profile(self, req: Request) -> Response:
        parsed = req.json()
        body = parsed if isinstance(parsed, dict) else {}
        out = tel_device.capture_profile(body.get("durationMs", 100), body.get("dir"))
        return Response(status=200 if out.get("ok") else 409, payload=out)
