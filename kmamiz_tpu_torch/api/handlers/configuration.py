"""Configuration REST handler (reference src/handler/ConfigurationService.ts).

A copy of kmamiz_tpu/api/handlers/configuration.py, importing the port's modules.
"""
from __future__ import annotations

from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.server.initializer import AppContext


class ConfigurationHandler(IRequestHandler):
    def __init__(self, ctx: AppContext) -> None:
        super().__init__("configuration")
        self._ctx = ctx
        self.add_route("get", "/config", self._config)

    def _config(self, req: Request) -> Response:
        return Response(
            payload={"SimulatorMode": self._ctx.settings.simulator_mode}
        )
