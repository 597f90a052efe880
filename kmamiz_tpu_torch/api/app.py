"""Router assembly of the port's REST API.

Counterpart of kmamiz_tpu/api/app.py:build_router, registering the
handlers ported so far (the model and graph routes). Serve it with
api.router.ApiServer:

    ctx = AppContext(processor=DataProcessor(trace_source=...))
    Initializer(ctx).register_data_caches()  # the caches /graph reads
    ApiServer(build_router(ctx), port=3000).start()
"""
from __future__ import annotations

from kmamiz_tpu_torch.api.handlers import GraphHandler, ModelHandler
from kmamiz_tpu_torch.api.router import Router
from kmamiz_tpu_torch.server.initializer import AppContext


def build_router(ctx: AppContext) -> Router:
    """Register every ported handler's routes under /api/v{N}."""
    router = Router(api_version=ctx.settings.api_version)
    for handler in (GraphHandler(ctx), ModelHandler(ctx)):
        router.add_handler(handler)
    return router
