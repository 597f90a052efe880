"""Application assembly: the KMamiz backend of the port.

Counterpart of kmamiz_tpu/api/app.py (KMamiz index.ts):
`build_production_context` wires the Zipkin and Kubernetes clients and
the card's processor from the settings, `build_router` registers every
handler's routes (the simulation handler's in simulator mode), and
`Application` picks the startup mode (production / simulator /
serve-only / read-only), serves the REST API and tears down by stopping
the schedules and flushing every cache to the store, or in simulator
mode clearing it (index.ts:95-113). Simulator mode builds no processor
and no clients: POST /api/v1/simulation/startSimulation fills the caches
from a YAML on the host. Run with

    python -m kmamiz_tpu_torch.api.app

(main(): the environment's settings, the processor on the card,
SIGTERM/SIGINT tear down and exit), or assemble it in process, with the
processor on the card or, in tests, on the CPU:

    app = Application(ctx=build_production_context(settings, device="cpu"))
    app.start_up()  # caches from the store, graph warm start, schedules
    app.listen(port=3000)
    ...
    app.tear_down()  # stop the schedules, flush every cache
"""
from __future__ import annotations

import logging
import signal
from typing import Optional

from kmamiz_tpu_torch.api.handlers import (
    AlertHandler,
    ComparatorHandler,
    ConfigurationHandler,
    DataHandler,
    GraphHandler,
    HealthHandler,
    ModelHandler,
    SwaggerHandler,
    TelemetryHandler,
)
from kmamiz_tpu_torch.api.router import ApiServer, Router
from kmamiz_tpu_torch.config import Settings
from kmamiz_tpu_torch.device import DeviceLike
from kmamiz_tpu_torch.server.import_export import ImportExportHandler
from kmamiz_tpu_torch.server.initializer import AppContext, Initializer
from kmamiz_tpu_torch.simulator.handler import SimulationHandler

logger = logging.getLogger("kmamiz_tpu_torch.app")


def build_production_context(
    app_settings: Optional[Settings] = None, device: DeviceLike = None, warm: bool = True
) -> AppContext:
    """A context with the live ingestion clients and the in-process Data
    Processor on `device` (None: the card, raising without one), as
    index.ts wires ZipkinService and KubernetesService into the realtime
    worker. Serve-only and simulator modes touch no mesh and get none;
    read-only mode keeps the clients for the startup sync handshake
    (index.ts:57-60) and skips the native library's build, since it
    ingests nothing. With `warm` the native library builds and the tick's
    device code loads here; main() passes warm=False and leaves both to
    the boot prewarm (core/prewarm.py)."""
    s = app_settings or Settings()
    zipkin = k8s = processor = None
    if not (s.simulator_mode or s.serve_only):
        from kmamiz_tpu_torch import native
        from kmamiz_tpu_torch.ingestion import KubernetesClient, ZipkinClient
        from kmamiz_tpu_torch.server.processor import DataProcessor

        if warm and not s.read_only_mode:
            native.available()  # the one-time build, off the request path
        zipkin = ZipkinClient(s.zipkin_url)
        if s.is_running_in_kubernetes:
            k8s = KubernetesClient.from_service_account(s.kube_api_host)
        else:
            k8s = KubernetesClient(s.kube_api_host)
        processor = DataProcessor(
            trace_source=zipkin.get_trace_list, k8s_source=k8s, device=device
        )
        if not s.read_only_mode:
            k8s.warm_up()  # the tick's fan-out processes, off the request path
            if warm:
                processor.warm_up()  # and its device code
    return AppContext.build(
        app_settings=s, processor=processor, zipkin_client=zipkin, k8s_client=k8s
    )


def build_router(ctx: AppContext, import_export: Optional[ImportExportHandler] = None) -> Router:
    """Register every handler's routes under /api/v{N} (Routes.ts:20-30),
    the simulation handler's in simulator mode."""
    router = Router(
        api_version=ctx.settings.api_version,
        static_dir=ctx.settings.static_dir,
        wasm_path=ctx.settings.wasm_path,
    )
    import_export = import_export or ImportExportHandler(ctx)
    graph = GraphHandler(ctx)
    data = DataHandler(ctx, import_export)
    handlers = [
        data,
        graph,
        SwaggerHandler(ctx),
        AlertHandler(ctx),
        ComparatorHandler(ctx, graph_handler=graph, data_handler=data),
        ConfigurationHandler(ctx),
        HealthHandler(ctx),
        ModelHandler(ctx),
        TelemetryHandler(ctx),
    ]
    if ctx.settings.simulator_mode:
        handlers.append(SimulationHandler(ctx))
    for handler in handlers:
        router.add_handler(handler)
    for line in router.route_list:
        logger.debug("route %s", line)
    return router


class Application:
    """One instance: context + router + HTTP server + teardown."""

    def __init__(self, app_settings: Optional[Settings] = None, ctx: Optional[AppContext] = None) -> None:
        self.settings = app_settings or (ctx.settings if ctx is not None else Settings())
        self.ctx = ctx or AppContext.build(app_settings=self.settings)
        self.initializer = Initializer(self.ctx)
        self.import_export = ImportExportHandler(self.ctx)
        self.router: Optional[Router] = None
        self.server: Optional[ApiServer] = None

    def start_up(self) -> None:
        """Mode switch (index.ts:55-92)."""
        s = self.settings
        if s.is_running_in_kubernetes and self.ctx.k8s_client is not None:
            # ask the instance being replaced to flush first (index.ts:57-60)
            self.ctx.k8s_client.force_kmamiz_sync(
                s.service_port, s.api_version, simulator_mode=s.simulator_mode
            )
        if s.simulator_mode:
            logger.info("Starting in simulator mode.")
            self.initializer.simulation_server_startup()
        elif s.serve_only:
            logger.info("Serve-only mode; registering caches without schedules.")
            self.initializer.register_data_caches()
        else:
            aggregated = self.ctx.store.get_aggregated_data()
            if s.reset_endpoint_dependencies:
                self.initializer.force_recreate_endpoint_dependencies()
            self.initializer.production_server_startup()
            rl_data = self.ctx.cache.get("CombinedRealtimeData").get_data()
            if aggregated is None and (rl_data is None or not rl_data.to_json()):
                logger.info("Database is empty, running first-time setup.")
                try:  # index.ts:78-84: a failed backfill must not block startup
                    self.initializer.first_time_setup()
                except Exception:  # noqa: BLE001 - logged; startup goes on
                    logger.exception("Cannot run first time setup, skipping.")
        self.router = build_router(self.ctx, self.import_export)

    def listen(self, host: str = "0.0.0.0", port: Optional[int] = None) -> None:
        if self.router is None:
            raise RuntimeError("call start_up() first")
        self.server = ApiServer(
            self.router, host=host, port=port if port is not None else int(self.settings.port)
        )
        self.server.start()
        logger.info("API server listening on port %s", self.server.port)

    def tear_down(self) -> None:
        """Graceful exit: stop the schedules (a fire in progress finishes
        first), then flush every cache, or in simulator mode clear the
        store, which never keeps a simulation (index.ts:97-112)."""
        logger.info("Flushing caches to store before exit.")
        self.ctx.scheduler.stop()
        if not self.settings.read_only_mode and not self.settings.serve_only:
            if self.settings.simulator_mode:
                self.ctx.store.clear_database()
            else:
                self.ctx.dispatch.sync_all()
        if self.server:
            self.server.stop()


def main() -> None:
    """The application on the card, configured from the environment
    (config.Settings); SIGTERM or SIGINT tears it down (the schedules
    stopped, every cache flushed) and exits 0. KMAMIZ_COMPILE_CACHE_DIR
    (core/compile_cache.py) is where the libraries are looked up and
    built; after start_up the boot prewarm (core/prewarm.py,
    KMAMIZ_PREWARM) builds or loads them and warms the device code, by
    default on a thread of its own while /api/v1/health answers 503
    WARMING (the readinessProbe of deploy/kmamiz-tpu-torch.yaml)."""
    from kmamiz_tpu_torch.core import compile_cache, prewarm
    from kmamiz_tpu_torch.core import logger as klog

    logging.basicConfig(level=logging.INFO)
    klog.configure()  # LOG_LEVEL (Logger.ts:22-30)
    compile_cache.enable_from_env()
    app = Application(ctx=build_production_context(warm=False))
    app.start_up()
    # read-only mode ingests nothing and warms nothing, as before
    processor = None if app.settings.read_only_mode else app.ctx.processor
    prewarm.boot_prewarm_from_env(processor)
    app.listen()

    def _exit(signum, frame):
        app.tear_down()
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _exit)
    signal.signal(signal.SIGINT, _exit)
    signal.pause()


if __name__ == "__main__":
    main()
