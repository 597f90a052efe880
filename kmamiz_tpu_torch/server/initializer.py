"""System wiring and startup sequences.

Counterpart of kmamiz_tpu/server/initializer.py (KMamiz
src/services/Initializer.ts): builds the cache registry (the eleven
production caches, plus the online forecast state's when a processor owns
it, plus the simulator's two in simulator mode), loads base data from the store, refreshes the label map,
warm-starts the processor's graph from the dependency cache, and
registers the three schedules (aggregation / realtime / dispatch).
`first_time_setup` backfills 30 days of traces from Zipkin when the
store is empty (Initializer.ts:40-101); `force_recreate_endpoint_dependencies`
rebuilds the dependency graph from a 30-day trace pull
(Initializer.ts:103-123).

`AppContext.build()` assembles the object graph the way the JAX package
does (the store from `settings.storage_uri`). A context built directly,
`AppContext(processor=DataProcessor(...))`, fills what it is not given:
a MemoryStore, the cache registry, the operator, the dispatch rotation
and a scheduler that is not started.

    ctx = AppContext.build(app_settings=settings, processor=proc)
    Initializer(ctx).production_server_startup()  # caches, warm start, schedules

The JAX package's compile prewarm (core/programs.py) has no counterpart:
PyTorch compiles nothing per shape.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import List, Optional

from kmamiz_tpu_torch.config import Settings
from kmamiz_tpu_torch.domain.traces import Traces
from kmamiz_tpu_torch.server.cache import Cacheable, DataCache
from kmamiz_tpu_torch.server.cacheables import (
    CCombinedRealtimeData,
    CEndpointDataType,
    CEndpointDependencies,
    CLabeledEndpointDependencies,
    CLabelMapping,
    CLookBackRealtimeData,
    CModelHistoryState,
    CReplicas,
    CSimulatedHistoricalData,
    CTaggedDiffData,
    CTaggedInterfaces,
    CTaggedSimulationYAML,
    CTaggedSwaggers,
    CUserDefinedLabel,
)
from kmamiz_tpu_torch.server.dispatch import DispatchStorage
from kmamiz_tpu_torch.server.operator import ServiceOperator
from kmamiz_tpu_torch.server.scheduler import Scheduler
from kmamiz_tpu_torch.server.service_utils import ServiceUtils
from kmamiz_tpu_torch.server.storage import MemoryStore, Store, store_from_uri

logger = logging.getLogger("kmamiz_tpu_torch.initializer")


@dataclass
class AppContext:
    """The assembled object graph of one instance."""

    settings: Settings = field(default_factory=Settings)
    processor: Optional[object] = None
    store: Optional[Store] = None
    cache: DataCache = field(default_factory=DataCache)
    service_utils: Optional[ServiceUtils] = None
    operator: Optional[ServiceOperator] = None
    dispatch: Optional[DispatchStorage] = None
    scheduler: Optional[Scheduler] = None
    zipkin_client: Optional[object] = None
    k8s_client: Optional[object] = None
    extra: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        s = self.settings
        if self.store is None:
            self.store = MemoryStore()
        if self.service_utils is None:
            self.service_utils = ServiceUtils(
                self.cache,
                self.store,
                unbounded_reads=s.read_only_mode or s.simulator_mode,
                # read-only keeps $lte now like the reference; only the
                # simulator is unbounded upward (MongoOperator.ts:55-66)
                keep_upper_bound=s.read_only_mode and not s.simulator_mode,
            )
        if self.operator is None:
            self.operator = ServiceOperator(
                self.cache,
                self.store,
                self.service_utils,
                processor=self.processor,
                external_dp_url=s.external_data_processor,
                k8s_client=self.k8s_client,
            )
        if self.dispatch is None:
            self.dispatch = DispatchStorage(self.cache)
        if self.scheduler is None:
            self.scheduler = Scheduler(tz=s.timezone)

    @classmethod
    def build(
        cls,
        app_settings: Optional[Settings] = None,
        store: Optional[Store] = None,
        processor: Optional[object] = None,
        zipkin_client: Optional[object] = None,
        k8s_client: Optional[object] = None,
    ) -> "AppContext":
        """The JAX package's assembly: the store from
        settings.storage_uri unless one is given."""
        s = app_settings or Settings()
        return cls(
            settings=s,
            processor=processor,
            store=store if store is not None else store_from_uri(s.storage_uri),
            zipkin_client=zipkin_client,
            k8s_client=k8s_client,
        )


class Initializer:
    def __init__(self, ctx: AppContext) -> None:
        self._ctx = ctx

    # -- cache registration (Initializer.ts:125-147) -------------------------

    def make_data_caches(self) -> List[Cacheable]:
        ctx = self._ctx
        sim = ctx.settings.simulator_mode
        store = ctx.store
        caches: List[Cacheable] = [
            CLabelMapping(),
            CEndpointDataType(store=store, simulator_mode=sim),
            CCombinedRealtimeData(store=store, simulator_mode=sim),
            CEndpointDependencies(store=store, simulator_mode=sim),
            CReplicas(
                fetch_replicas=(
                    (lambda: ctx.k8s_client.get_replicas_all())
                    if ctx.k8s_client is not None
                    else None
                ),
                read_only=ctx.settings.read_only_mode,
            ),
            CTaggedInterfaces(store=store, simulator_mode=sim),
            CTaggedSwaggers(store=store, simulator_mode=sim),
            CTaggedDiffData(store=store, simulator_mode=sim),
            CLabeledEndpointDependencies(
                get_label=lambda name: ctx.cache.get("LabelMapping").get_label(name),
                label_version=lambda: ctx.cache.get("LabelMapping").version,
            ),
            CUserDefinedLabel(store=store, simulator_mode=sim),
            CLookBackRealtimeData(store=store, simulator_mode=sim),
        ]
        # the online forecast state persists only when a processor owns it
        if ctx.processor is not None and hasattr(ctx.processor, "snapshot_history"):
            caches.append(
                CModelHistoryState(store=store, processor=ctx.processor, simulator_mode=sim)
            )
        if sim:
            caches.append(CTaggedSimulationYAML())
            caches.append(CSimulatedHistoricalData())
        return caches

    def register_data_caches(self) -> None:
        logger.info("Registering caches.")
        self._ctx.cache.register(self.make_data_caches())

    # -- startup (Initializer.ts:149-178) ------------------------------------

    def warm_start(self) -> int:
        """Load the processor's graph from the dependency cache (after a
        restart the graph is empty while the cache holds the records).
        Returns the number of records loaded."""
        ctx = self._ctx
        if ctx.processor is None:
            return 0
        dependencies = ctx.cache.get("EndpointDependencies").get_data()
        if not dependencies:
            return 0
        records = dependencies.to_json()
        ctx.processor.graph.load_dependencies(records)
        logger.info("Warm-started the graph from %d dependency records.", len(records))
        return len(records)

    def production_server_startup(self) -> None:
        """Register and load the caches, refresh the labels, warm-start the
        graph, then (unless read-only) register and start the three
        schedules. The realtime tick is the processor's collect, under its
        tick lock like the DP server's POST /."""
        ctx = self._ctx
        self.register_data_caches()

        logger.info("Loading data into cache.")
        ctx.cache.load_base_data()
        ctx.service_utils.update_label()
        self.warm_start()

        if ctx.settings.read_only_mode:
            logger.info("Readonly mode enabled, skipping schedule registration.")
            return

        logger.info("Setting up scheduled tasks.")
        ctx.scheduler.register(
            "aggregation",
            ctx.settings.aggregate_interval,
            ctx.operator.create_historical_and_aggregated_data,
        )
        ctx.scheduler.register(
            "realtime",
            ctx.settings.realtime_interval,
            ctx.operator.retrieve_realtime_data,
        )
        ctx.scheduler.register("dispatch", ctx.settings.dispatch_interval, ctx.dispatch.sync)
        ctx.scheduler.start()

    def simulation_server_startup(self) -> None:
        self.register_data_caches()

    # -- first-time setup (Initializer.ts:40-101) ----------------------------

    def first_time_setup(self) -> None:
        ctx = self._ctx
        if ctx.zipkin_client is None:
            logger.info("No Zipkin client; skipping first-time setup.")
            return

        now = time.time() * 1000
        today = int(now - (now % 86_400_000))

        # the device-graph backfill rides the uncapped streaming route:
        # page fetch and native parse of page k+1 overlap page k's merge
        # (processor.ingest_from_zipkin); the host-domain caches below
        # follow the reference's capped path
        if ctx.processor is not None:
            summary = ctx.processor.ingest_from_zipkin(ctx.zipkin_client, 86_400_000 * 30, now)
            logger.info(
                "device-graph backfill: %d spans / %d traces in %.0f ms",
                summary["spans"],
                summary["traces"],
                summary["ms"],
            )

        traces = Traces(ctx.zipkin_client.get_trace_list(86_400_000 * 30, today))

        dependencies = traces.to_endpoint_dependencies().trim()
        replicas: List[dict] = []
        if ctx.k8s_client is not None:
            for ns in ctx.k8s_client.get_namespaces():
                replicas.extend(ctx.k8s_client.get_replicas_from_pod_list(ns))

        realtime = traces.to_realtime_data(replicas).to_combined_realtime_data()
        if realtime.to_json():
            from kmamiz_tpu_torch.domain.aggregated import AggregatedData
            from kmamiz_tpu_torch.domain.historical import HistoricalData

            historical = realtime.to_historical_data(
                dependencies.to_service_dependencies(), replicas
            )
            aggregated = HistoricalData(
                {"date": now, "services": [s for h in historical for s in h["services"]]}
            ).to_aggregated_data()
            ctx.store.save("AggregatedData", AggregatedData(aggregated).to_json())
            ctx.store.insert_many("HistoricalData", historical)

        today_traces = Traces(ctx.zipkin_client.get_trace_list(int(now - today)))
        ctx.cache.get("CombinedRealtimeData").set_data(
            today_traces.to_realtime_data(replicas).to_combined_realtime_data()
        )

        merged = dependencies.combine_with(today_traces.to_endpoint_dependencies())
        ctx.cache.get("EndpointDependencies").set_data(merged)
        ctx.cache.get("LabeledEndpointDependencies").set_data(merged)

    # -- dependency rebuild (Initializer.ts:103-123) -------------------------

    def force_recreate_endpoint_dependencies(self) -> None:
        ctx = self._ctx
        if ctx.zipkin_client is None:
            return
        traces = Traces(ctx.zipkin_client.get_trace_list(86_400_000 * 30))
        dependencies = traces.to_endpoint_dependencies().trim()
        ctx.store.clear_collection("EndpointDependencies")
        ctx.store.insert_many("EndpointDependencies", dependencies.to_json())
        ctx.cache.get("EndpointDependencies").set_data(dependencies)
        ctx.cache.get("LabeledEndpointDependencies").set_data(dependencies)
