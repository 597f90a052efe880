"""The assembled object graph of one instance, and its cache wiring.

Counterpart of kmamiz_tpu/server/initializer.py (KMamiz
src/services/Initializer.ts), reduced to what the port's handlers and
realtime path read: the settings, the Data Processor, the cache registry,
the label refresh and the realtime operator. `Initializer` registers the
caches the graph routes read, wired as the JAX package wires them, and
warm-starts the processor's graph from the dependency cache. The store,
the schedules and the other caches join it with the slices that need
them.

    ctx = AppContext(processor=DataProcessor(trace_source=...))
    Initializer(ctx).register_data_caches()
    ctx.operator.retrieve_realtime_data()  # one realtime tick
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional

from kmamiz_tpu_torch.config import Settings
from kmamiz_tpu_torch.server.cache import Cacheable, DataCache
from kmamiz_tpu_torch.server.cacheables import (
    CCombinedRealtimeData,
    CEndpointDataType,
    CEndpointDependencies,
    CLabeledEndpointDependencies,
    CLabelMapping,
    CUserDefinedLabel,
)
from kmamiz_tpu_torch.server.operator import ServiceOperator
from kmamiz_tpu_torch.server.processor import DataProcessor
from kmamiz_tpu_torch.server.service_utils import ServiceUtils

logger = logging.getLogger("kmamiz_tpu_torch.initializer")


@dataclass
class AppContext:
    settings: Settings = field(default_factory=Settings)
    processor: Optional[DataProcessor] = None
    cache: DataCache = field(default_factory=DataCache)
    service_utils: Optional[ServiceUtils] = None
    operator: Optional[ServiceOperator] = None

    def __post_init__(self) -> None:
        if self.service_utils is None:
            self.service_utils = ServiceUtils(self.cache)
        if self.operator is None:
            self.operator = ServiceOperator(self.cache, self.service_utils, processor=self.processor)


class Initializer:
    def __init__(self, ctx: AppContext) -> None:
        self._ctx = ctx

    def make_data_caches(self) -> List[Cacheable]:
        ctx = self._ctx
        return [
            CLabelMapping(),
            CEndpointDataType(),
            CCombinedRealtimeData(),
            CEndpointDependencies(),
            CLabeledEndpointDependencies(
                get_label=lambda name: ctx.cache.get("LabelMapping").get_label(name),
                label_version=lambda: ctx.cache.get("LabelMapping").version,
            ),
            CUserDefinedLabel(),
        ]

    def register_data_caches(self) -> None:
        logger.info("Registering caches.")
        self._ctx.cache.register(self.make_data_caches())

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
