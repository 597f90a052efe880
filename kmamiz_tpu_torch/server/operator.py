"""The realtime schedule's in-process path.

Counterpart of kmamiz_tpu/server/operator.py (KMamiz
src/services/ServiceOperator.ts), reduced to the realtime tick: a DP
request built from the dependency cache goes to the in-process
`DataProcessor` on its device, and the response is merged into the
caches the graph routes read. There is no external-DP branch and no
fallback: a failing tick raises to the caller. Kubernetes replica counts
and the aggregation schedule wait for the port's cluster source and
store.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from kmamiz_tpu_torch.core.urls import get_params_from_url
from kmamiz_tpu_torch.domain.combined import CombinedRealtimeDataList
from kmamiz_tpu_torch.domain.endpoint_data_type import EndpointDataType
from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
from kmamiz_tpu_torch.server.cache import DataCache
from kmamiz_tpu_torch.server.service_utils import ServiceUtils

logger = logging.getLogger("kmamiz_tpu_torch.operator")

REALTIME_LOOK_BACK_MS = 30_000  # ServiceOperator.ts:295


class ServiceOperator:
    #: registration older than this is an orphan (its tick never reached
    #: post_retrieve)
    LATENCY_MAP_TTL_MS = 10 * 60 * 1000

    def __init__(
        self,
        cache: DataCache,
        service_utils: ServiceUtils,
        processor: Optional[object] = None,
        now_ms: Callable[[], float] = lambda: time.time() * 1000,
    ) -> None:
        self._cache = cache
        self._service_utils = service_utils
        self._processor = processor
        self._now_ms = now_ms
        # per-tick latency bookkeeping (ServiceOperator.ts:43,76-81)
        self._latency_map: Dict[str, float] = {}
        # a realtime merge is one compound update of several caches
        self._cache_update_lock = threading.Lock()

    def retrieve_realtime_data(self) -> None:
        """One realtime tick (ServiceOperator.ts:282-307)."""
        t = self._now_ms()
        unique_id = f"{random.randrange(16 ** 4):04x}"
        cutoff = t - self.LATENCY_MAP_TTL_MS
        if any(v < cutoff for v in self._latency_map.values()):
            self._latency_map = {k: v for k, v in self._latency_map.items() if v >= cutoff}
        self._latency_map[unique_id] = t
        logger.debug("Running realtime schedule [%s]", unique_id)

        existing_dep = self._cache.get("EndpointDependencies").get_data()
        self.retrieve(
            {
                "lookBack": REALTIME_LOOK_BACK_MS,
                "uniqueId": unique_id,
                "time": int(t),
                "existingDep": existing_dep.to_json() if existing_dep else None,
            }
        )

    def retrieve(self, request: dict) -> None:
        """The in-process Data Processor: the reference's worker thread."""
        if self._processor is None:
            logger.warning("no in-process DataProcessor configured, tick dropped")
            return
        self.post_retrieve(self._processor.collect(request))

    def post_retrieve(self, response: dict) -> None:
        """Merge a DP response into the caches (ServiceOperator.ts:66-89);
        the first schema of each datatype gets its query params parsed
        from the endpoint URL (ServiceOperator.ts:267-271)."""
        log = response.get("log")
        if log:
            logger.debug("DP: %s", log)
        start = self._latency_map.pop(response.get("uniqueId", ""), None)
        if start is not None:
            logger.debug("Realtime schedule done, in %.0fms", self._now_ms() - start)

        datatypes = response.get("datatype", [])
        for d in datatypes:
            url = d["uniqueEndpointName"].split("\t")[-1]
            if d.get("schemas"):
                d["schemas"][0]["requestParams"] = get_params_from_url(url)

        self.realtime_update_cache(
            CombinedRealtimeDataList(response.get("combined", [])),
            EndpointDependencies(response.get("dependencies", [])),
            [EndpointDataType(d) for d in datatypes],
        )

    def realtime_update_cache(
        self,
        data: CombinedRealtimeDataList,
        dep: EndpointDependencies,
        data_types: List[EndpointDataType],
    ) -> None:
        """ServiceOperator.ts:309-339, without the replica refresh."""
        with self._cache_update_lock:
            self._cache.get("CombinedRealtimeData").set_data(data)
            self._cache.get("EndpointDependencies").set_data(dep)
            self._cache.get("EndpointDataType").set_data(data_types)
            self._service_utils.update_label()
            self._cache.get("LabeledEndpointDependencies").set_data(dep)
