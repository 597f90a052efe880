"""Orchestrator for the realtime / aggregation schedules.

Equivalent of KMamiz src/services/ServiceOperator.ts. The
reference's realtime tick posts a DP request either to the external Rust
service (HTTP) or a Node worker thread (postMessage); here the primary
backend is the in-process `DataProcessor` on its device (the tick runs on
the scheduler's job thread so the API server never blocks), with an
optional external DP URL tried first when configured — preserving the
reference's fallback semantics (ServiceOperator.ts:300-306) with the roles
reversed-able via configuration.

Aggregation (ServiceOperator.ts:108-183): combined realtime data rolls up
into minute-bucketed historical data, risk is re-scored over a merged
30-minute look-back window, and the running aggregate is combined and
saved; the realtime cache is then reset.

Simulator mode (ServiceOperator.ts:186-245,341-384) writes the
simulator's static data into the caches and replays its per-slot
combined data through an aggregation that keeps its historical data in
the SimulatedHistoricalData cache. The external-DP fallback counts as
`dpFallback` in resilience/metrics.py.
"""
from __future__ import annotations

import gzip
import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from kmamiz_tpu_torch.analytics import risk as risk_analyzer
from kmamiz_tpu_torch.core.urls import get_params_from_url
from kmamiz_tpu_torch.domain.aggregated import AggregatedData
from kmamiz_tpu_torch.domain.combined import CombinedRealtimeDataList
from kmamiz_tpu_torch.domain.endpoint_data_type import EndpointDataType
from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
from kmamiz_tpu_torch.domain.historical import HistoricalData
from kmamiz_tpu_torch.resilience import metrics as res_metrics
from kmamiz_tpu_torch.server.cache import DataCache
from kmamiz_tpu_torch.server.service_utils import ServiceUtils
from kmamiz_tpu_torch.server.storage import Store
from kmamiz_tpu_torch.simulator.slot_metrics import parse_slot_key

logger = logging.getLogger("kmamiz_tpu_torch.operator")

RISK_LOOK_BACK_TIME_MS = 1_800_000  # ServiceOperator.ts:37
REALTIME_LOOK_BACK_MS = 30_000  # ServiceOperator.ts:295
DP_TIMEOUT_S = 30.0  # the reference's fixed external-DP timeout


class ServiceOperator:
    def __init__(
        self,
        cache: DataCache,
        store: Store,
        service_utils: ServiceUtils,
        processor: Optional[object] = None,
        external_dp_url: str = "",
        k8s_client: Optional[object] = None,
        now_ms: Callable[[], float] = lambda: time.time() * 1000,
    ) -> None:
        self._cache = cache
        self._store = store
        self._service_utils = service_utils
        self._processor = processor
        self._external_dp_url = external_dp_url
        self._k8s = k8s_client
        self._now_ms = now_ms
        # per-tick latency bookkeeping (ServiceOperator.ts:43,76-81)
        self._latency_map: Dict[str, float] = {}
        # The realtime and aggregation jobs run on separate scheduler
        # threads (the reference interleaves them on one event loop); this
        # lock keeps a realtime cache merge from landing between
        # aggregation's snapshot and its reset, where it would be wiped
        # and — the trace ids already being marked processed — lost for good.
        self._cache_update_lock = threading.Lock()

    # -- realtime schedule (ServiceOperator.ts:282-307) ----------------------

    #: registration older than this is an orphan (its tick never reached
    #: post_retrieve: dropped tick, DP error, mismatched uniqueId echo)
    LATENCY_MAP_TTL_MS = 10 * 60 * 1000

    def retrieve_realtime_data(self) -> None:
        t = self._now_ms()
        unique_id = f"{random.randrange(16 ** 4):04x}"
        # prune orphans before registering: post_retrieve is the only
        # other remover, and a tick that never reaches it (dropped /
        # failed / id mismatch) would otherwise leak one entry per 5 s
        # tick forever
        cutoff = t - self.LATENCY_MAP_TTL_MS
        if any(v < cutoff for v in self._latency_map.values()):
            self._latency_map = {
                k: v for k, v in self._latency_map.items() if v >= cutoff
            }
        self._latency_map[unique_id] = t
        logger.debug("Running realtime schedule [%s]", unique_id)

        existing_dep = self._cache.get("EndpointDependencies").get_data()
        request = {
            "lookBack": REALTIME_LOOK_BACK_MS,
            "uniqueId": unique_id,
            "time": int(t),
            "existingDep": existing_dep,
        }
        if self._external_dp_url:
            try:
                self.external_retrieve(
                    {**request, "existingDep": existing_dep.to_json() if existing_dep else None}
                )
                return
            except Exception:  # noqa: BLE001 - any DP failure falls back
                # the reference's worker fallback (ServiceOperator.ts:300-306)
                res_metrics.incr("dpFallback")
                logger.debug(
                    "External data processor failed, fallback to in-process.",
                    exc_info=True,
                )
        self.retrieve(request)

    def retrieve(self, request: dict) -> None:
        """The in-process Data Processor: the reference's worker thread,
        with the dependencies handed over as objects (collect)."""
        if self._processor is None:
            logger.warning("no in-process DataProcessor configured, tick dropped")
            return
        self.post_retrieve(self._processor.collect(request, objects=True))

    def external_retrieve(self, request: dict) -> None:
        """HTTP POST to an external DP service (ServiceOperator.ts:253-280).

        Hardened (resilience pillar 2): the request runs under the
        shared `external-dp` circuit breaker with jittered-backoff
        retries on transport errors (OSError covers URLError/HTTPError/
        timeouts). A down DP trips the breaker after N consecutive
        failures, after which ticks skip straight to the in-process
        fallback without waiting out the timeout; retrying a POST is
        safe because the DP server's encode memo is keyed on the
        request's uniqueId and the graph edge store merges by set union.
        The timeout is the reference's DP_TIMEOUT_S (the JAX package's
        KMAMIZ_DP_TIMEOUT_S knob is not ported)."""
        from kmamiz_tpu_torch.resilience import Retrier, get_breaker

        body = json.dumps(request).encode()
        req = urllib.request.Request(
            self._external_dp_url,
            data=body,
            method="POST",
            headers={
                "Content-Type": "application/json",
                "Accept-Encoding": "gzip",
            },
        )

        def _post() -> dict:
            with urllib.request.urlopen(req, timeout=DP_TIMEOUT_S) as res:
                if res.status != 200:
                    raise urllib.error.HTTPError(
                        self._external_dp_url,
                        res.status,
                        "bad status",
                        res.headers,
                        None,
                    )
                raw = res.read()
                if res.headers.get("Content-Encoding") == "gzip":
                    raw = gzip.decompress(raw)
            return json.loads(raw)

        breaker = get_breaker("external-dp")
        retrier = Retrier("external-dp", retry_on=(OSError,))
        self.post_retrieve(retrier.call(breaker.call, _post))

    def post_retrieve(self, response: dict) -> None:
        """Merge a DP response into the caches (ServiceOperator.ts:66-89).

        Mirrors externalRetrieve's requestParams re-derivation
        (ServiceOperator.ts:267-271): the first schema of each datatype gets
        its query params parsed from the endpoint URL.
        """
        log = response.get("log")
        if log:
            logger.debug("DP: %s", log)

        unique_id = response.get("uniqueId", "")
        start = self._latency_map.pop(unique_id, None)
        if start is not None:
            logger.debug(
                "Realtime schedule [%s] done, in %.0fms",
                unique_id,
                self._now_ms() - start,
            )

        datatypes = response.get("datatype", [])
        for d in datatypes:
            url = d["uniqueEndpointName"].split("\t")[-1]
            if d.get("schemas"):
                d["schemas"][0]["requestParams"] = get_params_from_url(url)

        dependencies = response.get("dependencies", [])
        self.realtime_update_cache(
            CombinedRealtimeDataList(response.get("combined", [])),
            dependencies.handed_over()
            if isinstance(dependencies, EndpointDependencies)
            else EndpointDependencies(dependencies),
            [EndpointDataType(d) for d in datatypes],
        )

    def realtime_update_cache(
        self,
        data: CombinedRealtimeDataList,
        dep: EndpointDependencies,
        data_types: List[EndpointDataType],
    ) -> None:
        """ServiceOperator.ts:309-339."""
        with self._cache_update_lock:
            self._realtime_update_cache_locked(data, dep, data_types)

    def _realtime_update_cache_locked(
        self,
        data: CombinedRealtimeDataList,
        dep: EndpointDependencies,
        data_types: List[EndpointDataType],
    ) -> None:
        self._cache.get("CombinedRealtimeData").set_data(data)
        self._cache.get("EndpointDependencies").set_data(dep)

        if self._k8s is not None:
            combined = self._cache.get("CombinedRealtimeData").get_data()
            namespaces = (
                combined.get_containing_namespaces() if combined else set()
            )
            try:
                self._cache.get("ReplicaCounts").set_data(
                    self._k8s.get_replicas(namespaces)
                )
            except Exception:  # noqa: BLE001 - replica refresh is best-effort
                logger.debug("replica refresh failed", exc_info=True)

        self._cache.get("EndpointDataType").set_data(data_types)
        # update_label relabels the dependency view from the cache just set
        # (dep, trimmed), which is what the reference's following
        # LabeledEndpointDependencies.set_data(dep) writes again: the port
        # does that once
        self._service_utils.update_label()

    # -- aggregation schedule (ServiceOperator.ts:108-183) -------------------

    def _get_data_for_aggregate(self):
        combined = self._cache.get("CombinedRealtimeData").get_data()
        dependencies = self._cache.get("LabeledEndpointDependencies").get_data()
        if not combined or not dependencies:
            logger.warning(
                "Cannot create AggregatedData from empty cache, "
                "skipping data aggregation"
            )
            return None
        return combined, dependencies

    def create_historical_and_aggregated_data(
        self, create_time_ms: Optional[float] = None
    ) -> None:
        with self._cache_update_lock:
            info = self._get_data_for_aggregate()
            if not info:
                return
            combined, dependencies = info
            create_time = (
                create_time_ms if create_time_ms is not None else self._now_ms()
            )

            service_dependencies = dependencies.to_service_dependencies()
            replicas = self._cache.get("ReplicaCounts").get_data() or []
            rl_data = combined.adjust_timestamp(create_time)

            historical = self._create_historical_data(
                create_time, rl_data, service_dependencies, replicas
            )
            if not historical:
                return

            self._combine_and_save_aggregate(historical.to_aggregated_data())
            self._cache.get("CombinedRealtimeData").reset()

    def _create_historical_data(
        self,
        now_ts_ms: float,
        rl_data: CombinedRealtimeDataList,
        service_dependencies: List[dict],
        replicas: List[dict],
    ) -> Optional[HistoricalData]:
        buckets = rl_data.to_historical_data(service_dependencies, replicas)
        if not buckets:
            return None
        historical = buckets[0]

        look_back_cache = self._cache.get("LookBackRealtimeData")
        look_back = look_back_cache.get_data()
        merged = rl_data
        for rows in look_back.values():
            merged = merged.combine_with(rows)
        look_back_cache.set_data({int(now_ts_ms): rl_data})

        result = HistoricalData(historical).update_risk_value(
            risk_analyzer.realtime_risk(
                merged.to_json(), service_dependencies, replicas
            )
        )
        self._store.insert_many("HistoricalData", [result.to_json()])
        return result

    def _combine_and_save_aggregate(self, aggregated: dict) -> None:
        prev_raw = self._store.get_aggregated_data()
        new_agg = AggregatedData(aggregated)
        if prev_raw:
            prev = AggregatedData(prev_raw)
            new_agg = prev.combine(aggregated)
            if prev_raw.get("_id"):
                new_agg.to_json()["_id"] = prev_raw["_id"]
        self._store.save("AggregatedData", new_agg.to_json())

    # -- simulator variants (ServiceOperator.ts:186-245,341-384) -------------

    def create_simulated_historical_and_aggregated_data(self) -> None:
        with self._cache_update_lock:
            info = self._get_data_for_aggregate()
            if not info:
                return
            combined, dependencies = info
            service_dependencies = dependencies.to_service_dependencies()
            replicas = self._cache.get("ReplicaCounts").get_data() or []

            buckets = combined.to_historical_data(service_dependencies, replicas)
            if not buckets:
                return
            result = HistoricalData(buckets[0]).update_risk_value(
                risk_analyzer.realtime_risk(combined.to_json(), service_dependencies, replicas)
            )
            self._cache.get("SimulatedHistoricalData").insert_one(result)

            self._combine_and_save_aggregate(result.to_aggregated_data())
            self._cache.get("CombinedRealtimeData").reset()

    def update_static_simulate_data_to_cache(
        self,
        dependencies: List[dict],
        data_types: List[EndpointDataType],
        replica_counts: List[dict],
    ) -> None:
        dep = EndpointDependencies(dependencies)
        with self._cache_update_lock:
            self._cache.get("EndpointDependencies").set_data(dep)
            self._cache.get("ReplicaCounts").set_data(replica_counts)
            self._cache.get("EndpointDataType").set_data(data_types)
            self._service_utils.update_label()
            self._cache.get("LabeledEndpointDependencies").set_data(dep)

    def update_dynamic_simulate_data(self, realtime_data_map: Dict[str, List[dict]]) -> None:
        """Replay per-slot combined data in 'day-hour-minute' order
        (ServiceOperator.ts:363-384)."""
        for _, rows in sorted(realtime_data_map.items(), key=lambda kv: parse_slot_key(kv[0])):
            if rows:
                self._cache.get("CombinedRealtimeData").set_data(CombinedRealtimeDataList(rows))
                self.create_simulated_historical_and_aggregated_data()
