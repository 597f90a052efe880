"""Label-map refresh and labeled historical/aggregated retrieval.

Equivalent of KMamiz src/services/ServiceUtils.ts: user label rules
are applied first, unknown endpoints are guessed against them, the remaining
endpoints get speculated labels, and the resulting map labels historical /
aggregated reads. Gap fill-in (ServiceUtils.ts:140-162) pads missing services
forward and backward through time so line charts have continuous series.

Unlike the reference's lazy singletons, everything here takes its
collaborators explicitly (cache registry + store) so tests and the simulator
can run many isolated instances.

A copy of kmamiz_tpu/server/service_utils.py, importing the port's
modules, whose label refresh reuses each service's label mapping while
that service's datatypes are unchanged (`_label_mapping`).
"""
from __future__ import annotations

from typing import List, Optional

from kmamiz_tpu_torch.analytics.endpoint_utils import (
    create_endpoint_label_mapping,
    guess_and_merge_endpoints,
)
from kmamiz_tpu_torch.domain.aggregated import AggregatedData
from kmamiz_tpu_torch.domain.historical import HistoricalData
from kmamiz_tpu_torch.server.cache import DataCache
from kmamiz_tpu_torch.server.storage import Store


class ServiceUtils:
    def __init__(
        self,
        cache: DataCache,
        store: Store,
        now_ms: Optional[object] = None,
        unbounded_reads: bool = False,
        keep_upper_bound: bool = False,
    ) -> None:
        import time

        self._cache = cache
        self._store = store
        self._now_ms = now_ms or (lambda: time.time() * 1000)
        # read-only / simulator modes read without the 30-day retention
        # window (MongoOperator.ts: $gte new Date(0)); read-only ALSO
        # keeps the $lte now upper bound — only SimulatorMode is
        # unbounded upward
        self._unbounded_reads = unbounded_reads
        self._keep_upper_bound = keep_upper_bound
        # the label mapping of each service: (its datatypes' key, mapping)
        self._label_memo: dict = {}

    # -- label mapping (ServiceUtils.ts:54-100) ------------------------------

    def update_label(self) -> None:
        label_mapping = self._cache.get("LabelMapping")
        data_type = self._cache.get("EndpointDataType")
        user_defined_label = self._cache.get("UserDefinedLabel")
        dependencies = self._cache.get("EndpointDependencies")
        labeled_dependencies = self._cache.get("LabeledEndpointDependencies")

        user_defined = user_defined_label.get_data()
        data_types = data_type.get_data()
        # the reference's `if (dataTypeData)` is ALWAYS truthy (getData
        # returns `|| []`, and an empty JS array is truthy): the rebuild
        # must run even with zero datatypes so user-defined label rules
        # alone can populate the mapping on a fresh or just-cleared
        # system
        if data_types is not None:
            preprocessed: dict = {}
            if user_defined:
                for rule in user_defined.get("labels", []):
                    if rule.get("block"):
                        continue
                    for sample in rule.get("samples", []):
                        preprocessed[sample] = rule["label"]
            preprocessed = guess_and_merge_endpoints(
                [d.to_json()["uniqueEndpointName"] for d in data_types],
                preprocessed,
            )

            label_map = self._label_mapping(
                [
                    d
                    for d in data_types
                    if d.to_json()["uniqueEndpointName"] not in preprocessed
                ]
            )
            label_map.update(preprocessed)

            label_mapping.set_data(
                label_map, user_defined_label.get_data(), dependencies.get_data()
            )

        dep = dependencies.get_data()
        if dep:
            labeled_dependencies.set_data(dep)

    def _label_mapping(self, data_types: list) -> dict:
        """create_endpoint_label_mapping over data_types, one service at a
        time, reusing a service's mapping while what the mapping reads of
        its datatypes is unchanged (_label_key): the mapping compares every
        pair of a service's endpoints and never groups across services. The
        services come in the order of their first datatype, as in one call
        over all, so the result (its order included) is that call's."""
        by_service: dict = {}
        for d in data_types:
            by_service.setdefault(d.to_json()["uniqueServiceName"], []).append(d)
        memo, label_map = {}, {}
        for service, dts in by_service.items():
            key = _label_key(dts)
            cached = self._label_memo.get(service)
            mapping = cached[1] if cached is not None and cached[0] == key else None
            if mapping is None:
                mapping = create_endpoint_label_mapping(dts)
            memo[service] = (key, mapping)
            label_map.update(mapping)
        self._label_memo = memo
        return label_map

    # -- labeled reads with gap fill (ServiceUtils.ts:102-139) ---------------

    def get_realtime_historical_data(
        self,
        namespace: Optional[str] = None,
        time_offset_ms: Optional[float] = None,
    ) -> List[dict]:
        """time_offset_ms is the API's notBefore: a look-back DURATION in
        ms (reference ServiceUtils.ts:102 passes it straight to
        MongoOperator's timeOffset, default 30 days)."""
        if self._unbounded_reads:
            # read-only: look back over the whole epoch but keep the
            # upper bound at now; simulator: fully unbounded
            window = self._now_ms() if self._keep_upper_bound else None
        else:
            window = (
                time_offset_ms if time_offset_ms is not None else 30 * 86_400_000
            )
        label_mapping = self._cache.get("LabelMapping")
        historical = label_mapping.label_historical_data(
            self._store.get_historical_data(
                namespace=namespace,
                time_offset_ms=window,
                now_ms=self._now_ms(),
            )
        )
        return self._fill_in_historical_data(historical)

    def get_realtime_aggregated_data(
        self,
        namespace: Optional[str] = None,
        time_offset_ms: Optional[float] = None,
    ) -> Optional[dict]:
        label_mapping = self._cache.get("LabelMapping")

        aggregated = self._store.get_aggregated_data(namespace)
        if not time_offset_ms:
            return (
                label_mapping.label_aggregated_data(aggregated)
                if aggregated
                else None
            )

        historical = self.get_realtime_historical_data(namespace, time_offset_ms)
        if not historical:
            return AggregatedData(aggregated).to_plain() if aggregated else None

        label_map = label_mapping.get_data()
        agg_list = [
            AggregatedData(HistoricalData(h).to_aggregated_data(label_map))
            for h in historical
        ]
        merged = agg_list[0]
        for nxt in agg_list[1:]:
            merged = merged.combine(nxt.to_json())
        return label_mapping.label_aggregated_data(merged.to_json())

    # -- gap fill-in (ServiceUtils.ts:140-188) -------------------------------

    @staticmethod
    def _fill_in_historical_data(historical: List[dict]) -> List[dict]:
        def fill_in(to: dict, from_: dict) -> None:
            have = {s["uniqueServiceName"] for s in to["services"]}
            to["services"] = to["services"] + [
                ServiceUtils._clean_historical_service_info(to["date"], s)
                for s in from_["services"]
                if s["uniqueServiceName"] not in have
            ]

        historical.sort(key=lambda h: h["date"])
        for i in range(1, len(historical)):
            fill_in(historical[i], historical[i - 1])
        for i in range(len(historical) - 2, -1, -1):
            fill_in(historical[i], historical[i + 1])
        return historical

    @staticmethod
    def _clean_historical_service_info(date: float, service_info: dict) -> dict:
        return {
            **service_info,
            "date": date,
            "endpoints": [
                {
                    **e,
                    "latencyCV": 0,
                    "requests": 0,
                    "requestErrors": 0,
                    "serverErrors": 0,
                }
                for e in service_info["endpoints"]
            ],
            "latencyCV": 0,
            "requestErrors": 0,
            "serverErrors": 0,
            "requests": 0,
            "risk": 0,
        }


_ROOT_INTERFACE = "interface Root {\n}"


def _label_key(data_types: list) -> tuple:
    """What create_endpoint_label_mapping reads of one service's
    datatypes: each endpoint's name and method in order, and per status
    the schema that has_matched_schema compares (the last of its status,
    as its status map keeps), its content types, and its interfaces with
    a missing one as the empty interface that _is_interface_matched takes
    it for. The order of the statuses does not enter the match, nor do a
    schema's time and samples: a realtime tick re-stamps every schema it
    merges and reorders the statuses by time, and leaves the mapping as
    it was."""
    key = []
    for d in data_types:
        j = d.to_json()
        by_status = {s["status"]: s for s in j["schemas"]}
        key.append(
            (
                j["uniqueEndpointName"],
                j["method"],
                tuple(
                    sorted(
                        (
                            status,
                            s.get("requestContentType"),
                            s.get("responseContentType"),
                            _ROOT_INTERFACE if s.get("requestSchema") is None else s["requestSchema"],
                            _ROOT_INTERFACE if s.get("responseSchema") is None else s["responseSchema"],
                        )
                        for status, s in by_status.items()
                    )
                ),
            )
        )
    return tuple(key)
