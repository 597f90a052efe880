"""The Cacheable subclasses (KMamiz src/classes/Cacheable/*).

Each cache mirrors its reference twin's merge/filter/label behavior; the
store-backed ones get init (load) and sync (replace-all flush) hooks wired
to the pluggable Store instead of Mongoose models.

A copy of kmamiz_tpu/server/cacheables.py. The simulator's two caches
(TaggedSimulationYAML, SimulatedHistoricalData) live in memory only.
CModelHistoryState persists the processor's online forecast state
through snapshot_history / restore_history.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from kmamiz_tpu_torch.analytics.endpoint_utils import guess_and_merge_endpoints
from kmamiz_tpu_torch.core.urls import explode_url
from kmamiz_tpu_torch.domain.combined import CombinedRealtimeDataList
from kmamiz_tpu_torch.domain.endpoint_data_type import EndpointDataType
from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
from kmamiz_tpu_torch.domain.historical import HistoricalData
from kmamiz_tpu_torch.server.cache import Cacheable
from kmamiz_tpu_torch.server.storage import Store

RISK_LOOK_BACK_TIME_MS = 30 * 60 * 1000  # ServiceOperator.RISK_LOOK_BACK_TIME


def _now_ms() -> float:
    return time.time() * 1000


def _snap(getter, to_docs):
    """One-read snapshot closure for sync hooks: `getter() and then
    getter().to_json()` reads the cache twice, and the aggregation
    thread's reset() landing between the reads turns the flush into an
    AttributeError that silently skips the collection."""
    def fn():
        data = getter()
        return to_docs(data) if data else None

    return fn


def _replace_all_sync(store: Store, collection: str, docs_fn: Callable[[], list]):
    def sync() -> None:
        docs = docs_fn()
        if docs is None:
            return
        # ids-only read: the rotation needs no document bodies, so it
        # skips the boundary validation walk entirely — and it still
        # purges documents the read path has quarantined
        old_ids = store.find_ids(collection)
        # strip _id so re-synced docs get fresh ids — otherwise docs loaded
        # from this store would be upserted under their old ids and then
        # deleted as "old", wiping the collection
        store.insert_many(
            collection,
            [{k: v for k, v in d.items() if k != "_id"} for d in docs],
        )
        store.delete_many(collection, old_ids)

    return sync


class CCombinedRealtimeData(Cacheable):
    unique_name = "CombinedRealtimeData"

    def __init__(
        self,
        init_data: Optional[List[dict]] = None,
        store: Optional[Store] = None,
        simulator_mode: bool = False,
    ) -> None:
        super().__init__(
            self.unique_name,
            CombinedRealtimeDataList(init_data) if init_data else None,
        )
        if store:
            self._set_init(
                lambda: self.set_data(
                    CombinedRealtimeDataList(store.find_all("CombinedRealtimeData"))
                ),
                simulator_mode,
            )
            self._set_sync(
                _replace_all_sync(
                    store,
                    "CombinedRealtimeData",
                    _snap(self.get_data, lambda d: d.to_json()),
                ),
                simulator_mode,
            )

    def set_data(self, update: CombinedRealtimeDataList, *args: Any) -> None:
        update = CombinedRealtimeDataList(
            [r for r in update.to_json() if r.get("service")]
        )
        data = Cacheable.get_data(self)
        Cacheable.set_data(self, data.combine_with(update) if data else update)

    def reset(self) -> None:
        self.clear()

    def get_data(self, namespace: Optional[str] = None):
        data = Cacheable.get_data(self)
        if namespace and data:
            return CombinedRealtimeDataList(
                [d for d in data.to_json() if d["namespace"] == namespace]
            )
        return data


class CEndpointDependencies(Cacheable):
    unique_name = "EndpointDependencies"

    def __init__(
        self,
        init_data: Optional[List[dict]] = None,
        store: Optional[Store] = None,
        simulator_mode: bool = False,
    ) -> None:
        super().__init__(
            self.unique_name,
            EndpointDependencies(init_data) if init_data else None,
        )
        if store:
            self._set_init(
                lambda: self.set_data(
                    EndpointDependencies(store.find_all("EndpointDependencies"))
                ),
                simulator_mode,
            )
            self._set_sync(
                _replace_all_sync(
                    store,
                    "EndpointDependencies",
                    _snap(self.get_data, lambda d: d.to_json()),
                ),
                simulator_mode,
            )

    def set_data(self, update: EndpointDependencies, *args: Any) -> None:
        Cacheable.set_data(self, update.trim())

    def get_data(self, namespace: Optional[str] = None):
        data = Cacheable.get_data(self)
        if namespace and data:
            return EndpointDependencies(
                [
                    d
                    for d in data.to_json()
                    if d["endpoint"]["namespace"] == namespace
                ]
            )
        return data


class CLabeledEndpointDependencies(Cacheable):
    unique_name = "LabeledEndpointDependencies"

    def __init__(
        self,
        init_data: Optional[List[dict]] = None,
        get_label: Optional[Callable[[str], Optional[str]]] = None,
        label_version: Optional[Callable[[], int]] = None,
    ) -> None:
        super().__init__(
            self.unique_name,
            EndpointDependencies(init_data) if init_data else None,
        )
        self._get_label = get_label or (lambda name: None)
        # when wired to the label mapping's change counter, relabel()
        # becomes a no-op until either this cache's data or the mapping
        # actually changed; unwired callers keep the relabel-every-read
        # behavior (correct, just slower)
        self._label_version = label_version
        self._relabel_key: Optional[tuple] = None
        # one labeling at a time: a second reader waits and then finds
        # the view already labeled. set_data never takes it.
        self._relabel_lock = threading.Lock()

    def set_data(self, update: EndpointDependencies, *args: Any) -> None:
        # stored trimmed and labeled on the next read (_labeled), with the
        # mapping of that read, as the reference's relabel-on-read gives:
        # the realtime tick writes this view and never reads it, so the
        # labeling of every endpoint leaves the tick
        trimmed = update.trim()
        with self._update_lock:
            Cacheable.set_data(self, trimmed)

    def _labeled(self) -> Optional[EndpointDependencies]:
        """The data labeled with the current mapping. The labeling runs
        outside the update lock, so a tick's set_data never waits for it,
        and its result is stored only if no set_data landed meanwhile: a
        view of older data never overwrites a newer tick's. The reader
        gets the view of the data it read either way."""
        with self._relabel_lock:
            with self._update_lock:
                data, version = Cacheable.get_data(self), self.version
            if not data:
                return data
            lv = self._label_version() if self._label_version else None
            if lv is not None and (version, lv) == self._relabel_key:
                return data
            labeled = EndpointDependencies(data.label(self._get_label))
            with self._update_lock:
                if self.version == version:
                    Cacheable.set_data(self, labeled)
                    if lv is not None:
                        # key on the post-set version: the NEXT read with
                        # the same data + mapping skips the relabel
                        self._relabel_key = (self.version, lv)
            return labeled

    def to_json(self) -> Any:
        data = self._labeled()
        return data.to_json() if data else data

    def get_data(self, namespace: Optional[str] = None):
        data = self._labeled()
        if namespace and data:
            return EndpointDependencies(
                [
                    d
                    for d in data.to_json()
                    if d["endpoint"]["namespace"] == namespace
                ]
            )
        return data


class CEndpointDataType(Cacheable):
    unique_name = "EndpointDataType"

    def __init__(
        self,
        init_data: Optional[List[dict]] = None,
        store: Optional[Store] = None,
        simulator_mode: bool = False,
    ) -> None:
        super().__init__(
            self.unique_name,
            [EndpointDataType(e) for e in init_data] if init_data else None,
        )
        if store:
            self._set_init(
                lambda: self.set_data(
                    [
                        EndpointDataType(r)
                        for r in store.find_all("EndpointDataType")
                    ]
                ),
                simulator_mode,
            )
            self._set_sync(
                _replace_all_sync(
                    store,
                    "EndpointDataType",
                    lambda: [e.to_json() for e in self.get_data()],
                ),
                simulator_mode,
            )

    def get_data(self, *args: Any) -> List[EndpointDataType]:
        return Cacheable.get_data(self) or []

    def set_data(self, update: List[EndpointDataType], *args: Any) -> None:
        data_type_map: Dict[str, EndpointDataType] = {}
        for d in self.get_data():
            data_type_map[d.to_json()["uniqueEndpointName"]] = d
        for d in update:
            name = d.to_json()["uniqueEndpointName"]
            existing = data_type_map.get(name)
            data_type_map[name] = existing.merge_schema_with(d) if existing else d
        Cacheable.set_data(self, [t.trim() for t in data_type_map.values()])


class CReplicas(Cacheable):
    unique_name = "ReplicaCounts"

    def __init__(
        self,
        init_data: Optional[List[dict]] = None,
        fetch_replicas: Optional[Callable[[], List[dict]]] = None,
        read_only: bool = False,
    ) -> None:
        super().__init__(self.unique_name, init_data)
        if fetch_replicas:
            def init() -> None:
                if read_only:
                    return
                self.set_data(fetch_replicas())

            self._set_init(init)

    def set_data(self, update: List[dict], *args: Any) -> None:
        Cacheable.set_data(self, [r for r in update if r.get("service")])


class CLabelMapping(Cacheable):
    unique_name = "LabelMapping"

    def __init__(self, init_data: Optional[List[Tuple[str, str]]] = None) -> None:
        super().__init__(
            self.unique_name, dict(init_data) if init_data else None
        )
        # get_label's answers for the mapping of one version: a tick
        # labels every endpoint of the dependency view (several hundred
        # thousand lookups at 10,000 endpoints), most of them falling back
        # to the URL's path
        self._labels: Tuple[int, Dict[str, Optional[str]]] = (-1, {})

    def set_data(
        self,
        update: Dict[str, str],
        user_defined_labels: Optional[dict] = None,
        endpoint_dependencies: Optional[EndpointDependencies] = None,
    ) -> None:
        unique_names: Dict[str, None] = {}
        if user_defined_labels:
            reversed_map: Dict[str, List[str]] = {}
            for k, v in update.items():
                reversed_map.setdefault(v, []).append(k)
            for l in user_defined_labels.get("labels", []):
                if not l.get("block"):
                    continue
                for e in reversed_map.get(l["label"], []):
                    if e.startswith(f"{l['uniqueServiceName']}\t{l['method']}"):
                        unique_names[e] = None
                        update.pop(e, None)
        if endpoint_dependencies:
            for d in endpoint_dependencies.dependencies:
                for dep in d["dependingBy"]:
                    unique_names[dep["endpoint"]["uniqueEndpointName"]] = None
                for dep in d["dependingOn"]:
                    unique_names[dep["endpoint"]["uniqueEndpointName"]] = None
                unique_names[d["endpoint"]["uniqueEndpointName"]] = None
        if unique_names:
            update = guess_and_merge_endpoints(list(unique_names), update)
        Cacheable.set_data(self, update)

    def get_label(self, unique_name: str) -> Optional[str]:
        version, labels = self._labels
        if version != self.version:
            labels = {}
            self._labels = (self.version, labels)
        if unique_name in labels:
            return labels[unique_name]
        label_map = Cacheable.get_data(self)
        label = (label_map or {}).get(unique_name)
        if not label:
            parts = unique_name.split("\t")
            url = parts[4] if len(parts) > 4 else ""
            label = explode_url(url).path
        labels[unique_name] = label
        return label

    def get_endpoints_from_label(self, label: str) -> List[str]:
        label_map = Cacheable.get_data(self)
        if not label_map:
            return []
        out: Dict[str, List[str]] = {}
        for name, l in label_map.items():
            out.setdefault(l, []).append(name)
        return out.get(label, [])

    def label_historical_data(self, historical_data: List[dict]) -> List[dict]:
        label_map = Cacheable.get_data(self)
        if label_map is None:
            return historical_data
        unique_names = {
            e["uniqueEndpointName"]: None
            for h in historical_data
            for s in h["services"]
            for e in s["endpoints"]
        }
        # guess_and_merge_endpoints mutates the map it is given; work on
        # a COPY and publish via set_data — other request threads iterate
        # the live dict concurrently
        self.set_data(
            guess_and_merge_endpoints(list(unique_names), dict(label_map))
        )
        for h in historical_data:
            for s in h["services"]:
                for e in s["endpoints"]:
                    e["labelName"] = self.get_label(e["uniqueEndpointName"])
        return historical_data

    def label_aggregated_data(self, aggregated_data: dict) -> dict:
        label_map = Cacheable.get_data(self)
        if label_map is None:
            return aggregated_data
        unique_names = {
            e["uniqueEndpointName"]: None
            for s in aggregated_data["services"]
            for e in s["endpoints"]
        }
        # copy before the mutating guess-merge (see label_historical_data)
        self.set_data(
            guess_and_merge_endpoints(list(unique_names), dict(label_map))
        )
        for s in aggregated_data["services"]:
            for e in s["endpoints"]:
                e["labelName"] = self.get_label(e["uniqueEndpointName"])
        return aggregated_data

    def get_endpoint_data_types_by_label(
        self,
        label: str,
        unique_service_name: str,
        method: str,
        endpoint_data_types: List[EndpointDataType],
    ) -> List[EndpointDataType]:
        return [
            dt
            for dt in endpoint_data_types
            if dt.to_json()["uniqueServiceName"] == unique_service_name
            and dt.to_json()["method"] == method
            and self.get_label(dt.to_json()["uniqueEndpointName"]) == label
        ]

    def to_json(self) -> List[List[str]]:
        data = Cacheable.get_data(self)
        if not data:
            return []
        return [[k, v] for k, v in data.items()]


class CUserDefinedLabel(Cacheable):
    unique_name = "UserDefinedLabel"

    def __init__(
        self,
        init_data: Optional[dict] = None,
        store: Optional[Store] = None,
        simulator_mode: bool = False,
    ) -> None:
        super().__init__(self.unique_name, init_data)
        if store:
            self._set_init(
                lambda: self.set_data(
                    (store.find_all("UserDefinedLabel") or [None])[0]
                ),
                simulator_mode,
            )
            self._set_sync(
                _replace_all_sync(
                    store,
                    "UserDefinedLabel",
                    _snap(self.get_data, lambda d: [d]),
                ),
                simulator_mode,
            )

    def update(self, label: dict) -> None:
        with self._update_lock:
            for l in label.get("labels", []):
                self.delete(l["label"], l["uniqueServiceName"], l["method"])
            self.add(label)

    def add(self, label: dict) -> None:
        with self._update_lock:
            data = self.get_data()
            self.set_data(
                {
                    "labels": (data or {}).get("labels", [])
                    + label.get("labels", [])
                }
            )

    def delete(self, label_name: str, unique_service_name: str, method: str) -> None:
        with self._update_lock:
            data = self.get_data()
            if not data:
                return
            self.set_data(
                {
                    "labels": [
                        l
                        for l in data.get("labels", [])
                        if l["label"] != label_name
                        or l["uniqueServiceName"] != unique_service_name
                        or l["method"] != method
                    ]
                }
            )


class CTaggedInterfaces(Cacheable):
    unique_name = "TaggedInterfaces"

    def __init__(
        self,
        init_data: Optional[List[dict]] = None,
        store: Optional[Store] = None,
        simulator_mode: bool = False,
    ) -> None:
        super().__init__(self.unique_name, init_data)
        if store:
            self._set_init(
                lambda: self.set_data(store.find_all("TaggedInterface")),
                simulator_mode,
            )
            self._set_sync(
                _replace_all_sync(
                    store, "TaggedInterface", lambda: self.get_data()
                ),
                simulator_mode,
            )

    def get_data(self, unique_label_name: Optional[str] = None) -> List[dict]:
        data = Cacheable.get_data(self) or []
        if unique_label_name:
            return [i for i in data if i.get("uniqueLabelName") == unique_label_name]
        return data

    def add(self, tagged: dict) -> None:
        tagged = {**tagged, "timestamp": _now_ms()}
        with self._update_lock:
            self.set_data(self.get_data() + [tagged])

    def delete(self, unique_label_name: str, user_label: str) -> None:
        # mirror of the reference's AND-of-inequalities filter
        with self._update_lock:
            self.set_data(
                [
                    i
                    for i in self.get_data()
                    if i.get("uniqueLabelName") != unique_label_name
                    and i.get("userLabel") != user_label
                ]
            )


class CTaggedSwaggers(Cacheable):
    unique_name = "TaggedSwaggers"

    def __init__(
        self,
        init_data: Optional[List[dict]] = None,
        store: Optional[Store] = None,
        simulator_mode: bool = False,
    ) -> None:
        super().__init__(self.unique_name, init_data)
        if store:
            self._set_init(
                lambda: self.set_data(store.find_all("TaggedSwagger")),
                simulator_mode,
            )
            self._set_sync(
                _replace_all_sync(store, "TaggedSwagger", lambda: self.get_data()),
                simulator_mode,
            )

    def get_data(
        self, unique_service_name: Optional[str] = None, tag: Optional[str] = None
    ) -> List[dict]:
        data = Cacheable.get_data(self) or []
        if not unique_service_name:
            return data
        docs = [d for d in data if d.get("uniqueServiceName") == unique_service_name]
        if not tag:
            return docs
        return [d for d in docs if d.get("tag") == tag]

    def add(self, tagged: dict) -> None:
        with self._update_lock:
            if self.get_data(
                tagged.get("uniqueServiceName"), tagged.get("tag")
            ):
                return
            tagged = {**tagged, "time": _now_ms()}
            self.set_data(self.get_data() + [tagged])

    def delete(self, unique_service_name: str, tag: str) -> None:
        with self._update_lock:
            self.set_data(
                [
                    d
                    for d in self.get_data()
                    if d.get("tag") != tag
                    or d.get("uniqueServiceName") != unique_service_name
                ]
            )


class CTaggedDiffData(Cacheable):
    unique_name = "TaggedDiffDatas"

    def __init__(
        self,
        init_data: Optional[List[dict]] = None,
        store: Optional[Store] = None,
        simulator_mode: bool = False,
    ) -> None:
        super().__init__(self.unique_name, init_data)
        if store:
            self._set_init(
                lambda: self.set_data(store.find_all("TaggedDiffData")),
                simulator_mode,
            )
            self._set_sync(
                _replace_all_sync(store, "TaggedDiffData", lambda: self.get_data()),
                simulator_mode,
            )

    def get_data(self, *args: Any) -> List[dict]:
        data = Cacheable.get_data(self) or []
        return [d for d in data if d.get("time")]

    def get_data_by_tag(self, tag: Optional[str] = None) -> Optional[dict]:
        if tag:
            existing = [d for d in self.get_data() if d.get("tag") == tag]
            if existing:
                return existing[0]
        return None

    def get_tags_with_time(self) -> List[dict]:
        return [{"tag": d["tag"], "time": d["time"]} for d in self.get_data()]

    def add(self, tagged: dict) -> None:
        with self._update_lock:
            if self.get_data_by_tag(tagged.get("tag")) is None:
                tagged = {**tagged, "time": _now_ms()}
                self.set_data((Cacheable.get_data(self) or []) + [tagged])

    def delete(self, tag: str) -> None:
        with self._update_lock:
            self.set_data(
                [d for d in self.get_data() if d.get("tag") != tag]
            )


class CLookBackRealtimeData(Cacheable):
    unique_name = "LookBackRealtimeData"
    can_export = False

    def __init__(
        self,
        init_data: Optional[List[Tuple[int, List[dict]]]] = None,
        store: Optional[Store] = None,
        simulator_mode: bool = False,
        now_ms: Callable[[], float] = _now_ms,
    ) -> None:
        data = (
            {ts: CombinedRealtimeDataList(rows) for ts, rows in init_data}
            if init_data
            else None
        )
        super().__init__(self.unique_name, data)
        self._now_ms = now_ms
        if store:
            def init() -> None:
                historical = store.get_historical_data(
                    time_offset_ms=RISK_LOOK_BACK_TIME_MS, now_ms=self._now_ms()
                )
                self.set_data(
                    {
                        h["date"]: HistoricalData(h).to_combined_realtime_data_list()
                        for h in historical
                    }
                )

            self._set_init(init, simulator_mode)

    def set_data(self, update: Dict[int, CombinedRealtimeDataList], *args: Any) -> None:
        existing = Cacheable.get_data(self) or {}
        existing.update(update)
        Cacheable.set_data(self, existing)

    def get_data(self, *args: Any) -> Dict[int, CombinedRealtimeDataList]:
        data = Cacheable.get_data(self)
        if not data:
            return {}
        now = self._now_ms()
        filtered = {
            ts: rows
            for ts, rows in data.items()
            if now - ts < RISK_LOOK_BACK_TIME_MS
        }
        Cacheable.set_data(self, filtered)
        return filtered


class CTaggedSimulationYAML(Cacheable):
    unique_name = "TaggedSimulationYAML"
    MAX_STORE_COUNT = 50

    def __init__(self, init_data: Optional[List[dict]] = None) -> None:
        super().__init__(self.unique_name, init_data)
        self._set_init(lambda: None)
        self._set_sync(lambda: None)

    def get_data(self, *args: Any) -> List[dict]:
        return Cacheable.get_data(self) or []

    def get_data_by_tag(self, tag: Optional[str] = None) -> Optional[dict]:
        if tag:
            existing = [d for d in self.get_data() if d.get("tag") == tag]
            if existing:
                return existing[0]
        return None

    def add(self, tagged: dict) -> None:
        if not tagged.get("tag"):
            tagged["tag"] = self.default_tag()
        with self._update_lock:
            if self.get_data_by_tag(tagged["tag"]) is None:
                tagged = {**tagged, "time": _now_ms()}
                updated = sorted(
                    self.get_data() + [tagged], key=lambda d: -d["time"]
                )[: self.MAX_STORE_COUNT]
                self.set_data(updated)

    def delete(self, tag: str) -> None:
        self.set_data([d for d in self.get_data() if d.get("tag") != tag])

    @staticmethod
    def default_tag(prefix: str = "my_simulate_") -> str:
        return prefix + time.strftime("%Y%m%d%H%M%S")


class CSimulatedHistoricalData(Cacheable):
    unique_name = "SimulatedHistoricalData"

    def __init__(self, init_data: Optional[List[dict]] = None) -> None:
        super().__init__(
            self.unique_name,
            [HistoricalData(h) for h in init_data] if init_data else None,
        )
        self._set_init(lambda: None)
        self._set_sync(lambda: None)

    def get_data(self, *args: Any) -> List[HistoricalData]:
        return Cacheable.get_data(self) or []

    def insert_one(self, one: HistoricalData) -> None:
        self.set_data(self.get_data() + [one])


class CModelHistoryState(Cacheable):
    """Persistence vehicle for the online forecast-model state: hour-keyed per-endpoint profiles take days of traffic to
    build, so they honor the same init/sync contract as every other live
    cache (Cacheable.ts:42-55) — restored at boot keyed by endpoint
    NAME, flushed on the dispatch rotation and at shutdown. The data
    itself lives on the DataProcessor (models/history.HistoryState); this
    cache holds no copy, it snapshots on sync and restores on init."""

    unique_name = "ModelHistoryState"
    can_export = False  # live serving state, like LookBackRealtimeData

    def __init__(
        self,
        store: Optional[Store] = None,
        processor: Optional[Any] = None,
        simulator_mode: bool = False,
    ) -> None:
        super().__init__(self.unique_name, None)
        if store is not None and processor is not None:

            def init() -> None:
                docs = store.find_all(self.unique_name)
                if docs:
                    # restore_history picks the newest COMPLETE part set
                    processor.restore_history(docs)

            def docs_fn() -> Optional[list]:
                # a list of chunked part documents (each a few MB at
                # most, under any backend's document-size cap); None
                # before the first observed tick leaves the stored
                # snapshot alone rather than wiping it
                return processor.snapshot_history()

            self._set_init(init, simulator_mode)
            self._set_sync(
                _replace_all_sync(store, self.unique_name, docs_fn),
                simulator_mode,
            )
