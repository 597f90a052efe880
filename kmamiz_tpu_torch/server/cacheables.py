"""The caches the graph routes and the realtime path read.

Counterpart of kmamiz_tpu/server/cacheables.py (KMamiz
src/classes/Cacheable/*), reduced to six of its thirteen caches:
combined realtime data, endpoint dependencies and their labeled view,
endpoint datatypes, the label mapping and the user-defined labels. Each
keeps its reference twin's merge/filter/label behavior for the realtime
path; the store-backed init/sync hooks, the aggregation's reset, the
label CRUD and the label reads of historical data wait for the slices
that use them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from kmamiz_tpu_torch.analytics.endpoint_utils import guess_and_merge_endpoints
from kmamiz_tpu_torch.core.urls import explode_url
from kmamiz_tpu_torch.domain.combined import CombinedRealtimeDataList
from kmamiz_tpu_torch.domain.endpoint_data_type import EndpointDataType
from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
from kmamiz_tpu_torch.server.cache import Cacheable


class CCombinedRealtimeData(Cacheable):
    unique_name = "CombinedRealtimeData"

    def __init__(self, init_data: Optional[List[dict]] = None) -> None:
        super().__init__(
            self.unique_name,
            CombinedRealtimeDataList(init_data) if init_data else None,
        )

    def set_data(self, update: CombinedRealtimeDataList, *args: Any) -> None:
        update = CombinedRealtimeDataList([r for r in update.to_json() if r.get("service")])
        data = Cacheable.get_data(self)
        Cacheable.set_data(self, data.combine_with(update) if data else update)

    def get_data(self, namespace: Optional[str] = None):
        data = Cacheable.get_data(self)
        if namespace and data:
            return CombinedRealtimeDataList(
                [d for d in data.to_json() if d["namespace"] == namespace]
            )
        return data


def _in_namespace(data: EndpointDependencies, namespace: str) -> EndpointDependencies:
    return EndpointDependencies(
        [d for d in data.to_json() if d["endpoint"]["namespace"] == namespace]
    )


class CEndpointDependencies(Cacheable):
    unique_name = "EndpointDependencies"

    def __init__(self, init_data: Optional[List[dict]] = None) -> None:
        super().__init__(
            self.unique_name,
            EndpointDependencies(init_data) if init_data else None,
        )

    def set_data(self, update: EndpointDependencies, *args: Any) -> None:
        Cacheable.set_data(self, update.trim())

    def get_data(self, namespace: Optional[str] = None):
        data = Cacheable.get_data(self)
        if namespace and data:
            return _in_namespace(data, namespace)
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
        # wired to the label mapping's change counter, relabel() is a no-op
        # until this cache's data or the mapping changed; unwired, it
        # relabels on every read
        self._label_version = label_version
        self._relabel_key: Optional[tuple] = None

    def set_data(self, update: EndpointDependencies, *args: Any) -> None:
        Cacheable.set_data(self, EndpointDependencies(update.trim().label(self._get_label)))

    def relabel(self) -> None:
        data = Cacheable.get_data(self)
        if not data:
            return
        lv = self._label_version() if self._label_version else None
        if lv is not None and (self.version, lv) == self._relabel_key:
            return
        self.set_data(EndpointDependencies(data.label(self._get_label)))
        if lv is not None:
            # keyed on the post-set version: the next read with the same
            # data and mapping skips the relabel
            self._relabel_key = (self.version, lv)

    def get_data(self, namespace: Optional[str] = None):
        self.relabel()
        data = Cacheable.get_data(self)
        if namespace and data:
            return _in_namespace(data, namespace)
        return data


class CEndpointDataType(Cacheable):
    unique_name = "EndpointDataType"

    def __init__(self, init_data: Optional[List[dict]] = None) -> None:
        super().__init__(
            self.unique_name,
            [EndpointDataType(e) for e in init_data] if init_data else None,
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


class CLabelMapping(Cacheable):
    unique_name = "LabelMapping"

    def __init__(self, init_data: Optional[List[Tuple[str, str]]] = None) -> None:
        super().__init__(self.unique_name, dict(init_data) if init_data else None)

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
            for d in endpoint_dependencies.to_json():
                for dep in d["dependingBy"] + d["dependingOn"] + [d]:
                    unique_names[dep["endpoint"]["uniqueEndpointName"]] = None
        if unique_names:
            update = guess_and_merge_endpoints(list(unique_names), update)
        Cacheable.set_data(self, update)

    def get_label(self, unique_name: str) -> Optional[str]:
        label_map = Cacheable.get_data(self)
        label = (label_map or {}).get(unique_name)
        if label:
            return label
        parts = unique_name.split("\t")
        url = parts[4] if len(parts) > 4 else ""
        return explode_url(url).path

    def to_json(self) -> List[List[str]]:
        data = Cacheable.get_data(self)
        if not data:
            return []
        return [[k, v] for k, v in data.items()]


class CUserDefinedLabel(Cacheable):
    unique_name = "UserDefinedLabel"

    def __init__(self, init_data: Optional[dict] = None) -> None:
        super().__init__(self.unique_name, init_data)
