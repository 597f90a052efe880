"""Endpoint schema objects and the SIDC (data-type cohesion) scorer.

Parity with KMamiz src/classes/EndpointDataType.ts: per-status
schema trim/dedup, interface-field schema matching, schema merge, and
service cohesion via pairwise cosine similarity of schema-field sets.
"""
from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, List, Optional, Set, Tuple

from kmamiz_tpu_torch.core import schema as schema_utils
from kmamiz_tpu_torch.core.urls import unique_params



_FIELD_RE = re.compile(r"  ([^?:]*)[^ ]* ([^;]*)")


@lru_cache(maxsize=16384)
def _breakdown_interface(interface_str: str) -> Tuple[Tuple[str, str], ...]:
    """(field, type) pairs of an interface string. Cached: the label
    mapping compares every pair of a service's endpoints on each tick, and
    a deployment has few distinct schemas."""
    out = []
    for line in interface_str.split("\n"):
        m = _FIELD_RE.match(line)
        if m and (m.group(1) or m.group(2)):
            out.append((m.group(1), m.group(2)))
    return tuple(out)

class EndpointDataType:
    def __init__(self, endpoint_data_type: dict) -> None:
        self._data = endpoint_data_type

    def to_json(self) -> dict:
        return self._data

    # -- trim / dedup (EndpointDataType.ts:21-61) ----------------------------

    def remove_duplicate_schemas(self) -> "EndpointDataType":
        schema_map: Dict[str, dict] = {}
        for s in self._data["schemas"]:
            key = (
                f"{s['status']}\t{s.get('responseSchema') or ''}"
                f"\t{s.get('requestSchema') or ''}"
            )
            schema_map[key] = s
        return EndpointDataType({**self._data, "schemas": list(schema_map.values())})

    def trim(self) -> "EndpointDataType":
        data_type = self.remove_duplicate_schemas()
        schema_map: Dict[str, dict] = {}
        for s in data_type._data["schemas"]:
            existing = schema_map.get(s["status"])
            if existing:
                s = dict(s)
                s["requestContentType"] = (
                    existing.get("requestContentType") or s.get("requestContentType")
                )
                s["requestParams"] = (existing.get("requestParams") or []) + (
                    s.get("requestParams") or []
                )
                s["requestSample"] = schema_utils.merge(
                    existing.get("requestSample"), s.get("requestSample")
                )
                s["requestSchema"] = schema_utils.object_to_interface_string(
                    s["requestSample"]
                )
                s["responseContentType"] = (
                    existing.get("responseContentType") or s.get("responseContentType")
                )
                s["responseSample"] = schema_utils.merge(
                    existing.get("responseSample"), s.get("responseSample")
                )
                s["responseSchema"] = schema_utils.object_to_interface_string(
                    s["responseSample"]
                )
            schema_map[s["status"]] = s
        return EndpointDataType(
            {**data_type._data, "schemas": list(schema_map.values())}
        )

    # -- schema matching (EndpointDataType.ts:63-121) ------------------------

    def has_matched_schema(self, other: "EndpointDataType") -> bool:
        this_schemas = {s["status"]: s for s in self._data["schemas"]}
        cmp_schemas = {s["status"]: s for s in other._data["schemas"]}
        common = [k for k in this_schemas if k in cmp_schemas]
        result = False
        for k in common:
            t, c = this_schemas[k], cmp_schemas[k]
            if not self._is_schema_matched(t, c):
                return False
            if t.get("requestContentType") or t.get("responseContentType"):
                result = True
        return result

    def _is_schema_matched(self, a: dict, b: dict) -> bool:
        return (
            a.get("requestContentType") == b.get("requestContentType")
            and a.get("responseContentType") == b.get("responseContentType")
            and self._is_interface_matched(a.get("requestSchema"), b.get("requestSchema"))
            and self._is_interface_matched(
                a.get("responseSchema"), b.get("responseSchema")
            )
        )

    def _is_interface_matched(
        self, interface_a: Optional[str], interface_b: Optional[str]
    ) -> bool:
        if interface_a is None:
            interface_a = "interface Root {\n}"
        if interface_b is None:
            interface_b = "interface Root {\n}"
        if interface_a and interface_b:
            a_map = dict(_breakdown_interface(interface_a))
            for field, t in _breakdown_interface(interface_b):
                exist = a_map.get(field)
                if not exist or (exist != t and exist != "any" and t != "any"):
                    return False
            return True
        return interface_a == interface_b

    # -- schema merge (EndpointDataType.ts:123-183) --------------------------

    def merge_schema_with(
        self, other: "EndpointDataType", now_ms: Optional[float] = None
    ) -> "EndpointDataType":
        if now_ms is None:
            # the reference stamps merged per-status schemas with the
            # merge time (EndpointDataType.ts:160 `time: new Date()`);
            # callers pass now_ms for determinism in tests
            import time as _time

            now_ms = _time.time() * 1000

        def to_map(schemas: List[dict]) -> Dict[str, dict]:
            ordered = sorted(schemas, key=lambda s: -(s.get("time") or 0))
            out: Dict[str, dict] = {}
            for s in ordered:
                out.setdefault(s["status"], s)
            return out

        existing_map = to_map(self._data["schemas"])
        new_map = to_map(other._data["schemas"])
        combined: Dict[str, dict] = {}
        all_statuses = list(
            dict.fromkeys(list(existing_map.keys()) + list(new_map.keys()))
        )
        for status in all_statuses:
            e, n = existing_map.get(status), new_map.get(status)
            if e and n:
                request_params = (e.get("requestParams") or []) + (
                    n.get("requestParams") or []
                )
                request_sample = schema_utils.merge(
                    e.get("requestSample"), n.get("requestSample")
                )
                response_sample = schema_utils.merge(
                    e.get("responseSample"), n.get("responseSample")
                )
                combined[status] = {
                    "status": status,
                    "time": now_ms,
                    "requestParams": unique_params(request_params),
                    "requestSample": request_sample,
                    "responseSchema": schema_utils.object_to_interface_string(
                        response_sample
                    )
                    if schema_utils.js_truthy(response_sample)
                    else None,
                    "responseSample": response_sample,
                    "requestSchema": schema_utils.object_to_interface_string(
                        request_sample
                    )
                    if schema_utils.js_truthy(request_sample)
                    else None,
                    "requestContentType": e.get("requestContentType")
                    or n.get("requestContentType"),
                    "responseContentType": e.get("responseContentType")
                    or n.get("responseContentType"),
                }
            elif n:
                combined[status] = n
        # the reference's mapToMap SORTS this.schemas in place (JS
        # Array.sort mutates) before the concat, so the merged object
        # carries time-DESC-ordered own schemas — later last-wins dedup
        # by status must see the same order
        own_sorted = sorted(
            self._data["schemas"], key=lambda s: -(s.get("time") or 0)
        )
        return EndpointDataType(
            {
                **self._data,
                "schemas": own_sorted + list(combined.values()),
            }
        )

    # -- SIDC cohesion (EndpointDataType.ts:185-314) -------------------------

    @staticmethod
    def get_service_cohesion(data_types: List["EndpointDataType"]) -> List[dict]:
        mapping = EndpointDataType._create_data_type_mapping(data_types)
        out = []
        for unique_service_name, endpoints in mapping.items():
            preprocessed = EndpointDataType._preprocess_endpoints(endpoints)
            endpoint_cohesion = EndpointDataType._create_endpoint_cohesion(preprocessed)
            total = sum(ec["score"] for ec in endpoint_cohesion)
            cohesiveness = (
                total / len(endpoint_cohesion) if endpoint_cohesion else 0
            )
            out.append(
                {
                    "uniqueServiceName": unique_service_name,
                    "cohesiveness": 1 if len(endpoints) == 1 else cohesiveness,
                    "endpointCohesion": endpoint_cohesion,
                }
            )
        return out

    @staticmethod
    def _create_data_type_mapping(
        data_types: List["EndpointDataType"],
    ) -> Dict[str, Dict[Optional[str], "EndpointDataType"]]:
        mapping: Dict[str, Dict[Optional[str], EndpointDataType]] = {}
        for d in data_types:
            dt = d._data
            service_map = mapping.setdefault(dt["uniqueServiceName"], {})
            label = dt.get("labelName")
            if label not in service_map:
                service_map[label] = d
            else:
                service_map[label] = service_map[label].merge_schema_with(d)
        return mapping

    @staticmethod
    def _preprocess_endpoints(
        endpoints: Dict[Optional[str], "EndpointDataType"],
    ) -> List[dict]:
        preprocessed = []
        for endpoint_name, e in endpoints.items():
            content_types: Set[str] = set()
            request: dict = {}
            response: dict = {}
            for s in e._data["schemas"]:
                if s.get("requestContentType") == "application/json":
                    request = {**request, **schema_utils._spread(s.get("requestSample"))}
                elif s.get("requestContentType"):
                    content_types.add(s["requestContentType"])
                if s.get("responseContentType") == "application/json":
                    response = {
                        **response,
                        **schema_utils._spread(s.get("responseSample")),
                    }
                elif s.get("responseContentType"):
                    content_types.add(s["responseContentType"])
            preprocessed.append(
                {
                    "endpointName": endpoint_name,
                    "contentTypes": content_types,
                    "requestSchema": schema_utils.match_interface_field_and_trim(
                        schema_utils.object_to_interface_string(request)
                    ),
                    "responseSchema": schema_utils.match_interface_field_and_trim(
                        schema_utils.object_to_interface_string(response)
                    ),
                }
            )
        return preprocessed

    @staticmethod
    def _create_endpoint_cohesion(preprocessed: List[dict]) -> List[dict]:
        out = []
        for i in range(len(preprocessed) - 1):
            a = preprocessed[i]
            for j in range(i + 1, len(preprocessed)):
                b = preprocessed[j]
                scores = []
                for key in ("requestSchema", "responseSchema", "contentTypes"):
                    sim = EndpointDataType._cosine_sim(a[key], b[key])
                    if sim is not None:
                        scores.append(sim)
                out.append(
                    {
                        "aName": a["endpointName"],
                        "bName": b["endpointName"],
                        "score": sum(scores) / len(scores) if scores else 0,
                    }
                )
        return out

    @staticmethod
    def _cosine_sim(set_a: Set[str], set_b: Set[str]) -> Optional[float]:
        if not set_a and not set_b:
            return None
        base = list(dict.fromkeys(list(set_a) + list(set_b)))
        return schema_utils.cos_sim(
            schema_utils.create_standard_vector(base, set_a),
            schema_utils.create_standard_vector(base, set_b),
        )
