"""Store-boundary document validation for the nine persisted collections.

The reference rejects malformed documents at the persistence boundary via
its nine Mongoose models (KMamiz src/services/MongoOperator.ts:6-14,
KMamiz src/entities/schema/*.ts). This module mirrors those
shapes as declarative specs checked on every Store write AND read, so a
corrupt or foreign document surfaces as a SchemaValidationError naming the
collection and field path — not a KeyError five frames deep in domain code.

Versioning: written documents are stamped `_schemaVersion` (CURRENT_VERSION).
Reads migrate older documents forward through MIGRATIONS — a per-collection
``{from_version: fn}`` registry; unstamped documents are version 0, and the
0 -> 1 migration stamps them unchanged (the shapes did not change).

Spec mini-language:
  "str" / "num" / "bool" / "any"    scalar field types ("any" = Mixed)
  "date"                            epoch-ms number (the reference stores
                                    JS Dates; this build persists epoch ms)
  {..}                              nested object (extra keys allowed, as
                                    in Mongoose's default strict mode on
                                    reads from foreign writers)
  [spec]                            homogeneous list
  Opt(spec)                         optional (absent or None allowed)

A copy of kmamiz_tpu/server/schemas.py, importing the port's modules,
without its KMAMIZ_SCHEMA_VALIDATION switch: the port always validates.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

CURRENT_VERSION = 1


class SchemaValidationError(ValueError):
    """A document failed shape validation at the store boundary."""

    def __init__(self, collection: str, path: str, message: str) -> None:
        super().__init__(f"{collection}: {path or '<root>'}: {message}")
        self.collection = collection
        self.path = path


class Opt:
    """Marks a spec as optional (field may be absent or None)."""

    def __init__(self, spec: Any) -> None:
        self.spec = spec


def _check(spec: Any, value: Any, collection: str, path: str) -> None:
    if isinstance(spec, Opt):
        if value is None:
            return
        _check(spec.spec, value, collection, path)
        return
    if spec == "any":
        return
    if spec == "str":
        if not isinstance(value, str):
            raise SchemaValidationError(
                collection, path, f"expected string, got {type(value).__name__}"
            )
        return
    if spec in ("num", "date"):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SchemaValidationError(
                collection, path, f"expected number, got {type(value).__name__}"
            )
        return
    if spec == "bool":
        if not isinstance(value, bool):
            raise SchemaValidationError(
                collection, path, f"expected bool, got {type(value).__name__}"
            )
        return
    if isinstance(spec, list):
        if not isinstance(value, list):
            raise SchemaValidationError(
                collection, path, f"expected list, got {type(value).__name__}"
            )
        for i, item in enumerate(value):
            _check(spec[0], item, collection, f"{path}[{i}]")
        return
    if isinstance(spec, dict):
        if not isinstance(value, dict):
            raise SchemaValidationError(
                collection, path, f"expected object, got {type(value).__name__}"
            )
        for key, sub in spec.items():
            child = f"{path}.{key}" if path else key
            if key not in value or value[key] is None:
                if isinstance(sub, Opt):
                    continue
                raise SchemaValidationError(
                    collection, child, "required field missing"
                )
            _check(sub, value[key], collection, child)
        return
    raise AssertionError(f"bad spec node: {spec!r}")


# -- the nine collection shapes ---------------------------------------------

_AGG_ENDPOINT = {
    "uniqueServiceName": "str",
    "uniqueEndpointName": "str",
    "method": "str",
    "totalRequests": "num",
    "totalServerErrors": "num",
    "totalRequestErrors": "num",
    "avgLatencyCV": "num",
}

# AggregatedDataSchema.ts
AGGREGATED_DATA = {
    "fromDate": "date",
    "toDate": "date",
    "services": [
        {
            "uniqueServiceName": "str",
            "service": "str",
            "namespace": "str",
            "version": "str",
            "totalRequests": "num",
            "totalServerErrors": "num",
            "totalRequestErrors": "num",
            "avgRisk": "num",
            "avgLatencyCV": "num",
            "endpoints": [_AGG_ENDPOINT],
        }
    ],
}

_HIST_ENDPOINT = {
    "uniqueServiceName": "str",
    "uniqueEndpointName": "str",
    "method": "str",
    "requests": "num",
    "serverErrors": "num",
    "requestErrors": "num",
    "latencyMean": "num",
    "latencyCV": "num",
}

# HistoricalDataSchema.ts
HISTORICAL_DATA = {
    "date": "date",
    "services": [
        {
            "uniqueServiceName": "str",
            "date": "date",
            "service": "str",
            "namespace": "str",
            "version": "str",
            "requests": "num",
            "serverErrors": "num",
            "requestErrors": "num",
            "risk": Opt("num"),
            "latencyMean": "num",
            "latencyCV": "num",
            "endpoints": [_HIST_ENDPOINT],
        }
    ],
}

# CombinedRealtimeDateSchema.ts
COMBINED_REALTIME_DATA = {
    "uniqueServiceName": "str",
    "uniqueEndpointName": "str",
    "latestTimestamp": "num",
    "method": "str",
    "service": "str",
    "namespace": "str",
    "version": "str",
    "latency": {"mean": "num", "cv": "num"},
    "status": "str",
    "combined": "num",
    "responseBody": Opt("any"),
    "responseContentType": Opt("str"),
    "responseSchema": Opt("str"),
    "requestBody": Opt("any"),
    "requestContentType": Opt("str"),
    "requestSchema": Opt("str"),
    "avgReplica": Opt("num"),
}

# EndpointDataTypeSchema.ts
ENDPOINT_DATA_TYPE = {
    "uniqueServiceName": "str",
    "uniqueEndpointName": "str",
    "service": "str",
    "namespace": "str",
    "version": "str",
    "method": "str",
    "schemas": [
        {
            "time": "date",
            "status": "str",
            "responseSample": Opt("any"),
            "responseContentType": Opt("str"),
            "responseSchema": Opt("str"),
            "requestSample": Opt("any"),
            "requestContentType": Opt("str"),
            "requestSchema": Opt("str"),
            "requestParams": Opt([{"param": "str", "type": "str"}]),
        }
    ],
}

_ENDPOINT_INFO = {
    "uniqueServiceName": "str",
    "uniqueEndpointName": "str",
    "service": "str",
    "namespace": "str",
    "version": "str",
    "url": "str",
    "host": "str",
    "path": "str",
    "port": "str",
    "method": "str",
    "clusterName": "str",
    "timestamp": "num",
}

# EndpointDependencySchema.ts
ENDPOINT_DEPENDENCIES = {
    "endpoint": _ENDPOINT_INFO,
    "lastUsageTimestamp": "num",
    "isDependedByExternal": Opt("bool"),
    "dependingOn": [
        {"endpoint": _ENDPOINT_INFO, "distance": "num", "type": "str"}
    ],
    "dependingBy": [
        {"endpoint": _ENDPOINT_INFO, "distance": "num", "type": "str"}
    ],
}

# EndpointLabel.ts
USER_DEFINED_LABEL = {
    "labels": [
        {
            "uniqueServiceName": "str",
            "method": "str",
            "label": "str",
            "samples": ["str"],
            "block": Opt("bool"),
        }
    ],
}

# TaggedInterface.ts
TAGGED_INTERFACE = {
    "uniqueLabelName": "str",
    "userLabel": "str",
    "requestSchema": "str",
    "responseSchema": "str",
    "timestamp": "num",
    "boundToSwagger": Opt("bool"),
}

# TaggedSwagger.ts
TAGGED_SWAGGER = {
    "tag": "str",
    "time": "num",
    "uniqueServiceName": "str",
    "openApiDocument": "str",
}

_GRAPH_DATA = {
    "nodes": [
        {
            "id": "str",
            "name": "str",
            "group": "str",
            "dependencies": ["str"],
            "linkInBetween": [{"source": "str", "target": "str"}],
            "usageStatus": Opt("str"),
        }
    ],
    "links": [{"source": "str", "target": "str"}],
}

# TaggedDiffData.ts
TAGGED_DIFF_DATA = {
    "tag": "str",
    "time": "num",
    "graphData": _GRAPH_DATA,
    "cohesionData": [
        {
            "uniqueServiceName": "str",
            "name": "str",
            "dataCohesion": "num",
            "usageCohesion": "num",
            "totalInterfaceCohesion": "num",
            "endpointCohesion": Opt(
                [{"aName": "str", "bName": "str", "score": "num"}]
            ),
            "totalEndpoints": "num",
            "consumers": Opt(
                [{"uniqueServiceName": "str", "consumes": "num"}]
            ),
        }
    ],
    "couplingData": [
        {
            "uniqueServiceName": "str",
            "name": "str",
            "ais": "num",
            "ads": "num",
            "acs": "num",
        }
    ],
    "instabilityData": [
        {
            "uniqueServiceName": "str",
            "name": "str",
            "dependingBy": "num",
            "dependingOn": "num",
            "instability": "num",
        }
    ],
    "endpointDataTypesMap": "any",
}

# encoded ndarray (models/history.encode_array): dtype + shape + base64
_ENCODED_ARRAY = {"dtype": "str", "shape": ["num"], "data": "str"}

# the online-model snapshot (DataProcessor.snapshot_history) — the 10th
# collection, an extension past the reference's nine Mongoose models: the
# reference has no online forecasting state to persist. Hour-keyed
# per-endpoint profiles take days of traffic to build, so they ride the
# same dispatch-cron/shutdown sync contract as every reference cache.
MODEL_HISTORY_STATE = {
    "savedAt": "date",
    # chunked part documents (endpoint ranges): no single doc outgrows a
    # backend's size cap; a restore stitches the newest complete set
    "part": Opt("num"),
    "parts": Opt("num"),
    "names": ["str"],
    "state": {
        "n": "num",
        "started": "bool",
        "window": [_ENCODED_ARRAY],
        "label_sum": _ENCODED_ARRAY,
        "label_obs": _ENCODED_ARRAY,
        "err_sum": _ENCODED_ARRAY,
        "err_obs": _ENCODED_ARRAY,
        "prev_err5": _ENCODED_ARRAY,
        "prev_lat": _ENCODED_ARRAY,
        "deg_in": _ENCODED_ARRAY,
        "deg_out": _ENCODED_ARRAY,
    },
    "hourBucket": Opt({"hour": "num", "arrays": [_ENCODED_ARRAY]}),
    "forecast": Opt(
        {
            "features": _ENCODED_ARRAY,
            "src": _ENCODED_ARRAY,
            "dst": _ENCODED_ARRAY,
            "mask": _ENCODED_ARRAY,
            "names": ["str"],
            "predictedHour": "num",
        }
    ),
    "historyFeatures": Opt(_ENCODED_ARRAY),
    "modelFeatures": Opt(_ENCODED_ARRAY),
    "predictedHour": Opt("num"),
}

SCHEMAS: Dict[str, dict] = {
    "AggregatedData": AGGREGATED_DATA,
    "HistoricalData": HISTORICAL_DATA,
    "CombinedRealtimeData": COMBINED_REALTIME_DATA,
    "EndpointDataType": ENDPOINT_DATA_TYPE,
    "EndpointDependencies": ENDPOINT_DEPENDENCIES,
    "UserDefinedLabel": USER_DEFINED_LABEL,
    "TaggedInterface": TAGGED_INTERFACE,
    "TaggedSwagger": TAGGED_SWAGGER,
    "TaggedDiffData": TAGGED_DIFF_DATA,
    "ModelHistoryState": MODEL_HISTORY_STATE,
}

# -- migrations --------------------------------------------------------------

# per-collection {from_version: migrate(doc) -> doc}; reads walk a doc
# forward one version at a time until CURRENT_VERSION
MIGRATIONS: Dict[str, Dict[int, Callable[[dict], dict]]] = {}


def _stamp_v1(doc: dict) -> dict:
    """0 -> 1: pre-versioning documents are shape-identical; stamp only."""
    return doc


def _endpoint_data_type_v1(doc: dict) -> dict:
    """0 -> 1 for EndpointDataType: pre-versioning writers could persist
    per-status schemas with ``time: null`` (merge_schema_with used to
    default the merge timestamp to None; the reference stamps
    ``new Date()``, EndpointDataType.ts:160). Repair to epoch 0 so the
    entry sorts oldest, matching how the old reader treated it
    (``s.get("time") or 0``)."""
    out = dict(doc)
    out["schemas"] = [
        {**s, "time": s.get("time") or 0} for s in doc.get("schemas", [])
    ]
    return out


for _name in SCHEMAS:
    MIGRATIONS[_name] = {0: _stamp_v1}
MIGRATIONS["EndpointDataType"] = {0: _endpoint_data_type_v1}


def validate_doc(collection: str, doc: Any) -> None:
    """Raise SchemaValidationError when doc does not match the collection
    shape. Unknown collections pass (the simulator adds private ones)."""
    spec = SCHEMAS.get(collection)
    if spec is None:
        return
    _check(spec, doc, collection, "")


def stamp(doc: dict) -> dict:
    """Mark a document as written at the current schema version."""
    doc.setdefault("_schemaVersion", CURRENT_VERSION)
    return doc


def migrate(collection: str, doc: dict) -> dict:
    """Walk a read document forward to CURRENT_VERSION via MIGRATIONS.
    Raises SchemaValidationError when a needed migration is missing.
    Unknown collections pass through unchanged, matching validate_doc's
    policy (the simulator adds private collections this module never
    versions)."""
    if collection not in SCHEMAS:
        return doc
    version = doc.get("_schemaVersion", 0)
    while version < CURRENT_VERSION:
        hook = MIGRATIONS.get(collection, {}).get(version)
        if hook is None:
            raise SchemaValidationError(
                collection,
                "_schemaVersion",
                f"no migration from version {version}",
            )
        doc = hook(doc)
        doc["_schemaVersion"] = version + 1
        version += 1
    return doc
