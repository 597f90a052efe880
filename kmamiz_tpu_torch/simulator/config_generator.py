"""Live system state -> static simulation-config YAML.

Equivalent of KMamiz src/MicroViSim-simulator/classes/
SimConfigGenerator.ts: snapshots the EndpointDependencies / ReplicaCounts /
EndpointDataType caches into a servicesInfo + endpointDependencies YAML the
user can edit and re-upload (`GET /simulation/generateStaticSimConfig`).
"""
from __future__ import annotations

import re
from typing import Dict, List

import yaml

from kmamiz_tpu_torch.simulator import naming
from kmamiz_tpu_torch.simulator.bodies import sample_to_user_defined_type

_EMPTY_BODY_RE = re.compile(r"^(\s*)(requestBody|responseBody): '\{\}'", re.M)


def _format_empty_bodies(raw_yaml: str) -> str:
    """Render '{}' bodies as editable multi-line blocks
    (SimConfigGenerator.ts:48-54)."""
    return _EMPTY_BODY_RE.sub(
        lambda m: f"{m.group(1)}{m.group(2)}: |-\n{m.group(1)}  {{\n\n{m.group(1)}  }}",
        raw_yaml,
    )


def generate_sim_config_from_static_data(
    data_types: List[dict],
    replica_counts: List[dict],
    endpoint_dependencies: List[dict],
) -> str:
    """SimConfigGenerator.ts:21-46. Inputs are the plain-JSON cache shapes."""
    services_info, endpoint_id_map = _build_services_info(
        data_types, replica_counts
    )
    dependencies = _build_endpoint_dependencies(
        endpoint_dependencies, endpoint_id_map
    )
    raw = yaml.safe_dump(
        {"servicesInfo": services_info, "endpointDependencies": dependencies},
        sort_keys=False,
        width=10_000,
        allow_unicode=True,
    )
    return _format_empty_bodies(raw)


def _build_services_info(data_types: List[dict], replica_counts: List[dict]):
    namespaces: Dict[str, dict] = {}
    id_counters: Dict[str, int] = {}
    endpoint_id_map: Dict[str, str] = {}

    # merge schemas by endpoint (SimConfigGenerator.ts:67-83)
    endpoint_map: Dict[str, dict] = {}
    for dt in data_types:
        key = dt["uniqueEndpointName"]
        if key not in endpoint_map:
            endpoint_map[key] = {**dt, "schemas": list(dt.get("schemas") or [])}
        else:
            endpoint_map[key]["schemas"].extend(dt.get("schemas") or [])

    for dtype in endpoint_map.values():
        namespace = dtype["namespace"]
        service = dtype["service"]
        version = dtype["version"]
        method = dtype["method"]
        schemas = dtype["schemas"]
        url = dtype["uniqueEndpointName"].split("\t")[4]
        path = naming.get_path_from_url(url)

        ns_yaml = namespaces.setdefault(
            namespace, {"namespace": namespace, "services": []}
        )
        svc_yaml = next(
            (s for s in ns_yaml["services"] if s["serviceName"] == service), None
        )
        if svc_yaml is None:
            svc_yaml = {"serviceName": service, "versions": []}
            ns_yaml["services"].append(svc_yaml)
        ver_yaml = next(
            (v for v in svc_yaml["versions"] if v["version"] == version), None
        )
        if ver_yaml is None:
            ver_yaml = {"version": version, "replica": 1, "endpoints": []}
            svc_yaml["versions"].append(ver_yaml)

        responses = [
            {
                "status": schema["status"],
                "responseContentType": schema.get("responseContentType") or "",
                "responseBody": (
                    sample_to_user_defined_type(schema.get("responseSample") or {})
                    if schema.get("responseContentType") == "application/json"
                    else "{}"
                ),
            }
            for schema in schemas
        ]
        prefix = f"{namespace}-{service}-{version}-{method.lower()}-ep"
        serial = id_counters.get(prefix, 1)
        endpoint_id = f"{prefix}-{serial}"
        id_counters[prefix] = serial + 1
        endpoint_id_map[dtype["uniqueEndpointName"]] = endpoint_id

        first = schemas[0] if schemas else {}
        ver_yaml["endpoints"].append(
            {
                "endpointId": endpoint_id,
                "endpointInfo": {"path": path, "method": method},
                "datatype": {
                    "requestContentType": first.get("requestContentType") or "",
                    "requestBody": (
                        sample_to_user_defined_type(first.get("requestSample") or {})
                        if first.get("requestContentType") == "application/json"
                        else "{}"
                    ),
                    "responses": responses,
                },
            }
        )

    for replica in replica_counts:
        ns_yaml = namespaces.get(replica["namespace"])
        if not ns_yaml:
            continue
        service_name = replica["uniqueServiceName"].split("\t")[0]
        svc_yaml = next(
            (s for s in ns_yaml["services"] if s["serviceName"] == service_name),
            None,
        )
        if not svc_yaml:
            continue
        ver_yaml = next(
            (v for v in svc_yaml["versions"] if v["version"] == replica["version"]),
            None,
        )
        if ver_yaml:
            ver_yaml["replica"] = replica["replicas"]

    return list(namespaces.values()), endpoint_id_map


def _build_endpoint_dependencies(
    endpoint_dependencies: List[dict], endpoint_id_map: Dict[str, str]
) -> List[dict]:
    result = []
    for dep in endpoint_dependencies:
        from_id = endpoint_id_map.get(dep["endpoint"]["uniqueEndpointName"])
        if not from_id:
            continue
        depend_on = [
            {"endpointId": endpoint_id_map[d["endpoint"]["uniqueEndpointName"]]}
            for d in dep.get("dependingOn", [])
            if d.get("distance") == 1
            and d["endpoint"]["uniqueEndpointName"] in endpoint_id_map
        ]
        if not depend_on:
            continue
        result.append(
            {
                "endpointId": from_id,
                "dependOn": depend_on,
                "isExternal": bool(dep.get("isDependedByExternal")),
            }
        )
    return result
