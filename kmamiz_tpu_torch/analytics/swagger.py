"""OpenAPI 3.0.1 document generation from endpoint data types.

Parity with KMamiz src/utils/SwaggerUtils.ts: per-status
responses, merged request bodies, query params, and recorded-example
descriptions. The label->endpoints resolver is injected (the reference
reads it from the LabelMapping cache singleton).

A copy of kmamiz_tpu/analytics/swagger.py, importing the port's modules.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from kmamiz_tpu_torch.core.schema import map_object_to_openapi_types, merge_object


def from_endpoints(
    title: str,
    version: str,
    endpoints: List[dict],
    endpoints_from_label: Optional[Callable[[str], List[str]]] = None,
) -> dict:
    """EndpointDataType dicts -> OpenAPI document (SwaggerUtils.ts:11-48)."""
    endpoint_mapping: Dict[Optional[str], List[dict]] = {}
    for e in endpoints:
        endpoint_mapping.setdefault(e.get("labelName"), []).append(e)

    paths: Dict[str, dict] = {}
    for label, eps in endpoint_mapping.items():
        item: dict = {}
        for e in eps:
            item.update(endpoint_to_path_item(e, endpoints_from_label))
        paths[label] = item

    return {
        "openapi": "3.0.1",
        "info": {"title": title, "version": version},
        "paths": paths,
        "components": {},
    }


def endpoint_to_path_item(
    endpoint: dict,
    endpoints_from_label: Optional[Callable[[str], List[str]]] = None,
) -> dict:
    """One endpoint data type -> path item (SwaggerUtils.ts:50-139)."""
    responses: dict = {}
    for s in endpoint.get("schemas", []):
        entry: dict = {"description": s["status"]}
        if s.get("responseSample"):
            entry["content"] = {
                "application/json": {
                    "schema": map_object_to_openapi_types(s["responseSample"])
                }
            }
        responses[s["status"]] = entry

    requests: dict = {}
    for s in endpoint.get("schemas", []):
        requests = merge_object(requests, s.get("requestSample"))
    request_body = (
        {
            "content": {
                "application/json": {
                    "schema": map_object_to_openapi_types(requests)
                }
            }
        }
        if requests
        else None
    )

    parameters = [
        {"in": "query", "name": p["param"], "schema": {"type": p["type"]}}
        for s in endpoint.get("schemas", [])
        for p in (s.get("requestParams") or [])
    ]

    label = endpoint.get("labelName")
    examples = endpoints_from_label(label) if endpoints_from_label else []
    if not examples:
        examples = [label or ""]
    example_urls = "\n".join(
        f"  - {e.split(chr(9))[-1]}" for e in examples[:10]
    )
    description = f"**Recorded examples:**\n\n{example_urls}"

    method = endpoint.get("method")
    if method in ("POST", "PUT", "DELETE"):
        op = {"responses": responses, "description": description}
        if request_body is not None:  # undefined keys vanish in the reference
            op["requestBody"] = request_body
        return {method.lower(): op}
    return {
        "get": {
            "responses": responses,
            "parameters": parameters,
            "description": description,
        }
    }
