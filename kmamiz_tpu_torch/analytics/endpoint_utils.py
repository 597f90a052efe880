"""Endpoint path speculation and label masking.

A copy of kmamiz_tpu/analytics/endpoint_utils.py (KMamiz
src/utils/EndpointUtils.ts): endpoints are
grouped by (service, method, token count, >50% token match, schema match)
and their paths merged into masked labels like "/api/{a,b}" or "/api/{}";
unknown endpoints are guessed by walking the label tree.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from kmamiz_tpu_torch.core.urls import explode_url


def create_endpoint_label_mapping(
    data_types: List["EndpointDataType"], matching_threshold: float = 0.5
) -> Dict[str, str]:
    """Group similar endpoints per service and label them with merged masked
    paths (EndpointUtils.ts:5-63)."""
    service_mapping: Dict[str, list] = {}
    for d in data_types:
        service_mapping.setdefault(d.to_json()["uniqueServiceName"], []).append(d)

    groups: List[list] = []
    for endpoints in service_mapping.values():
        grouped = set()
        for e in endpoints:
            if e.to_json()["uniqueEndpointName"] in grouped:
                continue
            group = []
            for ep in endpoints:
                if e.to_json()["method"] != ep.to_json()["method"]:
                    continue
                base_url = e.to_json()["uniqueEndpointName"].split("\t")[4]
                cmp_url = ep.to_json()["uniqueEndpointName"].split("\t")[4]
                base_path = explode_url(base_url).path
                cmp_path = explode_url(cmp_url).path
                if not _has_exact_token_count(base_path, cmp_path):
                    continue
                if not _has_matching_tokens(base_path, cmp_path, matching_threshold):
                    continue
                if e.has_matched_schema(ep):
                    group.append(ep)
            if group:
                groups.append(group)
            for ep in group:
                grouped.add(ep.to_json()["uniqueEndpointName"])

    label_mapping: Dict[str, str] = {}
    for group in groups:
        unique_names = [e.to_json()["uniqueEndpointName"] for e in group]
        paths = [
            explode_url(name.split("\t")[4]).path for name in unique_names
        ]
        label = _combine_and_mask_urls(paths)
        for name in unique_names:
            label_mapping[name] = label
    return label_mapping


def guess_and_merge_endpoints(
    unique_names: List[str], label_map: Dict[str, str]
) -> Dict[str, str]:
    """Guess labels for unknown endpoints by walking the known label tree
    (EndpointUtils.ts:65-113). Mutates and returns label_map."""
    import re

    label_to_sample: Dict[str, str] = {}
    for key, val in label_map.items():
        label_to_sample[re.sub(r"\{[^}]*\}", "{}", val, count=1)] = key

    label_tree: dict = {}
    for label in label_map.values():
        tokens = re.sub(r"\{[^}]*\}", "{}", label, count=1).split("/")[1:]
        root = label_tree
        for tok in tokens:
            root = root.setdefault(tok, {})

    for u in unique_names:
        if u in label_map:
            continue
        parts = u.split("\t")
        service, namespace, version, method, url = (
            parts[0],
            parts[1],
            parts[2],
            parts[3],
            parts[4],
        )
        unique_service_name = f"{service}\t{namespace}\t{version}"
        path = explode_url(url).path
        tokens = path.split("/")[1:]
        visited: List[str] = []
        root = label_tree
        dead_end = False
        for tok in tokens:
            if tok not in root:
                tok = "{}"
            if tok not in root:
                dead_end = True
                break
            visited.append(tok)
            root = root[tok]
        if dead_end:
            continue
        label = "/" + "/".join(visited)
        sample = label_to_sample.get(label)
        if sample and sample.startswith(f"{unique_service_name}\t{method}"):
            label_map[u] = label_map[sample]
    return label_map


def _combine_and_mask_urls(urls: List[str]) -> str:
    """Merge path variants into one masked label (EndpointUtils.ts:115-140)."""
    url_table = [u.split("/") for u in urls]
    masked = list(url_table[0])
    # insertion-ordered variant sets (JS Set iteration order)
    masked_position: Dict[int, dict] = {}
    for row in url_table[1:]:
        for j in range(len(masked)):
            other = row[j] if j < len(row) else None
            if masked[j] != other:
                pos = masked_position.setdefault(j, {masked[j]: None})
                pos[other] = None
                masked[j] = "{}"

    for i, token in enumerate(masked):
        if token != "{}":
            continue
        variants = list(masked_position.get(i, {}))
        if len(variants) > 5:
            continue
        partial = (
            "{"
            + ",".join(v.strip() for v in variants if v and v.strip())
            + "}"
        )
        if len(partial) <= 20:
            masked[i] = partial
    return "/".join(masked)


def _has_exact_token_count(path_a: str, path_b: str) -> bool:
    return len(path_a.split("/")) == len(path_b.split("/"))


def _has_matching_tokens(path_a: str, path_b: str, percentage: float) -> bool:
    tok_a = path_a.split("/")
    tok_b = path_b.split("/")
    length = min(len(tok_a), len(tok_b))
    equal = sum(1 for i in range(length) if tok_a[i] == tok_b[i])
    return equal / length > percentage
