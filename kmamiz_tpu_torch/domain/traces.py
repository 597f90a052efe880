"""Zipkin trace ingestion: span batches -> realtime data + dependency graph.

Behavioral parity with KMamiz src/classes/Traces.ts (the Rust twin
is kmamiz_data_processor/src/data/trace.rs): SERVER-span extraction, the
parent-chain walk that skips CLIENT spans to produce (ancestor, distance)
pairs in both directions, and endpoint-info URL parsing with istio-annotation
fallback.

The dict-shaped output is the wire/protocol layer (bounded by unique
endpoints); the bulk span statistics run on device via kmamiz_tpu_torch.ops.window
over the SoA form (see core.spans.SpanBatch).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from kmamiz_tpu_torch.core.schema import js_str
from kmamiz_tpu_torch.core.urls import explode_url
from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
from kmamiz_tpu_torch.domain.realtime import RealtimeDataList


#: structural to_endpoint_info results keyed by every input EXCEPT the
#: timestamp: a window repeats the same few hundred endpoint shapes
#: thousands of times, and the URL explodes + f-string joins dominated the
#: tick's dependency phase. Bounded by distinct (name, url, tag) shapes —
#: the same cardinality the endpoint interner already holds.
_INFO_TEMPLATES: Dict[tuple, dict] = {}


def to_endpoint_info(span: dict) -> dict:
    """Trace span -> TEndpointInfo dict (reference Traces.ts:213-241)."""
    tags = span.get("tags", {})
    url = tags.get("http.url", "")
    name = span.get("name", "")
    key = (
        name,
        url,
        tags.get("http.method"),
        tags.get("istio.canonical_service"),
        tags.get("istio.namespace"),
        tags.get("istio.mesh_id"),
        tags.get("istio.canonical_revision"),
    )
    tpl = _INFO_TEMPLATES.get(key)
    if tpl is None:
        host, port, path = explode_url(url)[:3]
        service_name = namespace = cluster_name = None
        if ".svc." in name:
            e = explode_url(name, True)
            service_name, namespace, cluster_name = (
                e.service,
                e.namespace,
                e.cluster,
            )
        else:
            # probably a static file request via istio-ingress; fall back to
            # istio annotations (reference Traces.ts:219-224)
            service_name = tags.get("istio.canonical_service")
            namespace = tags.get("istio.namespace")
            cluster_name = tags.get("istio.mesh_id")
        version = tags.get("istio.canonical_revision") or "NONE"
        unique_service_name = (
            f"{js_str(service_name)}\t{js_str(namespace)}\t{version}"
        )
        method = tags.get("http.method")
        tpl = _INFO_TEMPLATES[key] = {
            "version": version,
            "service": service_name,
            "namespace": namespace,
            "url": url,
            "host": host,
            "path": path,
            "port": port or "80",
            "clusterName": cluster_name,
            "method": method,
            "uniqueServiceName": unique_service_name,
            "uniqueEndpointName": f"{unique_service_name}\t{js_str(method)}\t{url}",
        }
    info = dict(tpl)
    info["timestamp"] = span["timestamp"] / 1000
    return info


class Traces:
    """Wrapper over Zipkin trace groups (Trace[][])."""

    def __init__(self, traces: List[List[dict]]) -> None:
        self._traces = traces

    def to_json(self) -> List[List[dict]]:
        return self._traces

    def _flat(self) -> List[dict]:
        return [s for group in self._traces for s in group]

    def extract_containing_namespaces(self) -> Set[str]:
        return {s.get("tags", {}).get("istio.namespace") for s in self._flat()}

    def to_realtime_data(self, replicas: Optional[List[dict]] = None) -> RealtimeDataList:
        """SERVER spans -> per-request realtime records (Traces.ts:27-53)."""
        replica_of = _replica_index(replicas)
        records = []
        for t in self._flat():
            if t.get("kind") != "SERVER":
                continue
            tags = t.get("tags", {})
            e = explode_url(t.get("name", ""), True)
            service_name, namespace = e.service, e.namespace
            version = tags.get("istio.canonical_revision")
            method = tags.get("http.method")
            unique_service_name = (
                f"{js_str(service_name)}\t{js_str(namespace)}\t{js_str(version)}"
            )
            records.append(
                {
                    "timestamp": t["timestamp"],
                    "service": service_name,
                    "namespace": namespace,
                    "version": version,
                    "method": method,
                    # /1000: keep standard deviation from overflowing
                    "latency": t["duration"] / 1000,
                    "status": tags.get("http.status_code"),
                    "uniqueServiceName": unique_service_name,
                    "uniqueEndpointName": (
                        f"{unique_service_name}\t{js_str(method)}"
                        f"\t{js_str(tags.get('http.url'))}"
                    ),
                    "replica": replica_of.get(unique_service_name),
                }
            )
        return RealtimeDataList(records)

    def combine_logs_to_realtime_data(
        self,
        structured_logs: List[dict],
        replicas: Optional[List[dict]] = None,
    ) -> RealtimeDataList:
        """Join SERVER spans with structured envoy logs by (traceId, spanId),
        falling back to the parent span id (Traces.ts:55-106)."""
        replica_of = _replica_index(replicas)
        log_map: Dict[str, Dict[str, dict]] = {}
        for l in structured_logs:
            traces = l.get("traces", [])
            if not traces:
                continue
            trace_id = traces[0]["traceId"]
            per_trace = log_map.setdefault(trace_id, {})
            for t in traces:
                per_trace[t["spanId"]] = t

        records = []
        # window-local record templates: a 2500-trace window repeats the
        # same few hundred (service, endpoint, status) shapes, and the
        # per-span js_str f-strings dominated the combine phase. The
        # template carries every field that doesn't vary per span; body
        # fields default None and are overwritten only when a log matched.
        templates: Dict[tuple, dict] = {}
        for trace in self._flat():
            if trace.get("kind") != "SERVER":
                continue
            tags = trace.get("tags", {})
            method = tags.get("http.method")
            key = (
                tags.get("istio.canonical_service"),
                tags.get("istio.namespace"),
                tags.get("istio.canonical_revision"),
                method,
                tags.get("http.status_code"),
                tags.get("http.url"),
            )
            tpl = templates.get(key)
            if tpl is None:
                service, namespace, version, _m, status, url = key
                unique_service_name = (
                    f"{js_str(service)}\t{js_str(namespace)}\t{js_str(version)}"
                )
                tpl = templates[key] = {
                    "timestamp": 0,
                    "service": service,
                    "namespace": namespace,
                    "version": version,
                    "method": method,
                    "latency": 0.0,
                    "status": status,
                    "responseBody": None,
                    "responseContentType": None,
                    "requestBody": None,
                    "requestContentType": None,
                    "uniqueServiceName": unique_service_name,
                    "uniqueEndpointName": (
                        f"{unique_service_name}\t{js_str(method)}"
                        f"\t{js_str(url)}"
                    ),
                    "replica": replica_of.get(unique_service_name),
                }

            log = log_map.get(trace["traceId"], {}).get(trace["id"])
            # fallback-mode fix: fall back to the parent span's log entry
            if (log is None or log.get("isFallback")) and trace.get("parentId"):
                log = log_map.get(trace["traceId"], {}).get(trace["parentId"])

            rec = dict(tpl)
            rec["timestamp"] = trace["timestamp"]
            rec["latency"] = trace["duration"] / 1000
            if log is not None:
                req = log.get("request", {})
                res = log.get("response", {})
                rec["responseBody"] = res.get("body")
                rec["responseContentType"] = res.get("contentType")
                rec["requestBody"] = req.get("body")
                rec["requestContentType"] = req.get("contentType")
            records.append(rec)
        return RealtimeDataList(records)

    def to_endpoint_dependencies(self) -> EndpointDependencies:
        """Parent-chain walk per SERVER span, skipping CLIENT spans, recording
        (ancestor, distance) pairs both directions (Traces.ts:112-211).

        Fast path: the output carries endpoint CONTENT and timestamps but no
        span ids, so every trace whose shape (kinds, parent wiring, endpoint
        fields — not ids/timestamps) was seen before instantiates from a
        cached template instead of re-walking. A window repeats a few dozen
        shapes thousands of times, and this walk dominated the tick's
        dependency phase. Traces the per-group model can't represent
        (duplicate span ids, cross-trace parent references) fall back to the
        original global walk for the whole call.
        """
        groups = self._traces
        idx_maps = []
        total = 0
        all_ids: Set[str] = set()
        usable = True
        for g in groups:
            m = {s["id"]: i for i, s in enumerate(g)}
            if len(m) != len(g):
                usable = False
                break
            idx_maps.append(m)
            total += len(g)
            all_ids.update(m)
        if not usable or len(all_ids) != total:
            return self._to_endpoint_dependencies_global()

        dependencies: List[dict] = []
        last_ts: Dict[str, float] = {}
        window_edges: Set[tuple] = set()
        templates = _DEP_TEMPLATES
        for g, m in zip(groups, idx_maps):
            key = _dep_shape_key(g, m, all_ids)
            if key is None:  # cross-trace parent link: global semantics
                return self._to_endpoint_dependencies_global()
            tpl = templates.get(key)
            if tpl is None:
                if len(templates) >= _DEP_TEMPLATES_MAX:
                    templates.clear()
                tpl = templates[key] = _build_group_template(g, m)
            info_tpls, dep_specs, edge_triples = tpl
            window_edges.update(edge_triples)
            infos = {}
            for idx, content in info_tpls:
                info = dict(content)
                ts = g[idx]["timestamp"] / 1000
                info["timestamp"] = ts
                infos[idx] = info
                name = info["uniqueEndpointName"]
                if ts > last_ts.get(name, 0):
                    last_ts[name] = ts
            for self_idx, by_spec, on_spec in dep_specs:
                dependencies.append(
                    {
                        "endpoint": infos[self_idx],
                        "lastUsageTimestamp": 0,
                        "isDependedByExternal": not by_spec,
                        "dependingBy": [
                            {"endpoint": infos[j], "distance": d, "type": "CLIENT"}
                            for j, d in by_spec
                        ],
                        "dependingOn": [
                            {"endpoint": infos[j], "distance": d, "type": "SERVER"}
                            for j, d in on_spec
                        ],
                    }
                )
        for dep in dependencies:
            dep["lastUsageTimestamp"] = last_ts.get(
                dep["endpoint"]["uniqueEndpointName"], 0
            )
        out = EndpointDependencies(dependencies)
        out._clean = True
        # raw pre-deprecation-filter edge set: the graph merge must see the
        # same rows the window-walk kernel would, filtered or not
        out.window_edges = window_edges
        return out

    def _to_endpoint_dependencies_global(self) -> EndpointDependencies:
        span_map: Dict[str, dict] = {}
        for span in self._flat():
            span_map[span["id"]] = {"span": span, "upper": {}, "lower": {}}

        filtered = [
            (sid, node)
            for sid, node in span_map.items()
            if node["span"].get("kind") == "SERVER"
        ]
        for span_id, node in filtered:
            span, upper = node["span"], node["upper"]
            parent_id = span.get("parentId")
            depth = 1
            while parent_id:
                parent_node = span_map.get(parent_id)
                if parent_node is None:
                    break
                if parent_node["span"].get("kind") == "CLIENT":
                    parent_id = parent_node["span"].get("parentId")
                    continue
                upper[parent_node["span"]["id"]] = depth
                parent_node["lower"][span_id] = depth
                parent_id = parent_node["span"].get("parentId")
                depth += 1

        # endpoint info is referenced once per edge endpoint; compute it once
        # per span (URLs repeat thousands of times per window)
        info_cache: Dict[str, dict] = {}

        def info_of(sid: str) -> dict:
            info = info_cache.get(sid)
            if info is None:
                info = info_cache[sid] = to_endpoint_info(span_map[sid]["span"])
            return info

        dependencies = []
        window_edges: Set[tuple] = set()
        for span_id, node in filtered:
            # tuple keys: same JS-Map dedup/ordering as the former
            # "uen\tdistance" strings, without building + re-splitting a
            # key string per edge
            self_uen = info_of(span_id)["uniqueEndpointName"]
            upper_map: Dict[tuple, dict] = {}
            for sid, distance in node["upper"].items():
                endpoint = info_of(sid)
                uen = endpoint["uniqueEndpointName"]
                upper_map[(uen, distance)] = endpoint
                window_edges.add((uen, self_uen, distance))
            lower_map: Dict[tuple, dict] = {}
            for sid, distance in node["lower"].items():
                endpoint = info_of(sid)
                lower_map[(endpoint["uniqueEndpointName"], distance)] = endpoint

            depending_by = [
                {"endpoint": endpoint, "distance": distance, "type": "CLIENT"}
                for (_uen, distance), endpoint in upper_map.items()
            ]
            depending_on = [
                {"endpoint": endpoint, "distance": distance, "type": "SERVER"}
                for (_uen, distance), endpoint in lower_map.items()
            ]
            dependencies.append(
                {
                    "endpoint": info_of(span_id),
                    "lastUsageTimestamp": 0,  # filled below
                    "isDependedByExternal": len(depending_by) == 0,
                    "dependingBy": depending_by,
                    "dependingOn": depending_on,
                }
            )

        # last-usage timestamp per endpoint over every appearance. Every
        # endpoint dict in the output came from info_cache, so one pass
        # over the cache sees each appearance's (name, ts) — the former
        # record/by/on triple walk re-visited the same dicts per edge.
        last_ts: Dict[str, float] = {}
        for info in info_cache.values():
            name, ts = info["uniqueEndpointName"], info["timestamp"]
            if ts > last_ts.get(name, 0):
                last_ts[name] = ts
        for dep in dependencies:
            dep["lastUsageTimestamp"] = last_ts.get(
                dep["endpoint"]["uniqueEndpointName"], 0
            )

        out = EndpointDependencies(dependencies)
        out._clean = True
        out.window_edges = window_edges
        return out


#: per-trace-shape dependency templates. Keyed on everything that can alter
#: the dependency output EXCEPT span ids and timestamps: kinds, the parent
#: wiring as local indices, and the endpoint-info input fields. Bounded by
#: distinct trace shapes; cleared wholesale at the cap as a runaway guard.
_DEP_TEMPLATES: Dict[tuple, tuple] = {}
_DEP_TEMPLATES_MAX = 4096


def _dep_shape_key(group: List[dict], idx_of: Dict[str, int], all_ids: Set[str]):
    """Timestamp/id-free shape signature of one trace group, or None when a
    parentId points into ANOTHER group (the global walk can follow it; the
    per-group template cannot)."""
    parts = []
    for s in group:
        tags = s.get("tags") or {}
        p = s.get("parentId")
        if p:
            pi = idx_of.get(p)
            if pi is None:
                if p in all_ids:
                    return None
                pi = -1  # dangling parent: the walk breaks, same as global
        else:
            pi = None
        parts.append(
            (
                s.get("kind"),
                s.get("name", ""),
                pi,
                tags.get("http.url", ""),
                tags.get("http.method"),
                tags.get("istio.canonical_service"),
                tags.get("istio.namespace"),
                tags.get("istio.mesh_id"),
                tags.get("istio.canonical_revision"),
            )
        )
    return tuple(parts)


def _build_group_template(group: List[dict], idx_of: Dict[str, int]) -> tuple:
    """Run the reference walk over ONE group, recording structure as local
    span indices. Mirrors _to_endpoint_dependencies_global exactly (including
    the (uen, distance) dedup where the first duplicate keeps its position
    but the LAST one supplies the endpoint dict)."""
    upper: List[Dict[int, int]] = [{} for _ in group]
    lower: List[Dict[int, int]] = [{} for _ in group]
    server_idxs = [
        i for i, s in enumerate(group) if s.get("kind") == "SERVER"
    ]
    for i in server_idxs:
        parent_id = group[i].get("parentId")
        depth = 1
        while parent_id:
            j = idx_of.get(parent_id)
            if j is None:
                break
            pspan = group[j]
            if pspan.get("kind") == "CLIENT":
                parent_id = pspan.get("parentId")
                continue
            upper[i][j] = depth
            lower[j][i] = depth
            parent_id = pspan.get("parentId")
            depth += 1

    referenced: Set[int] = set(server_idxs)
    for i in server_idxs:
        referenced.update(upper[i])
        referenced.update(lower[i])
    info_tpls = tuple(
        (
            idx,
            {
                k: v
                for k, v in to_endpoint_info(group[idx]).items()
                if k != "timestamp"
            },
        )
        for idx in sorted(referenced)
    )
    uen_of = {idx: tpl["uniqueEndpointName"] for idx, tpl in info_tpls}

    dep_specs = []
    for i in server_idxs:
        by_map: Dict[tuple, int] = {}
        for j, distance in upper[i].items():
            by_map[(uen_of[j], distance)] = j
        on_map: Dict[tuple, int] = {}
        for j, distance in lower[i].items():
            on_map[(uen_of[j], distance)] = j
        dep_specs.append(
            (
                i,
                tuple((j, d) for (_u, d), j in by_map.items()),
                tuple((j, d) for (_u, d), j in on_map.items()),
            )
        )
    # the group's distinct (caller_uen, callee_uen, distance) triples — the
    # same (src, dst, dist) rows the device window-walk kernel derives, in
    # load_dependencies direction. dependingBy covers every walked pair
    # (each pair's descendant is a SERVER span, i.e. a record owner).
    edge_triples = tuple(
        {
            (uen_of[j], uen_of[i], d)
            for i, by_spec, _on in dep_specs
            for j, d in by_spec
        }
    )
    return info_tpls, tuple(dep_specs), edge_triples


def _replica_index(replicas: Optional[List[dict]]) -> Dict[str, int]:
    """uniqueServiceName -> replicas, first match winning like the
    reference's Array.find."""
    index: Dict[str, int] = {}
    for r in replicas or []:
        index.setdefault(r.get("uniqueServiceName"), r.get("replicas"))
    return index
