"""Graph REST handler: dependency graphs, chords, charts and scorers.

Counterpart of kmamiz_tpu/api/handlers/graph.py (KMamiz
src/handler/GraphService.ts). Graph views and chords are cache reads
followed by host computations. The scorer routes (cohesion, instability,
coupling) are served from ops/scorers.py over the processor's resident
EndpointGraph on its device: the device returns integer counts and the
handler assembles the exact ratios in float64, so payloads equal the host
implementation's. The host path runs only when the caller asks for it
(`?scorer=host`), when there is no processor, or when the graph is empty.
Unlike the JAX handler, a device error is not answered with the host
oracle: it propagates and the router answers 500. The charts (`/line`,
`/statistics`, `/requests`) read the labeled historical data of the store
through ServiceUtils.
"""
from __future__ import annotations

import threading
import math
from typing import Callable, List, Optional

import numpy as np

from kmamiz_tpu_torch import config
from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.domain.endpoint_data_type import EndpointDataType
from kmamiz_tpu_torch.domain.endpoint_dependencies import EndpointDependencies
from kmamiz_tpu_torch.server.initializer import AppContext


class GraphHandler(IRequestHandler):
    def __init__(self, ctx: AppContext) -> None:
        super().__init__("graph")
        self._ctx = ctx
        self._label_version = None
        # scorer payload cache: (kind, namespace) -> (key, payload)
        self._scorer_payload_cache: dict = {}
        self._scorer_cache_lock = threading.Lock()

        self.add_route("get", "/dependency/endpoint/:namespace?", self._dependency)
        self.add_route("get", "/dependency/service/:namespace?", self._service_dependency)
        self.add_route("get", "/chord/direct/:namespace?", self._chord_direct)
        self.add_route("get", "/chord/indirect/:namespace?", self._chord_indirect)
        self.add_route("get", "/line/:namespace?", self._line)
        self.add_route("get", "/statistics/:namespace?", self._statistics)
        self.add_route("get", "/cohesion/:namespace?", self._cohesion)
        self.add_route("get", "/instability/:namespace?", self._instability)
        self.add_route("get", "/coupling/:namespace?", self._coupling)
        self.add_route("get", "/requests/:uniqueName", self._requests)

    # -- routes --------------------------------------------------------------

    def _dependency(self, req: Request) -> Response:
        graph = self.get_dependency_graph(req.params.get("namespace"))
        return Response(payload=graph) if graph else Response.status_only(404)

    def _service_dependency(self, req: Request) -> Response:
        graph = self.get_service_dependency_graph(req.params.get("namespace"))
        return Response(payload=graph) if graph else Response.status_only(404)

    def _chord_direct(self, req: Request) -> Response:
        return Response(payload=self.get_direct_service_chord(req.params.get("namespace")))

    def _chord_indirect(self, req: Request) -> Response:
        return Response(payload=self.get_indirect_service_chord(req.params.get("namespace")))

    def _line(self, req: Request) -> Response:
        return Response(
            payload=self.get_line_chart_data(
                req.params.get("namespace"), req.query_int("notBefore")
            )
        )

    def _statistics(self, req: Request) -> Response:
        return Response(
            payload=self.get_service_historical_statistics(
                req.params.get("namespace"), req.query_int("notBefore")
            )
        )

    def _cohesion(self, req: Request) -> Response:
        return Response(
            payload=self.get_service_cohesion(
                req.params.get("namespace"), force_host=req.query.get("scorer") == "host"
            )
        )

    def _instability(self, req: Request) -> Response:
        return Response(
            payload=self.get_service_instability(
                req.params.get("namespace"), force_host=req.query.get("scorer") == "host"
            )
        )

    def _coupling(self, req: Request) -> Response:
        return Response(
            payload=self.get_service_coupling(
                req.params.get("namespace"), force_host=req.query.get("scorer") == "host"
            )
        )

    def _requests(self, req: Request) -> Response:
        return Response(
            payload=self.get_request_info_chart_data(
                req.params["uniqueName"],
                req.query.get("ignoreServiceVersion") == "true",
                req.query_int("notBefore") or 86_400_000,
            )
        )

    # -- graph views (GraphService.ts:113-180) -------------------------------

    def _labeled_dependencies(self, namespace: Optional[str] = None) -> Optional[EndpointDependencies]:
        return self._ctx.cache.get("LabeledEndpointDependencies").get_data(namespace)

    def get_dependency_graph(self, namespace: Optional[str] = None) -> dict:
        dependencies = self._labeled_dependencies(namespace)
        if not dependencies:
            return self.get_empty_graph_data()
        return dependencies.to_graph_data()

    def get_empty_graph_data(self) -> dict:
        return EndpointDependencies([]).to_graph_data()

    def get_service_dependency_graph(self, namespace: Optional[str] = None) -> dict:
        return self.to_service_dependency_graph(self.get_dependency_graph(namespace))

    @staticmethod
    def to_service_dependency_graph(endpoint_graph: dict) -> dict:
        """Collapse the endpoint graph to service granularity
        (GraphService.ts:131-155)."""
        link_set = {}
        for l in endpoint_graph["links"]:
            source = "\t".join(l["source"].split("\t")[:2])
            target = "\t".join(l["target"].split("\t")[:2])
            link_set[f"{source}\n{target}"] = None
        links = [{"source": s, "target": t} for s, t in (k.split("\n") for k in link_set)]
        nodes = [n for n in endpoint_graph["nodes"] if n["id"] == n["group"]]
        for n in nodes:
            in_between = [l for l in links if l["source"] == n["id"]]
            n["linkInBetween"] = in_between
            n["dependencies"] = [l["target"] for l in in_between]
        return {"nodes": nodes, "links": links}

    def get_direct_service_chord(self, namespace: Optional[str] = None) -> dict:
        dependencies = self._labeled_dependencies(namespace)
        if not dependencies:
            return {"nodes": [], "links": []}
        direct = [
            {**ep, "dependingOn": [d for d in ep["dependingOn"] if d["distance"] == 1]}
            for ep in dependencies.to_json()
        ]
        return EndpointDependencies(direct).to_chord_data()

    def get_indirect_service_chord(self, namespace: Optional[str] = None) -> dict:
        dependencies = self._labeled_dependencies(namespace)
        if not dependencies:
            return {"nodes": [], "links": []}
        return dependencies.to_chord_data()

    # -- charts (GraphService.ts:182-292) ------------------------------------

    def get_line_chart_data(
        self,
        namespace: Optional[str] = None,
        not_before_ms: Optional[int] = None,
    ) -> dict:
        """not_before_ms is a look-back duration (the API's notBefore)."""
        historical = self._ctx.service_utils.get_realtime_historical_data(
            namespace, not_before_ms
        )
        if not historical:
            return {"dates": [], "metrics": [], "services": []}

        historical.sort(key=lambda h: h["date"])
        first_services = sorted(
            historical[0]["services"], key=lambda s: s["uniqueServiceName"]
        )
        services = [
            f"{s['service']}.{s['namespace']} ({s['version']})"
            for s in first_services
        ]
        dates: List[float] = []
        metrics: List[List[List[float]]] = []
        for h in historical:
            dates.append(h["date"])
            rows = sorted(h["services"], key=lambda s: s["uniqueServiceName"])
            metrics.append(
                [
                    [
                        s["requests"],
                        s["requestErrors"],
                        s["serverErrors"],
                        s["latencyCV"],
                        s.get("latencyMean", 0),
                        s.get("risk") or 0,
                    ]
                    for s in rows
                ]
            )
        return {"dates": dates, "services": services, "metrics": metrics}

    def get_service_historical_statistics(
        self,
        namespace: Optional[str] = None,
        not_before_ms: Optional[int] = None,
    ) -> List[dict]:
        historical = self._ctx.service_utils.get_realtime_historical_data(
            namespace, not_before_ms
        )
        stats: dict = {}
        for h in historical:
            for si in h["services"]:
                key = si["uniqueServiceName"]
                if key not in stats:
                    service, ns, version = key.split("\t")
                    stats[key] = {
                        "name": f"{service}.{ns} ({version})",
                        "totalLatencyMean": 0.0,
                        "totalRequests": 0,
                        "totalServerError": 0,
                        "totalRequestError": 0,
                        "validCount": 0,
                    }
                mean = si.get("latencyMean")
                if isinstance(mean, (int, float)) and math.isfinite(mean):
                    stats[key]["totalLatencyMean"] += mean
                    stats[key]["validCount"] += 1
                stats[key]["totalRequests"] += si["requests"]
                stats[key]["totalRequestError"] += si["requestErrors"]
                stats[key]["totalServerError"] += si["serverErrors"]
        return [
            {
                "uniqueServiceName": key,
                "name": v["name"],
                "latencyMean": v["totalLatencyMean"] / v["validCount"],
                "serverErrorRate": (
                    v["totalServerError"] / v["totalRequests"]
                    if v["totalRequests"]
                    else 0
                ),
                "requestErrorsRate": (
                    v["totalRequestError"] / v["totalRequests"]
                    if v["totalRequests"]
                    else 0
                ),
            }
            for key, v in stats.items()
            if v["validCount"] != 0
        ]

    # -- scorers (GraphService.ts:294-379) -----------------------------------

    def _device_graph(self):
        """The processor's graph, or None when there is no processor or
        the graph holds no edge (then the host path answers, as in the
        JAX handler). Drops the graph's label tables when the label map
        has changed since the last scorer call."""
        proc = self._ctx.processor
        graph = proc.graph if proc is not None else None
        if graph is None or graph.n_edges == 0:
            return None
        label_map = self._ctx.cache.get("LabelMapping")
        version = label_map.last_update if label_map is not None else None
        if version != self._label_version:
            graph.invalidate_labels()
            self._label_version = version
        return graph

    def _label_of(self) -> Optional[Callable[[str], Optional[str]]]:
        label_map = self._ctx.cache.get("LabelMapping")
        return label_map.get_label if label_map is not None else None

    def _scorer_cached(self, kind: str, namespace, extra_key, builder):
        """Payloads cached by (graph version, label-map freshness,
        namespace, scorer-specific freshness): every merge moves the
        graph version, so invalidation is automatic. Bypassed when a
        deprecated-endpoint threshold makes the scores time-varying, and
        without a processor."""
        if config.parse_threshold_ms(config.settings.deprecated_endpoint_threshold):
            return builder()
        processor = self._ctx.processor
        if processor is None:
            return builder()
        label_map = self._ctx.cache.get("LabelMapping")
        key = (
            processor.graph.version,
            label_map.last_update if label_map is not None else None,
            namespace,
            extra_key,
        )
        cache = self._scorer_payload_cache
        with self._scorer_cache_lock:
            hit = cache.get((kind, namespace))
            if hit is not None and hit[0] == key:
                return hit[1]
            # evict entries of older graph versions (the namespace axis is
            # caller-controlled)
            for k in [k for k, v in cache.items() if v[0][0] != key[0]]:
                del cache[k]
        payload = builder()  # device work runs outside the lock
        with self._scorer_cache_lock:
            cache[(kind, namespace)] = (key, payload)
        return payload

    @staticmethod
    def _service_rows(graph, namespace):
        """(sid, uniqueServiceName, display name) of the active services in
        the namespace, sorted by display name like every host scorer."""
        active = graph.active_services()
        rows = []
        for sid in range(len(graph.interner.services)):
            if sid >= len(active) or not active[sid]:
                continue
            usn = graph.interner.services.lookup(sid)
            service, ns, version = (usn.split("\t") + ["", ""])[:3]
            if namespace and ns != namespace:
                continue
            rows.append((sid, usn, f"{service}.{ns} ({version})"))
        rows.sort(key=lambda r: r[2])
        return rows

    def _device_usage_cohesion(self, graph, namespace) -> List[dict]:
        # raw endpoint granularity: no label collapsing for cohesion
        coh = graph.usage_cohesion()
        total = coh.total_endpoints.cpu().numpy()
        p_valid = coh.pair_valid.cpu().numpy()
        p_owner = coh.pair_owner.cpu().numpy()[p_valid]
        p_consumer = coh.pair_consumer.cpu().numpy()[p_valid]
        p_consumes = coh.pair_consumes.cpu().numpy()[p_valid]
        consumers_of: dict = {}
        for owner, consumer, consumes in zip(p_owner.tolist(), p_consumer.tolist(), p_consumes.tolist()):
            consumers_of.setdefault(owner, []).append((consumer, int(consumes)))
        services = graph.interner.services
        out = []
        for sid, usn, _name in self._service_rows(graph, namespace):
            consumers = [
                {"uniqueServiceName": services.lookup(c), "consumes": n}
                for c, n in consumers_of.get(sid, [])
            ]
            total_eps = int(total[sid]) if sid < len(total) else 0
            # exact f64 ratio from integer counts (the device's are f32)
            cohesion = 0.0
            if total_eps and consumers:
                cohesion = sum(c["consumes"] / total_eps for c in consumers) / len(consumers)
            out.append(
                {
                    "uniqueServiceName": usn,
                    "totalEndpoints": total_eps,
                    "consumers": consumers,
                    "endpointUsageCohesion": cohesion,
                }
            )
        return out

    def get_service_cohesion(self, namespace: Optional[str] = None, force_host: bool = False) -> List[dict]:
        if force_host:
            return self._build_service_cohesion(namespace, True)
        dt_cache = self._ctx.cache.get("EndpointDataType")
        dt_lu = dt_cache.last_update if dt_cache is not None else None
        return self._scorer_cached(
            "cohesion", namespace, dt_lu, lambda: self._build_service_cohesion(namespace, False)
        )

    def _build_service_cohesion(self, namespace: Optional[str], force_host: bool) -> List[dict]:
        graph = None if force_host else self._device_graph()
        if graph is not None:
            usage_cohesions = self._device_usage_cohesion(graph, namespace)
        else:
            dependencies = self._labeled_dependencies(namespace)
            if not dependencies:
                return []
            usage_cohesions = dependencies.to_service_endpoint_cohesion()

        label_map = self._ctx.cache.get("LabelMapping")
        data_types = []
        for e in self._ctx.cache.get("EndpointDataType").get_data():
            raw = dict(e.to_json())
            raw["labelName"] = label_map.get_label(raw["uniqueEndpointName"]) or raw["uniqueEndpointName"]
            data_types.append(EndpointDataType(raw))
        data_cohesion = {
            d["uniqueServiceName"]: d for d in EndpointDataType.get_service_cohesion(data_types)
        }

        results = []
        for u in usage_cohesions:
            name = u["uniqueServiceName"]
            service, ns, version = name.split("\t")
            d = data_cohesion.get(name)
            data_score = d["cohesiveness"] if d else 0
            results.append(
                {
                    "uniqueServiceName": name,
                    "isDatatypeMatched": d is not None,
                    "name": f"{service}.{ns} ({version})",
                    "dataCohesion": data_score,
                    "usageCohesion": u["endpointUsageCohesion"],
                    "totalInterfaceCohesion": (data_score + u["endpointUsageCohesion"]) / 2,
                    "endpointCohesion": d["endpointCohesion"] if d else [],
                    "totalEndpoints": u["totalEndpoints"],
                    "consumers": u["consumers"],
                }
            )
        return sorted(results, key=lambda r: r["name"])

    def get_service_instability(self, namespace: Optional[str] = None, force_host: bool = False) -> List[dict]:
        if force_host:
            return self._build_service_instability(namespace, True)
        return self._scorer_cached(
            "instability", namespace, None, lambda: self._build_service_instability(namespace, False)
        )

    def _build_service_instability(self, namespace: Optional[str], force_host: bool) -> List[dict]:
        graph = None if force_host else self._device_graph()
        if graph is None:
            dependencies = self._labeled_dependencies(namespace)
            if not dependencies:
                return []
            return sorted(dependencies.to_service_instability(), key=lambda r: r["name"])
        scores = graph.service_scores(self._label_of())
        on = scores.instability_on.cpu().numpy()
        by = scores.instability_by.cpu().numpy()
        out = []
        for sid, usn, name in self._service_rows(graph, namespace):
            d_on, d_by = int(on[sid]), int(by[sid])
            total = d_on + d_by
            out.append(
                {
                    "uniqueServiceName": usn,
                    "name": name,
                    "dependingBy": d_by,
                    "dependingOn": d_on,
                    # exact f64 ratio from the integer counts
                    "instability": d_on / total if total else 0,
                }
            )
        return out

    def get_service_coupling(self, namespace: Optional[str] = None, force_host: bool = False) -> List[dict]:
        if force_host:
            return self._build_service_coupling(namespace, True)
        return self._scorer_cached(
            "coupling", namespace, None, lambda: self._build_service_coupling(namespace, False)
        )

    def _build_service_coupling(self, namespace: Optional[str], force_host: bool) -> List[dict]:
        graph = None if force_host else self._device_graph()
        if graph is None:
            dependencies = self._labeled_dependencies(namespace)
            if not dependencies:
                return []
            return sorted(dependencies.to_service_coupling(), key=lambda r: r["name"])
        scores = graph.service_scores(self._label_of())
        ais = scores.ais.cpu().numpy()
        ads = scores.ads.cpu().numpy()
        out = []
        for sid, usn, name in self._service_rows(graph, namespace):
            d_ais, d_ads = int(ais[sid]), int(ads[sid])
            out.append(
                {
                    "uniqueServiceName": usn,
                    "name": name,
                    "ais": d_ais,
                    "ads": d_ads,
                    "acs": d_ais * d_ads,
                }
            )
        return out

    # -- per-endpoint request chart (GraphService.ts:381-448) ----------------

    def get_request_info_chart_data(
        self,
        unique_name: str,
        ignore_service_version: bool = False,
        not_before_ms: int = 86_400_000,
    ) -> dict:
        parts = unique_name.split("\t")
        # the reference's loose destructuring yields an empty chart for a
        # malformed name (GraphService.ts:385-388), not an error
        service = parts[0] if len(parts) > 0 else ""
        namespace = parts[1] if len(parts) > 1 else ""
        version = parts[2] if len(parts) > 2 else ""
        method = parts[3] if len(parts) > 3 else None
        label_name = parts[4] if len(parts) > 4 else None
        is_endpoint = bool(method and label_name)
        unique_service_name = f"{service}\t{namespace}\t{version}"

        historical = self._ctx.service_utils.get_realtime_historical_data(
            None, not_before_ms
        )
        filtered = [
            s
            for h in historical
            for s in h["services"]
            if (
                s["service"] == service and s["namespace"] == namespace
                if ignore_service_version
                else s["uniqueServiceName"] == unique_service_name
            )
        ]
        filtered.sort(key=lambda s: s["date"])

        if is_endpoint:
            source = []
            for s in filtered:
                endpoint = next(
                    (
                        e
                        for e in s["endpoints"]
                        if e.get("labelName") == label_name
                        and e["method"] == method
                    ),
                    None,
                )
                source.append({"date": s["date"], "risk": None, **(endpoint or {})})
        else:
            source = filtered

        chart = {
            "time": [],
            "requests": [],
            "clientErrors": [],
            "serverErrors": [],
            "latencyCV": [],
            "risks": None if is_endpoint else [],
            "totalRequestCount": 0,
            "totalClientErrors": 0,
            "totalServerErrors": 0,
        }
        for s in source:
            client_error = s.get("requestErrors") or 0
            server_error = s.get("serverErrors") or 0
            request = (s.get("requests") or 0) - server_error - client_error
            chart["time"].append(s["date"])
            chart["requests"].append(request)
            chart["clientErrors"].append(client_error)
            chart["serverErrors"].append(server_error)
            chart["latencyCV"].append(s.get("latencyCV") or 0)
            if not is_endpoint:
                chart["risks"].append(s.get("risk") or 0)
            chart["totalRequestCount"] += request
            chart["totalClientErrors"] += client_error
            chart["totalServerErrors"] += server_error
        return chart
