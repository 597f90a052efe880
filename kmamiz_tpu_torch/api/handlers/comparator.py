"""Comparator REST handler: tagged diff snapshots of the whole system view.

Equivalent of KMamiz src/handler/ComparatorService.ts: a diff
snapshot captures the dependency graph, every scorer's output, and the
per-endpoint datatype map, either stored locally (production) or pushed to
the production instance (simulator).
"""
from __future__ import annotations

import json
import urllib.request
from typing import Optional

from kmamiz_tpu_torch.api.handlers.data import DataHandler
from kmamiz_tpu_torch.api.handlers.graph import GraphHandler
from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.server.initializer import AppContext


class ComparatorHandler(IRequestHandler):
    def __init__(
        self,
        ctx: AppContext,
        graph_handler: Optional[GraphHandler] = None,
        data_handler: Optional[DataHandler] = None,
    ) -> None:
        super().__init__("comparator")
        self._ctx = ctx
        self._graph = graph_handler or GraphHandler(ctx)
        self._data = data_handler or DataHandler(ctx)

        self.add_route("get", "/tags", self._tags)
        self.add_route("get", "/diffData", self._get_diff)
        self.add_route("post", "/diffData", self._post_diff)
        self.add_route("delete", "/diffData", self._delete_diff)
        if not ctx.settings.simulator_mode:
            self.add_route("post", "/diffData/simulator", self._post_from_simulator)

    def _tags(self, req: Request) -> Response:
        return Response(
            payload=self._ctx.cache.get("TaggedDiffDatas").get_tags_with_time()
        )

    def _get_diff(self, req: Request) -> Response:
        return Response(payload=self.get_tagged_diff_data(req.query.get("tag")))

    def _post_diff(self, req: Request) -> Response:
        body = req.json() or {}
        tag = body.get("tag")
        if not tag:
            return Response.status_only(400)

        snapshot = self._snapshot(tag)
        if self._ctx.settings.simulator_mode:
            return self._push_to_production(snapshot)
        self._ctx.cache.get("TaggedDiffDatas").add(snapshot)
        return Response.status_only(200)

    def _post_from_simulator(self, req: Request) -> Response:
        tagged = req.json()
        if not tagged:
            return Response.status_only(400)
        self._ctx.cache.get("TaggedDiffDatas").add(tagged)
        return Response.status_only(200)

    def _delete_diff(self, req: Request) -> Response:
        body = req.json() or {}
        tag = body.get("tag")
        if not tag:
            return Response.status_only(400)
        self._ctx.cache.get("TaggedDiffDatas").delete(tag)
        return Response.status_only(200)

    # -- snapshot assembly (ComparatorService.ts:35-88,130-160) --------------

    def _snapshot(self, tag: str) -> dict:
        graph_data = self._graph.get_dependency_graph()
        return {
            "tag": tag,
            "graphData": graph_data,
            "cohesionData": self._graph.get_service_cohesion(),
            "couplingData": self._graph.get_service_coupling(),
            "instabilityData": self._graph.get_service_instability(),
            "endpointDataTypesMap": self._data.get_endpoint_data_types_map(
                [n["id"] for n in graph_data["nodes"]]
            ),
        }

    def get_tagged_diff_data(self, tag: Optional[str] = None) -> dict:
        if tag:
            diff = self._ctx.cache.get("TaggedDiffDatas").get_data_by_tag(tag)
            return {
                "tag": tag,
                "graphData": (diff or {}).get("graphData")
                or self._graph.get_empty_graph_data(),
                "cohesionData": (diff or {}).get("cohesionData") or [],
                "couplingData": (diff or {}).get("couplingData") or [],
                "instabilityData": (diff or {}).get("instabilityData") or [],
                "endpointDataTypesMap": (diff or {}).get("endpointDataTypesMap")
                or {},
            }
        graph_data = self._graph.get_dependency_graph()
        node_ids = [
            n["id"] for n in graph_data["nodes"] if n["id"] != n["group"]
        ]
        return {
            "tag": tag,
            "graphData": graph_data,
            "cohesionData": self._graph.get_service_cohesion(),
            "couplingData": self._graph.get_service_coupling(),
            "instabilityData": self._graph.get_service_instability(),
            "endpointDataTypesMap": self._data.get_endpoint_data_types_map(
                node_ids
            ),
        }

    def _push_to_production(self, snapshot: dict) -> Response:
        """Simulator -> production push (ComparatorService.ts:47-79)."""
        base_url = self._ctx.extra.get("production_service_url", "")
        if not base_url:
            return Response.status_only(500)
        snapshot = {**snapshot, "tag": f"[from Simulator] {snapshot['tag']}"}
        try:
            req = urllib.request.Request(
                f"{base_url}/api/v1/comparator/diffData/simulator",
                data=json.dumps(snapshot).encode(),
                method="POST",
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=30) as res:
                if res.status >= 400:
                    return Response(
                        status=500, payload={"message": res.read().decode()}
                    )
            return Response.status_only(200)
        except Exception:  # noqa: BLE001 - production unreachable
            return Response.status_only(500)
