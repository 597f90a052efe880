"""Data REST handler: aggregates, history, labels, interfaces, snapshots.

Equivalent of KMamiz src/handler/DataService.ts, including the
testing endpoints gated by ENABLE_TESTING_ENDPOINTS (clear / import /
force-aggregate) and the simulator-only clone-from-production route.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.server.import_export import ImportExportHandler
from kmamiz_tpu_torch.server.initializer import AppContext


class DataHandler(IRequestHandler):
    def __init__(
        self,
        ctx: AppContext,
        import_export: Optional[ImportExportHandler] = None,
    ) -> None:
        super().__init__("data")
        self._ctx = ctx
        self._import_export = import_export or ImportExportHandler(ctx)

        self.add_route("get", "/aggregate/:namespace?", self._aggregate)
        self.add_route("get", "/serviceDisplayInfo", self._service_display_info)
        self.add_route("get", "/history/:namespace?", self._history)
        self.add_route("get", "/datatype/:uniqueLabelName", self._datatype)

        # label CRUD (DataService.ts:103-132)
        self.add_route("get", "/label", self._get_labels)
        self.add_route("get", "/label/user", self._get_user_labels)
        self.add_route("post", "/label/user", self._post_user_labels)
        self.add_route("delete", "/label/user", self._delete_user_labels)

        # tagged interfaces (DataService.ts:134-165)
        self.add_route("get", "/interface", self._get_interfaces)
        self.add_route("post", "/interface", self._post_interface)
        self.add_route("delete", "/interface", self._delete_interface)

        self.add_route("post", "/sync", self._sync)
        self.add_route("get", "/export", self._export)
        if ctx.settings.simulator_mode:
            self.add_route(
                "post", "/cloneDataFromProductionService", self._clone
            )

        if ctx.settings.enable_testing_endpoints:
            self.add_route("delete", "/clear", self._clear)
            self.add_route("post", "/import", self._import)
            self.add_route("post", "/aggregate", self._force_aggregate)

    # -- reads ---------------------------------------------------------------

    def _aggregate(self, req: Request) -> Response:
        return Response(
            payload=self.get_aggregated_data(
                req.params.get("namespace"),
                req.query_int("notBefore"),
                req.query.get("filter"),
            )
        )

    def get_aggregated_data(
        self,
        namespace: Optional[str] = None,
        not_before_ms: Optional[int] = None,
        filter_prefix: Optional[str] = None,
    ) -> Optional[dict]:
        data = self._ctx.service_utils.get_realtime_aggregated_data(
            namespace, not_before_ms
        )
        if not filter_prefix or not data:
            return data
        return {
            **data,
            "services": [
                s
                for s in data["services"]
                if s["uniqueServiceName"].startswith(filter_prefix)
            ],
        }

    def _service_display_info(self, req: Request) -> Response:
        return Response(
            payload=self.get_service_display_info(req.query.get("filter"))
        )

    def get_service_display_info(
        self, filter_prefix: Optional[str] = None
    ) -> List[dict]:
        """Per-service endpoint counts from the labeled dependency cache
        (DataService.ts:216-273)."""
        dependencies = self._ctx.cache.get("LabeledEndpointDependencies").get_data()
        if not dependencies:
            return []
        service_map: Dict[str, dict] = {}
        for dep in dependencies.to_json():
            ep = dep["endpoint"]
            key = ep["uniqueServiceName"]
            entry = service_map.setdefault(
                key,
                {
                    "uniqueServiceName": key,
                    "service": ep["service"],
                    "namespace": ep["namespace"],
                    "version": ep["version"],
                    "endpointSet": set(),
                },
            )
            label_or_path = ep.get("labelName") or ep.get("path")
            entry["endpointSet"].add(
                f"{ep['version']}\t{ep['method']}\t{label_or_path}"
            )
        result = [
            {
                "uniqueServiceName": e["uniqueServiceName"],
                "service": e["service"],
                "namespace": e["namespace"],
                "version": e["version"],
                "endpointCount": len(e["endpointSet"]),
            }
            for e in service_map.values()
        ]
        if filter_prefix:
            result = [
                r
                for r in result
                if r["uniqueServiceName"].startswith(filter_prefix)
            ]
        return result

    def _history(self, req: Request) -> Response:
        return Response(
            payload=self._ctx.service_utils.get_realtime_historical_data(
                req.params.get("namespace"), req.query_int("notBefore")
            )
        )

    def _datatype(self, req: Request) -> Response:
        label_name = req.params.get("uniqueLabelName", "")
        if not label_name:
            return Response.status_only(400)
        result = self.get_endpoint_data_type(label_name)
        return Response(payload=result) if result else Response.status_only(404)

    def get_endpoint_data_type(self, unique_label_name: str) -> Optional[dict]:
        """Merge all datatypes sharing one label (DataService.ts:277-301)."""
        parts = unique_label_name.split("\t")
        if len(parts) < 5:
            return None
        service, namespace, version, method, label = parts[:5]
        unique_service_name = f"{service}\t{namespace}\t{version}"

        datatypes = self._ctx.cache.get("LabelMapping").get_endpoint_data_types_by_label(
            label,
            unique_service_name,
            method,
            self._ctx.cache.get("EndpointDataType").get_data() or [],
        )
        if not datatypes:
            return None
        merged = datatypes[0]
        for d in datatypes[1:]:
            merged = merged.merge_schema_with(d)
        return {**merged.to_json(), "labelName": label}

    def get_endpoint_data_types_map(
        self, unique_label_names: List[str]
    ) -> Dict[str, dict]:
        """Per-label merged datatypes, trimmed for the frontend
        (DataService.ts:303-335): one latest schema per status, samples
        dropped."""
        out: Dict[str, dict] = {}
        for name in unique_label_names:
            data_type = self.get_endpoint_data_type(name)
            if not data_type:
                continue
            cloned = json.loads(json.dumps(data_type))
            latest: Dict[str, dict] = {}
            for schema in cloned["schemas"]:
                existing = latest.get(schema["status"])
                if not existing or schema["time"] > existing["time"]:
                    latest[schema["status"]] = schema
            for schema in latest.values():
                schema.pop("requestSample", None)
                schema.pop("responseSample", None)
            cloned["schemas"] = list(latest.values())
            out[name] = cloned
        return out

    # -- labels --------------------------------------------------------------

    def _get_labels(self, req: Request) -> Response:
        label_map = self._ctx.cache.get("LabelMapping").get_data()
        return Response(payload=[[k, v] for k, v in (label_map or {}).items()])

    def _get_user_labels(self, req: Request) -> Response:
        data = self._ctx.cache.get("UserDefinedLabel").get_data()
        return Response(payload=data) if data else Response.status_only(404)

    def _post_user_labels(self, req: Request) -> Response:
        labels = req.json()
        if not labels or not labels.get("labels"):
            return Response.status_only(400)
        self._ctx.cache.get("UserDefinedLabel").update(labels)
        self._ctx.service_utils.update_label()
        return Response.status_only(201)

    def _delete_user_labels(self, req: Request) -> Response:
        label = req.json()
        if not label:
            return Response.status_only(400)
        self._ctx.cache.get("UserDefinedLabel").delete(
            label["label"], label["uniqueServiceName"], label["method"]
        )
        self._ctx.service_utils.update_label()
        return Response.status_only(204)

    # -- tagged interfaces ---------------------------------------------------

    def _get_interfaces(self, req: Request) -> Response:
        unique_label_name = req.query.get("uniqueLabelName")
        if not unique_label_name:
            return Response.status_only(400)
        return Response(
            payload=self._ctx.cache.get("TaggedInterfaces").get_data(
                unique_label_name
            )
        )

    def _post_interface(self, req: Request) -> Response:
        tagged = req.json()
        if not tagged:
            return Response.status_only(400)
        self._ctx.cache.get("TaggedInterfaces").add(tagged)
        return Response.status_only(201)

    def _delete_interface(self, req: Request) -> Response:
        body = req.json() or {}
        unique_label_name = body.get("uniqueLabelName")
        user_label = body.get("userLabel")
        if not unique_label_name or not user_label:
            return Response.status_only(400)
        ok = self.delete_tagged_interface(unique_label_name, user_label)
        return Response.status_only(204 if ok else 400)

    def delete_tagged_interface(self, unique_label_name: str, user_label: str) -> bool:
        cache = self._ctx.cache.get("TaggedInterfaces")
        existing = next(
            (
                i
                for i in cache.get_data(unique_label_name)
                if i.get("userLabel") == user_label
            ),
            None,
        )
        if not existing or existing.get("boundToSwagger"):
            return False
        cache.delete(unique_label_name, user_label)
        return True

    # -- snapshots / control -------------------------------------------------

    def _sync(self, req: Request) -> Response:
        self._ctx.dispatch.sync_all()
        return Response.status_only(200)

    def _export(self, req: Request) -> Response:
        return Response(
            raw_body=self._import_export.export_tgz(),
            content_type="application/tar+gzip",
        )

    def _clear(self, req: Request) -> Response:
        self._import_export.clear_data()
        return Response.status_only(200)

    def _import(self, req: Request) -> Response:
        try:
            pairs = self._import_export.read_tgz(req.body)
            ok = self._import_export.import_data(pairs)
            return Response.status_only(201 if ok else 400)
        except Exception:  # noqa: BLE001 - malformed upload
            return Response.status_only(400)

    def _force_aggregate(self, req: Request) -> Response:
        self._ctx.operator.create_historical_and_aggregated_data()
        return Response.status_only(204)

    def _clone(self, req: Request) -> Response:
        base_url = self._ctx.extra.get("production_service_url", "")
        result = self._import_export.clone_data_from_production_service(base_url)
        if result["isSuccess"]:
            return Response(status=201, payload={"message": "ok"})
        return Response(
            status=500,
            payload={"message": f"Internal Server Error: {result['message']}"},
        )
