"""Swagger REST handler: OpenAPI docs per service + version tags.

Equivalent of KMamiz src/handler/SwaggerService.ts; tagging a
swagger version also freezes the backing interfaces as tagged interfaces
bound to the swagger (SwaggerService.ts:112-147).

A copy of kmamiz_tpu/api/handlers/swagger.py, importing the port's modules.
"""
from __future__ import annotations

import json
from typing import List, Optional

import yaml

from kmamiz_tpu_torch.analytics.swagger import from_endpoints
from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.server.initializer import AppContext


class SwaggerHandler(IRequestHandler):
    def __init__(self, ctx: AppContext) -> None:
        super().__init__("swagger")
        self._ctx = ctx
        self.add_route("get", "/tags/:uniqueServiceName", self._get_tags)
        self.add_route("post", "/tags", self._post_tag)
        self.add_route("delete", "/tags", self._delete_tag)
        self.add_route("get", "/yaml/:uniqueServiceName", self._get_yaml)
        self.add_route("get", "/:uniqueServiceName", self._get_swagger)

    def _get_swagger(self, req: Request) -> Response:
        name = req.params.get("uniqueServiceName")
        if not name:
            return Response.status_only(400)
        return Response(payload=self.get_swagger(name, req.query.get("tag")))

    def _get_yaml(self, req: Request) -> Response:
        name = req.params.get("uniqueServiceName")
        if not name:
            return Response.status_only(400)
        doc = self.get_swagger(name, req.query.get("tag"))
        return Response(
            raw_body=yaml.safe_dump(doc, sort_keys=False).encode(),
            content_type="text/yaml",
        )

    def _get_tags(self, req: Request) -> Response:
        name = req.params.get("uniqueServiceName")
        if not name:
            return Response.status_only(400)
        return Response(payload=self.get_tags(name))

    def _post_tag(self, req: Request) -> Response:
        tagged = req.json()
        if not tagged:
            return Response.status_only(400)
        self.add_tagged_swagger(tagged)
        return Response.status_only(200)

    def _delete_tag(self, req: Request) -> Response:
        body = req.json() or {}
        name, tag = body.get("uniqueServiceName"), body.get("tag")
        if not name or not tag:
            return Response.status_only(400)
        self.delete_tagged_swagger(name, tag)
        return Response.status_only(200)

    # -- document assembly (SwaggerService.ts:72-110) ------------------------

    def get_swagger(
        self, unique_service_name: str, tag: Optional[str] = None
    ) -> dict:
        if tag:
            existing = self._ctx.cache.get("TaggedSwaggers").get_data(
                unique_service_name, tag
            )
            if existing:
                doc = json.loads(existing[0]["openApiDocument"])
                doc["info"]["version"] = tag
                return doc

        service, namespace, version = unique_service_name.split("\t")
        label_map = self._ctx.cache.get("LabelMapping")
        endpoints = []
        for e in self._ctx.cache.get("EndpointDataType").get_data():
            raw = e.to_json()
            if raw["uniqueServiceName"] != unique_service_name:
                continue
            endpoints.append(
                {
                    **raw,
                    "labelName": label_map.get_label(raw["uniqueEndpointName"]),
                }
            )
        return from_endpoints(
            f"{service}.{namespace}",
            version,
            endpoints,
            endpoints_from_label=label_map.get_endpoints_from_label,
        )

    def get_tags(self, unique_service_name: str) -> List[str]:
        docs = self._ctx.cache.get("TaggedSwaggers").get_data(unique_service_name)
        return [
            t["tag"]
            for t in sorted(docs, key=lambda d: d.get("time") or 0, reverse=True)
        ]

    # -- tagging (SwaggerService.ts:112-170) ---------------------------------

    def add_tagged_swagger(self, tagged: dict) -> None:
        self._ctx.cache.get("TaggedSwaggers").add(tagged)

        # the reference's tagging freezes interfaces grouped by the
        # datatypes' LABEL (SwaggerService.ts:112-147, where labelName
        # was stamped onto the cached objects by an earlier getSwagger);
        # this port's cached datatypes are immutable, so resolve the
        # label through the label map here — the same resolution
        # get_swagger uses — instead of reading a field that is never
        # set
        label_map = self._ctx.cache.get("LabelMapping")
        merged: dict = {}
        for d in self._ctx.cache.get("EndpointDataType").get_data():
            raw = d.to_json()
            if raw["uniqueServiceName"] != tagged["uniqueServiceName"]:
                continue
            name = label_map.get_label(raw["uniqueEndpointName"])
            merged[name] = (
                merged[name].merge_schema_with(d) if name in merged else d
            )

        interfaces = self._ctx.cache.get("TaggedInterfaces")
        for name, d in merged.items():
            dt = d.to_json()
            status_map: dict = {}
            for s in sorted(dt["schemas"], key=lambda s: s["time"]):
                status_map[s["status"]] = s
            for s in status_map.values():
                interfaces.add(
                    {
                        "timestamp": s["time"],
                        "requestSchema": s.get("requestSchema") or "",
                        "responseSchema": s.get("responseSchema") or "",
                        "userLabel": f"{tagged['tag']}-{s['status']}",
                        "uniqueLabelName": (
                            f"{dt['uniqueServiceName']}\t{dt['method']}\t"
                            f"{name}"
                        ),
                        "boundToSwagger": True,
                    }
                )

    def delete_tagged_swagger(self, unique_service_name: str, tag: str) -> None:
        interfaces = self._ctx.cache.get("TaggedInterfaces")
        for i in interfaces.get_data():
            if (
                i.get("boundToSwagger")
                and i["uniqueLabelName"].startswith(unique_service_name)
                and i["userLabel"].startswith(f"{tag}-")
            ):
                interfaces.delete(i["uniqueLabelName"], i["userLabel"])
        self._ctx.cache.get("TaggedSwaggers").delete(unique_service_name, tag)
