"""Simulation REST handler.

Equivalent of KMamiz src/MicroViSim-simulator/handler/
SimulationService.ts: YAML upload -> clear state -> generate simulation
data -> refresh caches and replay per-slot dynamic data; plus the
static-config generator endpoint. Accepts the YAML either as a raw request
body or as a multipart/form-data upload (the reference uses multer).
"""
from __future__ import annotations

import logging
import time

from kmamiz_tpu_torch.api.router import IRequestHandler, Request, Response
from kmamiz_tpu_torch.server.import_export import ImportExportHandler
from kmamiz_tpu_torch.simulator.config_generator import (
    generate_sim_config_from_static_data,
)
from kmamiz_tpu_torch.simulator.simulator import Simulator

logger = logging.getLogger("kmamiz_tpu_torch.simulator")


def _extract_yaml_body(body: bytes) -> str:
    """Raw YAML body, or the first file part of a multipart/form-data
    payload (sniffed from the leading boundary line)."""
    if body.lstrip().startswith(b"--"):
        boundary = body.split(b"\r\n", 1)[0].strip()
        if boundary.startswith(b"--"):
            for part in body.split(boundary):
                part = part.strip(b"\r\n")
                if not part or part == b"--":
                    continue
                header_end = part.find(b"\r\n\r\n")
                if header_end == -1:
                    continue
                headers = part[:header_end].lower()
                if b"filename=" in headers or b"name=\"file\"" in headers:
                    return part[header_end + 4 :].decode("utf-8", "replace")
    return body.decode("utf-8", "replace")


class SimulationHandler(IRequestHandler):
    def __init__(self, ctx) -> None:
        super().__init__("simulation")
        self._ctx = ctx
        self._simulator = Simulator()
        self._import_export = ImportExportHandler(ctx)
        self.add_route("post", "/startSimulation", self._start_simulation)
        self.add_route(
            "get", "/generateStaticSimConfig", self._generate_static_config
        )

    def _start_simulation(self, req: Request) -> Response:
        if not req.body:
            return Response(status=400, payload={"message": "YAML file is missing."})
        yaml_string = _extract_yaml_body(req.body).strip()
        if not yaml_string:
            return Response(
                payload={"message": "Received an empty YAML. Skipping data retrieval."}
            )
        status, message = self._process_simulation(yaml_string)
        return Response(status=status, payload={"message": message})

    def _process_simulation(self, yaml_string: str) -> tuple:
        """SimulationService.ts:61-118."""
        simulate_date_ms = time.time() * 1000
        try:
            self._import_export.clear_data()
            result = self._simulator.generate_simulation_data(
                yaml_string, simulate_date_ms
            )
            if result.validation_error_message:
                return 400, result.validation_error_message
            if result.converting_error_message:
                return 500, result.converting_error_message
            try:
                self._ctx.operator.update_static_simulate_data_to_cache(
                    dependencies=result.endpoint_dependencies,
                    data_types=result.data_types,
                    replica_counts=result.replica_counts,
                )
                self._ctx.operator.update_dynamic_simulate_data(
                    result.realtime_data_per_slot
                )
                return 201, "ok"
            except Exception as err:  # noqa: BLE001
                logger.exception("simulation cache update failed")
                return (
                    500,
                    "Error while caching and creating historical and aggregated "
                    f"data:\n---\n{err}",
                )
        except Exception as err:  # noqa: BLE001
            logger.exception("simulation failed")
            return 500, f"Error simulate retrive data by YAML:\n---\n{err}"

    def _generate_static_config(self, req: Request) -> Response:
        try:
            dep = self._ctx.cache.get("EndpointDependencies").get_data()
            data_types = self._ctx.cache.get("EndpointDataType").get_data() or []
            replicas = self._ctx.cache.get("ReplicaCounts").get_data() or []
            yaml_str = generate_sim_config_from_static_data(
                [dt.to_json() for dt in data_types],
                replicas,
                dep.to_json() if dep else [],
            )
            return Response(payload={"staticYamlStr": yaml_str, "message": "ok"})
        except Exception as err:  # noqa: BLE001
            logger.exception("static sim config generation failed")
            return Response(
                status=500,
                payload={
                    "staticYamlStr": "",
                    "message": (
                        "Error while trying to generate static Simulation "
                        f"Yaml:\n{err}"
                    ),
                },
            )
