"""Unique-name helpers for simulator-generated services/endpoints.

Equivalent of KMamiz src/MicroViSim-simulator/classes/SimulatorUtils.ts:
tab-joined unique names with the simulator's fake host convention
(`http://<svc>.<ns>.svc.cluster.local<path>`, SimulatorUtils.ts:29-32).
"""
from __future__ import annotations

from typing import Tuple
from urllib.parse import urlsplit


def generate_unique_service_name(service: str, namespace: str, version: str) -> str:
    return f"{service.strip()}\t{namespace.strip()}\t{version.strip()}"


def generate_unique_service_name_without_version(service: str, namespace: str) -> str:
    return f"{service.strip()}\t{namespace.strip()}"


def split_unique_service_name(unique_service_name: str) -> Tuple[str, str, str]:
    service, namespace, version = unique_service_name.split("\t")
    return service.strip(), namespace.strip(), version.strip()


def generate_unique_endpoint_name(
    service: str, namespace: str, version: str, method_upper: str, path: str
) -> str:
    service = service.strip()
    namespace = namespace.strip()
    url = f"http://{service}.{namespace}.svc.cluster.local{path.strip()}"
    return (
        f"{service}\t{namespace}\t{version.strip()}\t{method_upper.strip()}\t{url}"
    )


def extract_unique_service_name(unique_endpoint_name: str) -> str:
    return "\t".join(unique_endpoint_name.split("\t")[:3])


def get_path_from_url(url: str) -> str:
    try:
        path = urlsplit(url).path
        return path if path else "/"
    except ValueError:
        return "/"
