"""Simulation-config -> endpoint-dependency records + propagation maps.

Equivalent of KMamiz src/MicroViSim-simulator/classes/
SimEndpointDependencyBuilder.ts: builds the dependOn / dependBy adjacency,
the per-group call-probability structure used by the load propagator, and
the framework-shaped TEndpointDependency records (BFS closure over both
directions with distances, :218-288).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Set, Tuple

from kmamiz_tpu_torch.simulator import naming

# Probability groups: per source endpoint, a list of groups; each group is a
# list of (target uniqueEndpointName, call probability in percent). Groups
# are mutually exclusive choices; probability mass left under 100 in a group
# means "call nothing" (LoadSimulationPropagator.ts:13-29).
ProbabilityGroups = List[List[Tuple[str, float]]]


def build_dependency_maps(dependencies: List[dict]) -> dict:
    """-> {dependOnMap, dependByMap, dependOnGroups, externalIds}
    keyed by uniqueEndpointName (SimEndpointDependencyBuilder.ts:82-166)."""
    depend_on: Dict[str, Set[str]] = {}
    depend_by: Dict[str, Set[str]] = {}
    groups: Dict[str, ProbabilityGroups] = {}
    external: Set[str] = set()

    for dep in dependencies:
        source = dep["uniqueEndpointName"]
        if dep.get("isExternal"):
            external.add(source)
        on_set = depend_on.setdefault(source, set())
        group_list: ProbabilityGroups = []
        for entry in dep["dependOn"]:
            if "oneOf" in entry:
                group = []
                for one in entry["oneOf"]:
                    target = one["uniqueEndpointName"]
                    on_set.add(target)
                    depend_by.setdefault(target, set()).add(source)
                    group.append((target, float(one["callProbability"])))
                group_list.append(group)
            else:
                target = entry["uniqueEndpointName"]
                on_set.add(target)
                depend_by.setdefault(target, set()).add(source)
                prob = entry.get("callProbability")
                group_list.append([(target, 100.0 if prob is None else float(prob))])
        groups[source] = group_list

    return {
        "dependOnMap": depend_on,
        "dependByMap": depend_by,
        "dependOnGroups": groups,
        "externalIds": external,
    }


def extract_endpoint_infos(
    services_info: List[dict], timestamp_ms: float
) -> Dict[str, dict]:
    """uniqueEndpointName -> TEndpointInfo record
    (SimEndpointDependencyBuilder.ts:170-216)."""
    infos: Dict[str, dict] = {}
    seen_services: Set[str] = set()
    for ns in services_info:
        for svc in ns["services"]:
            for ver in svc["versions"]:
                usn = ver["uniqueServiceName"]
                if usn in seen_services:
                    continue
                seen_services.add(usn)
                for ep in ver["endpoints"]:
                    path = ep["endpointInfo"]["path"]
                    infos[ep["uniqueEndpointName"]] = {
                        "uniqueServiceName": usn,
                        "uniqueEndpointName": ep["uniqueEndpointName"],
                        "service": svc["serviceName"],
                        "namespace": ns["namespace"],
                        "version": ver["version"],
                        "labelName": path,
                        "url": "",
                        "host": "",
                        "path": path,
                        "port": "",
                        "method": ep["endpointInfo"]["method"].upper(),
                        "clusterName": "cluster.local",
                        "timestamp": timestamp_ms,
                    }
    return infos


def _bfs(
    start: str, graph: Dict[str, Set[str]], infos: Dict[str, dict], kind: str
) -> List[dict]:
    visited: Set[str] = {start}
    queue = deque([(start, 0)])
    result = []
    while queue:
        current, distance = queue.popleft()
        if current != start and current in infos:
            result.append(
                {"endpoint": infos[current], "distance": distance, "type": kind}
            )
        for nxt in sorted(graph.get(current, ())):
            if nxt not in visited:
                visited.add(nxt)
                queue.append((nxt, distance + 1))
    return result


def build_endpoint_dependencies(
    config: dict, timestamp_ms: float
) -> Tuple[List[dict], Dict[str, ProbabilityGroups]]:
    """-> (TEndpointDependency records, per-endpoint probability groups)
    (SimEndpointDependencyBuilder.ts:19-52)."""
    infos = extract_endpoint_infos(config["servicesInfo"], timestamp_ms)
    maps = build_dependency_maps(config["endpointDependencies"])

    records = []
    for name, info in infos.items():
        records.append(
            {
                "endpoint": info,
                "lastUsageTimestamp": timestamp_ms,
                "isDependedByExternal": name in maps["externalIds"],
                "dependingOn": _bfs(name, maps["dependOnMap"], infos, "SERVER"),
                "dependingBy": _bfs(name, maps["dependByMap"], infos, "CLIENT"),
            }
        )
    return records, maps["dependOnGroups"]
