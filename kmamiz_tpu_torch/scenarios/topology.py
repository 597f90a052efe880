"""Seeded mesh-topology sampler for the scenario factory.

A copy of kmamiz_tpu/scenarios/topology.py over the port's simulator:
the same ``random.Random`` draws, so one seed samples the same mesh and
renders the same YAML bytes in both packages.

Samples one of four production call-graph shapes — deep call chains,
fan-out hubs, cyclic retry loops, and dense random meshes — as a
:class:`Topology`: an immutable set of services, versions, and concrete
call *paths* (sequences of service hops) that every tick's trace groups
walk. Everything derives from the ``random.Random`` the factory hands
in, so the same seed samples the same mesh bit-for-bit.

The canonical serialized form of a sampled topology is the MicroViSim
simulation-config YAML rendered by
``simulator/config_generator.generate_sim_config_from_static_data`` —
the sampler builds the same plain-JSON cache shapes (EndpointDataType /
ReplicaCounts / EndpointDependencies rows) a live system would snapshot,
and the YAML's sha256 is the topology component of the scenario
signature (tests pin that two runs of one seed agree byte-for-byte).

Span emission is pure arithmetic over (tick, trace-index): no RNG is
consumed at run time, so the closed-loop runner's retries and recovery
probes can regenerate a tick's exact content any number of times (the
dedup map makes re-submission idempotent, which is what keeps the
post-soak ``graph_signature`` deterministic under real-clock jitter).
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

from kmamiz_tpu_torch.simulator import naming
from kmamiz_tpu_torch.simulator.config_generator import (
    generate_sim_config_from_static_data,
)

TOPOLOGY_KINDS = ("chain", "fanout", "cycle", "mesh")

#: spans of one trace all land inside this base microsecond epoch; each
#: (tick, trace, hop) offsets deterministically from it
BASE_TIMESTAMP_US = 1_700_000_000_000_000


@dataclass(frozen=True)
class Topology:
    """One sampled service mesh.

    ``paths`` are concrete call chains as tuples of service indices —
    a service may repeat inside one path (cyclic retries). Trace ``i``
    of tick ``t`` walks ``paths[(t * 7 + i) % len(paths)]``.
    """

    kind: str
    namespace: str
    services: Tuple[str, ...]
    replicas: Tuple[int, ...]
    urls_per_service: int
    paths: Tuple[Tuple[int, ...], ...]
    versions: Tuple[str, ...] = ("v1",)

    def path_for(self, tick: int, trace: int) -> Tuple[int, ...]:
        return self.paths[(tick * 7 + trace) % len(self.paths)]


def sample_topology(kind: str, rng: random.Random, namespace: str) -> Topology:
    """Draw one topology of the requested kind from ``rng``."""
    if kind not in TOPOLOGY_KINDS:
        raise ValueError(f"unknown topology kind: {kind!r}")
    if kind == "chain":
        n = rng.randint(6, 9)
        # one full-depth chain plus shallower prefixes: deep call chains
        # with realistic partial traversals
        full = tuple(range(n))
        paths = [full]
        for _ in range(rng.randint(2, 4)):
            depth = rng.randint(3, n)
            paths.append(full[:depth])
    elif kind == "fanout":
        leaves = rng.randint(6, 10)
        n = leaves + 1  # service 0 is the hub
        # each trace fans the hub out to a contiguous leaf band; the
        # union covers every leaf so the mesh shape is a star
        paths = []
        for start in range(1, leaves + 1):
            width = rng.randint(2, 4)
            band = [(start + j - 1) % leaves + 1 for j in range(width)]
            paths.append((0, *band))
    elif kind == "cycle":
        n = rng.randint(4, 6)
        # retry loops: A -> B -> A -> B(..) style revisits
        paths = []
        for a in range(n):
            b = (a + 1) % n
            revisits = rng.randint(1, 2)
            loop: List[int] = [a]
            for _ in range(revisits):
                loop.extend((b, a))
            paths.append(tuple(loop))
    else:  # mesh
        n = rng.randint(8, 12)
        paths = []
        for _ in range(rng.randint(8, 14)):
            length = rng.randint(3, 6)
            walk = [rng.randrange(n)]
            while len(walk) < length:
                step = rng.randrange(n)
                if step != walk[-1]:
                    walk.append(step)
            paths.append(tuple(walk))
    services = tuple(f"{kind[:4]}{i}" for i in range(n))
    replicas = tuple(rng.randint(1, 3) for _ in range(n))
    return Topology(
        kind=kind,
        namespace=namespace,
        services=services,
        replicas=replicas,
        urls_per_service=rng.randint(1, 2),
        paths=tuple(dict.fromkeys(paths)),  # dedup, order-preserving
    )


# -- canonical form (simulator/config_generator.py) --------------------------


def _endpoint_rows(topo: Topology, version: str) -> List[dict]:
    rows = []
    for svc in topo.services:
        for u in range(topo.urls_per_service):
            uep = naming.generate_unique_endpoint_name(
                svc, topo.namespace, version, "GET", f"/api/{u}"
            )
            rows.append(
                {
                    "uniqueEndpointName": uep,
                    "namespace": topo.namespace,
                    "service": svc,
                    "version": version,
                    "method": "GET",
                    "schemas": [
                        {
                            "status": "200",
                            "requestContentType": "",
                            "responseContentType": "",
                        }
                    ],
                }
            )
    return rows


def sim_config_yaml(topo: Topology) -> str:
    """The topology rendered as the editable MicroViSim sim-config YAML
    (SimConfigGenerator shapes) — the canonical, hashable serialization."""
    data_types: List[dict] = []
    replica_counts: List[dict] = []
    for version in topo.versions:
        data_types.extend(_endpoint_rows(topo, version))
        for svc_i, svc in enumerate(topo.services):
            replica_counts.append(
                {
                    "uniqueServiceName": naming.generate_unique_service_name(
                        svc, topo.namespace, version
                    ),
                    "namespace": topo.namespace,
                    "version": version,
                    "replicas": topo.replicas[svc_i],
                }
            )
    deps: Dict[str, List[dict]] = {}
    version = topo.versions[0]
    for path in topo.paths:
        for a, b in zip(path, path[1:]):
            ep_a = naming.generate_unique_endpoint_name(
                topo.services[a], topo.namespace, version, "GET", "/api/0"
            )
            ep_b = naming.generate_unique_endpoint_name(
                topo.services[b], topo.namespace, version, "GET", "/api/0"
            )
            bucket = deps.setdefault(ep_a, [])
            if not any(
                d["endpoint"]["uniqueEndpointName"] == ep_b for d in bucket
            ):
                bucket.append(
                    {"endpoint": {"uniqueEndpointName": ep_b}, "distance": 1}
                )
    endpoint_dependencies = [
        {
            "endpoint": {"uniqueEndpointName": ep},
            "dependingOn": depend_on,
            "isDependedByExternal": True,
        }
        for ep, depend_on in deps.items()
    ]
    return generate_sim_config_from_static_data(
        data_types, replica_counts, endpoint_dependencies
    )


def topology_digest(topo: Topology) -> str:
    """sha256 of the canonical sim-config YAML plus the path table (the
    YAML carries the distance-1 mesh; paths add the walk ordering)."""
    digest = hashlib.sha256(sim_config_yaml(topo).encode("utf-8"))
    digest.update(repr(topo.paths).encode("ascii"))
    return digest.hexdigest()


# -- span emission (pure, no runtime RNG) ------------------------------------


def entry_services(topo: Topology) -> Tuple[str, ...]:
    return tuple(sorted({topo.services[p[0]] for p in topo.paths}))


def downstream_of(topo: Topology, service: str) -> FrozenSet[str]:
    """Services that appear strictly after ``service`` in any path —
    the blast radius of a cascading failure rooted there."""
    out = set()
    for path in topo.paths:
        names = [topo.services[i] for i in path]
        if service in names:
            out.update(names[names.index(service) + 1 :])
    out.discard(service)
    return frozenset(out)


def _span(
    topo: Topology,
    trace_id: str,
    span_id: str,
    parent_id: Optional[str],
    svc: str,
    version: str,
    url_index: int,
    status: str,
    ts_us: int,
    duration_us: int,
) -> dict:
    host = f"{svc}.{topo.namespace}.svc.cluster.local"
    return {
        "traceId": trace_id,
        "id": span_id,
        "parentId": parent_id,
        "kind": "SERVER",
        "name": f"{host}:80/*",
        "timestamp": ts_us,
        "duration": duration_us,
        "tags": {
            "http.method": "GET",
            "http.status_code": status,
            "http.url": f"http://{host}/api/{url_index}",
            "istio.canonical_revision": version,
            "istio.canonical_service": svc,
            "istio.mesh_id": "cluster.local",
            "istio.namespace": topo.namespace,
        },
    }


def trace_group(
    topo: Topology,
    prefix: str,
    tick: int,
    trace: int,
    error_services: FrozenSet[str] = frozenset(),
    version_of: Optional[Callable[[str], str]] = None,
    latency_boost_us: int = 0,
) -> List[dict]:
    """One trace walking ``path_for(tick, trace)``. Status codes are a
    deterministic function of (tick, trace, hop): a small baseline error
    rate everywhere, 503 on every hop at a service in
    ``error_services`` (the cascade/outage storylines)."""
    path = topo.path_for(tick, trace)
    trace_id = f"{prefix}-t{tick}-{trace}"
    group: List[dict] = []
    parent: Optional[str] = None
    for hop, svc_i in enumerate(path):
        svc = topo.services[svc_i]
        version = version_of(svc) if version_of is not None else "v1"
        if svc in error_services:
            status = "503"
        else:
            status = "503" if (tick * 31 + trace * 7 + hop) % 41 == 0 else "200"
        span_id = f"{trace_id}-{hop}"
        group.append(
            _span(
                topo,
                trace_id,
                span_id,
                parent,
                svc,
                version,
                (tick + trace + hop) % topo.urls_per_service,
                status,
                BASE_TIMESTAMP_US + tick * 1_000 + trace * 10 + hop,
                1_000 + hop * 37 + latency_boost_us,
            )
        )
        parent = span_id
    return group


def tick_groups(
    topo: Topology,
    prefix: str,
    tick: int,
    count: int,
    drop_services: FrozenSet[str] = frozenset(),
    error_services: FrozenSet[str] = frozenset(),
    version_of: Optional[Callable[[str], str]] = None,
    latency_boost_us: int = 0,
) -> List[List[dict]]:
    """All trace groups of one tick. Traces whose path crosses a service
    in ``drop_services`` are never emitted (a partial-mesh outage: the
    dead service's sidecar reports nothing), which keeps the merged
    content a pure function of (tick schedule, storyline)."""
    groups = []
    for trace in range(count):
        path = topo.path_for(tick, trace)
        if any(topo.services[i] in drop_services for i in path):
            continue
        groups.append(
            trace_group(
                topo,
                prefix,
                tick,
                trace,
                error_services=error_services,
                version_of=version_of,
                latency_boost_us=latency_boost_us,
            )
        )
    return groups


def warmup_groups(
    topo: Topology,
    prefix: str,
    deployed_versions: Tuple[str, ...] = ("v1",),
) -> List[List[dict]]:
    """The scenario's terminal shape as one warmup window: every path
    under every revision the storyline will ever deploy. Ingesting it
    before the measured phase moves capacity growth — and its one
    legitimate compile — into warmup, which is what makes the
    steady-state zero-recompile gate honest (the PR-3 shape-hint
    prewarm discipline applied to scenarios)."""
    groups = []
    for v_i, version in enumerate(deployed_versions):
        for p_i in range(len(topo.paths)):
            groups.append(
                trace_group(
                    topo,
                    f"{prefix}-warm{v_i}",
                    0,
                    p_i,
                    version_of=lambda _svc, _v=version: _v,
                )
            )
    return groups
