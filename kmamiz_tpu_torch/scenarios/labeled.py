"""Labeled-window export: scenario replay as supervised model data.

A copy of kmamiz_tpu/scenarios/labeled.py: the storyline's per-tick view
comes from the port's copy of the runner's helpers (scenarios/runner.py)
and the features from the port's models/graphsage.assemble_features.

The scenario factory composes everything at seed time and span content
is pure arithmetic over (tick, trace, hop) — so a scenario's per-tick
endpoint windows, model features, dependency edges AND the ground truth
(which services the storyline injected faults into, and how hard) can
all be exported WITHOUT running a server. This is the data contract
`tools/eval_stlgt.py` scores against: quantile coverage needs the true
next-window latency per endpoint, attribution hit-rate needs the
injected fault set per tick, and both come straight from the composed
storyline rather than from heuristics over the emitted spans.

One window per tick, every window in the SAME endpoint id space (the
full topology × deployed-versions endpoint set, enumerated up front the
way the interner would converge to after warmup), with:

- ``features``  — the [N, 10] assemble_features layout (the exact
  train/serve column contract, hour_of_day = tick % 24);
- ``latency_ms`` / ``err5_share`` / ``active`` — per-endpoint outcomes;
- ``truth_services`` — services under injected error this tick
  (cascade storm membership: the root plus overload-modeled
  downstream), the attribution target;
- ``latency_boost_us`` — the storyline's injected latency inflation.

Edges are the union of parent->child span pairs over all windows, in
CSR (src, dst, mask) form, matching the live forecast snapshot shape.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from kmamiz_tpu_torch.scenarios.factory import ScenarioSpec
from kmamiz_tpu_torch.scenarios.topology import tick_groups
from kmamiz_tpu_torch.simulator import naming


def _endpoint_name(topo, svc: str, version: str, url_index: int) -> str:
    return naming.generate_unique_endpoint_name(
        svc, topo.namespace, version, "GET", f"/api/{url_index}"
    )


def labeled_windows(spec: ScenarioSpec, tenant_index: int = 0) -> dict:
    """Deterministic labeled replay of one tenant's scenario windows.

    Returns {"names", "src", "dst", "mask", "windows"} where windows is
    a list of per-tick dicts (see module docstring). Same spec -> same
    bytes; the storyline view logic is imported from the runner so the
    export can never skew from what a live soak would ingest."""
    # the runner owns storyline -> per-tick semantics; reusing its view
    # builders keeps this export and the live soak on one source of truth
    from kmamiz_tpu_torch.scenarios.runner import _deploy_version_fn, _tick_view

    plan = spec.tenants[tenant_index]
    topo = plan.topology

    # fixed id space: every (service, version, url) endpoint the
    # storyline can ever emit, enumerated in deterministic order
    names: List[str] = []
    ids: Dict[str, int] = {}
    for version in topo.versions:
        for svc in topo.services:
            for u in range(topo.urls_per_service):
                name = _endpoint_name(topo, svc, version, u)
                if name not in ids:
                    ids[name] = len(names)
                    names.append(name)
    n = len(names)
    svc_of = np.zeros(n, dtype=np.int64)
    for version in topo.versions:
        for svc_i, svc in enumerate(topo.services):
            for u in range(topo.urls_per_service):
                svc_of[ids[_endpoint_name(topo, svc, version, u)]] = svc_i
    replicas = np.asarray(
        [topo.replicas[svc_of[i]] for i in range(n)], dtype=np.float32
    )

    edge_set = set()
    windows = []
    for tick in range(spec.n_ticks):
        view = _tick_view(plan, tick)
        version_of = _deploy_version_fn(plan, tick)
        groups = tick_groups(
            topo,
            spec.name,
            tick,
            plan.traffic[tick],
            drop_services=frozenset(view["drop"]),
            error_services=frozenset(view["error"]),
            version_of=version_of,
            latency_boost_us=view["latency_us"],
        )
        count = np.zeros(n, dtype=np.float64)
        err5 = np.zeros(n, dtype=np.float64)
        lat_sum = np.zeros(n, dtype=np.float64)
        lat_sq = np.zeros(n, dtype=np.float64)
        for group in groups:
            prev_id = None
            for span in group:
                tags = span["tags"]
                svc = tags["istio.canonical_service"]
                url_index = int(tags["http.url"].rsplit("/", 1)[1])
                ep = ids[
                    _endpoint_name(
                        topo, svc, tags["istio.canonical_revision"], url_index
                    )
                ]
                count[ep] += 1
                if tags["http.status_code"] == "503":
                    err5[ep] += 1
                ms = span["duration"] / 1000.0
                lat_sum[ep] += ms
                lat_sq[ep] += ms * ms
                if prev_id is not None and prev_id != ep:
                    edge_set.add((prev_id, ep))
                prev_id = ep
        safe = np.maximum(count, 1.0)
        lat_mean = lat_sum / safe
        var = np.maximum(lat_sq / safe - lat_mean * lat_mean, 0.0)
        cv = np.where(lat_mean > 0, np.sqrt(var) / np.maximum(lat_mean, 1e-9), 0.0)
        active = count > 0
        from kmamiz_tpu_torch.models.graphsage import assemble_features

        features = np.array(  # fresh copy: rows are zeroed in place below
            assemble_features(
                request_rate=count.astype(np.float32),
                err4_share=np.zeros(n, dtype=np.float32),
                err5_share=(err5 / safe).astype(np.float32),
                log_latency=np.log1p(lat_mean).astype(np.float32),
                latency_cv=cv.astype(np.float32),
                replicas=replicas,
                log_volume=np.log1p(count).astype(np.float32),
                active=active.astype(np.float32),
                hour_of_day=float(tick % 24),
            ),
            dtype=np.float32,
        )
        # padded/inactive rows must be all-zero (the STLGT lane-mask
        # contract): an inactive endpoint still gets the hour columns
        # from assemble_features, so zero the dead rows explicitly
        features[~active] = 0.0
        windows.append(
            {
                "tick": tick,
                "features": features,
                "latency_ms": lat_mean.astype(np.float32),
                "err5_share": (err5 / safe).astype(np.float32),
                "active": active,
                "truth_services": sorted(view["error"]),
                "latency_boost_us": int(view["latency_us"]),
            }
        )

    edges = sorted(edge_set)
    src = np.asarray([e[0] for e in edges], dtype=np.int32)
    dst = np.asarray([e[1] for e in edges], dtype=np.int32)
    mask = np.ones(len(edges), dtype=bool)
    return {
        "names": names,
        "services": list(topo.services),
        "service_of": svc_of,
        "src": src,
        "dst": dst,
        "mask": mask,
        "windows": windows,
    }
