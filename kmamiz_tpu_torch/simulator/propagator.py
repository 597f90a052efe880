"""Vectorized traffic propagation over the dependency DAG.

Equivalent of KMamiz src/MicroViSim-simulator/classes/
LoadSimulation/LoadSimulationPropagator.ts, re-designed array-first: the
reference walks a recursive DFS per request id (:89-244); here the request
dimension is a vector axis and the DAG is swept twice per entry point —

  forward (topological order): per-endpoint request masks, Bernoulli
    own-error draws, and per-group dependency selection by cumulative call
    probability (one uniform draw per request per group);
  backward (reverse topological order): final success per fallback
    strategy and critical-path latency (own jittered latency + max over
    called children, LoadSimulationPropagator.ts:236-243).

Requests are processed in fixed-size chunks so memory stays bounded at
(subgraph size x chunk); statistics accumulate as (count, sum, sum-of-
squares) and finalize to the same sample mean / CV the reference computes
with Welford (:76-83,300-309).

Documented divergences from the reference (both intentional):
- A request reaching an endpoint through two parents (diamond) sees the
  endpoint's actual outcome on both paths; the reference's visited-set
  returns "assume success" to the second caller (:220-227).
- Endpoints are processed in deterministic topological order rather than
  JS Map insertion order; with seeded RNG this makes runs reproducible.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from kmamiz_tpu_torch.simulator import naming
from kmamiz_tpu_torch.simulator.dependency_builder import ProbabilityGroups
from kmamiz_tpu_torch.simulator.slot_metrics import SlotMetrics

FALLBACK_ANY = 0  # failIfAnyDependentFail (default)
FALLBACK_ALL = 1  # failIfAllDependentFail
FALLBACK_IGNORE = 2  # ignoreDependentFail

_FALLBACK_CODES = {
    "failIfAnyDependentFail": FALLBACK_ANY,
    "failIfAllDependentFail": FALLBACK_ALL,
    "ignoreDependentFail": FALLBACK_IGNORE,
}

DEFAULT_CHUNK = 1 << 16


class _StatsAccumulator:
    """Per-endpoint counters plus per-(endpoint, status) latency moments."""

    def __init__(self) -> None:
        self.request_count: Dict[str, int] = {}
        self.own_error: Dict[str, int] = {}
        self.downstream_error: Dict[str, int] = {}
        # (endpoint, status) -> [count, sum, sumsq]
        self.latency: Dict[Tuple[str, str], List[float]] = {}

    def add_counts(self, endpoint: str, requests: int, own: int, downstream: int) -> None:
        self.request_count[endpoint] = self.request_count.get(endpoint, 0) + requests
        self.own_error[endpoint] = self.own_error.get(endpoint, 0) + own
        self.downstream_error[endpoint] = (
            self.downstream_error.get(endpoint, 0) + downstream
        )

    def add_latency(self, endpoint: str, status: str, values: np.ndarray) -> None:
        entry = self.latency.setdefault((endpoint, status), [0, 0.0, 0.0])
        entry[0] += int(values.size)
        entry[1] += float(values.sum())
        entry[2] += float(np.square(values, dtype=np.float64).sum())

    def add_status_count(self, endpoint: str, status: str, count: int) -> None:
        if count > 0:
            entry = self.latency.setdefault((endpoint, status), [0, 0.0, 0.0])
            entry[0] += count

    def finalize(self, compute_latency: bool) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for endpoint, requests in self.request_count.items():
            out[endpoint] = {
                "requestCount": requests,
                "ownErrorCount": self.own_error.get(endpoint, 0),
                "downstreamErrorCount": self.downstream_error.get(endpoint, 0),
                "latencyStatsByStatus": {},
            }
        for (endpoint, status), (count, total, sumsq) in self.latency.items():
            stats = out.setdefault(
                endpoint,
                {
                    "requestCount": 0,
                    "ownErrorCount": 0,
                    "downstreamErrorCount": 0,
                    "latencyStatsByStatus": {},
                },
            )
            if compute_latency and count > 0:
                mean = total / count
                variance = (
                    max(0.0, (sumsq - count * mean * mean) / (count - 1))
                    if count > 1
                    else 0.0
                )
                std = math.sqrt(variance)
                cv = std / mean if mean != 0 else 0.0
                stats["latencyStatsByStatus"][status] = {"mean": mean, "cv": cv}
            else:
                stats["latencyStatsByStatus"][status] = {"mean": 0.0, "cv": 0.0}
        return out


def _reachable_topo_order(
    entry: str, groups: Dict[str, ProbabilityGroups]
) -> List[str]:
    """Topological order of the subgraph reachable from `entry` (DFS
    postorder reversed; the config validator guarantees acyclicity)."""
    order: List[str] = []
    state: Dict[str, int] = {}  # 1 = on stack, 2 = done
    stack: List[Tuple[str, int]] = [(entry, 0)]
    while stack:
        node, phase = stack.pop()
        if phase == 1:
            state[node] = 2
            order.append(node)
            continue
        if state.get(node):
            continue
        state[node] = 1
        stack.append((node, 1))
        for group in groups.get(node, ()):  # pragma: no branch
            for target, _prob in group:
                if not state.get(target):
                    stack.append((target, 0))
    order.reverse()
    return order


def _propagate_entry_chunk(
    topo: Sequence[str],
    entry: str,
    n: int,
    groups: Dict[str, ProbabilityGroups],
    error_rate: Dict[str, float],
    delay: Dict[str, Tuple[float, float]],
    replica_zero: Dict[str, bool],
    fallback: Dict[str, int],
    compute_latency: bool,
    rng: np.random.Generator,
    acc: _StatsAccumulator,
) -> None:
    """One chunk of `n` requests entering at `entry`, vectorized over the
    request axis."""
    mask: Dict[str, np.ndarray] = {name: np.zeros(n, dtype=bool) for name in topo}
    mask[entry][:] = True
    own_ok: Dict[str, np.ndarray] = {}
    own_lat: Dict[str, np.ndarray] = {}
    selections: Dict[str, List[np.ndarray]] = {}

    # forward sweep: masks, own-error draws, dependency selection
    for name in topo:
        m = mask[name]
        if replica_zero[name] or not m.any():
            continue
        ok = rng.random(n) >= error_rate[name]
        own_ok[name] = ok
        if compute_latency:
            base, jitter = delay[name]
            lat = base + (rng.random(n) * 2.0 - 1.0) * jitter
            own_lat[name] = np.maximum(0.0, lat).astype(np.float64)
        node_groups = groups.get(name, [])
        sels: List[np.ndarray] = []
        active = m & ok
        for group in node_groups:
            cum = np.cumsum([prob for _t, prob in group])
            draw = rng.random(n) * 100.0
            sel = np.searchsorted(cum, draw, side="right").astype(np.int32)
            sel[sel >= len(group)] = -1
            sel[~active] = -1  # failed/absent requests call nothing
            sels.append(sel)
            for idx, (target, _prob) in enumerate(group):
                mask[target] |= sel == idx
        selections[name] = sels

    # backward sweep: final status + critical-path latency
    final_ok: Dict[str, np.ndarray] = {}
    total_lat: Dict[str, np.ndarray] = {}
    for name in reversed(topo):
        m = mask[name]
        if replica_zero[name]:
            # reports failure upstream, latency 0, no propagation, no stats
            # (LoadSimulationPropagator.ts:112-123)
            final_ok[name] = np.zeros(n, dtype=bool)
            total_lat[name] = np.zeros(n, dtype=np.float64)
            continue
        if not m.any():
            final_ok[name] = np.zeros(n, dtype=bool)
            total_lat[name] = np.zeros(n, dtype=np.float64)
            continue
        ok = own_ok[name]
        node_groups = groups.get(name, [])
        sels = selections.get(name, [])
        strategy = fallback[name]

        if node_groups and strategy != FALLBACK_IGNORE:
            deps_ok = (
                np.ones(n, dtype=bool)
                if strategy == FALLBACK_ANY
                else np.zeros(n, dtype=bool)
            )
            for group, sel in zip(node_groups, sels):
                group_ok = np.ones(n, dtype=bool)  # NO_DEPENDENT_CALL => success
                for idx, (target, _prob) in enumerate(group):
                    chosen = sel == idx
                    if chosen.any():
                        group_ok[chosen] = final_ok[target][chosen]
                if strategy == FALLBACK_ANY:
                    deps_ok &= group_ok
                else:
                    deps_ok |= group_ok
            fin = ok & deps_ok
        else:
            fin = ok.copy()
        final_ok[name] = fin

        if compute_latency:
            lat = own_lat[name].copy()
            if node_groups:
                max_child = np.zeros(n, dtype=np.float64)
                for group, sel in zip(node_groups, sels):
                    group_lat = np.zeros(n, dtype=np.float64)
                    for idx, (target, _prob) in enumerate(group):
                        chosen = sel == idx
                        if chosen.any():
                            group_lat[chosen] = total_lat[target][chosen]
                    np.maximum(max_child, group_lat, out=max_child)
                lat[ok] += max_child[ok]  # children only called on own success
            total_lat[name] = lat

        # stats (only under the request mask)
        requests = int(m.sum())
        own_err = int((m & ~ok).sum())
        ds_err = int((m & ok & ~fin).sum())
        acc.add_counts(name, requests, own_err, ds_err)
        ok_mask = m & fin
        err_mask = m & ~fin
        if compute_latency:
            if ok_mask.any():
                acc.add_latency(name, "200", total_lat[name][ok_mask])
            if err_mask.any():
                acc.add_latency(name, "500", total_lat[name][err_mask])
        else:
            acc.add_status_count(name, "200", int(ok_mask.sum()))
            acc.add_status_count(name, "500", int(err_mask.sum()))


def simulate_propagation(
    endpoint_metrics: List[dict],
    depend_on_groups: Dict[str, ProbabilityGroups],
    metrics_per_slot: Dict[str, SlotMetrics],
    compute_latency: bool,
    rng: np.random.Generator,
    chunk_size: int = DEFAULT_CHUNK,
) -> Dict[str, Dict[str, dict]]:
    """-> slotKey -> uniqueEndpointName -> propagation stats
    (LoadSimulationPropagator.ts:32-63)."""
    fallback_by_endpoint = {
        m["uniqueEndpointName"]: _FALLBACK_CODES[m["fallbackStrategy"]]
        for m in endpoint_metrics
    }
    topo_cache: Dict[str, List[str]] = {}
    results: Dict[str, Dict[str, dict]] = {}

    for key in metrics_per_slot:
        metrics = metrics_per_slot[key]
        acc = _StatsAccumulator()
        for entry in sorted(metrics.entry_request_counts):
            # the reference's `for (i = 0; i < count; i++)` runs
            # ceil(count) times for fractional counts (traffic
            # multipliers make them common); int() truncated one
            # request off every such slot
            count = math.ceil(metrics.get_entry_request_count(entry))
            if count <= 0:
                continue
            if entry not in topo_cache:
                topo_cache[entry] = _reachable_topo_order(entry, depend_on_groups)
            topo = topo_cache[entry]
            error_rate = {n: metrics.get_error_rate(n) for n in topo}
            delay = {n: metrics.get_delay(n) for n in topo}
            replica_zero = {
                n: metrics.get_replicas(naming.extract_unique_service_name(n)) == 0
                for n in topo
            }
            fallback = {n: fallback_by_endpoint.get(n, FALLBACK_ANY) for n in topo}
            remaining = count
            while remaining > 0:
                n = min(remaining, chunk_size)
                _propagate_entry_chunk(
                    topo,
                    entry,
                    n,
                    depend_on_groups,
                    error_rate,
                    delay,
                    replica_zero,
                    fallback,
                    compute_latency,
                    rng,
                    acc,
                )
                remaining -= n
        results[key] = acc.finalize(compute_latency)
    return results
