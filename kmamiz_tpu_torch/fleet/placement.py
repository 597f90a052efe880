"""Forecast-driven placement: which worker should own a tenant next.

Counterpart of kmamiz_tpu/fleet/placement.py. Pure scoring over what can
be observed (no I/O, no clocks), so the same inputs give the same plan.
A tenant's weight is the control plane's predicted tick cost
(``control.predicted_costs``); a tenant it has not forecast yet weighs
the default, so placement works before any forecast and sharpens as they
arrive. The JAX package takes the larger of that and its compile-cost
model's prediction, which is off by default (``KMAMIZ_COST`` unset) and
then adds nothing; the port has no compile-cost model (nothing is
compiled per shape), so its weights are the JAX package's in that
setting.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from kmamiz_tpu_torch import control as ctl_plane
from kmamiz_tpu_torch.fleet.ring import HashRing

#: the weight of a tenant with no forecast
DEFAULT_TENANT_WEIGHT = 1.0


def tenant_weights(tenants: Iterable[str]) -> Dict[str, float]:
    """Forecast relative load per tenant: the control plane's predicted
    tick cost (ms), or the default weight where there is none."""
    pilot = ctl_plane.predicted_costs()
    weights = {}
    for tenant in tenants:
        forecast = float(pilot.get(tenant, 0.0))
        weights[tenant] = forecast if forecast > 0.0 else DEFAULT_TENANT_WEIGHT
    return weights


def worker_loads(
    ring: HashRing,
    tenants: Iterable[str],
    weights: Optional[Dict[str, float]] = None,
    overrides: Optional[Dict[str, str]] = None,
) -> Dict[str, float]:
    """worker -> summed forecast weight under the current placement
    (ring plus any migration overrides)."""
    tenants = list(tenants)
    if weights is None:
        weights = tenant_weights(tenants)
    overrides = overrides or {}
    loads = {worker: 0.0 for worker in ring.workers}
    for tenant in tenants:
        owner = overrides.get(tenant) or ring.owner(tenant)
        loads[owner] = loads.get(owner, 0.0) + weights.get(
            tenant, DEFAULT_TENANT_WEIGHT
        )
    return loads


def pick_target(
    ring: HashRing,
    tenant: str,
    tenants: Iterable[str],
    weights: Optional[Dict[str, float]] = None,
    overrides: Optional[Dict[str, str]] = None,
) -> str:
    """Least-loaded worker for a tenant about to move, its own weight
    excluded from every candidate (moving it empties its slot at the
    source). Deterministic tie-break on worker id."""
    tenants = list(tenants)
    if weights is None:
        weights = tenant_weights(tenants)
    loads = worker_loads(ring, tenants, weights=weights, overrides=overrides)
    overrides = overrides or {}
    current = overrides.get(tenant) or ring.owner(tenant)
    own = weights.get(tenant, DEFAULT_TENANT_WEIGHT)
    loads[current] -= own
    return min(sorted(loads), key=lambda worker: loads[worker])


def rebalance_plan(
    ring: HashRing,
    tenants: Iterable[str],
    weights: Optional[Dict[str, float]] = None,
    overrides: Optional[Dict[str, str]] = None,
    imbalance_ratio: float = 2.0,
    max_moves: int = 1,
) -> List[Tuple[str, str, str]]:
    """(tenant, source, target) moves that shrink forecast imbalance.

    Conservative by design: migrations cost a drain + replay, so the
    plan proposes at most ``max_moves`` and only while the hottest
    worker carries more than ``imbalance_ratio`` times the coldest's
    forecast load. Each proposed move takes the hottest worker's
    heaviest tenant to the coldest worker — the move with the best
    imbalance reduction per migration."""
    tenants = list(tenants)
    if weights is None:
        weights = tenant_weights(tenants)
    overrides = dict(overrides or {})
    moves: List[Tuple[str, str, str]] = []
    for _ in range(max(0, max_moves)):
        loads = worker_loads(
            ring, tenants, weights=weights, overrides=overrides
        )
        hot = max(sorted(loads), key=lambda worker: loads[worker])
        cold = min(sorted(loads), key=lambda worker: loads[worker])
        if hot == cold or loads[hot] <= loads[cold] * imbalance_ratio:
            break
        owned = [
            t
            for t in tenants
            if (overrides.get(t) or ring.owner(t)) == hot
        ]
        if len(owned) <= 1:
            break  # one hot tenant IS the load; moving it just moves the hotspot
        victim = max(
            sorted(owned),
            key=lambda t: weights.get(t, DEFAULT_TENANT_WEIGHT),
        )
        moves.append((victim, hot, cold))
        overrides[victim] = cold
    return moves
