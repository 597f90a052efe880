"""Forecast-aware tick scheduling policy.

A copy of kmamiz_tpu/control/policy.py (pure host code).

graftpilot's third lever: inside the TickRouter's
gather window, pending tenant ticks are
reordered by predicted per-tenant cost so cheap tenants are not stuck
serializing behind a forecast-expensive one. The cost table is the
controller's latest per-tenant predicted latency mass (sum of forecast
p99 across the tenant's endpoints), refreshed at fold boundaries; the
router only performs a dict lookup and a stable sort over an
already-drained batch — no forecasting on the hot path.

Ordering is deterministic: (predicted cost asc, tenant name, arrival
index). Tenants with no forecast sort at cost 0.0 — an unknown tenant
is assumed cheap rather than penalized for having no history.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, TypeVar

T = TypeVar("T")


def predicted_cost_ms(q99_ms: Sequence[float]) -> float:
    """A tenant's scheduling cost: total predicted p99 latency mass
    across its endpoints at the control horizon."""
    return float(sum(float(v) for v in q99_ms))


def order_batch(
    items: Sequence[T],
    cost_ms_by_tenant: Dict[str, float],
    tenant_of: Callable[[T], str],
) -> List[T]:
    """Stable cheap-first ordering of a drained gather-window batch.

    Pure and total: unknown tenants cost 0.0, ties break on tenant name
    then arrival order, and the result is a new list (the router zips
    results back positionally against the reordered batch)."""
    indexed = list(enumerate(items))
    indexed.sort(
        key=lambda pair: (
            cost_ms_by_tenant.get(tenant_of(pair[1]), 0.0),
            tenant_of(pair[1]),
            pair[0],
        )
    )
    return [item for _idx, item in indexed]
