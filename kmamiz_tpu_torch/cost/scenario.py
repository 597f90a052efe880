"""graftcost scenario plane: predicted wall cost of one soak cell.

Counterpart of kmamiz_tpu/cost/scenario.py, with the same weights, so a
sweep plan orders its cells as the JAX plan does. A soak sweep needs to
know "how long will this (archetype, seed) cell take end to end?" so the
scheduler can launch the longest cells first and the tail of a
thousand-cell sweep never straggles behind one slow scenario (LPT
scheduling; ``python -m kmamiz_tpu_torch.tools.graftsoak``).

Two-tier estimate, deterministic for one spec:

1. **Feature prior**: a linear model over the composed spec — per-tick
   harness overhead, per-trace span volume, per-tenant server cost,
   and a per-storyline-kind surcharge (a tick stall sleeps through the
   watchdog deadline; a kill-9 replay forks a crash child; recovery
   waits burn real wall time). Weights are calibrated from the seed-0
   matrix, not load-bearing: only the ORDERING matters.
2. **Observed correction**: when the sweep manifest already holds
   finished cells, ``fit_observed`` learns a per-archetype ratio of
   measured wall to the prior (median, robust to one outlier cell) and
   ``predicted_scenario_cost_s`` applies it — the second thousand
   cells are ordered by what the first thousand actually cost.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

#: feature weights (seconds) for the prior — per measured tick, per
#: emitted trace, per tenant (server + reference replay), per scenario
PER_TICK_S = 0.12
PER_TRACE_S = 0.004
PER_TENANT_S = 0.35
BASE_S = 0.6

#: storyline surcharges (seconds per event of the kind): wall the
#: harness demonstrably burns beyond span volume
EVENT_COST_S: Dict[str, float] = {
    "tick-stall": 1.2,       # stall sleep + watchdog deadline window
    "upstream-flap": 0.8,    # breaker cooldown + recovery-to-fresh poll
    "partial-outage": 0.6,   # outage window + recovery poll
    "cascade": 0.4,          # error-injection ticks + added latency
    "poison-storm": 0.3,     # quarantine round-trips
    "rolling-deploy": 0.3,   # v2 warmup + flip ticks
    "capacity-growth": 0.9,  # bucket crossing + the twin's replay of the crossing
    "kill9-replay": 9.0,     # forked crash child pays a full interpreter
    "tenant-migration": 12.0,  # 4-worker fleet ring + WAL handoff
}


def predicted_scenario_cost_s(
    spec, observed: Optional[Mapping[str, float]] = None
) -> float:
    """Deterministic cost estimate (seconds) for one composed scenario
    spec. ``observed`` maps archetype -> correction ratio from
    :func:`fit_observed`; absent archetypes fall back to the prior."""
    cost = BASE_S + PER_TICK_S * spec.n_ticks
    for plan in spec.tenants:
        cost += PER_TENANT_S
        cost += PER_TRACE_S * sum(plan.traffic)
        for ev in plan.events:
            cost += EVENT_COST_S.get(ev.kind, 0.2)
    ratio = (observed or {}).get(spec.archetype)
    if ratio is not None and ratio > 0:
        cost *= ratio
    return round(cost, 4)


def fit_observed(records: Iterable[Mapping]) -> Dict[str, float]:
    """Per-archetype correction ratios from finished cell records
    (each carrying ``archetype``, ``wall_s`` and ``predicted_s``).
    Median of wall/predicted per archetype — one straggler cell (page
    cache miss, CI noise) must not reorder the whole sweep."""
    ratios: Dict[str, list] = {}
    for rec in records:
        try:
            wall = float(rec["wall_s"])
            prior = float(rec["predicted_s"])
        except (KeyError, TypeError, ValueError):
            continue
        if wall <= 0 or prior <= 0:
            continue
        ratios.setdefault(str(rec["archetype"]), []).append(wall / prior)
    out: Dict[str, float] = {}
    for archetype, samples in ratios.items():
        samples.sort()
        out[archetype] = round(samples[len(samples) // 2], 4)
    return out
