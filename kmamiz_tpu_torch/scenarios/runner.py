"""The storyline's per-tick view, from the closed-loop soak runner.

The part of kmamiz_tpu/scenarios/runner.py that labeled.py reads, copied:
`_deploy_version_fn` (the canonical revision of each service under a
rolling deploy) and `_tick_view` (what the storyline does to a tenant at
a tick). The runner itself, which drives a scenario against a live server
with the fleet and cost layers, comes with the port's harnesses.
"""
from __future__ import annotations


def _deploy_version_fn(plan, tick: int):
    """istio.canonical_revision per service at ``tick`` under any active
    rolling-deploy event: one service of the event's order flips to v2
    per elapsed tick."""
    flipped = set()
    for ev in plan.events:
        if ev.kind == "rolling-deploy" and tick >= ev.at_tick:
            (order,) = ev.params
            flipped.update(order[: tick - ev.at_tick + 1])

    def version_of(svc: str) -> str:
        return "v2" if svc in flipped else "v1"

    return version_of


def _tick_view(plan, tick: int) -> dict:
    """What the storyline does to this tenant at this tick."""
    view = {
        "flap": False,
        "stall": False,
        "drop": set(),
        "error": set(),
        "latency_us": 0,
        "poisons": [],
        "growth": [],
    }
    for ev in plan.events:
        if not ev.active(tick):
            continue
        if ev.kind == "upstream-flap":
            view["flap"] = True
        elif ev.kind == "tick-stall":
            view["stall"] = True
        elif ev.kind == "partial-outage":
            view["drop"].update(ev.params[0])
        elif ev.kind == "cascade":
            view["error"].update(ev.params[0])
            view["latency_us"] = 5_000 * ev.params[1]
        elif ev.kind == "poison-storm":
            view["poisons"].append(ev)
        elif ev.kind == "capacity-growth":
            view["growth"].append(ev)
    return view
