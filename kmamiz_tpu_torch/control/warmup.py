"""Attribution-guided proactive breaker warm-up.

A copy of kmamiz_tpu/control/warmup.py over the port's breakers.

graftpilot's second lever: STLGT's neighbor-bias
gates assign every graph edge an attribution score — how much that
upstream edge is implicated in the forecast tail. When the top score
crosses the warm-up gate, the controller pre-trips the tenant's
resilience breakers into a *warmed* HALF_OPEN with a shortened probe
cooldown, so the first real upstream failure of the forecast cascade
short-circuits immediately instead of burning ``threshold`` consecutive
failures while the cascade lands. When attribution mass drops back
below the gate, warm-up auto-reverts and the breakers return to their
configured posture.

The decision (:func:`evaluate`) is a pure function of (attributions,
config); :func:`apply` performs the breaker side effects and is only
invoked by the controller at fold/refresh boundaries — never on the
warm tick.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Iterable, Tuple

Attribution = Tuple[str, str, float]  # (src endpoint, dst endpoint, score)


@dataclass(frozen=True)
class WarmupConfig:
    gate_threshold: float  # attribution score in [0, 1] that arms warm-up
    probe_cooldown_s: float  # shortened OPEN->HALF_OPEN probe window


@dataclass(frozen=True)
class WarmupDecision:
    warm: bool
    mass: float  # max attribution score seen this evaluation
    blamed: Tuple[Attribution, ...]  # edges at/above the gate, score desc


def evaluate(
    attributions: Iterable[Attribution], cfg: WarmupConfig
) -> WarmupDecision:
    """Pure warm-up decision: arm while any edge's attribution score
    holds the gate, disarm the moment the mass drops below it."""
    attrs = [(str(s), str(d), float(score)) for s, d, score in attributions]
    blamed = tuple(
        sorted(
            (a for a in attrs if a[2] >= cfg.gate_threshold),
            key=lambda a: (-a[2], a[0], a[1]),
        )
    )
    mass = max((a[2] for a in attrs), default=0.0)
    return WarmupDecision(warm=bool(blamed), mass=mass, blamed=blamed)


def apply(
    tenant: str,
    decision: WarmupDecision,
    cfg: WarmupConfig,
    warmed: FrozenSet[str],
) -> FrozenSet[str]:
    """Reconcile the tenant's registered breakers with the decision and
    return the new warmed-name set. Side effects live here (and only
    run at fold boundaries): arming warms every breaker currently
    registered for the tenant; disarming reverts exactly the ones this
    controller warmed. Breakers that tripped OPEN on real failures are
    never overridden in either direction."""
    from kmamiz_tpu_torch.resilience import breaker as breaker_mod

    if decision.warm:
        now_warm = set(warmed)
        for name, brk in breaker_mod.breakers_for(tenant).items():
            if brk.warm_up(cfg.probe_cooldown_s):
                now_warm.add(name)
        return frozenset(now_warm)
    live = breaker_mod.breakers_for(tenant)
    for name in warmed:
        brk = live.get(name)
        if brk is not None:
            brk.revert_warm_up()
    return frozenset()
