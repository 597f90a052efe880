"""Predictive admission control: the pure decision core.

A copy of kmamiz_tpu/control/admission.py (pure host code): the same
forecast sequence and config give the same decision trace.

graftpilot's first lever: when a tenant's forecasted
p99 at the serving horizon crosses its SLO threshold, that tenant's
low-priority ticks are shed (429) or deferred (served from last-good
with an explicit ``deferred`` marker) until the forecast clears.

Everything in this module is a pure function of (previous state,
forecast, config). The controller calls :func:`step` once per forecast
ingest — at fold/refresh boundaries, off the hot path — and stores the
returned frozen state; the serving edge only *reads* ``state.action``.
That split is what keeps the warm tick compile-free and host-sync-free,
and it is what makes decisions reproducible: the determinism test
replays the same (forecast sequence, config) in a fresh process and
must get bit-identical decision traces.

Hysteresis: a breach must persist for ``hysteresis`` consecutive
evaluations before shedding activates, and the forecast must stay clear
for the same count before it deactivates — a noisy forecast oscillating
around the SLO cannot flap admission on and off every fold.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Iterable, List, Optional

# admission actions, in escalation order
ALLOW = "allow"
DEFER = "defer"
SHED = "shed"
MODES = (DEFER, SHED)


@dataclass(frozen=True)
class AdmissionConfig:
    """Per-evaluation knobs (resolved from the controller's settings;
    tests construct directly)."""

    slo_ms: float
    hysteresis: int  # consecutive evals to enter AND to leave shedding
    mode: str = DEFER  # DEFER or SHED

    def normalized(self) -> "AdmissionConfig":
        mode = self.mode if self.mode in MODES else DEFER
        return AdmissionConfig(
            slo_ms=float(self.slo_ms),
            hysteresis=max(1, int(self.hysteresis)),
            mode=mode,
        )


@dataclass(frozen=True)
class AdmissionState:
    """One tenant's admission posture after the latest evaluation."""

    active: bool = False  # currently shedding/deferring low-prio ticks
    action: str = ALLOW  # ALLOW while inactive, else the config mode
    breach_streak: int = 0  # consecutive breaching evaluations
    clear_streak: int = 0  # consecutive clear evaluations
    forecast_p99_ms: float = 0.0  # last ingested forecast
    slo_ms: float = 0.0  # threshold it was judged against
    transitions: int = 0  # activation/deactivation count (flap meter)
    evaluations: int = 0

    def as_dict(self) -> dict:
        return asdict(self)


def step(
    prev: Optional[AdmissionState],
    forecast_p99_ms: float,
    cfg: AdmissionConfig,
) -> AdmissionState:
    """One admission evaluation: fold the latest forecast into the
    hysteresis streaks and decide the posture for the next window."""
    cfg = cfg.normalized()
    prev = prev or AdmissionState()
    breach = float(forecast_p99_ms) > cfg.slo_ms
    breach_streak = prev.breach_streak + 1 if breach else 0
    clear_streak = 0 if breach else prev.clear_streak + 1
    active = prev.active
    if not active and breach_streak >= cfg.hysteresis:
        active = True
    elif active and clear_streak >= cfg.hysteresis:
        active = False
    return AdmissionState(
        active=active,
        action=cfg.mode if active else ALLOW,
        breach_streak=breach_streak,
        clear_streak=clear_streak,
        forecast_p99_ms=float(forecast_p99_ms),
        slo_ms=cfg.slo_ms,
        transitions=prev.transitions + (1 if active != prev.active else 0),
        evaluations=prev.evaluations + 1,
    )


def decision_trace(
    forecast_p99_seq: Iterable[float], cfg: AdmissionConfig
) -> List[dict]:
    """Replay a forecast sequence through :func:`step` from a clean
    state and return every intermediate decision as plain dicts — the
    cross-process determinism oracle (same sequence + config in any
    process must produce a bit-identical trace)."""
    out: List[dict] = []
    state: Optional[AdmissionState] = None
    for p99 in forecast_p99_seq:
        state = step(state, p99, cfg)
        out.append(state.as_dict())
    return out
